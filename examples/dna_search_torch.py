"""The paper's case study end to end (§IV-V) on the PyTorch port, through
the client frontend, as ``examples/dna_search.py`` does with the JAX
package: chromosome-scale DNA ingest into a persisted ``SuffixTable``
behind a ``repro_torch.api.Database`` handle, single-process and 50-user
scan workloads, Table III/IV/V statistics, the hedged-read tail fix —
then the beyond-paper surface: typed locate queries, paged
``ReadSession`` streaming with a mid-stream cursor resume, append with
merged-read exact counts, compact, and re-open from disk.

    PYTHONPATH=src python examples/dna_search_torch.py --text-len 300000
    PYTHONPATH=src python examples/dna_search_torch.py --device cpu \\
        --text-len 20000 --queries 500

The streamed probe is the reference's 3 bases up to a few million bases
of text; at a chromosome's length it grows (:func:`stream_probe_len`)
so that the stream stays a few dozen pages long.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.api import Database, Query, SuffixTable
from repro_torch.core.codec import decode_dna, random_dna
from repro_torch.device import resolve_device
from repro_torch.serving import HedgedScanService


PAGE_SIZE = 100            # positions a streamed page
STREAM_MAX_PAGES = 64      # expected pages of the streamed probe, at most


def stream_probe_len(text_len: int) -> int:
    """Bases of the streamed probe: the shortest, from the reference's 3,
    whose expected positions in ``text_len`` uniform bases
    (``text_len / 4**L``) fit in ``STREAM_MAX_PAGES`` pages.  A 3-base
    probe fits up to 409,600 bases; chr1's length takes 8."""
    n = 3
    while text_len / 4**n > STREAM_MAX_PAGES * PAGE_SIZE:
        n += 1
    return n


def _disk_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(path) for f in files)


def main(argv=None) -> dict:
    """Runs the case study under a fresh root; returns the figures it
    prints (the Table III/IV/V and hedged statistics as
    ``HedgedScanService.run_workload`` gives them)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--text-len", type=int, default=300_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    db = Database(tempfile.mkdtemp(prefix="repro_torch_tables_"),
                  device=dev)
    root = db.root
    print(f"[ingest] {args.text_len} bases (paper: chr1, 17 min on 2 VMs)")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    codes = random_dna(args.text_len, seed=0)
    table = db.create_table("chr_demo", codes, is_dna=True)
    if on_card:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    ingest = {"seconds": dt, "mbase_per_s": args.text_len / dt / 1e6,
              "disk_bytes": _disk_bytes(os.path.join(root, "chr_demo")),
              "device_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if on_card else None)}
    peak = (f", device peak {ingest['device_peak_bytes']} bytes"
            if on_card else "")
    print(f"[ingest] {dt:.1f}s = {ingest['mbase_per_s']:.2f} Mbase/s "
          f"-> {root}/chr_demo v{table.version} "
          f"({ingest['disk_bytes']} bytes on disk{peak})")

    svc = HedgedScanService(table, database=db)
    # paper workload lengths are 1..100; clamp to the table's pattern cap
    # (run_workload validates max_len up front)
    max_len = min(100, table.max_query_len)
    # Table III: single process, in batches of 10 (a sequential single
    # stream is dispatch-bound; 10-wide batches keep its semantics)
    s3 = svc.run_workload(args.queries, batch=10, hedged=False, seed=3,
                          max_len=max_len)
    print(f"[table III] n={s3['n']} mean={s3['mean_ms']:.2f}ms "
          f"sd={s3['sd_ms']:.2f} max={s3['max_ms']:.0f} "
          f"hit={s3['hit_rate']:.3f}"
          f"   (paper: mean 2.79ms sd 3.64 max 41 hit 0.072)")
    # Table IV: 50 users
    s = svc.run_workload(args.queries, batch=50, hedged=False, seed=4,
                         max_len=max_len)
    print(f"[table IV ] n={s['n']} mean={s['mean_ms']:.2f}ms "
          f"max={s['max_ms']:.0f} hit={s['hit_rate']:.3f}"
          f"   (paper: mean 5.26ms max 771 hit 0.080)")
    # Table V: correlations
    print(f"[table V  ] corr(len,time)={s['corr_len_time']:.3f} "
          f"corr(len,hit)={s['corr_len_outcome']:.3f}"
          f"   (paper: 0.013 / -0.469)")
    # Beyond-paper: hedged reads kill the tail the paper measured
    h = svc.run_workload(args.queries, batch=50, hedged=True, seed=4,
                         max_len=max_len)
    print(f"[hedged   ] max={h['max_ms']:.0f}ms p99={h['p99_ms']:.1f}ms "
          f"(single-read max was {s['max_ms']:.0f}ms)")
    # Beyond-paper: match enumeration — the paper only reports the first
    # match row; a typed locate Query gathers the top-k smallest positions
    probe = decode_dna(codes[1000:1008])
    out = db.query(Query.locate("chr_demo", [probe], top_k=8))
    hits = [int(x) for x in out.value[0] if x >= 0]
    print(f"[locate   ] {probe!r}: count={int(out.count[0])} "
          f"positions={hits} (planted at 1000)")
    assert 1000 in hits or int(out.count[0]) > 8

    # Beyond-paper: paged streaming (the ReadRows analogue) — a huge
    # enumeration comes back in bounded pages; a serialized cursor resumes
    # mid-stream, even across the compaction below
    short = decode_dna(codes[1000:1000 + stream_probe_len(args.text_len)])
    sess = db.read_rows("chr_demo", short, page_size=PAGE_SIZE)
    first = sess.next_page()
    cursor = first.cursor                      # plain JSON, process-portable
    rest = sum(len(p.positions) for p in db.resume_read(cursor).pages())
    want = int(db.query(Query.count("chr_demo", [short])).value[0])
    assert len(first.positions) + rest == want
    print(f"[stream   ] {short!r}: {want} positions = "
          f"{len(first.positions)} (page 1) + {rest} (resumed from cursor)")

    # Beyond-paper: the write path.  Accumulo tables are mutable; so is
    # ours — appends land in the memtable and reads merge exact counts,
    # including matches straddling the old end-of-text.
    tail = decode_dna(codes[-4:])
    straddle = tail + "GATTACA"          # crosses the base/append boundary
    before = int(db.query(Query.count("chr_demo", [straddle])).value[0])
    table.append("GATTACA" + decode_dna(random_dna(500, seed=7)))
    after = int(db.query(Query.count("chr_demo", [straddle])).value[0])
    assert after == before + 1, (before, after)
    print(f"[append   ] {straddle!r}: count {before} -> {after} "
          f"(memtable merged read)")
    t0 = time.perf_counter()
    table.compact()
    compact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reopened = SuffixTable.open("chr_demo", root=root, device=dev)
    open_s = time.perf_counter() - t0
    reopened_count = int(reopened.count([straddle])[0])
    assert reopened_count == after
    print(f"[compact  ] v{reopened.version}, {len(reopened)} bases; "
          f"re-opened from disk with identical counts")
    figures = {"ingest": ingest, "table_iii": s3, "table_iv": s,
               "hedged": h, "locate": {"probe": probe, "positions": hits,
                                       "count": int(out.count[0])},
               "stream": {"probe": short, "count": want,
                          "first_page": len(first.positions),
                          "resumed": rest},
               "append": {"probe": straddle, "before": before,
                          "after": after},
               "compact": {"seconds": compact_s, "open_seconds": open_s,
                           "version": reopened.version,
                           "bases": len(reopened),
                           "reopened_count": reopened_count}}
    reopened.close()
    db.close()
    return figures


if __name__ == "__main__":
    main()
