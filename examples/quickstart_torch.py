"""Quickstart of the PyTorch port: the paper's pipeline via the client
frontend, as ``examples/quickstart.py`` does with the JAX package.

Builds a suffix-array table over a DNA string on the card, routes typed
``Query`` requests through a ``repro_torch.api.Database`` handle (count /
contains / locate / scan), streams a big enumeration in pages
(``ReadSession``), and shows the paper's own MISSISSIPPI worked example
(§III) on the low-level store.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import Database, Query, SuffixTable
from repro_torch.core import codec
from repro_torch.core.tablet import build_tablet_store
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    """Runs the quickstart; returns the figures it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- the paper's §III worked example (low-level store) ------------------
    text = "MISSISSIPPI"
    codes = np.frombuffer(text.encode(), dtype=np.uint8).astype(np.int32)
    store = build_tablet_store(codes, is_dna=False, device=dev)
    sa = store.sa[store.pad_count:].cpu().numpy()     # the card's SA, on host
    print("ordered suffixes (paper §III):")
    for i in sa:
        print("  ", text[i:])

    # --- DNA scans (paper §IV-V) through the typed client -------------------
    dna = codec.random_dna(100_000, seed=0)
    with Database.in_memory() as db:                  # the client handle
        table = db.attach("dna", SuffixTable.from_codes(dna, is_dna=True,
                                                        device=dev))

        patterns = ["ACGT", "TTTTTTTTTTTTTTTT", "GATTACA"]
        res = db.query(Query.scan("dna", patterns, top_k=3))
        scans = []
        for p, found, count, pos, row in zip(patterns, res.found, res.count,
                                             res.first_pos, res.positions):
            top = [int(x) for x in row if x >= 0]
            scans.append((p, bool(found), int(count), int(pos), top))
            print(f"pattern {p!r}: found={bool(found)} count={int(count)} "
                  f"first_pos={int(pos)} top3={top}")

        # --- paged streaming (the ReadRows analogue) ------------------------
        pages = list(db.read_rows("dna", "GATTACA", page_size=4).pages())
        total = sum(len(pg.positions) for pg in pages)
        print(f"streamed {total} 'GATTACA' positions in {len(pages)} pages "
              f"of <=4 (cursor resumes across appends and compactions)")

        # --- the write path: append, merged exact read ----------------------
        table.append("GATTACAGATTACA")
        after = int(db.query(Query.count("dna", ["GATTACA"])).value[0])
        print(f"after append: count('GATTACA') = {after}")
    return {"sa": sa.tolist(), "scans": scans, "streamed": total,
            "pages": len(pages), "count_after_append": after}


if __name__ == "__main__":
    main()
