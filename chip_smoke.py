#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once), then drives the port's main path
through the public entry points at chromosome scale:

1. ``[build]``   ``SuffixTable.from_codes`` over 2**26 random bases on
                 the card (SA by prefix doubling, text packed by pack2bit);
2. ``[count]``   the paper's workload (10,000 random patterns of 1-100
                 bases) through ``SuffixTable.scan`` in batches of 512;
3. ``[append]``  three appends of 2**17 bases: the second seals a run at
                 ``memtable_limit``, so a run and a memtable are live;
4. ``[merged]``  the workload again over base + run + memtable (the tier
                 scan kernel), then ``locate(top_k=5)``;
5. ``[linear]``  ``ops.tablet_scan`` of the first batch over every sorted
                 row of that table's base (the tablet scan kernel), held
                 against the plain binary search's bounds for every
                 query of the batch;
6. ``[freeze]``  a second table over the same bases, frozen onto an FM
                 index by the ``fm_threshold`` policy;
7. ``[frozen]``  the workload through the frozen table, base only (the
                 fm_scan kernel); counts and first_pos must equal
                 ``[count]``;
8. ``[frozen-merged]`` the same three appends to the frozen table, the
                 workload and ``locate(top_k=5)`` again (fm_scan plus the
                 tier scan kernel); must equal ``[merged]`` and
                 ``[locate]``;
9. ``[kernels]`` every kernel's launches on that run (must be > 0) and
                 its result held against its plain PyTorch version(s)
                 on inputs taken from that run; a sample of counts is
                 checked against a numpy brute-force scan of the text.
                 The two searches (``tablet_scan``, ``tier_scan``) also
                 print their rounds and probes (``[tablet]``,
                 ``[tiers]``), and ``[ptxas]`` lines give every
                 kernel's registers, shared memory and spills.

It prints one JSON line of per-kernel numbers (``ms``: time per call as
the host issues them; ``device_ms``: device time of launches queued back
to back, the L2 warm; ``cold_ms``: device time of a launch that follows
a flush of the L2) and, last, the device line.  Any build, launch or mismatch
failure exits non-zero without it.
It imports neither jax nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

TEXT_LEN = 2**26
MEMTABLE_LIMIT = 2**18
APPEND_LEN = 2**17
N_QUERIES = 10_000
BATCH = 512
MAX_QUERY_LEN = 128
SLICE_ROWS = 2**18          # rows the dense plain tablet scan is held on
FLUSH_WORDS = 2**26         # int32 words (256 MiB) written to flush the L2

# Published H100 SXM peaks (NVIDIA data sheet), used for the bounds.
MEM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12          # float32 outside the tensor cores


def cuda_ms(torch, fn, reps: int, *, queue_ahead: bool = False,
            flush=None) -> float:
    """Mean time of ``fn`` in ms over ``reps`` runs after one warm-up, by
    CUDA events.  Plain events time the calls as the host issues them:
    for a kernel of tens of µs the wrapper's host work per call is the
    larger part.  With ``queue_ahead`` the card first spins ~25 ms
    (``torch.cuda._sleep``), so the host has queued every launch before
    the first starts, and the events time the kernels back to back: each
    launch finds in the L2 what the one before it read.  With ``flush``
    (a tensor larger than the 50 MB L2; queued ahead as well) every run
    follows a write of that tensor and has its own pair of events: the
    device time of a launch whose inputs start in HBM."""
    fn()
    torch.cuda.synchronize()

    def ev():
        return torch.cuda.Event(enable_timing=True)

    if queue_ahead or flush is not None:
        torch.cuda._sleep(50_000_000)
    if flush is not None:
        pairs = [(ev(), ev()) for _ in range(reps)]
        for start, end in pairs:
            flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps
    start, end = ev(), ev()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def fm_traffic(torch, FM, fa, syms):
    """What the backward search of the plan ``syms`` needs on index
    ``fa``, counted on this run's data: per active step one rank at
    ``lo`` and, while the run is not empty, one at ``hi`` (fm_scan.cu
    takes one rank once ``lo == hi``); each rank reads one Occ entry and
    the ceil(rem / 16) BWT words below its row.  Steps the search in
    plain torch; returns (ranks, words, lo, hi)."""
    B = int(syms.shape[1])
    cc = fa.cc.to(torch.int64)
    lo = torch.zeros(B, dtype=torch.int64, device=syms.device)
    hi = torch.full_like(lo, fa.n + 1)
    ranks = torch.zeros((), dtype=torch.int64, device=syms.device)
    words = torch.zeros_like(ranks)
    for t in range(int(syms.shape[0])):
        s = syms[t].to(torch.int64)
        act = s >= 0
        two = act & (hi > lo)
        ranks += act.sum() + two.sum()
        words += ((lo % FM.SB + 15) // 16)[act].sum()
        words += ((hi % FM.SB + 15) // 16)[two].sum()
        sc = s.clamp(0, fa.vocab - 1)
        lo2 = cc[sc] + FM.rank(fa, sc, lo)
        hi2 = cc[sc] + FM.rank(fa, sc, hi)
        lo = torch.where(act, lo2, lo)
        hi = torch.where(act, hi2, hi)
    return int(ranks), int(words), lo.to(torch.int32), hi.to(torch.int32)


def probed_rows(torch, trace):
    """What a traced 17-ary search (``kary.search``) probed: the distinct
    rows, each with the most window words any probe of it read, the
    rounds in which some lane probed, the probes and the words they read
    in all."""
    rows = torch.cat([r for r, _ in trace])
    words = torch.cat([w for _, w in trace])
    uniq, inv = torch.unique(rows, return_inverse=True)
    most = torch.zeros(uniq.shape, dtype=torch.int64, device=rows.device)
    most.scatter_reduce_(0, inv, words, "amax")
    rounds = sum(1 for r, _ in trace if r.numel())
    return uniq, most, rounds, int(rows.numel()), int(words.sum())


def tablet_traffic(torch, trace):
    """Bytes a traced tablet search of this run's data reads (each read
    once): 4 per distinct probed row (its position) + 4 per window word
    the early-exit compare reads of it; plus the rounds, the probes and
    the words compared in all.  From a binary search's trace this is what
    the function needs; from the kernel's 17-ary one, what its probes
    read."""
    uniq, most, rounds, probes, words = probed_rows(torch, trace)
    return 4 * int(uniq.numel()) + 4 * int(most.sum()), rounds, probes, words


def tier_traffic(torch, traces, sa, text_packed, run_lo, run_hi):
    """Bytes a traced tier search and the sweep of the match runs
    ``[run_lo, run_hi)`` (T, B) of this run's data read (each read once):
    per tier, 4 per distinct sa row that a probe or a swept run reads,
    and 4 per distinct packed text word that the early-exit compares read
    (words ``pos // 16 ..``, one more when ``pos % 16`` shifts the window
    across a word); plus the most rounds of any tier, the probes and the
    words compared in all.  Binary and 17-ary traces as in
    :func:`tablet_traffic`."""
    T, R = sa.shape
    n_words = int(text_packed.shape[1])
    dev = sa.device
    n_bytes, rounds, probes, words = 0, 0, 0, 0
    for t in range(T):
        uniq, most, r, p, w = probed_rows(torch, traces[t])
        rounds, probes, words = max(rounds, r), probes + p, words + w
        lb = run_lo[t].to(torch.int64)
        ub = run_hi[t].to(torch.int64)
        cover = torch.zeros(R + 1, dtype=torch.int64, device=dev)
        cover.index_add_(0, lb, torch.ones_like(lb))
        cover.index_add_(0, ub, -torch.ones_like(ub))
        touched = torch.cumsum(cover, 0)[:R] > 0
        touched[uniq] = True
        pos = sa[t, uniq].to(torch.int64)
        span = most + (((pos % 16) != 0) & (most > 0)).to(torch.int64)
        mark = torch.zeros(n_words, dtype=torch.bool, device=dev)
        for j in range(int(span.max()) if span.numel() else 0):
            idx = (pos // 16 + j)[span > j]
            mark[idx[idx < n_words]] = True
        n_bytes += 4 * int(touched.sum()) + 4 * int(mark.sum())
    return n_bytes, rounds, probes, words


def ptxas_report(build_dir, names):
    """Registers, shared memory and spills of every kernel entry in the
    nvcc logs of ``names`` (built with -Xptxas -v), one dict each."""
    import re
    out = []
    for name in names:
        log = build_dir / f"{name}.log"
        if not log.exists():
            continue
        cur = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                k = re.search(r"\d+(\w+_kernel)", m.group(1))
                cur = {"kernel": k.group(1) if k else m.group(1)}
                out.append(cur)
            elif cur is not None:
                for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("registers", r"Used (\d+) registers"),
                                 ("smem_bytes", r"(\d+) bytes smem")):
                    m = re.search(pat, line)
                    if m:
                        cur[key] = int(m.group(1))
    return out


def brute_positions(np, text, pattern):
    """All start positions of ``pattern`` in ``text`` (uint8 codes), by a
    vectorised numpy scan that filters candidates one base at a time."""
    L = len(pattern)
    cand = np.flatnonzero(text[:len(text) - L + 1] == pattern[0])
    for k in range(1, L):
        cand = cand[text[cand + k] == pattern[k]]
    return cand


def sorted_windows(torch, codec, store, n_words: int, chunk: int = 2**22):
    """(W, n_real) uint32: the packed window of every real sorted row of
    ``store``, extracted ``chunk`` rows at a time (the one-shot
    extraction's int64 temporaries would take ~10x the result)."""
    pos = store.sa[store.pad_count:]
    n = int(pos.shape[0])
    wt = torch.empty((n_words, n), dtype=torch.uint32, device=pos.device)
    for i in range(0, n, chunk):
        win = codec.extract_window(store.text_packed, pos[i:i + chunk],
                                   n_words)
        wt.view(torch.int32)[:, i:i + chunk] = win.view(torch.int32).T
    return wt


def profile_batches(torch, table, patterns, tag: str) -> None:
    """Device busy share and top kernels over four batches (cache
    cleared), by torch.profiler; outside the counted main path."""
    from torch.profiler import ProfilerActivity, profile
    table.clear_cache()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(0, 4 * BATCH, BATCH):
                table.scan(patterns[i:i + BATCH])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                     for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        print(f"[profile:{tag}] batches=4 wall_ms={wall_us / 1e3:.3f} "
              f"device_busy_ms={dev_us / 1e3:.3f} "
              f"device_busy_share={dev_us / wall_us:.4f}", flush=True)
        for e in top:
            print(f"[profile:kernel] {e.key[:60]} calls={e.count} "
                  f"device_ms={e.self_device_time_total / 1e3:.3f}",
                  flush=True)
    except (RuntimeError, AttributeError) as exc:   # profiler unavailable
        print(f"[profile:{tag}] not measured: {exc}", flush=True)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.api import SuffixTable
    from repro_torch.core import codec
    from repro_torch.core import query as Q
    from repro_torch.kernels import _build, kary, ops, ref
    from repro_torch.kernels import fm_scan as FM
    from repro_torch.kernels import tier_scan as TS
    from repro_torch.kernels.tablet_scan import BIG as NO_ROW
    from repro_torch.kernels.tablet_scan import (tablet_scan_cuda,
                                                 tablet_scan_plain)
    from repro_torch.kernels.pack2bit import pack2bit_cuda
    from repro_torch.kernels.pattern_scan import (bounded_search_cuda,
                                                  pattern_compare_cuda)

    failures: list[str] = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)
            print(f"[FAIL] {what}", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[device] {smi}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"[nvcc] built {', '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.3f} s into {_build.BUILD_DIR}",
          flush=True)
    for k in ptxas_report(_build.BUILD_DIR, _build.SOURCES):
        print("[ptxas] " + " ".join(f"{a}={b}" for a, b in k.items()),
              flush=True)

    # ---------------- main path: every launch from here is counted ------
    _build.reset_launches()
    base = codec.random_dna(TEXT_LEN, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table = SuffixTable.from_codes(base, is_dna=True,
                                   max_query_len=MAX_QUERY_LEN,
                                   memtable_limit=MEMTABLE_LIMIT)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[build] n={TEXT_LEN} seconds={dt:.4f} "
          f"mbase_per_s={TEXT_LEN / dt / 1e6:.3f} "
          f"resident_bytes={torch.cuda.memory_allocated()} "
          f"peak_bytes={torch.cuda.max_memory_allocated()}", flush=True)
    check(table.store.device.type == "cuda", "table lives on the card")

    patterns = Q.random_patterns(N_QUERIES, 1, 100, seed=0)

    def serve(tag: str, table) -> tuple[np.ndarray, np.ndarray]:
        """The workload through ``table.scan``: (counts, first_pos)."""
        lat, counts, firsts = [], [], []
        table.tracer.reset()
        t_all = time.perf_counter()
        for i in range(0, N_QUERIES, BATCH):
            t = time.perf_counter()
            out = table.scan(patterns[i:i + BATCH])
            lat.append((time.perf_counter() - t) * 1e3)
            counts.append(out.count)
            firsts.append(out.first_pos)
        total = time.perf_counter() - t_all
        c = np.concatenate(counts)
        lat = np.asarray(lat)
        print(f"[{tag}] queries={len(c)} batches={len(lat)} "
              f"p50_ms={np.percentile(lat, 50):.4f} "
              f"p99_ms={np.percentile(lat, 99):.4f} "
              f"queries_per_s={len(c) / total:.1f} "
              f"found={int((c > 0).sum())}", flush=True)
        check(c.shape == (N_QUERIES,) and bool((c >= 0).all()),
              f"{tag}: counts have the expected shape and are >= 0")
        spans = table.tracer.snapshot()
        print(f"[spans:{tag}] " + " ".join(
            f"{k}:sum_ms={v['sum_ms']},p50_ms={v['p50_ms']}"
            for k, v in spans.items()), flush=True)
        return c, np.concatenate(firsts)

    def append_all(tag: str, table) -> None:
        for chunk in appended:
            table.append(chunk)
        st = table.stats()["tiers"]
        print(f"[{tag}] runs={st['run_count']} run_rows={st['run_rows']} "
              f"memtable_rows={st['memtable_rows']}", flush=True)
        check(st["run_count"] == 1 and st["memtable_rows"] == APPEND_LEN,
              f"{tag}: one sealed run and one live memtable after three "
              f"appends")

    base_counts, base_first = serve("count", table)
    appended = [codec.random_dna(APPEND_LEN, seed=1 + i) for i in range(3)]
    append_all("append", table)
    merged_counts, merged_first = serve("merged", table)
    loc_pats = ["ACGT", "GATTACA", "TTTT"]
    located = table.locate(loc_pats, top_k=5)

    # [linear] the tablet scan over every sorted row of the base, held
    # against the plain binary search's bounds on every query: count =
    # ub - lb, less = lb, first_row = lb where found (rows without the
    # store's pad rows), 2**30 elsewhere
    store = table.store
    patt, plen = table.planner.encode(patterns[:BATCH])
    B, W = patt.shape
    rows_wt = sorted_windows(torch, codec, store, W)
    pos_sorted = store.sa[store.pad_count:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lin = ops.tablet_scan(patt, plen, rows_wt.T, pos_sorted, n_real=store.n_real)
    torch.cuda.synchronize()
    lin_s = time.perf_counter() - t0
    plb, pub = Q.search_bounds_plain(store, patt, plen)
    lb_real = plb - store.pad_count
    lin_err = max_abs_err(torch, lin, (pub - plb, lb_real,
                                       torch.where(pub > plb, lb_real,
                                                   NO_ROW)))
    res = Q.query(store, patt, plen)
    ok = lin_err == 0 and torch.equal(lin[0], res.count)
    print(f"[linear] queries={B} rows={rows_wt.shape[1]} words={W} "
          f"seconds={lin_s:.4f} found={int((pub > plb).sum())} "
          f"max_abs_err={lin_err} match={str(bool(ok)).lower()}",
          flush=True)
    check(bool(ok), "tablet_scan count / less / first_row equal the plain "
          "binary search's bounds for every query")

    # [freeze] a second table over the same bases, frozen by the policy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frozen = SuffixTable.from_codes(base, is_dna=True,
                                    max_query_len=MAX_QUERY_LEN,
                                    memtable_limit=MEMTABLE_LIMIT,
                                    fm_threshold=TEXT_LEN)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    build_s = frozen.stats()["build"]["elapsed_s"]
    fm_bytes = frozen.stats()["tiers"]["resident_bytes"]["fm"]
    sa_bytes = table.stats()["tiers"]["resident_bytes"]["base_sa"]
    print(f"[freeze] n={TEXT_LEN} build_seconds={build_s:.4f} "
          f"freeze_seconds={total_s - build_s:.4f} fm_bytes={fm_bytes} "
          f"live_base_sa_bytes={sa_bytes} "
          f"fm_over_sa={fm_bytes / sa_bytes:.4f} "
          f"is_frozen={str(frozen.is_frozen).lower()}", flush=True)
    check(frozen.is_frozen and frozen.stats()["tiers"]["frozen"],
          "fm_threshold froze the second table")

    fc, ff = serve("frozen", frozen)
    check(np.array_equal(fc, base_counts) and np.array_equal(ff, base_first),
          "frozen base-only counts and first_pos equal the live table's")
    append_all("frozen-append", frozen)
    fmc, fmf = serve("frozen-merged", frozen)
    check(np.array_equal(fmc, merged_counts)
          and np.array_equal(fmf, merged_first),
          "frozen merged counts and first_pos equal the live table's")
    floc = frozen.locate(loc_pats, top_k=5)
    check(np.array_equal(floc, located),
          "frozen locate(top_k=5) equals the live table's")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    # ---------------- end of the main path ------------------------------
    print(f"[locate] {json.dumps({p: located[i].tolist() for i, p in enumerate(loc_pats)})}",
          flush=True)
    check(bool((merged_counts >= base_counts).all()),
          "appends never lower a count")

    # brute-force sample over the base text and the whole logical text
    text = np.concatenate([base] + appended)
    rng = np.random.default_rng(0)
    sample = rng.choice(N_QUERIES, size=16, replace=False)
    ok = True
    for i in sample:
        p = codec.encode_dna(patterns[i])
        want_base = len(brute_positions(np, base, p))
        want_all = len(brute_positions(np, text, p))
        ok &= base_counts[i] == want_base and merged_counts[i] == want_all
    print(f"[brute] patterns=16 match={str(bool(ok)).lower()}", flush=True)
    check(bool(ok), "counts agree with a brute-force scan of the text")
    for i, p in enumerate(loc_pats):
        want = brute_positions(np, text, codec.encode_dna(p))[:5]
        got = located[i][located[i] >= 0]
        check(np.array_equal(got, want), f"locate({p!r}) = smallest positions")

    # ---------------- each kernel against its plain version -------------
    dev = store.device
    rows = []
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=dev)

    def row(name, source, replaces, err, kernel, reps, plain_ms, n_bytes,
            n_ops, library_ms=None, **extra):
        """One kernel's JSON row: ``ms`` is the time per call of
        ``kernel`` as the host issues them, host work of the wrapper
        included; ``device_ms`` the device time of launches back to back
        (L2 warm), ``cold_ms`` of a launch after an L2 flush."""
        b, by = bound_ms(n_bytes, n_ops)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": cuda_ms(torch, kernel, reps),
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": library_ms,
                     "device_ms": cuda_ms(torch, kernel, reps,
                                          queue_ahead=True),
                     "cold_ms": cuda_ms(torch, kernel, reps, flush=flush),
                     **extra})
        check(launches[name] > 0, f"{name} launched on the main path")
        check(err == 0, f"{name} equals its plain version")

    # pack2bit over the whole base text
    codes = torch.from_numpy(base).to(dev)
    n_words = codec.packed_length(TEXT_LEN)
    lanes = codes.to(torch.int64).reshape(n_words, 16)
    got = pack2bit_cuda(codes)
    want = ref.pack2bit_ref(lanes.T)
    err = max_abs_err(torch, [codec.words_i64(got)], [codec.words_i64(want)])
    check(torch.equal(got.view(torch.int32),
                      store.text_packed.view(torch.int32)),
          "pack2bit output is the table's packed text")
    shifts = 30 - 2 * torch.arange(16, dtype=torch.int64, device=dev)
    row("pack2bit", "src/repro_torch/kernels/csrc/pack2bit.cu",
        "src/repro/kernels/pack2bit.py:30", err,
        lambda: pack2bit_cuda(codes), 20,
        cuda_ms(torch, lambda: ref.pack2bit_ref(lanes.T), 3),
        TEXT_LEN + 4 * n_words, 2 * 16 * n_words,
        library_ms=cuda_ms(torch, lambda: (lanes << shifts).sum(dim=1), 5))

    # bounded_search on the base store, first batch of the workload
    steps = Q.search_steps(store.n_pad)
    lb, ub = bounded_search_cuda(store.sa, store.text_packed, store.n_real,
                                 patt, plen, store.n_pad)
    row("bounded_search", "src/repro_torch/kernels/csrc/pattern_scan.cu",
        "src/repro/kernels/pattern_scan.py:55",
        max_abs_err(torch, [lb, ub], [plb, pub]),
        lambda: bounded_search_cuda(
            store.sa, store.text_packed, store.n_real, patt, plen,
            store.n_pad), 20,
        cuda_ms(torch, lambda: Q.search_bounds_plain(store, patt, plen), 2),
        2 * B * steps * 12 + B * W * 4 + 3 * B * 4, 2 * B * steps * W)

    # pattern_compare on the suffixes at those lower bounds
    pos = store.sa[lb.clamp(0, store.n_pad - 1).to(torch.int64)]
    win = codec.extract_window(store.text_packed, pos, W)
    got = pattern_compare_cuda(win, patt, plen, pos, n_real=store.n_real)
    want = ref.pattern_compare_ref(win.T, patt.T, plen, pos,
                                   n_real=store.n_real)
    row("pattern_compare", "src/repro_torch/kernels/csrc/pattern_scan.cu",
        "src/repro/kernels/pattern_scan.py:55",
        max_abs_err(torch, got, want),
        lambda: pattern_compare_cuda(
            win, patt, plen, pos, n_real=store.n_real), 50,
        cuda_ms(torch, lambda: ref.pattern_compare_ref(
            win.T, patt.T, plen, pos, n_real=store.n_real), 5),
        2 * B * W * 4 + 2 * B * 4 + 3 * B, B * W)

    # tier_scan over the live run + memtable: the kernel reads the stacked
    # packed text and sa; held against its plain 17-ary version, the
    # dense plain version (the TPU kernel's algorithm, over windows) and
    # the binary-search twin
    stack = table._tierset().stack
    meta = ops.tier_meta(stack)
    pt = patt.T.contiguous()
    args = (pt, plen, stack.text_packed, stack.sa, stack.pad_cnt, meta)
    got = TS.tier_scan_cuda(*args)
    traces, bin_traces = [], []
    plain = TS.tier_scan_plain(*args, trace=traces)
    binary = TS.tier_scan_plain(*args, trace=bin_traces, arity=2)
    wt = ref.tier_windows(stack, W)
    t1 = time.perf_counter()
    dense = ref.tier_scan_ref(pt, plen, wt, stack.sa, meta)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t1) * 1e3
    del wt
    twin = TS.fused_tier_scan(stack, patt, plen)
    err = max(max_abs_err(torch, got, w)
              for w in (plain, binary, dense, twin))
    T, R = (int(d) for d in stack.sa.shape)
    # bytes: the sa rows and text words that a binary search of both
    # bounds and the match runs past their padding read (tier_traffic),
    # the pattern words in use, plen, meta, two pad_cnt entries per tier
    # and the outputs; operations: ~4 per word compared.  The 17-ary
    # search's own reads are counted apart (kary_bytes).
    used_words = int(((plen.to(torch.int64) + 15) // 16).sum())
    fixed = 4 * used_words + 4 * B + 40 * T + 4 * T * B * 4
    less = got[1].to(torch.int64)
    run_hi = less + got[2]
    run_lo = less.maximum(TS.pad_prefix(stack.pad_cnt)[:, None]).minimum(
        run_hi)
    t_bytes, t_bin_rounds, t_bin_probes, t_bin_words = tier_traffic(
        torch, bin_traces, stack.sa, stack.text_packed, run_lo, run_hi)
    k_bytes, t_rounds, t_probes, t_words = tier_traffic(
        torch, traces, stack.sa, stack.text_packed, run_lo, run_hi)
    row("tier_scan", "src/repro_torch/kernels/csrc/tier_scan.cu",
        "src/repro/kernels/tier_scan.py:338", err,
        lambda: TS.tier_scan_cuda(*args), 50,
        cuda_ms(torch, lambda: TS.tier_scan_plain(*args), 2),
        t_bytes + fixed, 4 * t_bin_words, rounds=t_rounds,
        binary_rounds=t_bin_rounds, kary_bytes=k_bytes + fixed,
        dense_plain_ms=dense_ms)
    print(f"[tiers] T={T} rows={R} n_rows={stack.n_rows.tolist()} "
          f"rounds={t_rounds} max_rounds={kary.max_rounds(R)} "
          f"probes={t_probes} words={t_words} kary_bytes={k_bytes + fixed} "
          f"binary_rounds={t_bin_rounds} binary_probes={t_bin_probes} "
          f"binary_words={t_bin_words} bound_bytes={t_bytes + fixed} "
          f"run_rows={int(got[2].sum())} longest_run={int(got[2].max())} "
          f"swept_rows={int((run_hi - run_lo).sum())} "
          f"longest_sweep={int((run_hi - run_lo).max())} "
          f"dense_plain_ms={dense_ms:.4f} twin_ms="
          f"{cuda_ms(torch, lambda: TS.fused_tier_scan(stack, patt, plen), 2):.4f}",
          flush=True)

    # tablet_scan: the main path's launch over all 2**26 rows was held
    # against the plain binary search's bounds in [linear]; here the
    # kernel on all rows against its plain 17-ary version, and on a
    # contiguous slice of 2**18 rows against the dense plain version
    # (all 2**26 would take minutes)
    R = int(rows_wt.shape[1])
    full = (pt, plen, rows_wt, pos_sorted)
    got = tablet_scan_cuda(*full, n_real=store.n_real)
    trace, bin_trace = [], []
    plain = tablet_scan_plain(*full, n_real=store.n_real, trace=trace)
    binary = tablet_scan_plain(*full, n_real=store.n_real, trace=bin_trace,
                               arity=2)
    sl = slice(TEXT_LEN // 2, TEXT_LEN // 2 + SLICE_ROWS)
    part = (pt, plen, rows_wt[:, sl], pos_sorted[sl])
    got_sl = tablet_scan_cuda(*part, n_real=store.n_real)
    t1 = time.perf_counter()
    dense = ref.tablet_scan_ref(*part, n_real=store.n_real)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t1) * 1e3
    fixed = 4 * used_words + 4 * B + 3 * B * 4
    b_bytes, b_bin_rounds, b_bin_probes, b_bin_words = tablet_traffic(
        torch, bin_trace)
    k_bytes, b_rounds, b_probes, b_words = tablet_traffic(torch, trace)
    row("tablet_scan", "src/repro_torch/kernels/csrc/tablet_scan.cu",
        "src/repro/kernels/tablet_scan.py:82",
        max(lin_err, max_abs_err(torch, got, plain),
            max_abs_err(torch, got, binary),
            max_abs_err(torch, got_sl, dense)),
        lambda: tablet_scan_cuda(*full, n_real=store.n_real), 50,
        cuda_ms(torch, lambda: tablet_scan_plain(*full, n_real=store.n_real),
                2),
        b_bytes + fixed, 4 * b_bin_words, rounds=b_rounds,
        binary_rounds=b_bin_rounds, kary_bytes=k_bytes + fixed,
        dense_plain_ms=dense_ms, dense_plain_rows=SLICE_ROWS)
    slice_ms = cuda_ms(torch, lambda: tablet_scan_cuda(
        *part, n_real=store.n_real), 50, queue_ahead=True)
    print(f"[tablet] rows={R} rounds={b_rounds} "
          f"max_rounds={kary.max_rounds(R)} probes={b_probes} "
          f"words={b_words} kary_bytes={k_bytes + fixed} "
          f"binary_rounds={b_bin_rounds} binary_probes={b_bin_probes} "
          f"binary_words={b_bin_words} bound_bytes={b_bytes + fixed} "
          f"slice_rows={SLICE_ROWS} "
          f"kernel_slice_ms={slice_ms:.4f} dense_plain_slice_ms="
          f"{dense_ms:.4f}", flush=True)

    # fm_scan on the frozen table's index, first batch of the workload
    fa = frozen.fm.arrays
    fm_steps = W * 16
    syms = FM.syms_from_packed(patt, plen, fm_steps)
    meta = FM.fm_meta(fa)
    got = FM.fm_scan_cuda(syms, fa.bwt, fa.occ, meta)
    want = FM.search_syms(fa, syms)
    # bytes: 4 per rank (Occ entry) + 4 per BWT word read, the plan, the
    # outputs and meta; operations: ~9 per word (xor, not, and, shift,
    # and, mask, popcount, add)
    ranks, words, tlo, thi = fm_traffic(torch, FM, fa, syms)
    check(torch.equal(tlo, got[0]) and torch.equal(thi, got[1]),
          "the fm_scan traffic count followed the kernel's search")
    row("fm_scan", "src/repro_torch/kernels/csrc/fm_scan.cu",
        "src/repro/kernels/fm_scan.py:260", max_abs_err(torch, got, want),
        lambda: FM.fm_scan_cuda(syms, fa.bwt, fa.occ, meta), 50,
        cuda_ms(torch, lambda: FM.search_syms(fa, syms), 1),
        4 * ranks + 4 * words + fm_steps * B * 4 + 2 * B * 4 + 32,
        9 * words)
    lo, hi = got
    print(f"[fm] steps={fm_steps} active_steps={int(plen.sum())} "
          f"ranks={ranks} words={words} found={int((hi > lo).sum())} "
          f"bwt_words={fa.bwt.shape[0]} occ_rows={fa.occ.shape[0]}",
          flush=True)

    profile_batches(torch, table, patterns, "merged")
    profile_batches(torch, frozen, patterns, "frozen-merged")

    print("[kernels] " + " ".join(
        f"{r['name']}:launches={r['launches']},match="
        f"{str(r['max_abs_err'] == 0).lower()}" for r in rows), flush=True)
    print(f"[memory] peak_bytes={torch.cuda.max_memory_allocated()}",
          flush=True)
    print(smi, flush=True)          # card name and power limit, as is
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
