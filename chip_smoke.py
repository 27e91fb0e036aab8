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
9. ``[compact]`` major compaction of the live table (the merge's
                 insertion search is a ``bounded_search`` launch, the
                 re-attach packs the text with pack2bit): the merged SA
                 must equal a from-scratch build on every row, and the
                 workload on the compacted table (``[compacted]``) must
                 equal ``[merged]``;
10. ``[frozen-compact]`` the same for the frozen table: its SA rebuilt
                 from the index, merged, frozen again; it must stay
                 frozen and ``[frozen-compacted]`` must equal ``[merged]``;
11. ``[persist]`` ``SuffixTable.create`` under a directory in
                 ``build/``, the three appends, ``flush``, then ``open``
                 in a fresh object (``[reopened]`` must equal
                 ``[merged]``); seconds and bytes on disk;
12. ``[wal]``    one more append to the reopened table, no flush, and
                 ``open`` again: the commit log's replay must give the
                 appending table's answers (``[replayed]``);
13. ``[long]``   patterns past 16 words: a third 2**26-base table at
                 ``max_query_len=1024`` (W = 64) serves 512 patterns of
                 1-1000 bases (half cut from the text) base only, then
                 after an append, ``minor_compact`` and an append (the tier
                 scan kernel); a frozen table over a 2**22-base slice
                 serves its own 512 (``fm_scan``); counts against a host
                 brute force for 16 patterns of each; then each search
                 kernel against its plain versions at W = 17, 32 and 64
                 (``[long:W=..]``) and its W = 64 times (``[long:kernel]``);
14. ``[client]`` the live table attached to ``Database.in_memory()``:
                 ``benchmarks/client_bench.py``'s three arms through the
                 port (``per_call``: 128 callers, a batch of 1 each;
                 ``coalesced``: ``query_many``; ``scheduler``: 128 threads
                 calling ``submit``), 8 waves of the paper workload with
                 ``top_k=5``, the string cache cleared before every wave;
                 the three arms' answers must be bit-identical;
15. ``[serve]``  ``python -m repro_torch.launch.serve`` in the process at
                 2**26 bases, 10,000 queries in batches of 512, under a
                 root in ``build/`` (removed at the end); an unflushed
                 append; the launcher again on the root (the ``[open ]``
                 path: the commit log must replay the append); then
                 ``--dump-stats``.  ``[locate]`` is held against a host
                 brute force, ``[stream]``'s page total against the
                 one-shot count, ``[write ]``'s rise against the planted
                 occurrences, and the feed must hold the reference's rows;
16. ``[kernels]`` every kernel's launches on each of the six paths
                 (serving 1-8, compaction 9-10, persistence 11-12, long 13,
                 client 14, serve 15; the counts are set to 0 before each
                 and read after it) and
                 its result held against its plain PyTorch version(s)
                 on inputs taken from that run, and timed, between
                 phases 12 and 13; a sample of counts is
                 checked against a numpy brute-force scan of the text.
                 The three searches (``bounded_search``, ``tablet_scan``,
                 ``tier_scan``) also print their rounds and probes
                 (``[search]``, ``[tablet]``, ``[tiers]``), ``[fm]`` the
                 backward search's ranks and words, and ``[ptxas]``
                 lines give every kernel's registers, shared memory and
                 spills.

``pattern_compare`` runs on the serving path as the epilogue of the
``bounded_search`` launch (``pattern_scan.bounded_match_cuda``): its
standalone kernel must show no launch there, and ``found == (count >
0)`` must hold on every query of every live phase; the epilogue's four
outputs are held against their plain version on a whole batch.

It prints one JSON line of per-kernel numbers (``ms``: time per call as
the host issues them; ``device_ms``: device time of launches queued back
to back, the L2 warm; ``cold_ms``: device time of a launch that follows
a flush of the L2; ``ms_after_phases``: ``ms`` again after phase 15)
and, last, the device line.  Any build, launch or mismatch
failure exits non-zero without it.
It imports neither jax nor the JAX package.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
LONG_QUERY_LEN = 1024       # [long]: W = 64 pattern words
LONG_MAX_PATTERN = 1000
LONG_WIDTHS = (17, 32, 64)
FROZEN_SLICE = 2**22        # [long]: bases of the frozen table
LONG_TABLET_ROWS = 2**20    # [long]: sorted rows tablet_scan is held on
CALLERS = 128               # [client]: callers per wave
CLIENT_WAVES = 8

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


def text_bytes(torch, pos, most, text_packed):
    """4 B per distinct packed text word that early-exit compares read
    of the suffixes at ``pos``, ``most[i]`` window words of the suffix at
    ``pos[i]`` (words ``pos // 16 ..``, one more when ``pos % 16``
    shifts the window across a word)."""
    pos = pos.to(torch.int64)
    n_words = int(text_packed.shape[0])
    span = most + (((pos % 16) != 0) & (most > 0)).to(torch.int64)
    mark = torch.zeros(n_words, dtype=torch.bool, device=pos.device)
    for j in range(int(span.max()) if span.numel() else 0):
        idx = (pos // 16 + j)[span > j]
        mark[idx[idx < n_words]] = True
    return 4 * int(mark.sum())


def search_traffic(torch, trace, sa, text_packed):
    """Bytes a traced search of the sorted rows ``sa`` of one store
    reads (each read once): 4 per distinct probed row (its ``sa``
    entry) + the text words its compares read (:func:`text_bytes`);
    plus the rounds, the probes and the words compared in all.  From a
    binary search's trace this is what the function needs."""
    uniq, most, rounds, probes, words = probed_rows(torch, trace)
    return (4 * int(uniq.numel()) + text_bytes(torch, sa[uniq], most,
                                               text_packed),
            rounds, probes, words)


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
        n_bytes += 4 * int(touched.sum()) + text_bytes(
            torch, sa[t, uniq], most, text_packed[t])
    return n_bytes, rounds, probes, words


def used_words(torch, plen) -> int:
    """Pattern words the masks keep, summed over the batch."""
    return int(((plen.to(torch.int64) + 15) // 16).sum())


def match_traffic(torch, kary, codec, store, patt, plen, lb, bin_trace):
    """What ``bounded_match_cuda`` needs on ``store`` (each byte once):
    the binary search's reads (``bin_trace``, :func:`search_traffic`)
    plus the epilogue's compare at ``lb`` (its sa row and the text words
    it reads, into the same dedup), the pattern words in use, plen and 13
    B of outputs a query; ~4 operations per word compared.  Also the
    bounds alone (8 B of outputs a query), and the epilogue's words and
    positions."""
    B, W = (int(d) for d in patt.shape)
    s_bytes, rounds, probes, words = search_traffic(
        torch, bin_trace, store.sa, store.text_packed)
    lbc = lb.clamp(max=store.n_pad - 1).to(torch.int64)
    pos_lb = store.sa[lbc]
    _, _, w_lb = kary.compare(
        codec.extract_window(store.text_packed, pos_lb, W)[None, :, None],
        pos_lb[None, :, None], patt, plen, store.n_real)
    w_lb = w_lb.reshape(-1)
    e_bytes, _, _, _ = search_traffic(
        torch, bin_trace + [(lbc, w_lb)], store.sa, store.text_packed)
    fixed = 4 * used_words(torch, plen) + 4 * B
    return {"bytes": e_bytes + fixed + 13 * B,
            "ops": 4 * (words + int(w_lb.sum())),
            "bounds_bytes": s_bytes + fixed + 8 * B, "bounds_ops": 4 * words,
            "rounds": rounds, "probes": probes, "words": words,
            "w_lb": w_lb, "pos_lb": pos_lb}


def tier_runs(torch, TS, stack, got):
    """The match runs past their padding that the tier kernel sweeps,
    (run_lo, run_hi) (T, B), from its outputs ``got``."""
    less = got[1].to(torch.int64)
    run_hi = less + got[2]
    run_lo = less.maximum(TS.pad_prefix(stack.pad_cnt)[:, None]).minimum(
        run_hi)
    return run_lo, run_hi


def tier_fixed(torch, stack, plen) -> int:
    """The tier scan's bytes besides the searches and sweeps: the
    pattern words in use, plen, meta, two pad_cnt entries per tier and
    16 B of outputs per (tier, query)."""
    T, B = int(stack.sa.shape[0]), int(plen.shape[0])
    return 4 * used_words(torch, plen) + 4 * B + 40 * T + 16 * T * B


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


def long_patterns(np, codec, Q, text, n: int, max_len: int, seed: int):
    """``n`` patterns of 1..``max_len`` bases: the even ones cut from
    ``text`` (so they match), the odd ones random."""
    rng = np.random.default_rng(seed)
    rand = Q.random_patterns(n, 1, max_len, seed=seed)
    out = []
    for i in range(n):
        if i % 2:
            out.append(rand[i])
            continue
        L = int(rng.integers(1, max_len + 1))
        s = int(rng.integers(0, len(text) - L))
        out.append(codec.decode_dna(text[s:s + L]))
    return out


def run_cli(main, argv) -> str:
    """Run ``main(argv)`` in this process; return what it printed, and
    print it too."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    return out


def cli_line(out: str, prefix: str) -> str:
    """The first line of ``out`` starting with ``prefix`` ('' if none)."""
    return next((ln for ln in out.splitlines() if ln.startswith(prefix)),
                "")


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
    from repro_torch.kernels.pattern_scan import (bounded_match_cuda,
                                                  bounded_match_plain,
                                                  bounded_search_cuda,
                                                  bounded_search_plain,
                                                  pattern_compare_cuda)
    from repro_torch.core.suffix_array import build_suffix_array

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

    # every base search of a live table is one query.query call (the
    # planner's and ops.fused_single's): keep its results, to check
    # found == (count > 0) on every query after each phase
    live_results = []
    search = Q.query

    def recording_query(store, patt, plen):
        res = search(store, patt, plen)
        live_results.append(res)
        return res

    Q.query = recording_query

    def serve(tag: str, table) -> tuple[np.ndarray, np.ndarray]:
        """The workload through ``table.scan``: (counts, first_pos)."""
        lat, counts, firsts = [], [], []
        live_results.clear()
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
        if not table.is_frozen:
            n_q = sum(int(r.count.shape[0]) for r in live_results)
            ok = all(torch.equal(r.found, r.count > 0) for r in live_results)
            print(f"[found:{tag}] searches={len(live_results)} "
                  f"queries={n_q} found_eq_count_gt_0="
                  f"{str(bool(ok)).lower()}", flush=True)
            # (queries the table's string cache answered never reach it)
            check(ok and n_q > 0,
                  f"{tag}: found == (count > 0) on every searched query")
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
    print(f"[serve-launches] " + " ".join(
        f"{k}={v}" for k, v in launches.items()), flush=True)
    check(launches["pattern_compare"] == 0,
          "the standalone pattern_compare kernel is not launched on the "
          "serving path (its compare is bounded_search's epilogue)")
    text = np.concatenate([base] + appended)
    # outside the counted paths: profiles of the merged phases, and the
    # tier stack and FM index the kernel rows below are measured on
    profile_batches(torch, table, patterns, "merged")
    profile_batches(torch, frozen, patterns, "frozen-merged")
    tier_stack = table._tierset().stack
    fm_arrays = frozen.fm.arrays

    # ---------------- compaction path: counted apart --------------------
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    version = table.compact()
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merge_searches = _build.LAUNCHES["bounded_search"]
    t0 = time.perf_counter()
    rebuilt = build_suffix_array(torch.from_numpy(text).to(table.device))
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    st = table.store
    same_sa = torch.equal(st.sa[st.pad_count:], rebuilt)
    del rebuilt
    print(f"[compact] n={len(text)} delta={len(text) - TEXT_LEN} "
          f"dirty={len(text) - TEXT_LEN + MAX_QUERY_LEN - 1} "
          f"version={version} merge_seconds={merge_s:.4f} "
          f"rebuild_seconds={rebuild_s:.4f} "
          f"merge_search_launches={merge_searches} "
          f"sa_equals_rebuild={str(same_sa).lower()}", flush=True)
    check(same_sa, "the compacted SA equals a from-scratch build on every "
          "row")
    check(version == 1 and not table.runs and table.memtable.size == 0,
          "compaction folded the run and the memtable into version 1")
    check(merge_searches >= 1, "the merge's insertion search ran as a "
          "bounded_search launch")
    cc, cf = serve("compacted", table)
    check(np.array_equal(cc, merged_counts)
          and np.array_equal(cf, merged_first),
          "compacted counts and first_pos equal the merged phase's")
    check(np.array_equal(table.locate(loc_pats, top_k=5), located),
          "compacted locate(top_k=5) equals the merged phase's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fversion = frozen.compact()
    torch.cuda.synchronize()
    fmerge_s = time.perf_counter() - t0
    print(f"[frozen-compact] version={fversion} seconds={fmerge_s:.4f} "
          f"is_frozen={str(frozen.is_frozen).lower()} "
          f"fm_n={frozen.fm.n if frozen.fm is not None else -1}",
          flush=True)
    check(frozen.is_frozen and fversion == 1 and frozen.fm.n == len(text),
          "the frozen table stays frozen across compaction")
    fcc, fcf = serve("frozen-compacted", frozen)
    check(np.array_equal(fcc, merged_counts)
          and np.array_equal(fcf, merged_first),
          "frozen-compacted counts and first_pos equal the merged phase's")
    torch.cuda.synchronize()
    compact_launches = dict(_build.LAUNCHES)
    print(f"[compact-launches] " + " ".join(
        f"{k}={v}" for k, v in compact_launches.items()), flush=True)
    for k in ("bounded_search", "pack2bit", "fm_scan"):
        check(compact_launches[k] > 0, f"{k} launched on the compaction "
              f"path")

    # ---------------- persistence path: counted apart -------------------
    _build.reset_launches()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_tables_",
                            dir=os.path.join(ROOT, "build"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ptable = SuffixTable.create("chip", base, root=root, is_dna=True,
                                    max_query_len=MAX_QUERY_LEN,
                                    memtable_limit=MEMTABLE_LIMIT)
        torch.cuda.synchronize()
        create_s = time.perf_counter() - t0
        for chunk in appended:
            ptable.append(chunk)
        t0 = time.perf_counter()
        ptable.flush()
        flush_s = time.perf_counter() - t0
        del ptable
        disk = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        t0 = time.perf_counter()
        opened = SuffixTable.open("chip", root=root)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        st = opened.stats()["tiers"]
        print(f"[persist] create_seconds={create_s:.4f} "
              f"flush_seconds={flush_s:.4f} open_seconds={open_s:.4f} "
              f"bytes_on_disk={disk} runs={st['run_count']} "
              f"memtable_rows={st['memtable_rows']}", flush=True)
        check(st["run_count"] == 1 and st["memtable_rows"] == APPEND_LEN,
              "open restored the sealed run and the memtable")
        oc, of = serve("reopened", opened)
        check(np.array_equal(oc, merged_counts)
              and np.array_equal(of, merged_first),
              "reopened counts and first_pos equal the merged phase's")
        extra = codec.random_dna(APPEND_LEN, seed=4)
        opened.append(extra)            # logged, acked, not flushed
        ac, af = serve("appended", opened)
        del opened
        t0 = time.perf_counter()
        replayed = SuffixTable.open("chip", root=root)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        rec = replayed.stats()["wal"]["recovery"] or {}
        print(f"[wal] open_seconds={replay_s:.4f} "
              f"records_replayed={rec.get('records_replayed')} "
              f"reason={rec.get('reason')} "
              f"memtable_rows={replayed.memtable.size}", flush=True)
        check(rec.get("records_replayed") == 1
              and replayed.memtable.size == 2 * APPEND_LEN,
              "the commit log replayed the unflushed append")
        rc, rf = serve("replayed", replayed)
        check(np.array_equal(rc, ac) and np.array_equal(rf, af),
              "replayed counts and first_pos equal the appending table's")
        del replayed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    persist_launches = dict(_build.LAUNCHES)
    print(f"[persist-launches] " + " ".join(
        f"{k}={v}" for k, v in persist_launches.items()), flush=True)
    for k in ("pack2bit", "bounded_search", "tier_scan"):
        check(persist_launches[k] > 0, f"{k} launched on the persistence "
              f"path")

    # ---------------- each kernel against its plain version -------------
    # at W = 8, timed before the [long], [client] and [serve] phases add
    # their tables, results and threads to the process; each row gains
    # those paths' launches and its [long] numbers after the last phase
    dev = store.device
    rows, timed = [], []
    flush = torch.empty(FLUSH_WORDS, dtype=torch.int32, device=dev)

    def times(kernel, reps) -> dict:
        """``ms``: time per call of ``kernel`` as the host issues them,
        host work of the wrapper included; ``device_ms``: device time of
        launches back to back (L2 warm); ``cold_ms``: of a launch after
        an L2 flush."""
        return {"ms": cuda_ms(torch, kernel, reps),
                "device_ms": cuda_ms(torch, kernel, reps, queue_ahead=True),
                "cold_ms": cuda_ms(torch, kernel, reps, flush=flush)}

    def row(name, source, replaces, err, kernel, reps, plain_ms, n_bytes,
            n_ops, library_ms=None, **extra):
        """One kernel's JSON row, its times as :func:`times`."""
        b, by = bound_ms(n_bytes, n_ops)
        counted = "pattern_compare_fused" if name == "pattern_compare" \
            else name
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[counted],
                     "max_abs_err": err, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by,
                     "library_ms": library_ms, **times(kernel, reps),
                     **extra})
        timed.append((counted, kernel, reps))
        check(launches[counted] > 0, f"{name} launched on the main path")
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

    # bounded_search on the base store, first batch of the workload, as
    # the serving path launches it: with the compare epilogue
    # (bounded_match_cuda), held against its plain version on all 512
    # queries; its bounds alone (bounded_search_cuda, the compaction
    # merge's launch) against the plain binary search ([linear]'s plb,
    # pub) and the plain 17-ary version.  Bytes: what the binary search
    # reads (traced with arity=2, each sa row and text word once) plus
    # the epilogue's compare at lb (its sa row and the text words it
    # reads, into the same dedup), the pattern words in use, plen and
    # the outputs (13 B a query; 8 for the bounds alone); operations:
    # ~4 per word compared.
    n_used = used_words(torch, plen)
    sargs = (store.sa, store.text_packed, store.n_real, patt, plen,
             store.n_pad)
    margs = sargs + (store.pad_count,)
    lb, ub = bounded_search_cuda(*sargs)
    epi = bounded_match_cuda(*margs)
    epi_plain = bounded_match_plain(store, patt, plen)
    epi_err = max_abs_err(torch, epi, epi_plain)
    epi_found_ok = torch.equal(epi[0], epi[1] > 0)
    check(epi_err == 0 and epi_found_ok,
          "the search epilogue's four outputs equal their plain version on "
          "all queries, and found == (count > 0)")
    trace, bin_trace = [], []
    kary_bounds = bounded_search_plain(*sargs, trace=trace)
    bin_bounds = bounded_search_plain(*sargs, trace=bin_trace, arity=2)
    m = match_traffic(torch, kary, codec, store, patt, plen, lb, bin_trace)
    w_lb, pos_lb = m["w_lb"], m["pos_lb"]
    _, s_rounds, s_probes, s_words = search_traffic(
        torch, trace, store.sa, store.text_packed)
    bounds_only = (lambda: bounded_search_cuda(*sargs))
    row("bounded_search", "src/repro_torch/kernels/csrc/pattern_scan.cu",
        "src/repro/kernels/pattern_scan.py:55",
        max(max_abs_err(torch, [lb, ub], [plb, pub]),
            max_abs_err(torch, [lb, ub], kary_bounds),
            max_abs_err(torch, bin_bounds, [plb, pub]), epi_err),
        lambda: bounded_match_cuda(*margs), 20,
        cuda_ms(torch, lambda: bounded_match_plain(store, patt, plen), 2),
        m["bytes"], m["ops"], rounds=s_rounds, binary_rounds=m["rounds"],
        kary_plain_ms=cuda_ms(torch, lambda: bounded_search_plain(*sargs),
                              2),
        bounds_only_ms=cuda_ms(torch, bounds_only, 20),
        bounds_only_device_ms=cuda_ms(torch, bounds_only, 20,
                                      queue_ahead=True),
        bounds_only_cold_ms=cuda_ms(torch, bounds_only, 20, flush=flush),
        bounds_only_bound_ms=bound_ms(m["bounds_bytes"],
                                      m["bounds_ops"])[0])
    check(s_rounds <= kary.max_rounds(store.n_pad),
          "bounded_search ends within floor(log17 n_pad) + 1 rounds")
    print(f"[search] rows={store.n_pad} rounds={s_rounds} "
          f"max_rounds={kary.max_rounds(store.n_pad)} probes={s_probes} "
          f"words={s_words} binary_rounds={m['rounds']} "
          f"binary_probes={m['probes']} binary_words={m['words']} "
          f"bound_bytes={m['bytes']} "
          f"bounds_only_bound_bytes={m['bounds_bytes']} "
          f"epilogue_words={int(w_lb.sum())}", flush=True)
    print(f"[epilogue] queries={B} max_abs_err={epi_err} "
          f"found={int(epi[0].sum())} found_eq_count_gt_0="
          f"{str(epi_found_ok).lower()} pattern_compare_standalone_launches="
          f"{launches['pattern_compare']} fused_launches="
          f"{launches['pattern_compare_fused']} bounded_search_launches "
          f"serve={launches['bounded_search']} "
          f"compact={compact_launches['bounded_search']} "
          f"persist={persist_launches['bounded_search']}", flush=True)

    # pattern_compare: the standalone entry point (the TPU kernel's
    # contract over explicit windows) on the suffixes at those lower
    # bounds.  On the serving path the compare runs as the epilogue
    # above: its launches are the row's, its outputs are in max_abs_err,
    # and epilogue_bound_ms counts its own bytes (the sa row at lb, the
    # text words its compare reads, the pattern words, 13 B of outputs)
    lb_pos = store.sa[lb.clamp(0, store.n_pad - 1).to(torch.int64)]
    win = codec.extract_window(store.text_packed, lb_pos, W)
    got = pattern_compare_cuda(win, patt, plen, lb_pos, n_real=store.n_real)
    want = ref.pattern_compare_ref(win.T, patt.T, plen, lb_pos,
                                   n_real=store.n_real)
    row("pattern_compare", "src/repro_torch/kernels/csrc/pattern_scan.cu",
        "src/repro/kernels/pattern_scan.py:55",
        max(max_abs_err(torch, got, want), epi_err),
        lambda: pattern_compare_cuda(
            win, patt, plen, lb_pos, n_real=store.n_real), 50,
        cuda_ms(torch, lambda: ref.pattern_compare_ref(
            win.T, patt.T, plen, lb_pos, n_real=store.n_real), 5),
        2 * B * W * 4 + 2 * B * 4 + 3 * B, B * W,
        standalone_launches=launches["pattern_compare"],
        fused_into="bounded_search",
        epilogue_bound_ms=bound_ms(
            4 * B + text_bytes(torch, pos_lb, w_lb, store.text_packed)
            + 4 * n_used + 13 * B, 4 * int(w_lb.sum()))[0])

    # tier_scan over the live run + memtable: the kernel reads the stacked
    # packed text and sa; held against its plain 17-ary version, the
    # dense plain version (the TPU kernel's algorithm, over windows) and
    # the binary-search twin
    stack = tier_stack
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
    fixed = tier_fixed(torch, stack, plen)
    run_lo, run_hi = tier_runs(torch, TS, stack, got)
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
    fixed = 4 * n_used + 4 * B + 3 * B * 4
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

    # fm_scan on the frozen table's index, first batch of the workload:
    # the kernel reads the packed patterns; its plain version
    # (backward_search) steps search_syms over the (16 W, B) plan
    fa = fm_arrays
    fm_steps = W * 16
    syms = FM.syms_from_packed(patt, plen, fm_steps)
    got = FM.fm_scan_cuda(patt, plen, fa.bwt, fa.occ, fa.meta)
    want = FM.search_syms(fa, syms)
    # bytes: 4 per rank (Occ entry) + 4 per BWT word read, the packed
    # patterns, plen, the outputs and meta; operations: ~9 per word (xor,
    # not, and, shift, and, mask, popcount, add)
    ranks, words, tlo, thi = fm_traffic(torch, FM, fa, syms)
    check(torch.equal(tlo, got[0]) and torch.equal(thi, got[1]),
          "the fm_scan traffic count followed the kernel's search")
    row("fm_scan", "src/repro_torch/kernels/csrc/fm_scan.cu",
        "src/repro/kernels/fm_scan.py:260", max_abs_err(torch, got, want),
        lambda: FM.fm_scan_cuda(patt, plen, fa.bwt, fa.occ, fa.meta), 50,
        cuda_ms(torch, lambda: FM.backward_search(fa, patt, plen), 1),
        4 * ranks + 4 * words + B * W * 4 + B * 4 + 2 * B * 4 + 32,
        9 * words)
    lo, hi = got
    print(f"[fm] steps={fm_steps} active_steps={int(plen.sum())} "
          f"ranks={ranks} words={words} found={int((hi > lo).sum())} "
          f"bwt_words={fa.bwt.shape[0]} occ_rows={fa.occ.shape[0]}",
          flush=True)

    # ---------------- [long] path: patterns past 16 words ---------------
    _build.reset_launches()

    def serve_long(tag, t, pats):
        """One batch of ``pats`` through ``t.scan``: (counts, first_pos)."""
        live_results.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = t.scan(pats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ok = all(torch.equal(r.found, r.count > 0) for r in live_results)
        print(f"[{tag}] queries={len(pats)} "
              f"max_len={max(map(len, pats))} "
              f"words={codec.packed_length(t.max_query_len)} "
              f"seconds={dt:.4f} found={int((out.count > 0).sum())} "
              f"found_eq_count_gt_0={str(bool(ok)).lower()}", flush=True)
        check(ok and (t.is_frozen or len(live_results) > 0),
              f"{tag}: found == (count > 0) on every searched query")
        return out.count, out.first_pos

    long_pats = long_patterns(np, codec, Q, base, BATCH, LONG_MAX_PATTERN, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ltable = SuffixTable.from_codes(base, is_dna=True,
                                    max_query_len=LONG_QUERY_LEN,
                                    memtable_limit=MEMTABLE_LIMIT)
    torch.cuda.synchronize()
    print(f"[long] n={TEXT_LEN} max_query_len={LONG_QUERY_LEN} "
          f"build_seconds={time.perf_counter() - t0:.4f}", flush=True)
    lc, lf = serve_long("long", ltable, long_pats)
    ltable.append(appended[0])
    ltable.minor_compact()
    ltable.append(appended[1])
    check(len(ltable.runs) == 1 and ltable.memtable.size == APPEND_LEN,
          "[long]: one sealed run and one live memtable")
    lmc, lmf = serve_long("long-merged", ltable, long_pats)
    long_text = np.concatenate([base, appended[0], appended[1]])
    fslice = base[:FROZEN_SLICE]
    ftable = SuffixTable.from_codes(fslice, is_dna=True,
                                    max_query_len=LONG_QUERY_LEN,
                                    fm_threshold=FROZEN_SLICE)
    check(ftable.is_frozen, "[long]: the slice's table is frozen")
    fpats = long_patterns(np, codec, Q, fslice, BATCH, LONG_MAX_PATTERN, 6)
    flc, flf = serve_long("long-frozen", ftable, fpats)
    torch.cuda.synchronize()
    long_launches = dict(_build.LAUNCHES)
    print(f"[long-launches] " + " ".join(
        f"{k}={v}" for k, v in long_launches.items()), flush=True)
    for k in ("bounded_search", "tier_scan", "fm_scan"):
        check(long_launches[k] > 0, f"{k} launched on the [long] path")
    ok = True
    for i in np.random.default_rng(1).choice(BATCH, size=16, replace=False):
        for lp, ltext, (cnt, fst) in ((long_pats, base, (lc, lf)),
                                      (long_pats, long_text, (lmc, lmf)),
                                      (fpats, fslice, (flc, flf))):
            pos = brute_positions(np, ltext, codec.encode_dna(lp[i]))
            ok &= (cnt[i] == len(pos)
                   and fst[i] == (pos[0] if len(pos) else -1))
    print(f"[long-brute] patterns=16 tables=3 match={str(bool(ok)).lower()}",
          flush=True)
    check(bool(ok), "[long] counts and first_pos agree with a brute-force "
          "scan of the text")

    # ---------------- [client] path: the client frontend -----------------
    _build.reset_launches()
    from repro_torch.api import Database, Query
    cdb = Database.in_memory(coalesce_window_ms=2.0)
    cdb.attach("live", table)
    waves = [[Query.scan("live", [p], top_k=5)
              for p in Q.random_patterns(CALLERS, 1, 100, seed=100 + w)]
             for w in range(CLIENT_WAVES)]
    cdb.query(waves[0][0])                  # first use of every path
    cdb.query_many(waves[0])
    arms: dict = {}

    def per_call(wave):
        lat, got = [], []
        for q in wave:
            t = time.perf_counter()
            got.append(cdb.query(q))
            lat.append((time.perf_counter() - t) * 1e3)
        return got, lat

    def coalesced(wave):
        t = time.perf_counter()
        got = cdb.query_many(wave)
        return got, [(time.perf_counter() - t) * 1e3] * len(wave)

    def scheduler(wave):
        got, lat = [None] * len(wave), [0.0] * len(wave)
        gate = threading.Barrier(len(wave))

        def caller(i):
            gate.wait()
            t = time.perf_counter()
            got[i] = cdb.submit(wave[i]).result(timeout=120.0)
            lat[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(len(wave))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(180.0)
        return got, lat

    for name, fn in (("per_call", per_call), ("coalesced", coalesced),
                     ("scheduler", scheduler)):
        s0 = cdb.scheduler.stats_snapshot()
        got_all, lat_all, wall = [], [], 0.0
        for wave in waves:
            table.clear_cache()
            t = time.perf_counter()
            got, lat = fn(wave)
            wall += time.perf_counter() - t
            got_all += got
            lat_all += lat
        s1 = cdb.scheduler.stats_snapshot()
        arms[name] = got_all
        lat_all = np.asarray(lat_all)
        if name == "per_call":
            # a call's top-5 enumerates its whole SA slice on the host:
            # the time of the patterns of <= 3 bases, apart
            short = np.asarray([len(q.patterns[0]) <= 3
                                for wave in waves for q in wave])
            print(f"[client] arm=per_call short_patterns="
                  f"{int(short.sum())} short_ms={lat_all[short].sum():.4f} "
                  f"other_ms={lat_all[~short].sum():.4f}", flush=True)
        print(f"[client] arm={name} callers={CALLERS} waves={CLIENT_WAVES} "
              f"queries={len(got_all)} "
              f"queries_per_s={len(got_all) / wall:.1f} "
              f"p50_ms={np.percentile(lat_all, 50):.4f} "
              f"p95_ms={np.percentile(lat_all, 95):.4f} "
              f"batches={s1['batches'] - s0['batches']} "
              f"coalesced_queries="
              f"{s1['coalesced_queries'] - s0['coalesced_queries']} "
              f"fast_path_queries="
              f"{s1['fast_path_queries'] - s0['fast_path_queries']}",
              flush=True)
        check(all(r is not None and r.ok for r in got_all),
              f"[client] {name}: every query answered")

    def answer(r):
        return (r.count.tolist(), r.first_pos.tolist(),
                r.positions.tolist())

    same = all(answer(a) == answer(b) == answer(c) for a, b, c in
               zip(arms["per_call"], arms["coalesced"], arms["scheduler"]))
    print(f"[client] identical={str(same).lower()} "
          f"found={sum(int(r.count[0] > 0) for r in arms['per_call'])}",
          flush=True)
    check(same, "[client] counts, first_pos and top-5 positions are "
          "bit-identical across per_call, coalesced and scheduler")
    cdb.close()
    torch.cuda.synchronize()
    client_launches = dict(_build.LAUNCHES)
    print(f"[client-launches] " + " ".join(
        f"{k}={v}" for k, v in client_launches.items()), flush=True)
    check(client_launches["bounded_search"] > 0,
          "bounded_search launched on the [client] path")

    # ---------------- [serve] path: the serving launcher -----------------
    _build.reset_launches()
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving.metrics import aggregate_metrics, read_lines
    sroot = os.path.join(ROOT, "build", "chip_serve")
    shutil.rmtree(sroot, ignore_errors=True)
    cli = ["--text-len", str(TEXT_LEN), "--queries", str(N_QUERIES),
           "--batch", str(BATCH), "--root", sroot, "--metrics-interval",
           "0.5"]
    planted = codec.encode_dna("GATTACA" * 3)
    demo = np.concatenate([planted, codec.random_dna(993, seed=1)])
    extra = codec.random_dna(4096, seed=9)
    stexts = [base, np.concatenate([base, demo, extra])]
    try:
        outs, walls = [], []
        for k in range(2):
            if k == 1:        # an acked append that only the log holds
                t = SuffixTable.open("dna_serve", root=sroot)
                t.append(extra)
                t.close()
                del t
            t0 = time.perf_counter()
            outs.append(run_cli(serve_cli.main, cli))
            walls.append(time.perf_counter() - t0)
        varz = run_cli(serve_cli.main, ["--root", sroot, "--table",
                                        "dna_serve", "--dump-stats"])
        feed = read_lines(os.path.join(sroot, "dna_serve", "metrics.jsonl"))
        agg = aggregate_metrics(os.path.join(sroot, "dna_serve",
                                             "metrics.jsonl"))
    finally:
        shutil.rmtree(sroot, ignore_errors=True)
    first, second = outs
    check("[build]" in first and "[open ]" in second,
          "[serve] the second run opened the first run's table")
    want_len = TEXT_LEN + len(demo) + len(extra)
    check(f"[wal  ] recovered: replayed=1 skipped=0 torn_bytes=0"
          in second and f", {want_len} bases" in cli_line(second, "[open ] v"),
          "[serve] the reopen replayed the unflushed append: nothing lost")
    ok = True
    for out, stext in zip(outs, stexts):
        for ln in out.splitlines():
            m = re.match(r"\[locate\] '(\w+)': count=(\d+) first_5=(.*)",
                         ln)
            if m:
                pos = brute_positions(np, stext, codec.encode_dna(m[1]))
                ok &= (int(m[2]) == len(pos)
                       and json.loads(m[3]) == pos[:5].tolist())
        ln = cli_line(out, "[stream]")
        ok &= bool(ln) and int(ln.split(":")[1].split()[0]) == int(
            ln.split("one-shot count")[1].strip(" )"))
        m = re.search(r"count\(GATTACAGAT\.\.\.\) (\d+) -> (\d+)",
                      cli_line(out, "[write ]"))
        after = np.concatenate([stext, demo])
        rise = (len(brute_positions(np, after, planted))
                - len(brute_positions(np, stext, planted)))
        ok &= m is not None and int(m[2]) - int(m[1]) == rise
    print(f"[serve] create_run_seconds={walls[0]:.4f} "
          f"open_run_seconds={walls[1]:.4f} feed_rows={len(feed)} "
          f"emitters={agg['summary']['emitters']} "
          f"feed_queries={agg['summary']['queries']} "
          f"checks={str(bool(ok)).lower()}", flush=True)
    check(bool(ok), "[serve] [locate] equals a brute-force scan, [stream]'s "
          "pages total the one-shot count, [write ] rises by the planted "
          "occurrences")
    row_keys = {"role", "table", "pid", "queries", "p50_ms", "p95_ms",
                "p99_ms", "stats", "ts"}
    check(len(feed) >= 2 and all(set(r) == row_keys for r in feed)
          and agg["summary"]["tables"] >= 1
          and "[varz  ] table-proc dna_serve" in varz,
          "[serve] the feed holds the reference's rows and --dump-stats "
          "reads it")
    torch.cuda.synchronize()
    serve_launches = dict(_build.LAUNCHES)
    print(f"[serve-cli-launches] " + " ".join(
        f"{k}={v}" for k, v in serve_launches.items()), flush=True)
    for k in ("pack2bit", "bounded_search", "tier_scan"):
        check(serve_launches[k] > 0, f"{k} launched on the [serve] path")

    by_path = {"serve": launches, "compact": compact_launches,
               "persist": persist_launches, "long": long_launches,
               "client": client_launches, "serve_cli": serve_launches}
    Q.query = search
    print(f"[locate] {json.dumps({p: located[i].tolist() for i, p in enumerate(loc_pats)})}",
          flush=True)
    check(bool((merged_counts >= base_counts).all()),
          "appends never lower a count")

    # brute-force sample over the base text and the whole logical text
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

    # [long]: each search kernel against its plain versions at W = 17, 32
    # and 64 on the [long] tables (patterns cut to 16 W bases), and its
    # times and bound at W = 64
    def long_kernels() -> dict:
        """name -> the [long] numbers of that kernel's row."""
        wide = {k: {"wide_max_abs_err": 0} for k in
                ("bounded_search", "tier_scan", "tablet_scan", "fm_scan")}
        lst = ltable.store
        lstack = ltable._tierset().stack
        lmeta = ops.tier_meta(lstack)
        lfa = ftable.fm.arrays
        # tablet_scan's rows: LONG_TABLET_ROWS consecutive sorted rows
        # around the lower bound of the first (cut, so matching) pattern
        _, pp0, pl0 = Q.encode_patterns(long_pats[:1], LONG_QUERY_LEN,
                                        device=dev)
        lb0 = int(Q.search_bounds_plain(lst, pp0, pl0)[0][0]) \
            - lst.pad_count
        t_lo = min(max(lb0 - LONG_TABLET_ROWS // 2, 0),
                   lst.n_real - LONG_TABLET_ROWS)
        r0 = lst.pad_count + t_lo
        lpos = lst.sa[r0:r0 + LONG_TABLET_ROWS]
        lwt = codec.extract_window(lst.text_packed, lpos,
                                   LONG_WIDTHS[-1]).T.contiguous()
        for W in LONG_WIDTHS:
            _, pp, pl = Q.encode_patterns([p[:16 * W] for p in long_pats],
                                          16 * W, device=dev)
            _, fpp, fpl = Q.encode_patterns([p[:16 * W] for p in fpats],
                                            16 * W, device=dev)
            Bw = int(pp.shape[0])
            sargs = (lst.sa, lst.text_packed, lst.n_real, pp, pl, lst.n_pad)
            lb, ub = bounded_search_cuda(*sargs)
            plb, pub = Q.search_bounds_plain(lst, pp, pl)
            e_bs = max(max_abs_err(torch, [lb, ub], [plb, pub]),
                       max_abs_err(torch, bounded_match_cuda(*sargs,
                                                             lst.pad_count),
                                   bounded_match_plain(lst, pp, pl)))
            pt = pp.T.contiguous()
            targs = (pt, pl, lstack.text_packed, lstack.sa, lstack.pad_cnt,
                     lmeta)
            tgot = TS.tier_scan_cuda(*targs)
            e_ts = max_abs_err(torch, tgot, TS.tier_scan_plain(*targs))
            bargs = (pt, pl, lwt[:W], lpos)
            bgot = tablet_scan_cuda(*bargs, n_real=lst.n_real)
            e_tb = max_abs_err(torch, bgot, tablet_scan_plain(
                *bargs, n_real=lst.n_real))
            fgot = FM.fm_scan_cuda(fpp, fpl, lfa.bwt, lfa.occ, lfa.meta)
            e_fm = max_abs_err(torch, fgot, FM.backward_search(lfa, fpp, fpl))
            for k, e in (("bounded_search", e_bs), ("tier_scan", e_ts),
                         ("tablet_scan", e_tb), ("fm_scan", e_fm)):
                wide[k]["wide_max_abs_err"] = max(
                    wide[k]["wide_max_abs_err"], e)
            print(f"[long:W={W}] max_len={16 * W} bounded_search_err={e_bs} "
                  f"tier_scan_err={e_ts} tablet_scan_err={e_tb} "
                  f"fm_scan_err={e_fm} found={int((ub > lb).sum())} "
                  f"tier_matches={int(tgot[2].sum())} "
                  f"tablet_found={int((bgot[0] > 0).sum())} "
                  f"fm_found={int((fgot[1] > fgot[0]).sum())}", flush=True)
            if W != LONG_WIDTHS[-1]:
                continue
            # bounds at W = 64, counted as the W = 8 rows' are
            bin_trace = []
            bounded_search_plain(*sargs, trace=bin_trace, arity=2)
            m = match_traffic(torch, kary, codec, lst, pp, pl, lb, bin_trace)
            bin_traces = []
            TS.tier_scan_plain(*targs, trace=bin_traces, arity=2)
            t_bytes, _, _, t_words = tier_traffic(
                torch, bin_traces, lstack.sa, lstack.text_packed,
                *tier_runs(torch, TS, lstack, tgot))
            tb_trace = []
            tablet_scan_plain(*bargs, n_real=lst.n_real, trace=tb_trace,
                              arity=2)
            b_bytes, _, _, b_words = tablet_traffic(torch, tb_trace)
            f_ranks, f_words, _, _ = fm_traffic(
                torch, FM, lfa, FM.syms_from_packed(fpp, fpl, 16 * W))
            u = used_words(torch, pl)
            for k, fn, reps, nb, no in (
                    ("bounded_search",
                     lambda: bounded_match_cuda(*sargs, lst.pad_count), 20,
                     m["bytes"], m["ops"]),
                    ("tier_scan", lambda: TS.tier_scan_cuda(*targs), 50,
                     t_bytes + tier_fixed(torch, lstack, pl), 4 * t_words),
                    ("tablet_scan",
                     lambda: tablet_scan_cuda(*bargs, n_real=lst.n_real), 50,
                     b_bytes + 4 * u + 4 * Bw + 12 * Bw, 4 * b_words),
                    ("fm_scan",
                     lambda: FM.fm_scan_cuda(fpp, fpl, lfa.bwt, lfa.occ,
                                             lfa.meta), 50,
                     4 * f_ranks + 4 * f_words + Bw * W * 4 + Bw * 4
                     + 2 * Bw * 4 + 32, 9 * f_words)):
                b, by = bound_ms(nb, no)
                wide[k].update({f"w{W}_{key}": v
                                for key, v in times(fn, reps).items()},
                               **{f"w{W}_bound_ms": b, f"w{W}_bound_by": by})
                print(f"[long:kernel] {k} W={W} " + " ".join(
                    f"{key}={v:.6g}" if isinstance(v, float) else f"{key}={v}"
                    for key, v in wide[k].items()), flush=True)
        return wide

    # the rows gain every path's launches and, for a search kernel, its
    # [long] numbers: the largest error at W = 17, 32 and 64, folded into
    # max_abs_err, and its W = 64 times and bound.  ``ms_after_phases``
    # times each W = 8 call as issued once more, with the later phases'
    # state in the process
    wide = long_kernels()
    for r, (counted, kernel, reps) in zip(rows, timed):
        long = wide.get(r["name"], {})
        r["max_abs_err"] = max(r["max_abs_err"],
                               long.get("wide_max_abs_err", 0))
        r.update(long, launches_by_path={k: v[counted]
                                         for k, v in by_path.items()},
                 ms_after_phases=cuda_ms(torch, kernel, reps))
        check(r["max_abs_err"] == 0,
              f"{r['name']} equals its plain version at every width")
    print(f"[after-phases] threads={threading.active_count()} " + " ".join(
        f"{r['name']}:ms={r['ms']:.6f},ms_after_phases="
        f"{r['ms_after_phases']:.6f}" for r in rows), flush=True)
    for r in rows:
        if "w64_device_ms" in r:
            print(f"[width] {r['name']} " + " ".join(
                f"{w}:ms={r[p + 'ms']:.6f},device_ms={r[p + 'device_ms']:.6f},"
                f"cold_ms={r[p + 'cold_ms']:.6f},bound_ms="
                f"{r[p + 'bound_ms']:.3g}"
                for w, p in (("W=8", ""), ("W=64", "w64_"))), flush=True)
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
