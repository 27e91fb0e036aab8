#!/usr/bin/env python3
"""Live-table A/B of two checkouts of the PyTorch port on one CUDA card.

Runs the live phases of ``chip_smoke.py`` once per checkout, each in a
fresh process, in the order A B B A: a 2**26-base table built on the
card, the paper's workload (10,000 random patterns of 1-100 bases in
batches of 512) base-only, three appends of 2**17 bases (one sealed run
and a memtable), then the workload again over base + run + memtable.
Each workload runs twice: ``cold`` (the first pass, first launches
included, as chip_smoke measures it) and ``warm`` (result cache cleared,
kernels loaded).  Run from anywhere::

    python3 tools/torch_live_ab.py [--rounds N] OLD_ROOT NEW_ROOT

Each ROOT is the root of a checkout whose ``src/`` holds ``repro_torch``;
each builds its own kernels under its ``build/``.  ``--rounds N``
repeats A B B A N times (default 1).  Prints one JSON line per run, then
one ``[ab]`` line per (phase, pass): each checkout's median queries/s
with its quartiles, the mean p50 ms, and the pairs the new checkout won
(run i of A against run i of B, so each round gives two pairs, one with
each checkout first).  Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

TEXT_LEN = 2**26
MEMTABLE_LIMIT = 2**18
APPEND_LEN = 2**17
N_QUERIES = 10_000
BATCH = 512
MAX_QUERY_LEN = 128
PHASES = ("base_cold", "base_warm", "merged_cold", "merged_warm")


def run_one(root: str) -> int:
    """The live phases on the checkout at ``root``; prints one JSON line."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_live_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.api import SuffixTable
    from repro_torch.core import codec
    from repro_torch.core import query as Q
    from repro_torch.kernels import _build

    _build.build()
    base = codec.random_dna(TEXT_LEN, seed=0)
    t0 = time.perf_counter()
    table = SuffixTable.from_codes(base, is_dna=True,
                                   max_query_len=MAX_QUERY_LEN,
                                   memtable_limit=MEMTABLE_LIMIT)
    torch.cuda.synchronize()
    out = {"root": root, "build_s": time.perf_counter() - t0}
    patterns = Q.random_patterns(N_QUERIES, 1, 100, seed=0)

    def serve(tag: str) -> None:
        for rep in ("cold", "warm"):
            table.clear_cache()
            lat = []
            t_all = time.perf_counter()
            for i in range(0, N_QUERIES, BATCH):
                t = time.perf_counter()
                table.scan(patterns[i:i + BATCH])
                lat.append((time.perf_counter() - t) * 1e3)
            total = time.perf_counter() - t_all
            out[f"{tag}_{rep}"] = {
                "queries_per_s": N_QUERIES / total,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "first_batch_ms": lat[0]}

    serve("base")
    for i in range(3):
        table.append(codec.random_dna(APPEND_LEN, seed=1 + i))
    serve("merged")
    print(json.dumps(out), flush=True)
    return 0


def main(argv: list[str]) -> int:
    import numpy as np
    args = argv[1:]
    if len(args) == 2 and args[0] == "--one":
        return run_one(args[1])
    rounds = 1
    if len(args) == 4 and args[0] == "--rounds":
        rounds, args = int(args[1]), args[2:]
    if len(args) != 2 or rounds < 1:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(r) for r in args)
    runs: dict[str, list[dict]] = {a: [], b: []}
    for root in (a, b, b, a) * rounds:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(f"torch_live_ab: the run on {root} failed "
                  f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        runs[root].append(rec)
    for ph in PHASES:
        line = [f"[ab] {ph}"]
        qps = {}
        for name, root in (("old", a), ("new", b)):
            recs = [r[ph] for r in runs[root]]
            qps[name] = np.array([r["queries_per_s"] for r in recs])
            q1, med, q3 = np.percentile(qps[name], [25, 50, 75])
            p50 = sum(r["p50_ms"] for r in recs) / len(recs)
            line.append(f"{name}_queries_per_s_median={med:.1f} "
                        f"{name}_q1={q1:.1f} {name}_q3={q3:.1f} "
                        f"{name}_p50_ms={p50:.4f}")
        wins = int((qps["new"] > qps["old"]).sum())
        line.append(f"new_won={wins}/{len(qps['new'])}")
        print(" ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
