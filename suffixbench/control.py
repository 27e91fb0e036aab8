"""The control of a cell: the plain reference put in the program's
place with one guarantee broken, judged by the same comparison as a
run, at the cell's own size, on each seed given.  On a read-only cell
``first_pos`` is taken from the first matching row in suffix order, not
the smallest position; on a cell whose loop writes, every pattern is
answered over the base text alone, as if no append had been made.

    python3 suffixbench/control.py --workload chr1-live.bulk500 \\
        --patterns 40000 --seeds 11 12 13

Prints one JSON line a seed with its checks.  The benchmark's own runs
do not run it; it is the evidence that the comparison fails a wrong
answer at the timed sizes.
"""
import argparse
import json
import os
import sys
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control(cell, reference, seed: int, n_patterns: int, seconds: float,
            dev) -> dict:
    """One seed's control: its patterns, its checks (and, on a writing
    cell, the checks of its "latest" patterns alone)."""
    import torch
    from suffixbench import harness
    cfg = cell.config
    n = int(cfg["n_bases"])
    max_len = int(cfg["max_query_len"])
    text = harness.make_text(n, seed, dev)
    ctx = types.SimpleNamespace(seed=seed, traffic=cell.traffic, config=cfg,
                                device=dev, db=None, table=None,
                                table_name=harness.TABLE, n_bases=n,
                                text=text, seconds=seconds)
    load = cell.loop.Traffic(ctx)
    out = {}
    if hasattr(load, "appended"):
        b = load.control_batches(n_patterns)
        base = reference.SuffixReference(torch.from_numpy(text).to(dev),
                                         max_len)
        count, first = base.answer(torch.as_tensor(b.codes),
                                   torch.as_tensor(b.plen))
        del base
        text = np.concatenate([text, load.appended()])
        ref = reference.SuffixReference(torch.from_numpy(text).to(dev),
                                        max_len, n_fixed=n)
        out["checks"] = harness.judge(ref, b.codes, b.plen, count,
                                      count > 0, first, 0, b.n_visible)
        m = b.latest
        out["latest_checks"] = harness.judge(
            ref, b.codes[m], b.plen[m], count[m], count[m] > 0, first[m],
            0, b.n_visible[m])
    else:
        codes, plen = load.window_patterns(n_patterns)
        ref = reference.SuffixReference(torch.from_numpy(text).to(dev),
                                        max_len)
        count, first = ref.answer_rank_first(torch.as_tensor(codes),
                                             torch.as_tensor(plen))
        out["checks"] = harness.judge(ref, codes, plen, count, count > 0,
                                      first, 0)
    out["patterns"] = int(count.size)
    out["correct"] = all(c["value"] <= c["limit"]
                         for c in out["checks"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--patterns", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from suffixbench import spec

    if not torch.cuda.is_available():
        print("suffixbench: the control needs a CUDA device",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.resolve(args.workload, ROOT)
    # a writing cell schedules appends for the benchmark's window
    seconds = float(spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
                    ["run_seconds"])
    reference = spec.load_module(os.path.join(ROOT, cell.config["reference"]),
                                 "suffixbench_reference")
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(cell, reference, seed, args.patterns, seconds, dev)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "patterns": out["patterns"],
            "correct": out["correct"],
            "seconds": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(dev),
            **{k: v for k, v in out.items() if k.endswith("checks")}}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
