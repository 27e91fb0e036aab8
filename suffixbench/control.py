"""The control of a cell: the plain reference put in the program's
place with one guarantee broken (``first_pos`` taken from the first
matching row in suffix order, not the smallest position), judged by the
same comparison as a run, at the cell's own size, on each seed given.

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

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--patterns", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from suffixbench import harness, spec

    if not torch.cuda.is_available():
        print("suffixbench: the control needs a CUDA device",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.resolve(args.workload, ROOT)
    cfg = cell.config
    reference = spec.load_module(os.path.join(ROOT, cfg["reference"]),
                                 "suffixbench_reference")
    for seed in args.seeds:
        t0 = time.perf_counter()
        text = harness.make_text(int(cfg["n_bases"]), seed, dev)
        ctx = types.SimpleNamespace(seed=seed, traffic=cell.traffic,
                                    config=cfg, device=dev, db=None,
                                    table=None, table_name=harness.TABLE)
        codes, plen = cell.loop.Traffic(ctx).window_patterns(args.patterns)
        ref = reference.SuffixReference(torch.from_numpy(text).to(dev),
                                        int(cfg["max_query_len"]))
        count, first = ref.answer_rank_first(torch.as_tensor(codes),
                                             torch.as_tensor(plen))
        checks = harness.judge(ref, codes, plen, count, count > 0, first, 0)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "patterns": int(len(plen)),
            "correct": all(c["value"] <= c["limit"]
                           for c in checks.values()),
            "seconds": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(dev), "checks": checks}),
            flush=True)
        del ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
