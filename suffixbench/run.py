"""One run of one benchmark cell of ``repro_torch`` on the card.

    python3 suffixbench/run.py --workload chr1-live.bulk500 --seed 7 \\
        --seconds 30 --trace 0

The cell, its configuration, its traffic mix and its metrics are found
by name from ``BENCHMARK.json`` (``suffixbench/spec.py``).  The run
makes its bases and patterns from ``--seed``, builds the table, warms
up, measures for ``--seconds``, checks every answer of the window
against the plain reference, and prints one JSON line last on standard
output (with ``--trace 1``, the per-layer metrics of a traced run in
place of the end-to-end ones).  It prints no result and exits non-zero
without enough CUDA devices, or when JAX or the JAX package is loaded
once the window has closed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (up to the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run at a fixed path inside the checkout; the
    # kernels build into build/repro_torch_kernels/ there already
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    for path in (ROOT, os.path.join(ROOT, "src")):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch
    from suffixbench import harness, spec

    cell = spec.resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"suffixbench: {cell.name} needs {cell.chips} CUDA "
              f"device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"suffixbench: loaded after the window: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}={c['value']} limit={c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
