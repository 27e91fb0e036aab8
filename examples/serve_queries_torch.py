"""Serving driver of the PyTorch port: batched scan requests through the
typed client frontend, as ``examples/serve_queries.py`` does with the JAX
package — the paper's §V service shape, runnable end to end.  Every batch
is a ``repro_torch.api.Query`` routed by table name through a
``Database`` handle: the shared ``QueryScheduler`` coalesces concurrent
callers (here with a 2 ms micro-batch window) with LSM-tier merge and
sentinel retry on the table's device; the run demos multi-table serving,
paged ``ReadSession`` streaming, and ends with an append + compact (the
write path).

    PYTHONPATH=src python examples/serve_queries_torch.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import main as serve_main

# the reference script's launcher arguments
SERVE_ARGV = ["--text-len", "200000", "--queries", "5000",
              "--batch", "256", "--coalesce-window", "2.0"]


def main(argv=None):
    """Runs ``repro_torch.launch.serve`` with the reference's arguments
    and ``--device``; returns what the launcher returns."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_main(SERVE_ARGV + ["--device", args.device])


if __name__ == "__main__":
    main()
