"""Puts the checkout's root (for ``suffixbench``) and ``src/`` (for the
program) on the path, and gives the tests a small cell."""
import copy
import glob
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


# cells the harness keeps code for but BENCHMARK.json does not measure
# (their runs spread past any bound), with the metrics they would report
PROBES = {"chr1-live.users50": ("chr1-live", "users50"),
          "chr1-frozen.users50": ("chr1-frozen", "users50")}
USERS_LAYER = ("client.wave_queries", "client.coalesce_wait_ms",
               "table.cache_hit_share")


def bench_with_probes() -> dict:
    """``BENCHMARK.json`` with the ``PROBES`` cells added (a live probe
    reports what the live bulk cell does, a frozen one what the frozen
    bulk cell does, and both the users' client and cache metrics), and
    the entries of each cell held out in ``suffixbench/held/``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for path in sorted(glob.glob(os.path.join(ROOT, "suffixbench", "held",
                                              "*.json"))):
        with open(path) as f:
            held = json.load(f)
        for key, entries in held.items():
            have = {e["name"] for e in bench[key]}
            bench[key] += [e for e in entries if e["name"] not in have]
    like = {"chr1-live": "chr1-live.bulk500",
            "chr1-frozen": "chr1-frozen.bulk100"}
    for name, (config, traffic) in PROBES.items():
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "probe"})
        moves = None
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like[config] in m.get("workloads", ()):
                m["workloads"].append(name)
                if m["name"].startswith("queries_per_s"):
                    moves = m["name"]
        bench["per_layer"] += [
            {"name": n, "unit": "-", "better": "lower",
             "source": "program_counter", "layer": "client",
             "moves": moves, "workloads": [name]} for n in USERS_LAYER]
    return bench


def _small_cell(name: str, n_bases: int = 4096, seals: bool = False):
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``PROBES`` or
    ``held/``) at a size a CPU test holds: ``n_bases`` bases, 4 callers,
    a few batches; a writing cell also few appends, and with ``seals`` a
    memtable of a few hundred bases, else one that no run fills."""
    from suffixbench import spec
    cell = spec.resolve(name, bench=bench_with_probes())
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["n_bases"] = n_bases
    if cell.traffic["loop"] == "users":
        cell.traffic.update(callers=4, warmup_queries=16)
    else:
        cell.traffic.update(block_batches=2, pool_batches=2,
                            warmup_batches=1)
    if cell.traffic["loop"] == "append":
        # with seals the load seals two runs, the window several more
        cell.config["table_options"].update(
            memtable_limit=600 if seals else 1 << 20)
        cell.traffic.update(uniform_per_length=1, reads_per_append=2,
                            load_reads=10, append_period_ms=100)
    return cell


@pytest.fixture
def small_cell():
    return _small_cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, when the
    test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
