"""Finds a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout names the cell; its configuration is
``suffixbench/configs/<config>.json``, its traffic mix
``suffixbench/traffic/<traffic>.json``, whose ``loop`` names the driver
``suffixbench/loops/<loop>.py``, and each of its metrics a reader
``suffixbench/end_to_end/<metric>.py`` or
``suffixbench/layer_metrics/<metric>.py``.  Nothing here lists a cell.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_module(path: str, name: str) -> ModuleType:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    entry: dict                   # its entry in BENCHMARK.json
    reader: ModuleType            # read(ctx) -> float | None

    @property
    def name(self) -> str:
        return self.entry["name"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                  # the configuration's file
    traffic: dict                 # the traffic mix's file
    loop: ModuleType
    end_to_end: list[Metric]
    per_layer: list[Metric]


def _applies(entry: dict, cell: str, reported=None) -> bool:
    """Whether a metric goes with the cell: the cells its ``workloads``
    list, or without that key every cell (a per-layer metric: every cell
    that reports the end-to-end metric it ``moves``)."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry["moves"] in reported


def resolve(workload: str, root: str = ROOT, bench: dict | None = None
            ) -> Cell:
    """The cell named ``workload`` with every part it names loaded, from
    ``bench`` (by default ``BENCHMARK.json``)."""
    if bench is None:
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    here = os.path.join(root, "suffixbench")
    traffic = load_json(os.path.join(here, "traffic",
                                     f"{w['traffic']}.json"))
    loop = load_module(os.path.join(here, "loops", f"{traffic['loop']}.py"),
                       f"suffixbench_loop_{traffic['loop']}")
    e2e = [Metric(m, load_module(
               os.path.join(here, "end_to_end", f"{m['name']}.py"),
               f"suffixbench_e2e_{i}"))
           for i, m in enumerate(bench["end_to_end"])
           if _applies(m, workload)]
    reported = {m.name for m in e2e}
    per = [Metric(m, load_module(
               os.path.join(here, "layer_metrics", f"{m['name']}.py"),
               f"suffixbench_layer_{i}"))
           for i, m in enumerate(bench["per_layer"])
           if _applies(m, workload, reported)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, loop=loop, end_to_end=e2e, per_layer=per)
