"""``BENCHMARK.json`` and the files it names: every cell resolves by
name to its configuration, traffic, loop and metric readers, and the
file keeps to the benchmark's contract."""
import ast
import json
import os
import re

import pytest

from suffixbench import spec

ROOT = spec.ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = spec.resolve(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    conf = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert c.config == json.load(open(os.path.join(ROOT, conf["file"])))
    assert c.traffic == json.load(open(os.path.join(
        ROOT, "suffixbench", "traffic", f"{w['traffic']}.json")))
    assert c.loop.__file__.endswith(
        os.path.join("loops", f"{c.traffic['loop']}.py"))
    assert hasattr(c.loop, "Traffic")
    names = [m.name for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(m.reader.read)
    for m in c.per_layer:
        assert m.entry["moves"] in names


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.resolve("no-such.cell")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["suffixbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    cfg_names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in cfg_names
        cfg_names.add(c["name"])
        assert c["file"].startswith("suffixbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] \
            == c["reduced"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in cfg_names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(set(CELLS)) == len(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    for d, _dirs, files in os.walk(os.path.join(ROOT, "suffixbench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``repro_torch`` is the program,
    ``repro`` the JAX package."""
    for path in _sources():
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "repro",
                               "benchmarks"), (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "suffixbench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] in ("__future__", "numpy",
                                             "torch"), (f, mod)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    run = spec.load_module(os.path.join(ROOT, "suffixbench", "run.py"),
                           "suffixbench_run_under_test")
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType(
        "repro_torch_like"))
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.api", types.ModuleType("x"))
    assert run.forbidden_modules() == ["repro"]
