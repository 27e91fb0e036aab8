"""The port's tracer as profiler ranges: a span opens the range
``<component>.<span>`` only while a torch profiler records, ranges from
a serving thread nest as the spans do (``client.execute`` over the
table's ``dispatch`` and ``merge``, ``merge`` over ``range_min`` on a
live table and ``lf_walk`` on a frozen one), the write path records
its spans, and the module still imports without torch."""
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import Database, Query, SuffixTable
from repro_torch.core.codec import decode_dna
from repro_torch.core import query as Q
from repro_torch.serving import trace

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
TEXT = np.random.default_rng(3).integers(0, 4, 3000).astype(np.uint8)
# past the k-mer table's K bases and in the text, so a batch holding it
# leaves a slice to reduce (live) or walk (frozen)
LONG = decode_dna(TEXT[1000:1012])
PATTERNS = ["A", LONG, "CG", "GATTACA", "T" * 31]
SHORT = ["CG", "GATTACA"]     # base matches the k-mer table answers all
NO_MATCH = ["ACGT" * 20]      # a batch of it alone has no base match


@pytest.fixture
def ranges_opened(monkeypatch):
    """The names of the profiler ranges the tracer opens from here on."""
    ranges = sys.modules["torch._C._profiler"]
    opened = []
    inner = ranges._RecordFunctionFast

    def recording(name, *a, **kw):
        opened.append(name)
        return inner(name, *a, **kw)
    monkeypatch.setattr(ranges, "_RecordFunctionFast", recording)
    return opened


def _all_threads():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _db(frozen: bool):
    db = Database.in_memory()
    table = db.attach("dna", SuffixTable.from_codes(TEXT, is_dna=True,
                                                    device="cpu"))
    if frozen:
        table.freeze(sample_rate=4)
    return db, table


def _raw_query(patterns, top_k=0) -> Query:
    """A pre-encoded batch (packed words as ``uint32``), as the bulk
    benchmark sends it."""
    _, words, lens = Q.encode_patterns(patterns, 128, device="cpu")
    return Query(table="dna", kind="scan", top_k=top_k,
                 codes=words.view(torch.int32).numpy().view(np.uint32),
                 lens=lens.numpy())


def _from_worker(db, queries, marker: str = ""):
    """``db.query`` of each query from one thread of its own, as the
    benchmark's caller runs; inside a profiler range ``marker``, if
    given, to name that thread in a trace."""
    out = []

    def run():
        if not marker:
            out.extend(db.query(q) for q in queries)
            return
        with torch.autograd.profiler.record_function(marker):
            out.extend(db.query(q) for q in queries)
    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert all(r.ok for r in out)
    return out


def _thread_of(prof, name: str):
    """The profiler's thread id of the one range ``name`` it recorded."""
    (tid,) = {e.thread for e in prof.events() if e.name == name}
    return tid


def _program_ranges(prof) -> list:
    """(name, parent program range or None, thread) of each program
    range the profiler recorded."""
    def program(e):
        return e is not None and e.name.split(".")[0] in (
            "client", "table", "planner")
    out = []
    for e in prof.events():
        if program(e):
            par = e.cpu_parent
            while par is not None and not program(par):
                par = par.cpu_parent
            out.append((e.name, par.name if par else None, e.thread))
    return out


def test_no_profiler_opens_no_range(ranges_opened):
    tr = trace.Tracer("table")
    for _ in range(3):
        with tr.span("merge"):
            pass
    assert ranges_opened == []
    snap = tr.snapshot()["merge"]
    assert snap["total"] == 3 and snap["n"] == 3 and snap["sum_ms"] >= 0


def test_a_recording_profiler_opens_component_ranges(ranges_opened):
    tr = trace.Tracer("client")
    off = trace.Tracer("client", enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("execute"):
            with tr.span("inner"):
                pass
        tr.record("coalesce_wait", 1.5)            # measured elsewhere
        with off.span("execute"):
            pass
    assert ranges_opened == ["client.execute", "client.inner"]
    assert off.snapshot() == {}
    assert tr.snapshot()["coalesce_wait"]["total"] == 1
    got = [(n, p) for n, p, _t in _program_ranges(prof)]
    assert sorted(got) == [("client.execute", None),
                           ("client.inner", "client.execute")]
    with tr.span("after"):                         # the profiler stopped
        pass
    assert len(ranges_opened) == 2


@pytest.mark.parametrize("frozen,child", [(False, "range_min"),
                                          (True, "lf_walk")])
def test_worker_thread_ranges_nest_as_the_spans(frozen, child):
    db, table = _db(frozen)
    try:
        _from_worker(db, [_raw_query(PATTERNS)])       # warm
        with _all_threads() as prof:
            with torch.autograd.profiler.record_function("main_marker"):
                _from_worker(db, [_raw_query(PATTERNS)], "worker_marker")
        got = {(n, p) for n, p, _t in _program_ranges(prof)}
        assert ("client.execute", None) in got
        assert ("table.dispatch", "client.execute") in got
        assert ("table.merge", "client.execute") in got
        assert (f"table.{child}", "table.merge") in got
        other = {"range_min", "lf_walk"} - {child}
        assert not any(n == f"table.{o}" for n, _p in got for o in other)
        threads = {t for _n, _p, t in _program_ranges(prof)}
        worker = _thread_of(prof, "worker_marker")
        assert threads == {worker}
        assert worker != _thread_of(prof, "main_marker")
    finally:
        db.close()


@pytest.mark.parametrize("frozen,child", [(False, "range_min"),
                                          (True, "lf_walk")])
def test_child_span_counts_the_batches_with_a_base_match(frozen, child):
    """The child span counts the batches with a base match that leave a
    slice to reduce or walk: one whose matches the k-mer table answers
    all (``SHORT``) records none."""
    db, table = _db(frozen)
    try:
        _from_worker(db, [_raw_query(PATTERNS), _raw_query(NO_MATCH),
                          _raw_query(PATTERNS[1:]), _raw_query(NO_MATCH),
                          _raw_query(SHORT)])
        snap = table.tracer.snapshot()
        assert snap["merge"]["total"] == 5
        assert snap[child]["total"] == 2
        assert snap[child]["sum_ms"] <= snap["merge"]["sum_ms"]
        assert ({"range_min", "lf_walk"} - {child}).isdisjoint(snap)
    finally:
        db.close()


@pytest.mark.parametrize("frozen", [True, False])
def test_frozen_walks_count_the_kernel_rows(frozen):
    """A frozen table counts ``lf_kernel_rows`` beside ``slice_rows`` in
    each batch that walks: 0 on the CPU, whose walks are the plain ones.
    A live table walks nothing and records no such counter."""
    db, table = _db(frozen)
    try:
        _from_worker(db, [_raw_query(PATTERNS), _raw_query(SHORT),
                          _raw_query(NO_MATCH), _raw_query(PATTERNS[1:])])
        snap = table.tracer.snapshot()
        assert snap["slice_rows"]["sum_ms"] > 0
        if not frozen:
            assert "lf_kernel_rows" not in snap
            return
        assert snap["lf_kernel_rows"]["total"] == 2
        assert snap["lf_walk"]["total"] == 2
        assert snap["lf_kernel_rows"]["sum_ms"] == 0
        counters = {f"table.{k}": (v["sum_ms"], v["total"])
                    for k, v in snap.items()}
        share = _layer_reader("table.lf_kernel_row_share.frozen")
        assert share.read(types.SimpleNamespace(counters=counters)) == 0.0
    finally:
        db.close()


def test_kernel_rows_are_what_the_walk_reports(monkeypatch):
    """``lf_kernel_rows`` adds up the rows each walk reports its launch
    walked, not rows the table works out for itself: a walk that
    reports 7 rows a batch gives 14 over the two batches that walk."""
    from repro_torch.api.fm import FMIndex
    plain = FMIndex.segment_min_positions

    def reporting(self, starts, counts):
        return plain(self, starts, counts)[0], 7
    monkeypatch.setattr(FMIndex, "segment_min_positions", reporting)
    db, table = _db(True)
    try:
        _from_worker(db, [_raw_query(PATTERNS), _raw_query(SHORT),
                          _raw_query(NO_MATCH), _raw_query(PATTERNS[1:])])
        snap = table.tracer.snapshot()
        assert snap["lf_kernel_rows"]["total"] == 2
        assert snap["lf_kernel_rows"]["sum_ms"] == 14
    finally:
        db.close()


def test_the_kernel_row_share_reads_the_counters():
    """The benchmark's reader of the walked rows' share: None without the
    counter (a program that lacks it) or without a walked row, else 100
    x ``lf_kernel_rows`` / ``slice_rows``."""
    share = _layer_reader("table.lf_kernel_row_share.frozen")

    def read(**counters):
        flat = {f"table.{k}": v for k, v in counters.items()}
        return share.read(types.SimpleNamespace(counters=flat))
    assert read() is None
    assert read(slice_rows=(1270.0, 30)) is None
    assert read(slice_rows=(0.0, 30), lf_kernel_rows=(0.0, 0)) is None
    assert read(slice_rows=(1270.0, 30), lf_kernel_rows=(1270.0, 30)) \
        == 100.0
    assert read(slice_rows=(1270.0, 30), lf_kernel_rows=(0.0, 30)) == 0.0
    assert read(slice_rows=(1000.0, 30), lf_kernel_rows=(250.0, 30)) \
        == 25.0


def test_frozen_top_k_walks_are_lf_walk_spans():
    """On a frozen table the ``top_k`` path's walks (one a matching row)
    are ``lf_walk`` spans too, besides the batch's minimum walk."""
    db, table = _db(True)
    try:
        res = _from_worker(db, [_raw_query(PATTERNS[:3], top_k=2)])[0]
        assert (res.count[:3] > 0).all()
        snap = table.tracer.snapshot()
        assert snap["lf_walk"]["total"] == 1 + 3
        assert snap["lf_walk"]["sum_ms"] <= snap["merge"]["sum_ms"]
    finally:
        db.close()


def test_locate_range_walks_record_no_lf_walk():
    """``locate_range`` walks a frozen table's rows outside any
    ``merge``, so it records no ``lf_walk``: the span stays nested in
    ``merge`` and ``merge`` less its children stays the row loop."""
    db, table = _db(True)
    try:
        got = table.locate_range("CG", limit=None)
        assert got.size > 0
        snap = table.tracer.snapshot()
        assert "lf_walk" not in snap and "merge" not in snap
    finally:
        db.close()


WRITE_SPANS = ("append", "log_wait", "seal", "snapshot_sync",
               "tier_snapshot", "delta_positions")


def _layer_reader(name: str):
    """The benchmark's reader of the per-layer metric ``name``, loaded
    from its file."""
    import importlib.util
    path = os.path.join(os.path.dirname(SRC), "suffixbench",
                        "layer_metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _held_dispatch_self():
    """The benchmark's reader of ``dispatch`` less its ``dispatch_*``
    children (a writing cell's)."""
    return _layer_reader("table.dispatch_self_ms_per_query.append")


def test_a_sealing_append_and_a_read_record_the_write_path_spans(tmp_path):
    """Four appends of 150 bases into a 600-base memtable (the fourth
    seals it) and a read after them: each append is an ``append`` and a
    ``log_wait``, the seal one ``seal`` holding one ``snapshot_sync``
    and its bytes, and the read rebuilds the tier snapshot and gathers
    the delta positions inside its ``dispatch`` but outside every
    ``dispatch_*``, so ``dispatch`` less its ``dispatch_*`` children,
    as the benchmark reads it, still holds them."""
    db = Database(str(tmp_path), device="cpu")
    table = db.create_table("dna", TEXT, is_dna=True, memtable_limit=600)
    try:
        for k in range(4):
            db.append("dna", TEXT[300 * k:300 * k + 150])
        assert len(table.runs) == 1
        _from_worker(db, [_raw_query(PATTERNS)])
        snap = table.tracer.snapshot()
        assert snap["append"]["total"] == snap["log_wait"]["total"] == 4
        assert snap["seal"]["total"] == snap["snapshot_sync"]["total"] == 1
        assert snap["tier_snapshot"]["total"] == 1
        assert snap["delta_positions"]["total"] == 1
        step = os.path.join(str(tmp_path), "dna", "step_0000000002")
        assert snap["snapshot_sync_bytes"]["sum_ms"] == sum(
            os.path.getsize(os.path.join(step, f))
            for f in os.listdir(step))
        assert snap["snapshot_sync"]["sum_ms"] <= snap["seal"]["sum_ms"] \
            <= snap["append"]["sum_ms"]
        assert not any(n.startswith("dispatch_") for n in WRITE_SPANS)
        inner = sum(v["sum_ms"] for k, v in snap.items()
                    if k.startswith("dispatch_"))
        outside = snap["dispatch"]["sum_ms"] - inner
        assert snap["tier_snapshot"]["sum_ms"] + \
            snap["delta_positions"]["sum_ms"] <= outside + 1e-3
        counters = {f"table.{k}": (v["sum_ms"], v["total"])
                    for k, v in snap.items()}
        got = _held_dispatch_self().read(types.SimpleNamespace(
            counters=counters, segment_patterns=len(PATTERNS)))
        assert got == pytest.approx(outside / len(PATTERNS))
    finally:
        db.close()


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(SRC), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profiled_scan(table, on_card: bool):
    """``key_averages()`` of a profiled ``table.scan`` inside a user
    range ``smoke.batches`` of its caller's, as ``chip_smoke.py``
    profiles one."""
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        with torch.autograd.profiler.record_function("smoke.batches"):
            table.scan(PATTERNS)
        if on_card:
            torch.cuda.synchronize()
    return prof.key_averages()


def test_program_ranges_are_operators_and_annotations_are_left_out():
    """A profiled ``table.scan``'s ranges are operator ranges of the
    host row, not user annotations (the profiler copies only those onto
    the device row), and ``chip_smoke.device_kernels`` leaves a user
    annotation out and keeps the operators inside it."""
    db, table = _db(False)
    try:
        table.scan(PATTERNS[1:])                           # warm
        table.clear_cache()
        events = _profiled_scan(table, False)
        program = [e for e in events if e.key.startswith("table.")]
        assert {"table.dispatch", "table.merge", "table.range_min"} <= {
            e.key for e in program}
        assert all(str(e.device_type).endswith("CPU")
                   and not e.is_user_annotation for e in program)
        kept = {e.key for e in _chip_smoke().device_kernels(events, "CPU")}
        assert "smoke.batches" not in kept and "aten::min" in kept
        assert _chip_smoke().device_kernels(events) == []   # no card row
    finally:
        db.close()


@pytest.mark.cuda
def test_profiled_scan_on_the_card_counts_kernels_only():
    """On the card a profiled ``table.scan`` puts no ``table.*`` range on
    the device row, and the busy time ``chip_smoke.profile_fn`` sums
    leaves out the caller's user range, which the profiler copies there
    over the kernels it encloses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    table = SuffixTable.from_codes(TEXT, is_dna=True, device="cuda")
    table.scan(PATTERNS[1:])                               # warm, build
    torch.cuda.synchronize()
    table.clear_cache()
    events = _profiled_scan(table, True)
    on_card = [e for e in events if str(e.device_type).endswith("CUDA")]
    assert not any(e.key.startswith("table.") for e in on_card)
    assert "smoke.batches" in {e.key for e in on_card
                               if e.is_user_annotation}
    kept = _chip_smoke().device_kernels(events)
    assert kept and "smoke.batches" not in {e.key for e in kept}
    assert {e.key for e in on_card} - {e.key for e in kept} == {
        e.key for e in on_card if e.is_user_annotation}


def test_importing_the_tracer_pulls_in_no_torch():
    code = ("import sys, repro_torch.serving.trace as t; "
            "assert 'torch' not in sys.modules, 'torch imported'; "
            "tr = t.Tracer('router'); "
            "s = tr.span('dispatch_remote'); s.__enter__(); "
            "s.__exit__(None, None, None); "
            "assert tr.snapshot()['dispatch_remote']['total'] == 1; "
            "assert 'torch' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
