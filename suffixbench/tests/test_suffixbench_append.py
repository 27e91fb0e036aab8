"""The writing cell (held out of ``BENCHMARK.json``, its entries in
``suffixbench/held/``) on the CPU at a small size: the reference's
answers at a shorter length against brute force, the append schedule,
the durability checks (an fsync before each ack; a reopen), the faults
a writing run can have, the control, and that the read-only cells
resolve as they did."""
import os
import time
import types

import numpy as np
import pytest
import torch

from suffixbench import harness, roofline, spec
from suffixbench.reference.suffix_array import SuffixReference
from suffixbench.tests.conftest import bench_with_probes
from suffixbench.tests.test_suffixbench_reference import brute

CELL = "chr1-append.ycsb-d"


def _run(cell, seed=2**31 + 7, seconds=1.0, trace=False):
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("k", range(3))
def test_answers_at_each_length_equal_brute_force(k):
    """Patterns cut from every part of a grown text (the base, the
    appends, across the end of the base and across each length asked),
    and random ones, each answered at its own length."""
    rng = np.random.default_rng(k)
    n_fixed, n = 600, 1000
    text = rng.integers(0, 2 + k, n).astype(np.uint8)   # repeats, too
    max_len = 12
    ref = SuffixReference(torch.as_tensor(text), max_len, n_fixed=n_fixed)
    pats, vis = [], []
    for j in range(400):
        L = int(rng.integers(1, max_len + 1))
        v = int(rng.integers(n_fixed, n + 1))
        kind = j % 4
        if kind == 0:                       # across the length asked
            s = v - int(rng.integers(1, L + 1))
        elif kind == 1:                     # across the end of the base
            s = n_fixed - int(rng.integers(0, L + 1))
        elif kind == 2:
            s = int(rng.integers(0, n - L + 1))
        if kind == 3:
            p = rng.integers(0, 4, L).astype(np.uint8)
        else:
            s = min(max(s, 0), n - L)
            p = text[s:s + L]
        pats.append(p)
        vis.append(v)
    codes = np.zeros((len(pats), max_len), np.uint8)
    for i, p in enumerate(pats):
        codes[i, :len(p)] = p
    plen = np.array([len(p) for p in pats])
    count, first = ref.answer(torch.as_tensor(codes), torch.as_tensor(plen),
                              np.array(vis))
    want = [brute(text[:v], p) for p, v in zip(pats, vis)]
    assert count.tolist() == [c for c, _ in want]
    assert first.tolist() == [f for _, f in want]
    # at the whole length, the same as without n_visible
    c0, f0 = ref.answer(torch.as_tensor(codes), torch.as_tensor(plen))
    c1, f1 = ref.answer(torch.as_tensor(codes), torch.as_tensor(plen),
                        np.full(len(pats), n))
    assert (c0 == c1).all() and (f0 == f1).all()


def test_a_length_below_the_fixed_text_is_refused():
    ref = SuffixReference(torch.zeros(300, dtype=torch.uint8), 8,
                          n_fixed=200)
    with pytest.raises(ValueError):
        ref.answer(torch.zeros((1, 8), dtype=torch.uint8),
                   torch.tensor([3]), np.array([150]))


class _FakeDB:
    """Takes appends and answers every read at once with nothing."""

    def __init__(self):
        self.appended = []

    def append(self, name, codes):
        self.appended.append(np.array(codes))
        return 0

    def query(self, q):
        B = int(np.asarray(q.lens).shape[0])
        time.sleep(0.03)
        return types.SimpleNamespace(
            ok=True, count=np.zeros(B, np.int64), found=np.zeros(B, bool),
            first_pos=np.full(B, -1, np.int64))


def _schedule(small_cell, seed, seconds=0.5):
    cell = small_cell(CELL)
    text = harness.make_text(4096, seed, torch.device("cpu"))
    db = _FakeDB()
    ctx = types.SimpleNamespace(
        db=db, table=None, table_name=harness.TABLE, seed=seed,
        config=cell.config, traffic=cell.traffic,
        device=torch.device("cpu"), n_bases=4096, text=text,
        seconds=seconds)
    load = cell.loop.Traffic(ctx)
    load.warm_up()
    _start, _end, requests = harness.run_window(load.callers(), seconds)
    return load, db, requests


def test_the_schedule_sends_the_same_appends_for_a_seed(small_cell):
    a, db_a, req_a = _schedule(small_cell, 11)
    b, db_b, _req_b = _schedule(small_cell, 11)
    c, _db_c, _req_c = _schedule(small_cell, 12)
    assert len(a.append_log) == len(b.append_log) == a.n_window_appends
    assert a.n_window_appends == 5                     # 0.5 s, 100 ms
    assert np.array_equal(a.appended(), b.appended())
    assert np.array_equal(np.concatenate(db_a.appended), a.appended())
    assert not np.array_equal(a.appended(), c.appended())
    # each read is judged over the bases acked before it was sent
    n_load = a.n_load * a.read_len
    assert req_a[0].n_visible >= 4096 + n_load
    assert all(r.n_visible <= 4096 + a.appended().size for r in req_a)
    assert [r.n_visible for r in req_a] == sorted(r.n_visible
                                                  for r in req_a)


def test_latest_patterns_come_from_the_appended_reads(small_cell):
    load, _db, _req = _schedule(small_cell, 13)
    words, lens = load._latest(7, 0)
    codes = roofline.unpack_words(words)
    reads = load.reads[:load.n_acked]
    for c, L in zip(codes, lens):
        hits = [r for r in reads
                if any(np.array_equal(r[o:o + L], c[:L])
                       for o in range(load.read_len - L + 1))]
        assert hits


def test_a_sound_writing_run_loses_nothing(small_cell):
    out = _run(small_cell(CELL))
    assert out["correct"], out["checks"]
    assert out["checks"]["lost_appends"] == {"value": 0, "limit": 0}
    assert out["checks"]["unsynced_acks"] == {"value": 0, "limit": 0}
    assert list(out["checks"]) == ["wrong_count", "wrong_found",
                                   "wrong_first_pos", "unanswered",
                                   "unsynced_acks", "lost_appends"]


def test_an_ack_before_the_fsync_is_caught(small_cell, monkeypatch):
    """The commit log acks every append at once, fsyncing nothing: the
    reopen after a clean close still finds every append (the close
    fsyncs), the fsync witness does not."""
    from repro_torch.api.wal import WriteAheadLog

    def wait(self, token):
        with self._cond:
            self.acked += 1
            self._synced_seq = max(self._synced_seq, token)

    monkeypatch.setattr(WriteAheadLog, "wait", wait)
    out = _run(small_cell(CELL))
    assert not out["correct"]
    assert out["checks"]["unsynced_acks"]["value"] > 0
    assert out["checks"]["lost_appends"]["value"] == 0
    assert out["checks"]["wrong_count"]["value"] == 0


def test_a_sealing_append_is_acked_with_no_fsync_of_its_record(small_cell):
    """The program's fault that holds the writing cell out of
    ``BENCHMARK.json``: an append that fills the memtable is acked once
    the seal's snapshot is written and the commit log replaced, with no
    fsync of the log that held its record, nor of the snapshot.  Every
    other check of the run holds; each seal reads one unsynced ack."""
    out = _run(small_cell(CELL, seals=True))
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks.pop("unsynced_acks") > 0
    assert set(checks.values()) == {0}
    assert not out["correct"]


@pytest.mark.parametrize("seals", [False, True])
def test_a_cut_commit_log_is_caught(small_cell, monkeypatch, seals):
    """The commit log's last record cut short once the program has
    closed: the reopened table lacks an acknowledged append."""
    from repro_torch.api import Database
    from repro_torch.api.catalog import table_wal_dir
    inner = Database.close

    def close_and_cut(self):
        inner(self)
        path = os.path.join(table_wal_dir(self.root, harness.TABLE),
                            "wal.log")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 7)

    monkeypatch.setattr(Database, "close", close_and_cut)
    out = _run(small_cell(CELL, seals=seals))
    assert not out["correct"]
    assert out["checks"]["lost_appends"]["value"] > 0
    assert out["checks"]["wrong_count"]["value"] == 0


def test_an_append_acked_but_not_applied_is_caught(small_cell, monkeypatch):
    """The memtable returns its state unchanged on an append."""
    from repro_torch.api.memtable import Memtable
    monkeypatch.setattr(Memtable, "append",
                        lambda self, codes, **kw: self.size)
    out = _run(small_cell(CELL))
    assert not out["correct"]
    assert out["checks"]["wrong_count"]["value"] > 0
    assert out["checks"]["lost_appends"]["value"] > 0


def test_a_traced_writing_run_reads_its_layer_metrics(small_cell):
    out = _run(small_cell(CELL), seconds=2.0, trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert {"table.merge_ms_per_query.append",
            "table.dispatch_self_ms_per_query.append",
            "planner.dispatch_ms_per_query.append",
            "device.idle_share.append"} <= set(m)
    # no kernel runs on the CPU: its roofline is left out, not 0
    assert "tier_scan_roofline" not in m


def test_the_base_only_control_is_not_correct(small_cell):
    from suffixbench import control
    cell = small_cell(CELL)
    ref = spec.load_module(os.path.join(spec.ROOT, cell.config["reference"]),
                           "suffixbench_reference")
    out = control.control(cell, ref, 5, 2000, 1.0, torch.device("cpu"))
    assert not out["correct"]
    assert out["latest_checks"]["wrong_count"]["value"] > 0
    assert out["patterns"] >= 2000


def test_spec_resolves_the_writing_cell():
    with pytest.raises(KeyError):
        spec.resolve(CELL)                 # held out of BENCHMARK.json
    c = spec.resolve(CELL, bench=bench_with_probes())
    assert c.traffic["loop"] == "append" and hasattr(c.loop.Traffic,
                                                     "appended")
    assert harness.table_options(c.config) == {
        "memtable_limit": 4194304, "max_runs": None, "group_commit_ms": 0}
    assert {m.name for m in c.end_to_end} == {
        "queries_per_s.append", "p95_ms.append", "serve_bytes_per_base",
        "setup_s"}
    assert {m.name for m in c.per_layer} == {
        "table.merge_ms_per_query.append",
        "table.dispatch_self_ms_per_query.append",
        "planner.dispatch_ms_per_query.append",
        "device.idle_share.append", "tier_scan_roofline"}


# what the read-only cells resolved to before the writing cell came
BEFORE = {
    "chr1-live.bulk500": (
        ["queries_per_s", "serve_bytes_per_base", "setup_s"],
        ["table.merge_ms_per_query", "planner.dispatch_ms_per_query",
         "table.ingest_s", "bounded_search_roofline", "device.idle_share",
         "table.range_min_ms_per_query", "table.merge_self_ms_per_query",
         "table.kmer_hit_share"]),
    "chr1-frozen.bulk100": (
        ["queries_per_s.frozen", "p95_ms.frozen", "ingest_s.frozen",
         "serve_bytes_per_base", "setup_s"],
        ["table.merge_ms_per_query.frozen",
         "planner.dispatch_ms_per_query.frozen", "fm_scan_roofline",
         "device.idle_share.frozen", "table.lf_walk_ms_per_query.frozen",
         "table.kmer_hit_share.frozen"]),
}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_read_only_cells_resolve_as_before(name):
    c = spec.resolve(name)
    e2e, per = BEFORE[name]
    assert [m.name for m in c.end_to_end] == e2e
    assert [m.name for m in c.per_layer] == per
    for m in c.end_to_end:
        assert m.reader.__file__ == os.path.join(spec.HERE, "end_to_end",
                                                 f"{m.name}.py")
    for m in c.per_layer:
        assert m.reader.__file__ == os.path.join(spec.HERE, "layer_metrics",
                                                 f"{m.name}.py")
    assert harness.table_options(c.config) == {}
    assert "trace_seconds" not in c.traffic


def test_table_options_are_limited():
    with pytest.raises(ValueError):
        harness.table_options({"table_options": {"keep_n": 9}})


def test_tier_references_are_the_program_tiers():
    """Each tier's suffix array, as the roofline rebuilds it from the
    reference's text and the stack's offset, end and rows, is the one
    the program stacks; and a launch over them counts its reads."""
    from repro_torch.api.table import SuffixTable
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, 3000).astype(np.uint8)
    t = SuffixTable.from_codes(base, is_dna=True, max_query_len=16,
                               device="cpu", memtable_limit=500)
    appended = rng.integers(0, 4, 1300).astype(np.uint8)
    for k in range(0, 1300, 100):
        t.append(appended[k:k + 100])
    tiers = t._tierset()
    st = tiers.stack
    ref = SuffixReference(torch.as_tensor(np.concatenate([base, appended])),
                          16)
    offsets, ends, rows = (st.offset.numpy(), st.hi.numpy(),
                           st.n_rows.numpy())
    assert tiers.num_tiers == 3
    for k in range(tiers.num_tiers):
        r = roofline._tier_reference(ref, int(offsets[k]), int(ends[k]),
                                     int(rows[k]))
        assert r.sa.tolist() == tiers.sa_host[k, :int(rows[k])].tolist()
    codes = rng.integers(0, 4, (40, 16)).astype(np.uint8)
    plen = rng.integers(1, 17, 40)
    n_bytes, n_ops = roofline.tier_traffic(ref, codes, plen, 1, offsets,
                                           ends, rows)
    assert n_bytes > 4 * 40 + 4 * 40 + 16 * 40 * 3 and n_ops > 0
