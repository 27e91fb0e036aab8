"""Durable tables in the port: the numpy-only checkpoint manager, the
catalog, ``create``/``open``/``flush``, frozen artifacts and the commit
log — and the compatibility rule that a table written by either package
opens in the other with equal counts, ``first_pos`` and ``locate``
(``device="cpu"``)."""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import SuffixTable as JTable  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro_torch.api import SuffixTable  # noqa: E402
from repro_torch.api.catalog import Catalog, table_wal_dir  # noqa: E402
from repro_torch.api.wal import HEADER_SIZE  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import codec as C, query as Q  # noqa: E402

CPU = "cpu"
PATS = Q.random_patterns(30, 1, 7, seed=3) + ["ACGT", "GATTACA", "TTTT"]


def _brute(text, pattern):
    p = C.encode_dna(pattern)
    k = len(p)
    return [i for i in range(len(text) - k + 1)
            if (text[i:i + k] == p).all()]


def _full_text(t) -> np.ndarray:
    parts = [np.asarray(t._codes)] + [np.asarray(r.codes) for r in t.runs]
    if t.memtable.size:
        parts.append(np.asarray(t.memtable.appended))
    return np.concatenate([p.astype(np.int64) for p in parts])


def _assert_same_reads(a, b, text, pats=PATS, top_k=5):
    x, y = a.scan(pats, top_k=top_k), b.scan(pats, top_k=top_k)
    for f in ("count", "first_pos", "positions"):
        np.testing.assert_array_equal(getattr(y, f), getattr(x, f), f)
    np.testing.assert_array_equal(b.locate(pats[:8], top_k=3),
                                  a.locate(pats[:8], top_k=3))
    for i, p in enumerate(pats):
        want = _brute(text, p)
        assert int(y.count[i]) == len(want), p
        assert int(y.first_pos[i]) == (want[0] if want else -1), p


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------
def test_manager_round_trip_and_reference_format(tmp_path):
    state = {"codes": C.random_dna(100, seed=1),
             "sa_real": np.arange(100, dtype=np.int32)[::-1].copy(),
             "run10_sa": np.arange(7, dtype=np.int32),
             "run2_tail": np.zeros(3, np.uint8),
             "mem_codes": np.zeros(0, np.uint8)}
    extra = {"kind": "suffix_table", "version": 3, "runs": [{"start": 1}]}
    mgr = CheckpointManager(str(tmp_path / "p"), keep_n=2)
    for step in (1, 2, 3):
        mgr.save(step, state, extra=extra)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    os.makedirs(tmp_path / "p" / "step_0000000009.tmp")   # never published
    assert mgr.latest_step() == 3
    jmgr = JManager(str(tmp_path / "j"), keep_n=2)
    jmgr.save(1, state, extra=extra)
    # both packages write and read the same files
    for d in ("p", "j"):
        for reader in (CheckpointManager(str(tmp_path / d)),
                       JManager(str(tmp_path / d))):
            step = reader.latest_step()
            arrays, got_extra = reader.restore_arrays(step)
            assert got_extra == extra
            assert list(arrays) == sorted(f"['{k}']" for k in state)
            for k, v in state.items():
                np.testing.assert_array_equal(arrays[f"['{k}']"], v)
                assert arrays[f"['{k}']"].dtype == v.dtype
    import json
    with open(tmp_path / "p" / "step_0000000003" / "meta.json") as f:
        mine = json.load(f)
    with open(tmp_path / "j" / "step_0000000001" / "meta.json") as f:
        ref = json.load(f)
    assert mine["paths"] == ref["paths"]


# ---------------------------------------------------------------------------
# a table written by either package opens in the other
# ---------------------------------------------------------------------------
def _write(pkg, state, root):
    """Write table "t" in ``state`` with package ``pkg``; returns the
    writer and the logical text."""
    base = C.random_dna(1500, seed=7)
    kw = dict(root=str(root), is_dna=True, max_query_len=24,
              memtable_limit=300)
    if pkg == "torch":
        t = SuffixTable.create("t", base, device=CPU, **kw)
    else:
        t = JTable.create("t", base, **kw)
    text = base
    chunks = [C.random_dna(n, seed=8 + n) for n in (200, 160, 90)]
    if state == "frozen":
        t.freeze(sample_rate=8)
    if state != "live":
        for c in chunks:
            t.append(c)
            text = np.concatenate([text, c])
    if state in ("runs", "frozen"):
        assert len(t.runs) == 1 and t.memtable.size == 90
        t.flush()
    if state == "compacted":
        assert t.compact() == 2
    # "wal_tail": the last append (after the seal) is only in the log
    return t, text


@pytest.mark.parametrize("state", ["live", "runs", "frozen", "compacted",
                                   "wal_tail"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_table_opens_in_the_other_package(tmp_path, writer, state):
    t, text = _write(writer, state, tmp_path)
    if writer == "torch":
        other = JTable.open("t", root=str(tmp_path))
    else:
        other = SuffixTable.open("t", root=str(tmp_path), device=CPU)
    assert other.version == t.version
    assert (len(other.runs), other.memtable.size, other.n_base) == \
        (len(t.runs), t.memtable.size, t.n_base)
    assert other.is_frozen == t.is_frozen == (state == "frozen")
    np.testing.assert_array_equal(_full_text(other), text)
    _assert_same_reads(t, other, text)
    if state == "frozen":       # the artifact itself loads, not a rebuild
        from repro.api.fm import FMIndex as JFM
        from repro_torch.api.catalog import table_fm_dir
        from repro_torch.api.fm import FMIndex
        fm_dir = table_fm_dir(str(tmp_path), "t")
        for fm in (FMIndex.load(fm_dir, device=CPU), JFM.load(fm_dir)):
            np.testing.assert_array_equal(np.asarray(fm.bwt),
                                          np.asarray(t.fm.bwt))
            np.testing.assert_array_equal(fm.samples, t.fm.samples)
    rec = other.stats()["wal"]["recovery"]
    if state == "wal_tail":
        assert rec["records_replayed"] == 1 and rec["reason"] == "clean"


def test_flush_open_compact_round_trip(tmp_path):
    """The port on its own: runs + memtable restored by ``open``, then a
    major compaction of the reopened table, then another open."""
    base = C.random_dna(1200, seed=5)
    root = str(tmp_path)
    t = SuffixTable.create("lsm", base, root=root, device=CPU)
    text = base
    for s in range(2):
        app = C.random_dna(100, seed=90 + s)
        t.append(app)
        text = np.concatenate([text, app])
        t.minor_compact()                  # publishes the sealed run
    tail = C.random_dna(60, seed=99)
    t.append(tail)
    text = np.concatenate([text, tail])
    t.flush()
    assert t.is_persistent and t.stats()["version"] == 1
    t2 = SuffixTable.open("lsm", root=root, device=CPU)
    assert len(t2.runs) == 2 and t2.memtable.size == 60
    _assert_same_reads(t, t2, text)
    assert t2.compact() == 2 and not t2.runs
    t3 = SuffixTable.open("lsm", root=root, device=CPU)
    assert t3.version == 2 and t3.n_base == len(text) and not t3.runs
    _assert_same_reads(t2, t3, text)
    with pytest.raises(RuntimeError):
        SuffixTable.from_codes(base, device=CPU).flush()


def test_create_registration_is_crash_safe(tmp_path):
    codes = C.random_dna(300, seed=10)
    root = str(tmp_path)
    os.makedirs(tmp_path / "crashed" / "step_0000000001.tmp")
    assert SuffixTable.create("crashed", codes, root=root,
                              device=CPU).version == 1
    assert SuffixTable.open("crashed", root=root,
                            device=CPU).count(["ACGT"])[0] >= 0

    class _Boom(RuntimeError):
        pass

    orig = SuffixTable._persist
    try:
        def boom(self):
            raise _Boom()
        SuffixTable._persist = boom
        with pytest.raises(_Boom):
            SuffixTable.create("half", codes, root=root, device=CPU)
    finally:
        SuffixTable._persist = orig
    assert "half" in Catalog(root, reconcile=False).list_tables()
    assert "half" in Catalog(root, reconcile=False).reconcile()
    assert "half" not in Catalog(root).list_tables()
    assert SuffixTable.create("half", codes, root=root,
                              device=CPU).version == 1
    with pytest.raises(FileExistsError):
        SuffixTable.create("half", codes, root=root, device=CPU)
    # the staged build is chosen by any of its options, as in the
    # reference, and gives the in-memory build's SA
    want = SuffixTable.open("half", root=root, device=CPU).store
    for kw in ({"staged": True}, {"max_device_bytes": 1 << 20},
               {"spill_dir": os.path.join(root, "spill")}):
        x = SuffixTable.create("x", codes, root=root, device=CPU,
                               overwrite=True, **kw)
        assert x.stats()["build"]["mode"] == "staged"
        assert torch.equal(x.store.sa, want.sa)
        x.close()
    cat = Catalog(root)
    cat.drop_table("half")
    assert "half" not in cat.list_tables()
    assert not os.path.exists(os.path.join(root, "half"))


# ---------------------------------------------------------------------------
# the commit log: acked appends survive a crash
# ---------------------------------------------------------------------------
def _crash_copy(root, dst) -> str:
    """The disk at crash time: the live table object is abandoned."""
    shutil.copytree(str(root), str(dst))
    return str(dst)


@pytest.mark.parametrize("seed", [0, 1])
def test_crash_recovers_acked_appends_over_random_schedule(tmp_path, seed):
    rng = np.random.default_rng(seed)
    base = C.random_dna(600, seed=seed)
    root = tmp_path / "root"
    t = SuffixTable.create("t", base, root=str(root), max_query_len=16,
                           device=CPU)
    acked = [np.asarray(base, np.int64)]
    for _ in range(12):
        op = rng.choice(["append", "append", "append", "minor", "major"])
        if op == "append":
            chunk = C.random_dna(int(rng.integers(1, 40)),
                                 seed=int(rng.integers(1 << 30)))
            t.append(chunk)                  # returns == acked durable
            acked.append(np.asarray(chunk, np.int64))
        elif op == "minor":
            t.minor_compact()
        else:
            t.compact()
    acked = np.concatenate(acked)
    crash = _crash_copy(root, tmp_path / f"crash{seed}")
    for reopen in (lambda: SuffixTable.open("t", root=crash, device=CPU),
                   lambda: JTable.open("t", root=_crash_copy(
                       root, tmp_path / f"jcrash{seed}"))):
        t2 = reopen()
        np.testing.assert_array_equal(_full_text(t2), acked)
        _assert_same_reads(t, t2, acked.astype(np.uint8),
                           ["ACGT", "GATTACA", "TT", "CCG"])
        rec = t2.stats()["wal"]["recovery"]
        assert rec is None or rec["reason"] == "clean"


def test_torn_tail_record_is_discarded_whole(tmp_path):
    base = C.random_dna(300, seed=7)
    root = tmp_path / "root"
    t = SuffixTable.create("t", base, root=str(root), max_query_len=16,
                           device=CPU)
    chunks = [C.random_dna(n, seed=50 + n) for n in (6, 11, 3)]
    for c in chunks:
        t.append(c)
    path = os.path.join(table_wal_dir(str(root), "t"), "wal.log")
    size = os.path.getsize(path)
    crash = _crash_copy(root, tmp_path / "cut")
    with open(os.path.join(table_wal_dir(crash, "t"), "wal.log"),
              "r+b") as f:
        f.truncate(size - 2)                 # the last record is torn
    t2 = SuffixTable.open("t", root=crash, device=CPU)
    want = np.concatenate([base] + chunks[:2]).astype(np.int64)
    np.testing.assert_array_equal(_full_text(t2), want)
    rec = t2.stats()["wal"]["recovery"]
    assert rec["records_replayed"] == 2 and rec["reason"] != "clean"


def test_replay_respects_memtable_limit_after_recovery(tmp_path):
    root = str(tmp_path / "root")
    t = SuffixTable.create("t", C.random_dna(300, seed=23), root=root,
                           max_query_len=16, device=CPU)
    for i in range(4):
        t.append(C.random_dna(30, seed=30 + i))
    assert t.stats()["wal"]["seq"] == 4
    crash = _crash_copy(root, tmp_path / "crash")
    t2 = SuffixTable.open("t", root=crash, memtable_limit=100, device=CPU)
    assert t2.memtable.size == 0 and len(t2.runs) == 1
    assert len(t2) == 300 + 120
    assert os.path.getsize(os.path.join(table_wal_dir(crash, "t"),
                                        "wal.log")) == HEADER_SIZE
    t3 = SuffixTable.open("t", root=_crash_copy(crash, tmp_path / "c2"),
                          memtable_limit=100, device=CPU)
    assert len(t3) == 420
    t3.close()
    with pytest.raises(RuntimeError):
        t3.append("ACGT")
