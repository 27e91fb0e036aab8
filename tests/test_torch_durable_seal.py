"""A seal drops nothing that is not on disk: when an append fills the
memtable (or ``compact()`` folds it), the commit-log segment that held
its record and the snapshot that takes its place are fsync'd before the
fresh segment is renamed over the log, and a frozen table's FM artifact
with them, once.  The base-only snapshots of ``create_table`` and of a
``freeze`` before any append fsync nothing of theirs.  Across two seals
every read equals the plain reference at the text length it was sent
over, and a reopen reads every acknowledged append back.

``os.fsync``, ``os.replace`` and ``os.rename`` are wrapped to log, in
order, what each one touched (small tables, ``device="cpu"``)."""
import os

import numpy as np
import pytest
import torch

from repro_torch.api import Database, Query, SuffixTable
from repro_torch.api.catalog import table_fm_dir, table_wal_dir
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import query as Q
from repro_torch.core.codec import decode_dna, encode_dna

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MQ = 32
LIMIT = 600                       # the memtable seals every 4th append
READ = 150
BASE = np.random.default_rng(5).integers(0, 4, 3000).astype(np.uint8)


class Disk:
    """The fsyncs (path, inode) and renames (destination) of this
    process, in order."""

    def __init__(self, monkeypatch):
        self.events = []
        fsync, replace, rename = os.fsync, os.replace, os.rename

        def logged_fsync(fd):
            fsync(fd)
            self.events.append(("fsync", os.readlink(f"/proc/self/fd/{fd}"),
                                os.fstat(fd).st_ino))

        def logged(kind, inner):
            def move(src, dst, *a, **kw):
                inner(src, dst, *a, **kw)
                self.events.append((kind, os.fspath(dst), None))
            return move
        monkeypatch.setattr(os, "fsync", logged_fsync)
        monkeypatch.setattr(os, "replace", logged("replace", replace))
        monkeypatch.setattr(os, "rename", logged("rename", rename))

    def clear(self) -> None:
        self.events.clear()

    def fsynced(self) -> list:
        return [(p, i) for kind, p, i in self.events if kind == "fsync"]

    def index(self, kind: str, dst: str) -> int:
        """Where the last ``kind`` onto ``dst`` happened."""
        hits = [k for k, (kd, p, _i) in enumerate(self.events)
                if kd == kind and p == dst]
        assert hits, (kind, dst, self.events)
        return hits[-1]

    def fsync_of(self, ino: int, before: int, after: int = -1) -> bool:
        return any(kd == "fsync" and i == ino
                   for kd, _p, i in self.events[after + 1:before])


@pytest.fixture
def disk(monkeypatch):
    return Disk(monkeypatch)


def _latest_step(directory: str) -> str:
    step = CheckpointManager(directory).latest_step()
    return os.path.join(directory, f"step_{step:010d}")


def _step_inodes(step_dir: str) -> dict:
    out = {f: os.stat(os.path.join(step_dir, f)).st_ino
           for f in os.listdir(step_dir)}
    out["."] = os.stat(step_dir).st_ino
    return out


def _read(i: int) -> np.ndarray:
    """Appended read ``i``: 150 bases of the base, 1% substituted."""
    rng = np.random.default_rng(100 + i)
    at = int(rng.integers(0, BASE.size - READ))
    read = BASE[at:at + READ].copy()
    sub = rng.random(READ) < 0.01
    read[sub] = (read[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    return read


def _table(root: str, frozen: bool) -> SuffixTable:
    t = SuffixTable.create("t", BASE, root=root, is_dna=True,
                           max_query_len=MQ, memtable_limit=LIMIT,
                           device=CPU)
    if frozen:
        t.freeze(sample_rate=4)
    return t


def _check_sealed(disk, root: str, seg_ino: int, frozen_files=None):
    """The retired segment ``seg_ino`` and the newest snapshot (files,
    step directory; the table directory after the step's rename) are
    fsync'd before the fresh segment's rename, and ``frozen_files``
    (inodes) too."""
    table_dir = os.path.join(root, "t")
    swap = disk.index("replace", os.path.join(table_wal_dir(root, "t"),
                                              "wal.log"))
    step = _latest_step(table_dir)
    publish = disk.index("rename", step)
    assert publish < swap
    assert disk.fsync_of(seg_ino, before=swap)
    for name, ino in _step_inodes(step).items():
        assert disk.fsync_of(ino, before=publish), name
    assert disk.fsync_of(os.stat(table_dir).st_ino, before=swap,
                         after=publish)
    for ino in frozen_files or ():
        assert disk.fsync_of(ino, before=publish)


@pytest.mark.parametrize("frozen", [False, True])
def test_a_sealing_append_syncs_its_record_and_snapshot_first(
        tmp_path, disk, frozen):
    root = str(tmp_path)
    t = _table(root, frozen)
    wal = os.path.join(table_wal_dir(root, "t"), "wal.log")
    fm_files = (set(_step_inodes(_latest_step(table_fm_dir(root, "t")))
                    .values()) | {os.stat(table_fm_dir(root, "t")).st_ino}
                if frozen else set())
    for seal in range(2):
        for i in range(4 * seal, 4 * seal + 3):
            t.append(_read(i))
        assert not t.runs[seal:]
        seg_ino = os.stat(wal).st_ino
        disk.clear()
        t.append(_read(4 * seal + 3))
        assert len(t.runs) == seal + 1
        # the FM artifact is synced with the first seal only
        _check_sealed(disk, root, seg_ino, fm_files if seal == 0 else None)
        if seal:
            assert not fm_files & {i for _p, i in disk.fsynced()}
        log = t.stats()["wal"]["log"]
        assert log["acked"] == log["fsyncs"] == 4 * seal + 4
    t.close()


@pytest.mark.parametrize("frozen", [False, True])
def test_compact_syncs_its_snapshot_before_the_log_is_sealed(
        tmp_path, disk, frozen):
    root = str(tmp_path)
    t = _table(root, frozen)
    wal = os.path.join(table_wal_dir(root, "t"), "wal.log")
    seg_ino = os.stat(wal).st_ino
    disk.clear()
    for i in range(3):
        t.append(_read(i))
    assert t.compact() == 2
    # compaction's own snapshot, then (frozen) the re-freeze's, each
    # durable: the newest one on disk is the one that opens
    _check_sealed(disk, root, seg_ino)
    if frozen:
        fm_step = _latest_step(table_fm_dir(root, "t"))
        swap = disk.index("replace", wal)
        for name, ino in _step_inodes(fm_step).items():
            assert disk.fsync_of(ino, before=swap), name
    t.close()
    again = SuffixTable.open("t", root=root, device=CPU)
    assert len(again) == BASE.size + 3 * READ and again.is_frozen == frozen
    again.close()


def test_a_durable_save_syncs_its_step_and_a_sharded_commit_none(
        tmp_path, disk):
    """``save(durable=True)`` fsyncs the step's files and directory
    before the rename and the checkpoint directory after it; the staged
    build's ``ShardedSave.commit`` publishes through the same rename
    with no fsync (no caller promises a durable base-only table)."""
    mgr = CheckpointManager(str(tmp_path / "c"))
    state = {"codes": np.arange(10, dtype=np.uint8)}
    real = os.rename
    staged = {}

    def spy(src, dst, *a, **kw):       # the step's inodes, just before
        if os.path.basename(os.fspath(dst)).startswith("step_"):
            staged.update(_step_inodes(os.fspath(src)))
        return real(src, dst, *a, **kw)
    disk.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "rename", spy)
        final = mgr.save(1, state, {"kind": "test"}, durable=True)
    publish = disk.index("rename", final)
    assert set(staged) == {"arrays.npz", "meta.json", "."}
    for name, ino in staged.items():
        assert disk.fsync_of(ino, before=publish), name
    assert disk.fsync_of(os.stat(mgr.dir).st_ino, before=len(disk.events),
                         after=publish)
    assert mgr.synced_bytes > 0 and mgr.synced_ms >= 0

    stage = mgr.stage_sharded(2)
    for i in range(2):
        stage.add_shard("sa_real", i, np.arange(5, dtype=np.int32) + i)
    disk.clear()
    final = stage.commit(state, {"kind": "test"})
    assert disk.fsynced() == [] and disk.index("rename", final) >= 0
    arrays, _extra = mgr.restore_arrays(2)
    assert arrays["['sa_real']"].tolist() == [0, 1, 2, 3, 4, 1, 2, 3, 4, 5]


def test_create_and_freeze_sync_no_snapshot(tmp_path, disk):
    """The read-only cells' set-up: the base-only snapshots of
    ``create_table`` and ``freeze`` are written with no fsync (only the
    commit log's fresh segments and their directory are), and a read
    fsyncs nothing."""
    root = str(tmp_path)
    db = Database(root, device=CPU)
    db.create_table("t", BASE, is_dna=True, max_query_len=MQ)
    db.freeze("t", sample_rate=4)
    wal_dir = os.path.realpath(table_wal_dir(root, "t"))
    paths = {p for p, _i in disk.fsynced()}
    assert paths and paths <= {wal_dir, os.path.join(wal_dir,
                                                     "wal.log.new")}
    table = db.table("t")
    assert table.tracer.snapshot().get("snapshot_sync") is None
    disk.clear()
    _query(db, ["ACG", decode_dna(BASE[7:39])])
    assert disk.fsynced() == []
    db.close()


def _reference(text: np.ndarray, n_fixed: int):
    from importlib import util
    path = os.path.join(ROOT, "suffixbench", "reference", "suffix_array.py")
    spec = util.spec_from_file_location("suffixbench_reference_seal", path)
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SuffixReference(torch.from_numpy(text), MQ, n_fixed=n_fixed)


def _patterns(appended: list, i: int) -> list[str]:
    """Uniform patterns and cuts of the newest appended read (found in
    the appends, and across a run's edge)."""
    rng = np.random.default_rng(900 + i)
    pats = Q.random_patterns(12, 1, 20, seed=900 + i)
    for _ in range(6):
        src = appended[-1 - int(rng.integers(0, min(3, len(appended))))]
        lo = int(rng.integers(0, READ - 24))
        pats.append(decode_dna(src[lo:lo + int(rng.integers(1, 25))]))
    return pats


def _query(db, pats):
    """A pre-encoded batch (packed words as ``uint32``) through
    ``Database.query``, as the benchmark sends one."""
    _, words, lens = Q.encode_patterns(pats, MQ, device=CPU)
    res = db.query(Query(table="t", kind="scan",
                         codes=words.view(torch.int32).numpy().view(
                             np.uint32),
                         lens=lens.numpy()))
    assert res.ok
    return res


def test_reads_across_two_seals_match_the_reference_and_survive_reopen(
        tmp_path):
    root = str(tmp_path)
    db = Database(root, device=CPU)
    db.create_table("t", BASE, is_dna=True, max_query_len=MQ,
                    memtable_limit=LIMIT)
    appended, reads = [], []
    for i in range(10):                    # seals after the 4th and 8th
        db.append("t", _read(i))
        appended.append(_read(i))
        pats = _patterns(appended, i)
        n_visible = BASE.size + READ * len(appended)
        reads.append((pats, n_visible, _query(db, pats)))
    assert len(db.table("t").runs) == 2
    db.close()
    text = np.concatenate([BASE] + appended)
    ref = _reference(text, BASE.size)
    for pats, n_visible, res in reads:
        codes = np.zeros((len(pats), MQ), np.uint8)
        for k, p in enumerate(pats):
            codes[k, :len(p)] = encode_dna(p)
        plen = np.array([len(p) for p in pats], np.int64)
        count, first = ref.answer(torch.from_numpy(codes),
                                  torch.from_numpy(plen),
                                  np.full(len(pats), n_visible))
        np.testing.assert_array_equal(res.count, count)
        np.testing.assert_array_equal(res.first_pos, first)
        np.testing.assert_array_equal(res.found, count > 0)
    again = Database(root, device=CPU, memtable_limit=LIMIT)
    assert len(again.table("t")) == text.size
    pats = reads[-1][0]
    res = _query(again, pats)
    np.testing.assert_array_equal(res.count, reads[-1][2].count)
    np.testing.assert_array_equal(res.first_pos, reads[-1][2].first_pos)
    again.close()
