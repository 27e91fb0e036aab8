"""The staged out-of-core build in the port (``repro_torch.core.
build_pipeline``, ``dsort.merge_sorted_runs``, ``ShardedSave``,
``SuffixTable.create(staged=True)``) against ``repro`` at
``tests/test_build_pipeline.py``'s sizes, ``device="cpu"``: every
suffix array, shard, stats record and snapshot must be EQUAL to the
reference's (integers, so ``array_equal``)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api.table import SuffixTable as JTable  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core.build_pipeline import staged_suffix_array as j_staged  # noqa: E402
from repro.core.dsort import merge_sorted_runs as j_merge  # noqa: E402
from repro.core.suffix_array import build_suffix_array as j_build  # noqa: E402
from repro_torch.api import SuffixTable  # noqa: E402
from repro_torch.api.catalog import Catalog  # noqa: E402
from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: E402
                                            ShardedSave)
from repro_torch.core import build_pipeline as BP  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core.dsort import merge_sorted_runs  # noqa: E402
from repro_torch.core.suffix_array import (  # noqa: E402
    build_suffix_array, build_suffix_array_staged)
from repro_torch.launch.mesh import make_tablet_mesh  # noqa: E402

CPU = "cpu"
TIMING = ("elapsed_s", "bases_per_s")


def _ref(codes):
    return np.asarray(j_build(np.asarray(codes, np.int32)))


def _same_stats(port, ref):
    a, b = port.to_dict(), ref.to_dict()
    for k in TIMING:
        a.pop(k), b.pop(k)
    assert a == b


def _sa(table):
    return table.store.sa[table.store.pad_count:].numpy()


def _jsa(table):
    return np.asarray(table.store.sa)[table.store.pad_count:]


# --------------------------------------------------------------------------
# merge_sorted_runs
# --------------------------------------------------------------------------
class _ArrRun:
    def __init__(self, key, idx):
        self.n = len(key)
        self._k, self._i = key, idx

    def read_block(self, lo, hi):
        return self._k[lo:hi], self._i[lo:hi]


@pytest.mark.parametrize("n,k,block", [(5000, 7, 64), (3000, 3, 1000),
                                       (800, 12, 17)])
def test_merge_sorted_runs_matches_lexsort_and_reference(n, k, block):
    rng = np.random.default_rng(n)
    key = rng.integers(0, 50, size=n).astype(np.int64)   # heavy key ties
    idx = rng.permutation(n).astype(np.int32)            # unique tiebreak
    order = np.lexsort((idx, key))
    cuts = np.sort(rng.choice(np.arange(1, n), size=k - 1, replace=False))
    runs = []
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, n]):
        seg = np.lexsort((idx[lo:hi], key[lo:hi]))
        runs.append(_ArrRun(key[lo:hi][seg], idx[lo:hi][seg]))
    got = list(merge_sorted_runs(runs, block_rows=block))
    want = list(j_merge(runs, block_rows=block))
    assert len(got) == len(want)                 # the same blocks
    for (gk, gi), (wk, wi) in zip(got, want):
        assert np.array_equal(gk, wk) and np.array_equal(gi, wi)
    assert np.array_equal(np.concatenate([b for b, _ in got]), key[order])
    assert np.array_equal(np.concatenate([i for _, i in got]), idx[order])


def test_merge_single_and_empty_runs():
    key = np.arange(100, dtype=np.int64)
    idx = np.arange(100, dtype=np.int32)
    blocks = list(merge_sorted_runs(
        [_ArrRun(key, idx), _ArrRun(key[:0], idx[:0])], block_rows=17))
    assert [len(b) for b, _ in blocks] == [17] * 5 + [15]
    assert np.array_equal(np.concatenate([b for b, _ in blocks]), key)
    assert list(merge_sorted_runs([_ArrRun(key[:0], idx[:0])])) == []
    assert list(merge_sorted_runs([])) == []


# --------------------------------------------------------------------------
# the staged SA: a sweep of sizes, chunk sizes and corpus kinds
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,chunk_rows,dna,seed", [
    (2, 256, True, 0), (257, 256, True, 1), (1000, 256, False, 2),
    (4000, 512, True, 3), (3000, 2048, False, 4), (2500, 300, True, 5),
])
def test_staged_sa_and_stats_equal_reference(n, chunk_rows, dna, seed):
    rng = np.random.default_rng(seed)
    if dna:
        codes = C.random_dna(n, seed=seed)
    else:
        codes = rng.integers(0, 1 + int(rng.integers(1, 5000)),
                             size=n).astype(np.int32)
    sa, stats = BP.staged_suffix_array(codes, chunk_rows=chunk_rows,
                                       device=CPU)
    jsa, jstats = j_staged(codes, chunk_rows=chunk_rows)
    assert sa.dtype == np.int32
    assert np.array_equal(sa, jsa) and np.array_equal(sa, _ref(codes))
    assert np.array_equal(sa, build_suffix_array(codes).numpy())
    _same_stats(stats, jstats)
    assert stats.n_chunks == -(-n // chunk_rows) and stats.spill_bytes == 0


def test_staged_spill_to_disk_equal_and_cleaned(tmp_path):
    codes = C.random_dna(20_000, seed=1)
    spill = tmp_path / "spill"
    sa, stats = BP.staged_suffix_array(codes, chunk_rows=777,
                                       spill_dir=str(spill), device=CPU)
    jsa, jstats = j_staged(codes, chunk_rows=777,
                           spill_dir=str(tmp_path / "jspill"))
    assert np.array_equal(sa, jsa)
    assert stats.spill_bytes > 0
    _same_stats(stats, jstats)             # spill_bytes counted alike
    assert os.listdir(spill) == []


def test_staged_emit_shard_streaming():
    codes = C.random_dna(5000, seed=2)
    got, want = [], []
    sa, _ = BP.staged_suffix_array(
        codes, chunk_rows=512, shard_rows=900, device=CPU,
        emit_shard=lambda i, blk: got.append((i, blk.copy())))
    j_staged(codes, chunk_rows=512, shard_rows=900,
             emit_shard=lambda i, blk: want.append((i, blk.copy())))
    assert sa is None
    assert [i for i, _ in got] == [i for i, _ in want] == list(
        range(len(got)))
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    assert [len(b) for _, b in got] == [900] * 5 + [500]


def test_staged_edge_sizes():
    for n in (0, 1, 2, 3, BP.MIN_CHUNK_ROWS, BP.MIN_CHUNK_ROWS + 1):
        codes = C.random_dna(n, seed=n)
        sa, st = BP.staged_suffix_array(codes, chunk_rows=BP.MIN_CHUNK_ROWS,
                                        device=CPU)
        jsa, jst = j_staged(codes, chunk_rows=BP.MIN_CHUNK_ROWS)
        assert np.array_equal(sa, jsa), n
        _same_stats(st, jst)
        shards = []
        BP.staged_suffix_array(codes, chunk_rows=BP.MIN_CHUNK_ROWS,
                               device=CPU, emit_shard=lambda i, b:
                               shards.append(b))
        assert len(shards) == min(n, 1) + (n > BP.MIN_CHUNK_ROWS)
    # constant text: maximal ties, saturation only at the last round
    const = np.zeros(1000, np.uint8)
    sa, st = BP.staged_suffix_array(const, chunk_rows=BP.MIN_CHUNK_ROWS,
                                    device=CPU)
    jsa, jst = j_staged(const, chunk_rows=BP.MIN_CHUNK_ROWS)
    assert np.array_equal(sa, jsa)
    _same_stats(st, jst)
    # wrapper spelling
    assert np.array_equal(build_suffix_array_staged(
        const, chunk_rows=BP.MIN_CHUNK_ROWS, device=CPU), sa)


def test_budget_math_and_device_sort_rows():
    assert BP.chunk_rows_for_budget(None) == BP.DEFAULT_CHUNK_ROWS
    assert BP.chunk_rows_for_budget(10 * BP.BYTES_PER_ROW) == \
        BP.MIN_CHUNK_ROWS
    assert BP.chunk_rows_for_budget(100_000) == 100_000 // BP.BYTES_PER_ROW
    _, stats = BP.staged_suffix_array(
        C.random_dna(4000, seed=3), device=CPU,
        max_device_bytes=BP.MIN_CHUNK_ROWS * BP.BYTES_PER_ROW)
    assert stats.chunk_rows == BP.MIN_CHUNK_ROWS
    assert stats.peak_device_bytes == BP.MIN_CHUNK_ROWS * BP.BYTES_PER_ROW
    # a CPU sort, or one without a budget, takes the whole chunk; a CUDA
    # sort under a budget what fits it at the measured footprint (no card
    # is needed to size it)
    cuda = torch.device("cuda")
    assert BP.device_sort_rows(4096, 1 << 20, torch.device("cpu")) == 4096
    budget = 100_663_296
    rows = BP.device_sort_rows(BP.chunk_rows_for_budget(budget), budget,
                               cuda)
    assert rows * BP.SORT_BYTES_PER_ROW + BP.SORT_FIXED_BYTES <= budget
    assert (rows + 1) * BP.SORT_BYTES_PER_ROW + BP.SORT_FIXED_BYTES > budget
    assert BP.device_sort_rows(1 << 16, None, cuda) == 1 << 16
    assert BP.device_sort_rows(256, None, cuda) == 256
    least = BP.MIN_CHUNK_ROWS * BP.SORT_BYTES_PER_ROW + BP.SORT_FIXED_BYTES
    assert BP.device_sort_rows(1 << 16, least, cuda) == BP.MIN_CHUNK_ROWS
    for small in (1000, 100_000, 1 << 20, least - 1):
        with pytest.raises(ValueError, match="max_device_bytes"):
            BP.device_sort_rows(300, small, cuda)


def test_sub_chunk_runs_keep_the_sa(monkeypatch):
    """Several sorted runs per chunk (what a CUDA budget below the sort's
    footprint gives) merge to the same SA, rounds and chunks."""
    codes = C.random_dna(6000, seed=8)
    jsa, jst = j_staged(codes, chunk_rows=1024)
    for rows in (1000, 333, 256):
        monkeypatch.setattr(BP, "device_sort_rows",
                            lambda c, b, d, _r=rows: _r)
        sa, st = BP.staged_suffix_array(codes, chunk_rows=1024, device=CPU)
        assert np.array_equal(sa, jsa), rows
        assert (st.rounds, st.n_chunks, st.chunk_rows) == (
            jst.rounds, jst.n_chunks, jst.chunk_rows)


def test_mesh_sort_rows_budget_math():
    """A tablet of a mesh sort takes the whole chunk on the CPU or
    without a budget; on CUDA what fits the budget on the card holding
    the most tablets (no card is needed to size it)."""
    from repro_torch.launch.mesh import TabletMesh
    cpu8 = make_tablet_mesh(8, device=CPU)
    assert BP.mesh_sort_rows(4096, 1 << 20, cpu8) == 4096
    one_card = TabletMesh(devices=(torch.device("cuda", 0),) * 8)
    two_cards = TabletMesh(devices=tuple(torch.device("cuda", d % 2)
                                         for d in range(8)))
    assert BP.mesh_sort_rows(1 << 16, None, one_card) == 1 << 16
    budget = 64 << 20
    for mesh, k in ((one_card, 8), (two_cards, 4)):
        rows = BP.mesh_sort_rows(1 << 30, budget, mesh)
        assert k * (rows * BP.MESH_SORT_BYTES_PER_ROW
                    + BP.MESH_SORT_FIXED_BYTES) <= budget
        assert k * ((rows + 1) * BP.MESH_SORT_BYTES_PER_ROW
                    + BP.MESH_SORT_FIXED_BYTES) > budget
        assert BP.mesh_sort_rows(300, budget, mesh) == 300
        least = k * (BP.MIN_CHUNK_ROWS * BP.MESH_SORT_BYTES_PER_ROW
                     + BP.MESH_SORT_FIXED_BYTES)
        assert BP.mesh_sort_rows(1 << 16, least, mesh) == BP.MIN_CHUNK_ROWS
        with pytest.raises(ValueError, match="max_device_bytes"):
            BP.mesh_sort_rows(1 << 16, least - 1, mesh)
    assert BP.mesh_sort_rows(1 << 30, budget, two_cards) > \
        BP.mesh_sort_rows(1 << 30, budget, one_card)


def test_mesh_sub_chunk_sorts_keep_the_sa(monkeypatch):
    """Super-chunks of fewer rows a tablet than ``chunk_rows`` (what a
    CUDA budget gives on a mesh) merge to the reference's SA, rounds and
    chunks."""
    codes = C.random_dna(5000, seed=12)
    jsa, jst = j_staged(codes, chunk_rows=512)
    mesh = make_tablet_mesh(8, device=CPU)
    for rows in (300, 256):
        monkeypatch.setattr(BP, "mesh_sort_rows",
                            lambda c, b, m, _r=rows: _r)
        sa, st = BP.staged_suffix_array(codes, chunk_rows=512, mesh=mesh,
                                        device=CPU)
        assert np.array_equal(sa, jsa), rows
        assert (st.rounds, st.n_chunks, st.chunk_rows) == (
            jst.rounds, jst.n_chunks, jst.chunk_rows)


def test_mesh_raises(tmp_path):
    """The staged build's mesh path (one ``make_superchunk_sorter`` sort
    per super-chunk of 8 x 256 rows) gives the reference's SA, rounds and
    chunks (the reference's own 8-device run is held in
    ``tests/test_torch_distributed.py``); constructors take no mesh."""
    codes = C.random_dna(3000, seed=11)
    jsa, jst = j_staged(codes, chunk_rows=256)
    mesh = make_tablet_mesh(8, device=CPU)
    for method in ("sample", "bitonic"):
        sa, st = BP.staged_suffix_array(codes, chunk_rows=256, mesh=mesh,
                                        method=method, device=CPU)
        assert np.array_equal(sa, jsa) and np.array_equal(sa, _ref(codes))
        assert (st.rounds, st.n_chunks, st.chunk_rows,
                st.peak_device_bytes) == (jst.rounds, jst.n_chunks,
                                          jst.chunk_rows, 256 * 24)
    with pytest.raises(TypeError):
        SuffixTable.create("m", C.random_dna(100), root=str(tmp_path),
                           staged=True, mesh=object(), device=CPU)


# --------------------------------------------------------------------------
# staged create -> open -> stats, in both packages
# --------------------------------------------------------------------------
def test_staged_create_equal_to_reference(tmp_path):
    codes = C.random_dna(12_000, seed=4)
    kw = dict(build_chunk_rows=1024)
    t = SuffixTable.create("g", codes, root=str(tmp_path / "p"),
                           spill_dir=str(tmp_path / "ps"), device=CPU, **kw)
    jt = JTable.create("g", codes, root=str(tmp_path / "j"),
                       spill_dir=str(tmp_path / "js"), **kw)
    assert np.array_equal(_sa(t), _jsa(jt))
    assert np.array_equal(_sa(t), _ref(codes))
    b, jb = t.stats()["build"], jt.stats()["build"]
    assert b["mode"] == "staged" and b["spill_bytes"] > 0
    assert {k: v for k, v in b.items() if k not in TIMING} == \
        {k: v for k, v in jb.items() if k not in TIMING}
    assert b["bases_per_s"] > 0
    assert os.listdir(tmp_path / "ps") == []
    # the snapshot is the streamed-shard kind, file for file
    step = CheckpointManager(str(tmp_path / "p" / "g")).latest_step()
    names = sorted(os.listdir(tmp_path / "p" / "g" / f"step_{step:010d}"))
    jstep = JManager(str(tmp_path / "j" / "g")).latest_step()
    assert step == jstep == 1
    assert names == sorted(os.listdir(
        tmp_path / "j" / "g" / f"step_{jstep:010d}"))
    assert "shard_sa_real_000011.npy" in names
    pats = ["ACGT", "GATTACA", "A", "TTTTT", "CG"]
    a, j = t.scan(pats, top_k=4), jt.scan(pats, top_k=4)
    for f in ("count", "first_pos", "positions"):
        assert np.array_equal(getattr(a, f), getattr(j, f)), f
    t.append("GATTACA")
    jt.append("GATTACA")
    assert int(t.count(["GATTACA"])[0]) == int(jt.count(["GATTACA"])[0])
    t.close(), jt.close()
    # reopen restores the same SA, the persisted build record and the
    # logged append
    t2 = SuffixTable.open("g", root=str(tmp_path / "p"), device=CPU)
    assert np.array_equal(_sa(t2), _ref(codes))
    assert t2.stats()["build"] == b
    assert t2.memtable.size == 7
    t2.close()


def test_staged_create_token_corpus(tmp_path):
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 30_000, size=6000).astype(np.int32)
    kw = dict(max_device_bytes=512 * BP.BYTES_PER_ROW)
    t = SuffixTable.create("tok", codes, root=str(tmp_path / "p"),
                           device=CPU, **kw)
    jt = JTable.create("tok", codes, root=str(tmp_path / "j"), **kw)
    assert not t.is_dna and not jt.is_dna
    assert np.array_equal(_sa(t), _jsa(jt))
    assert t.stats()["build"]["chunk_rows"] == 512
    t.close(), jt.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_staged_table_opens_in_the_other_package(tmp_path, writer):
    codes = C.random_dna(5000, seed=9)
    root = str(tmp_path)
    kw = dict(build_chunk_rows=512, shard_rows=700)
    if writer == "port":
        SuffixTable.create("x", codes, root=root, device=CPU, **kw).close()
        t = JTable.open("x", root=root)
        sa = _jsa(t)
    else:
        JTable.create("x", codes, root=root, **kw).close()
        t = SuffixTable.open("x", root=root, device=CPU)
        sa = _sa(t)
    assert np.array_equal(sa, _ref(codes))
    b = t.stats()["build"]
    assert b["mode"] == "staged" and b["n_chunks"] == 10
    t.close()


# --------------------------------------------------------------------------
# crash at every shard boundary + reconcile
# --------------------------------------------------------------------------
def test_kill_at_every_shard_boundary(tmp_path, monkeypatch):
    """A create killed after ANY number of streamed shards (abort never
    runs — a hard kill) leaves no published snapshot; the next catalog
    open removes the remnant and a re-create succeeds with the same
    SA."""
    codes = C.random_dna(4000, seed=6)
    ref = _ref(codes)
    n_shards = -(-4000 // 512)

    class _Kill(BaseException):
        pass

    orig_add = ShardedSave.add_shard
    orig_commit = ShardedSave.commit
    monkeypatch.setattr(ShardedSave, "abort", lambda self: None)
    for die_at in range(n_shards + 1):        # +1: die at commit instead
        root = tmp_path / f"r{die_at}"
        seen = {"n": 0}

        def add(self, name, i, arr, _die=die_at, _seen=seen):
            if _seen["n"] == _die:
                raise _Kill()
            _seen["n"] += 1
            return orig_add(self, name, i, arr)

        monkeypatch.setattr(ShardedSave, "add_shard", add)
        if die_at == n_shards:
            monkeypatch.setattr(
                ShardedSave, "commit",
                lambda self, state, extra=None: (_ for _ in ()).throw(
                    _Kill()))
        with pytest.raises(_Kill):
            SuffixTable.create("t", codes, root=str(root), device=CPU,
                               build_chunk_rows=512, shard_rows=512)
        monkeypatch.setattr(ShardedSave, "add_shard", orig_add)
        monkeypatch.setattr(ShardedSave, "commit", orig_commit)
        # the kill left a registered entry + partial stream, no snapshot
        cat = Catalog(str(root), reconcile=False)
        assert "t" in cat
        with pytest.raises(FileNotFoundError):
            SuffixTable.open("t", root=str(root), device=CPU)
        Catalog(str(root))                    # open-time auto-reconcile
        assert "t" not in Catalog(str(root)).list_tables()
        assert not os.path.isdir(root / "t")
        t = SuffixTable.create("t", codes, root=str(root), device=CPU,
                               build_chunk_rows=512, shard_rows=512)
        assert np.array_equal(_sa(t), ref)
        t.close()


# --------------------------------------------------------------------------
# the ShardedSave protocol, and its format in both packages
# --------------------------------------------------------------------------
def test_sharded_save_protocol(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    stage = mgr.stage_sharded(1)
    stage.add_shard("sa_real", 0, np.arange(5, dtype=np.int32))
    with pytest.raises(ValueError, match="out of order"):
        stage.add_shard("sa_real", 2, np.arange(3, dtype=np.int32))
    stage.add_shard("sa_real", 1, torch.arange(5, 8, dtype=torch.int32))
    assert mgr.latest_step() is None          # nothing visible pre-commit
    stage.commit({"codes": np.zeros(8, np.uint8)}, {"v": 1})
    with pytest.raises(RuntimeError, match="already"):
        stage.add_shard("sa_real", 2, np.zeros(1, np.int32))
    for m in (mgr, JManager(str(tmp_path))):  # the reference reads it too
        arrays, extra = m.restore_arrays(1)
        got = {k.strip("[']"): v for k, v in arrays.items()}
        assert np.array_equal(got["sa_real"], np.arange(8))
        assert got["sa_real"].dtype == np.int32 and extra == {"v": 1}
        assert np.array_equal(got["codes"], np.zeros(8, np.uint8))
    # abort leaves nothing behind
    stage2 = mgr.stage_sharded(2)
    stage2.add_shard("x", 0, np.ones(4))
    stage2.abort()
    assert mgr.latest_step() == 1
    assert not os.path.exists(stage2.tmp)


def test_sharded_save_matches_reference_files(tmp_path):
    """The same stream through both managers gives the same meta.json and
    the same shard files."""
    import json
    shards = [np.arange(i * 4, i * 4 + 4, dtype=np.int32) for i in range(3)]
    state = {"mem_codes": np.zeros(0, np.uint8),
             "codes": np.arange(12, dtype=np.uint8) % 4}
    for mgr in (CheckpointManager(str(tmp_path / "p")),
                JManager(str(tmp_path / "j"))):
        stage = mgr.stage_sharded(3)
        for i, s in enumerate(shards):
            stage.add_shard("sa_real", i, s)
        stage.commit(state, {"k": 1})
    pd, jd = (tmp_path / d / "step_0000000003" for d in "pj")
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    assert json.load(open(pd / "meta.json")) == json.load(
        open(jd / "meta.json"))
    for i in range(3):
        f = f"shard_sa_real_{i:06d}.npy"
        assert np.array_equal(np.load(pd / f), np.load(jd / f))
