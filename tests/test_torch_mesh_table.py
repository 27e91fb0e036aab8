"""Mesh tables: a port ``SuffixTable`` on an 8-tablet CPU mesh
(``REPRO_TORCH_HOST_DEVICES=8``, the counterpart of the reference's 8
XLA host devices) against the reference's single-device table over the
same text and schedule, and against brute force.  Reads run below and
above ``routed_min_batch`` (broadcast and routed), merged over appended
runs and a memtable; ``compact()`` rebuilds over the mesh; ``freeze``
drops the mesh; a table created on one device opens on eight tablets;
the staged build sorts its super-chunks over the mesh."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import SuffixTable as JTable  # noqa: E402
from repro_torch.api import SuffixTable  # noqa: E402
from repro_torch.core import codec as C, query as Q  # noqa: E402
from repro_torch.core.planner import ScanPlanner  # noqa: E402
from repro_torch.core.suffix_array import build_suffix_array  # noqa: E402
from repro_torch.core.tablet import build_tablet_store  # noqa: E402
from repro_torch.launch.mesh import (HOST_DEVICES_ENV,  # noqa: E402
                                     make_tablet_mesh)

CPU = "cpu"
P = 8


@pytest.fixture
def eight(monkeypatch):
    monkeypatch.setenv(HOST_DEVICES_ENV, str(P))


def _sa(table):
    return table.store.sa[table.store.pad_count:].numpy()


def _brute(text, pats):
    return [Q.brute_force_count(text.astype(np.int32),
                                C.encode_dna(p).astype(np.int32))
            for p in pats]


def _same(pt, jt, pats, top_k):
    a, b = pt.scan(pats, top_k=top_k), jt.scan(pats, top_k=top_k)
    for f in ("count", "found", "first_pos") + (("positions",)
                                                if top_k else ()):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    return a


def test_mesh_table_reads_match_reference(eight):
    base = C.random_dna(3000, seed=4)
    kw = dict(is_dna=True, memtable_limit=400, max_query_len=32)
    pt = SuffixTable.from_codes(base, device=CPU, routed_min_batch=64,
                                capacity_factor=0.5, **kw)
    jt = JTable.from_codes(base, **kw)
    assert pt.mesh is not None and pt.planner.num_tablets == P
    assert pt._distributed_build and pt.store.n_pad % P == 0
    np.testing.assert_array_equal(_sa(pt), np.asarray(jt.store.sa))
    assert pt.stats()["build"]["mode"] == "in_memory"
    small = Q.random_patterns(20, 1, 8, seed=1) + ["A", "ACGT"]
    big = Q.random_patterns(150, 1, 12, seed=2) + ["A"] * 30 + ["C"]
    out = _same(pt, jt, small, top_k=3)
    for (want, first), c, f in zip(_brute(base, small), out.count,
                                   out.first_pos):
        assert (c, f) == (want, first)
    _same(pt, jt, big, top_k=4)
    modes = pt.stats()["planner"]["mode_counts"]
    assert modes["broadcast"] >= 1 and modes["routed"] >= 1
    st = pt.stats()["planner"]
    assert st["retried_overflow"] + st["retried_saturated"] > 0
    # scan_batch, locate and locate_range through the routed path
    patt, plen = pt.planner.encode(big)
    a = pt.scan_batch(patt, plen, top_k=2)
    b = jt.scan(big, top_k=2)
    for f in ("count", "first_pos", "positions"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    np.testing.assert_array_equal(pt.locate(big[:12], top_k=3),
                                  jt.locate(big[:12], top_k=3))
    np.testing.assert_array_equal(pt.locate_range("AC", limit=None),
                                  jt.locate_range("AC", limit=None))


def test_mesh_table_appends_and_compaction(eight):
    rng = np.random.default_rng(3)
    base = C.random_dna(2500, seed=6)
    kw = dict(is_dna=True, memtable_limit=300, max_query_len=16)
    pt = SuffixTable.from_codes(base, device=CPU, routed_min_batch=32,
                                **kw)
    jt = JTable.from_codes(base, **kw)
    pats = Q.random_patterns(80, 1, 10, seed=7) + ["A", "GATTACA"]
    for step in range(3):
        chunk = C.random_dna(int(rng.integers(100, 280)), seed=50 + step)
        pt.append(chunk)
        jt.append(chunk)
        _same(pt, jt, pats, top_k=3)
    assert len(pt.runs) == len(jt.runs) >= 1
    assert pt.stats()["planner"]["fused_batches"] >= 3
    text = np.concatenate([base] + [r.codes for r in jt.runs]
                          + [jt.memtable.appended])
    v = pt.compact()
    assert v == jt.compact() and pt.mesh is not None
    np.testing.assert_array_equal(_sa(pt), np.asarray(
        build_suffix_array(torch.from_numpy(text.astype(np.int32)))))
    np.testing.assert_array_equal(
        _sa(pt), np.asarray(jt.store.sa)[jt.store.pad_count:])
    out = _same(pt, jt, pats, top_k=2)
    assert [c for c, _ in _brute(text, pats)] == out.count.tolist()
    # distributed_build=False keeps the mesh but compacts by merging
    merge = SuffixTable.from_codes(base, device=CPU,
                                   distributed_build=False, **kw)
    merge.append(text[len(base):])
    merge.compact()
    assert merge.mesh is not None and not merge._distributed_build
    np.testing.assert_array_equal(_sa(merge), _sa(pt))


def test_freeze_drops_the_mesh(eight):
    base = C.random_dna(1500, seed=8)
    pt = SuffixTable.from_codes(base, device=CPU, is_dna=True)
    jt = JTable.from_codes(base, is_dna=True)
    assert pt.mesh is not None
    pt.freeze()
    jt.freeze()
    assert pt.mesh is None and pt.planner.mesh is None
    assert pt.planner.plan(512).mode == "fm"
    pats = Q.random_patterns(70, 1, 9, seed=3)
    _same(pt, jt, pats, top_k=2)
    pt.append("ACGTACGTAC")
    jt.append("ACGTACGTAC")
    _same(pt, jt, pats, top_k=2)


def test_create_on_one_device_open_on_eight(tmp_path, monkeypatch):
    """The counterpart of the reference's 1 -> 8 -> 1 device round trip:
    the saved real-row SA is re-padded for the tablet count, no
    rebuild; appends and a compaction on the mesh persist, and one
    device reopens them."""
    root = str(tmp_path)
    codes = C.random_dna(4096, seed=5)
    pats = Q.random_patterns(48, 1, 10, seed=3) + ["A", "ACGT"]
    monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)
    t1 = SuffixTable.create("elastic", codes, root=root, device=CPU)
    assert t1.mesh is None
    want = t1.scan(pats, top_k=8)
    t1.close()
    monkeypatch.setenv(HOST_DEVICES_ENV, str(P))
    t8 = SuffixTable.open("elastic", root=root, device=CPU)
    assert t8.planner.num_tablets == P and t8.mesh is not None
    got = t8.scan(pats, top_k=8)
    for f in ("count", "first_pos", "positions"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    t8.append("ACGTACGTACGT")
    v = t8.compact()
    after = t8.scan(pats)
    t8.close()
    monkeypatch.delenv(HOST_DEVICES_ENV)
    back = SuffixTable.open("elastic", root=root, device=CPU)
    assert back.mesh is None and back.version == v
    np.testing.assert_array_equal(back.scan(pats).count, after.count)
    assert JTable.open("elastic", root=root).count(["ACGTACGT"])[0] == \
        back.count(["ACGTACGT"])[0]


def test_staged_create_on_the_mesh(tmp_path, eight):
    codes = C.random_dna(6000, seed=9)
    t = SuffixTable.create("staged8", codes, root=str(tmp_path),
                           build_chunk_rows=256, device=CPU)
    jt = JTable.create("staged1", codes, root=str(tmp_path / "ref"),
                       build_chunk_rows=256)
    assert t.mesh is not None and t.stats()["build"]["mode"] == "staged"
    np.testing.assert_array_equal(_sa(t), np.asarray(
        jt.store.sa)[jt.store.pad_count:])
    b, jb = t.stats()["build"], jt.stats()["build"]
    for k in ("rounds", "n_chunks", "chunk_rows", "peak_device_bytes"):
        assert b[k] == jb[k], k
    pats = Q.random_patterns(70, 1, 9, seed=5)
    _same(t, jt, pats, top_k=2)
    t.close()
    jt.close()


def test_from_store_takes_a_mesh_planner():
    """As in the reference, a mesh planner goes in through from_store;
    no constructor takes ``mesh``."""
    mesh = make_tablet_mesh(4, device=CPU)
    store = build_tablet_store(C.random_dna(1000, seed=2), num_tablets=4,
                               mesh=mesh, axis_name="tablets",
                               method="sample")
    planner = ScanPlanner(store, mesh=mesh, routed_min_batch=8)
    t = SuffixTable.from_store(store, planner=planner)
    assert t.mesh is mesh and t.planner is planner
    pats = Q.random_patterns(40, 1, 8, seed=6)
    single = SuffixTable.from_codes(C.random_dna(1000, seed=2),
                                    device=CPU, is_dna=True)
    np.testing.assert_array_equal(t.count(pats), single.count(pats))
    assert t.stats()["planner"]["mode_counts"]["routed"] == 1
    with pytest.raises(TypeError):
        SuffixTable(np.zeros(4, np.uint8), None, is_dna=True, mesh=mesh)


def test_token_mesh_table_broadcasts(eight):
    """A token (non-DNA) table on the mesh broadcasts every batch (the
    routed owner choice compares packed DNA only), with the reference's
    single-device answers."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 9, size=900).astype(np.int32)
    pt = SuffixTable.from_codes(codes, max_query_len=8, device=CPU,
                                routed_min_batch=8)
    jt = JTable.from_codes(codes, max_query_len=8)
    assert not pt.is_dna and pt.mesh is not None
    patt = np.zeros((70, 8), np.int32)
    plen = rng.integers(1, 4, size=70).astype(np.int32)
    for i in range(70):
        s = int(rng.integers(0, 890))
        patt[i, :plen[i]] = codes[s:s + plen[i]]
    import jax.numpy as jnp
    a = pt.scan_batch(torch.from_numpy(patt), torch.from_numpy(plen),
                      top_k=3)
    b = jt.scan_batch(jnp.asarray(patt), jnp.asarray(plen), top_k=3)
    for f in ("count", "found", "first_pos", "positions"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert pt.planner.plan(70).mode == "broadcast"
    assert pt.stats()["planner"]["mode_counts"]["broadcast"] == 1
