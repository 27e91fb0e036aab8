"""The port's tablet mesh (``repro_torch.distributed``, ``launch.mesh``,
``core.dsort``, ``core.dsa``, ``query.query_sharded`` /
``query_routed`` and the planner's broadcast and routed modes) on an
8-tablet CPU mesh, against the reference's own 8-device mesh.

One module-scoped fixture runs the reference once in a subprocess with 8
XLA host devices (``conftest.run_multidevice``; tiny sizes) and saves
its inputs and outputs as ``.npz``: the bitonic, sample and auto sorts
with the sample sort's overflow flags, ``build_suffix_array_distributed``
for each method, ``query_sharded``, the planner's raw routed counts
(``retry=False``, with the -1 and -2 sentinels at
``capacity_factor=0.25``), its retried answers and ``retried_*`` stats,
and the staged build's mesh path.  Every port output must be EQUAL
(integers).  The same answers are also held against ``repro``'s
single-device ones and brute force, in-process."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import run_multidevice  # noqa: E402
from repro.core import query as JQ  # noqa: E402
from repro.core.suffix_array import build_suffix_array as j_build  # noqa: E402
from repro.core.tablet import build_tablet_store as j_store  # noqa: E402
from repro_torch.core import codec as C  # noqa: E402
from repro_torch.core import dsa, dsort  # noqa: E402
from repro_torch.core import query as Q  # noqa: E402
from repro_torch.core.build_pipeline import staged_suffix_array  # noqa: E402
from repro_torch.core.planner import (MODE_BROADCAST, MODE_ROUTED,  # noqa: E402
                                      ScanPlanner)
from repro_torch.core.suffix_array import suffix_array_naive  # noqa: E402
from repro_torch.core.tablet import (build_tablet_store,  # noqa: E402
                                     shard_store)
from repro_torch.distributed import collectives as COL  # noqa: E402
from repro_torch.launch.mesh import (HOST_DEVICES_ENV,  # noqa: E402
                                     make_tablet_mesh, table_mesh,
                                     visible_devices)

CPU = "cpu"
P = 8
FIELDS = ("found", "count", "first_rank", "first_pos")
TIMING = ("elapsed_s", "bases_per_s")

# The reference's side, run in a subprocess with 8 host devices.  The
# routed batch is a multiple of 8: this jax refuses the reference
# planner's slice of a padded routed batch (ROADMAP, queue 3).
REFERENCE = r'''
import json
from functools import partial
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import query as Q
from repro.core.build_pipeline import staged_suffix_array
from repro.core.codec import random_dna, decode_dna
from repro.core.dsa import build_suffix_array_distributed
from repro.core.dsort import (bitonic_sort_sharded, sample_sort_sharded,
                              sort_sharded_auto)
from repro.core.planner import ScanPlanner
from repro.core.tablet import build_tablet_store
from repro.launch.mesh import make_tablet_mesh

assert len(jax.devices()) == 8
mesh = make_tablet_mesh(8)
spec = P("tablets")
out = {}
for tag, m, hi in (("ties", 64, 20), ("uniq", 256, 10**6)):
    rng = np.random.default_rng(m)
    k1 = rng.integers(0, hi, size=8 * m).astype(np.int32)
    k2 = rng.integers(-1, 3, size=8 * m).astype(np.int32)
    v = np.arange(8 * m, dtype=np.int32)
    out[tag + "_k1"], out[tag + "_k2"] = k1, k2

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(spec,) * 3,
             out_specs=(spec,) * 13)
    def run(a, b, c):
        ax = "tablets"
        bit = bitonic_sort_sharded((a, b, c), num_keys=2, axis_name=ax)
        smp, ovf = sample_sort_sharded((a, c), num_keys=1, axis_name=ax)
        auto = sort_sharded_auto((a, b, c), num_keys=2, axis_name=ax)
        auto1 = sort_sharded_auto((a, c), num_keys=1, axis_name=ax,
                                  capacity_factor=8.0)
        smp2, ovf2 = sample_sort_sharded((b, c), num_keys=1, axis_name=ax)
        return (bit + smp + auto + auto1[1:]
                + (ovf.astype(np.int32)[None],) + smp2
                + (ovf2.astype(np.int32)[None],))

    names = ("bit_k1", "bit_k2", "bit_v", "smp_k", "smp_v", "auto_k1",
             "auto_k2", "auto_v", "auto1_v", "smp_ovf", "smp2_k", "smp2_v",
             "smp2_ovf")
    for name, x in zip(names, run(k1, k2, v)):
        out[tag + "_" + name] = np.asarray(x)
codes = random_dna(203, seed=3)
for method in ("bitonic", "sample", "sample_unsafe"):
    sa, pad = build_suffix_array_distributed(codes, mesh, "tablets",
                                             method=method)
    out["sa_" + method] = np.asarray(sa)
    out["pad_" + method] = np.int32(pad)
text = random_dna(4096, seed=5)
store = build_tablet_store(text, num_tablets=8)
pats = Q.random_patterns(64, 1, 10, seed=9)
_, pp, pl = Q.encode_patterns(pats, 16)

@jax.jit
@partial(shard_map, mesh=mesh, in_specs=(spec, None, P(), P()),
         out_specs=P())
def bcast(sa_local, meta, patt, plen):
    return Q.query_sharded(sa_local, meta, patt, plen, "tablets")

res = bcast(store.sa, store, pp, pl)
for f in ("found", "count", "first_rank", "first_pos"):
    out["sharded_" + f] = np.asarray(getattr(res, f))
sa_np = np.asarray(store.sa)
m = store.n_pad // 8
boundary = [decode_dna(text[int(sa_np[d * m]):int(sa_np[d * m]) + 6])
            for d in range(1, 8) if int(sa_np[d * m]) <= 4096 - 8]
rpats = ["A"] * 40 + Q.random_patterns(24, 1, 10, seed=11) + boundary
rpats += Q.random_patterns(-len(rpats) % 8, 1, 10, seed=12)
out["rpats"] = np.array(rpats)
_, rp, rl = Q.encode_patterns(rpats, 16)
for cf in ("2.0", "0.25"):
    pln = ScanPlanner(store, mesh=mesh, capacity_factor=float(cf),
                      routed_min_batch=8)
    raw = pln.scan_encoded(rp, rl, mode="routed", retry=False)
    res = pln.scan_encoded(rp, rl)
    for f in ("found", "count", "first_rank", "first_pos"):
        out["raw" + cf + "_" + f] = np.asarray(getattr(raw, f))
        out["res" + cf + "_" + f] = np.asarray(getattr(res, f))
    st = pln.stats
    out["stats" + cf] = np.array([st.retried_overflow, st.retried_saturated,
                                  st.retried_inexact_rank, st.batches,
                                  st.queries])
    out["loc" + cf] = pln.positions_from_result(res, top_k=5)
scodes = random_dna(3000, seed=11)
ssa, sst = staged_suffix_array(scodes, chunk_rows=256, mesh=mesh,
                               axis_name="tablets", spill_dir=SPILL)
out["staged_sa"] = ssa
out["staged_stats"] = np.array(json.dumps(sst.to_dict()))
np.savez(OUT, **out)
print("REF_OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ref")
    path = str(d / "ref.npz")
    code = (f"OUT = {path!r}\nSPILL = {str(d / 'spill')!r}\n"
            + REFERENCE)
    assert "REF_OK" in run_multidevice(code, n_devices=P, timeout=300)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def mesh():
    return make_tablet_mesh(P, device=CPU)


def _split(x, mesh):
    return dsa._split(np.asarray(x, np.int32), mesh)


def _cat(blocks, i):
    return torch.cat([b[i] for b in blocks]).numpy()


def _store(mesh):
    return build_tablet_store(C.random_dna(4096, seed=5), num_tablets=P,
                              device=CPU)


def test_linspace_take_matches_jax():
    """The sample sort's splitter sample positions are float32 linspace,
    truncated: equal to jnp's at every (m, s) the sorts can meet."""
    for m in list(range(1, 300)) + [1000, 4096, 2**20 + 7, 2**23]:
        s = min(64, m)
        want = np.asarray(jnp.linspace(0, m - 1, s).astype(jnp.int32))
        np.testing.assert_array_equal(dsort.linspace_take(m, s), want)
    # inside jit, as the reference's sort runs it, XLA folds constants
    for m in (23, 30, 44, 2**23):
        want = np.asarray(jax.jit(
            lambda: jnp.linspace(0, m - 1, 64).astype(jnp.int32))())
        np.testing.assert_array_equal(dsort.linspace_take(m, 64), want)


def test_collectives_follow_lax():
    xs = [torch.full((2, 3), d, dtype=torch.int32) for d in range(4)]
    assert all(torch.equal(x, torch.full((2, 3), 6, dtype=torch.int32))
               for x in COL.psum(xs))
    g = COL.all_gather([torch.tensor([d, 10 * d]) for d in range(4)])
    assert all(torch.equal(x, torch.tensor([[0, 0], [1, 10], [2, 20],
                                            [3, 30]])) for x in g)
    # tablet d receives row d of every tablet's (p, cap) send buffer
    send = [torch.arange(8).reshape(4, 2) + 100 * d for d in range(4)]
    for d, got in enumerate(COL.all_to_all(send)):
        want = torch.stack([send[s][d] for s in range(4)])
        assert torch.equal(got, want)
    # (source, destination) pairs; a tablet nobody sends to gets zeros
    got = COL.ppermute([torch.tensor([d + 1]) for d in range(4)],
                       [(0, 1), (1, 2), (2, 3)])
    assert [int(x) for x in got] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        COL.all_to_all([torch.zeros(3, 2)] * 4)


@pytest.mark.parametrize("tag", ["ties", "uniq"])
def test_sorts_match_reference(ref, mesh, tag):
    k1, k2 = ref[tag + "_k1"], ref[tag + "_k2"]
    v = np.arange(k1.shape[0], dtype=np.int32)
    three = list(zip(_split(k1, mesh), _split(k2, mesh), _split(v, mesh)))
    two = list(zip(_split(k1, mesh), _split(v, mesh)))
    bit = dsort.bitonic_sort_sharded(three, num_keys=2)
    auto = dsort.sort_sharded_auto(three, num_keys=2)
    for i, n in enumerate(("k1", "k2", "v")):
        np.testing.assert_array_equal(_cat(bit, i), ref[f"{tag}_bit_{n}"])
        np.testing.assert_array_equal(_cat(auto, i),
                                      ref[f"{tag}_auto_{n}"])
    # a sort (the network is not stable across tablets): the payload is
    # a permutation carrying its keys, which come out in key order
    got = _cat(bit, 2)
    assert sorted(got.tolist()) == v.tolist()
    key = k1.astype(np.int64) * 8 + k2 + 1
    assert (np.diff(key[got]) >= 0).all()
    smp, ovf = dsort.sample_sort_sharded(two, num_keys=1)
    assert [int(ovf)] * P == ref[f"{tag}_smp_ovf"].tolist()
    np.testing.assert_array_equal(_cat(smp, 0), ref[f"{tag}_smp_k"])
    np.testing.assert_array_equal(_cat(smp, 1), ref[f"{tag}_smp_v"])
    auto1 = dsort.sort_sharded_auto(two, num_keys=1, capacity_factor=8.0)
    np.testing.assert_array_equal(_cat(auto1, 1), ref[f"{tag}_auto1_v"])
    np.testing.assert_array_equal(_cat(auto1, 1),
                                  np.argsort(k1, kind="stable"))
    # four distinct keys overflow the buckets: the flag, and the
    # (invalid) output, are the reference's
    small = list(zip(_split(k2, mesh), _split(v, mesh)))
    smp2, ovf2 = dsort.sample_sort_sharded(small, num_keys=1)
    assert ovf2 and ref[f"{tag}_smp2_ovf"].all()
    np.testing.assert_array_equal(_cat(smp2, 0), ref[f"{tag}_smp2_k"])
    np.testing.assert_array_equal(_cat(smp2, 1), ref[f"{tag}_smp2_v"])
    with pytest.raises(ValueError, match="power of two"):
        dsort.bitonic_sort_sharded(three[:6], num_keys=2)


@pytest.mark.parametrize("method", dsa.METHODS)
def test_distributed_sa_matches_reference(ref, mesh, method):
    codes = C.random_dna(203, seed=3)
    sa, pad = dsa.build_suffix_array_distributed(codes, mesh, "tablets",
                                                 method=method)
    assert pad == int(ref["pad_" + method]) == 5
    np.testing.assert_array_equal(sa.numpy(), ref["sa_" + method])
    if method != "sample_unsafe":        # the unsafe sort overflows here
        want = np.asarray(j_build(codes.astype(np.int32)))
        np.testing.assert_array_equal(sa.numpy()[pad:], want)
        np.testing.assert_array_equal(want, suffix_array_naive(codes))


def test_query_sharded_matches_reference(ref, mesh):
    store = _store(mesh)
    pats = Q.random_patterns(64, 1, 10, seed=9)
    _, pp, pl = Q.encode_patterns(pats, 16, device=CPU)
    res = Q.query_sharded(shard_store(store, mesh), pp, pl)
    single = JQ.query(j_store(C.random_dna(4096, seed=5), num_tablets=P),
                      *JQ.encode_patterns(pats, 16)[1:])
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      ref["sharded_" + f])
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(single, f)))


@pytest.mark.parametrize("cf", ["2.0", "0.25"])
def test_routed_raw_and_retried_match_reference(ref, mesh, cf):
    """Raw routed counts (``retry=False``) carry the reference's -1
    (dispatch overflow) and -2 (saturated run) sentinels; the planner's
    retried answers and ``retried_*`` stats are the reference's, and
    exact against brute force."""
    store = _store(mesh)
    pats = [str(p) for p in ref["rpats"]]
    pln = ScanPlanner(store, mesh=mesh, capacity_factor=float(cf),
                      routed_min_batch=8)
    assert pln.plan(len(pats)).mode == MODE_ROUTED
    pp, pl = pln.encode(pats)
    raw = pln.scan_encoded(pp, pl, mode=MODE_ROUTED, retry=False)
    res = pln.scan_encoded(pp, pl)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(raw, f).numpy(),
                                      ref[f"raw{cf}_{f}"], f)
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      ref[f"res{cf}_{f}"], f)
    st = pln.stats
    assert [st.retried_overflow, st.retried_saturated,
            st.retried_inexact_rank, st.batches, st.queries] == \
        ref["stats" + cf].tolist()
    np.testing.assert_array_equal(pln.positions_from_result(res, top_k=5),
                                  ref["loc" + cf])
    rc = raw.count.numpy()
    if cf == "0.25":
        assert (rc == -1).any() and (rc == -2).any()
        assert st.retried_overflow > 0 and st.retried_saturated > 0
    text = C.random_dna(4096, seed=5).astype(np.int32)
    for i, p in enumerate(pats):
        want, first = Q.brute_force_count(text, C.encode_dna(p)
                                          .astype(np.int32))
        assert int(res.count[i]) == want, p
        assert bool(res.found[i]) == (want > 0)


def test_routed_pads_odd_batches_and_broadcasts_small_ones(mesh):
    """A routed batch that is no multiple of p is padded (plen 1) and
    cut back; a batch under ``routed_min_batch`` broadcasts; both equal
    the single-device search, whose mode needs no mesh."""
    store = _store(mesh)
    pats = Q.random_patterns(61, 1, 12, seed=4) + ["A", "ACGTACGTACGTACG"]
    pln = ScanPlanner(store, mesh=mesh, routed_min_batch=16)
    pp, pl = pln.encode(pats)
    single = Q.query(store, pp, pl)
    for mode in (None, MODE_BROADCAST):
        got = pln.scan_encoded(pp, pl, mode=mode)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(single, f)), f
    small = pln.scan_encoded(pp[:5], pl[:5])
    assert pln.plan(5).mode == MODE_BROADCAST
    assert torch.equal(small.count, single.count[:5])
    assert pln.stats.mode_counts == {"single": 0, "broadcast": 2,
                                     "routed": 1, "fm": 0}
    assert pln.num_tablets == P and len(pln.tablets()) == P


def test_staged_mesh_build_matches_reference(ref, mesh, tmp_path):
    codes = C.random_dna(3000, seed=11)
    sa, st = staged_suffix_array(codes, chunk_rows=256, mesh=mesh,
                                 spill_dir=str(tmp_path / "spill"),
                                 device=CPU)
    np.testing.assert_array_equal(sa, ref["staged_sa"])
    want = json.loads(str(ref["staged_stats"]))
    got = st.to_dict()
    for k in TIMING:
        got.pop(k), want.pop(k)
    assert got == want and got["spill_bytes"] > 0
    assert os.listdir(tmp_path / "spill") == []


def test_visible_devices_follow_the_host_device_count(monkeypatch):
    monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)
    assert visible_devices(CPU) == [torch.device(CPU)]
    assert table_mesh(CPU) is None
    monkeypatch.setenv(HOST_DEVICES_ENV, "4")
    mesh = table_mesh(CPU)
    assert mesh.shape == {"tablets": 4} and mesh.axis_names == ("tablets",)
    assert mesh.devices == (torch.device(CPU),) * 4
    monkeypatch.setenv(HOST_DEVICES_ENV, "1")
    assert table_mesh(CPU) is None
    monkeypatch.setenv(HOST_DEVICES_ENV, "0")
    with pytest.raises(ValueError):
        visible_devices(CPU)
