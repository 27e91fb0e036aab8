"""repro_torch query path (store, search, planner) against repro on the
CPU.  The JAX store is carried over with ``store_from_numpy`` so query
parity does not depend on SA-build parity; integer outputs compare
exactly, values and dtypes."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planner as JP, query as JQ, tablet as JT  # noqa: E402
from repro_torch.core import codec as C, planner as P  # noqa: E402
from repro_torch.core import query as Q, tablet as T  # noqa: E402
from repro_torch.launch.mesh import make_tablet_mesh  # noqa: E402

CPU = "cpu"
FIELDS = ("found", "count", "first_rank", "first_pos")


def _carry(js) -> T.TabletStore:
    return T.store_from_numpy(
        {"text_packed": (None if js.text_packed is None
                         else np.asarray(js.text_packed)),
         "text_codes": np.asarray(js.text_codes), "sa": np.asarray(js.sa),
         "n_real": js.n_real, "n_pad": js.n_pad, "is_dna": js.is_dna,
         "max_query_len": js.max_query_len}, device=CPU)


def _assert_same(res, jres):
    for f in FIELDS:
        g, w = getattr(res, f).numpy(), np.asarray(getattr(jres, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, f)


@pytest.mark.parametrize("text_n,nq,max_len,num_tablets", [
    (64, 30, 8, 1), (1000, 200, 20, 1), (3000, 300, 128, 1),
    (2500, 100, 40, 4),
])
def test_dna_query_matches_reference(text_n, nq, max_len, num_tablets):
    codes = C.random_dna(text_n, seed=text_n)
    js = JT.build_tablet_store(codes, num_tablets=num_tablets)
    store = _carry(js)
    pats = Q.random_patterns(nq, 1, max_len, seed=nq) + ["A" * 9, "ACGT"]
    _, jp, jl = JQ.encode_patterns(pats, 128)
    _, pp, pl = Q.encode_patterns(pats, 128, device=CPU)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    _assert_same(Q.query(store, pp, pl), JQ.query(js, jp, jl))
    # the port's own build gives the same store
    own = T.build_tablet_store(codes, num_tablets=num_tablets, device=CPU)
    for k in ("text_packed", "text_codes", "sa"):
        np.testing.assert_array_equal(getattr(own, k).numpy(),
                                      np.asarray(getattr(js, k)), k)
    assert (own.n_real, own.n_pad) == (js.n_real, js.n_pad)


@pytest.mark.parametrize("text_n,min_rows,max_len", [
    (64, 0, 8), (1500, 0, 40), (1000, 1200, 128), (20, 0, 30),
])
def test_search_epilogue_plain_matches_reference(text_n, min_rows, max_len):
    """The plain version of ``bounded_search``'s compare epilogue (the
    four fields from the search, the compare at the lower bound) equals
    ``repro.core.query.query``, pad rows and patterns longer than the
    text included; ``found`` is ``count > 0`` on every query."""
    from repro_torch.kernels.pattern_scan import bounded_match_plain
    codes = C.random_dna(text_n, seed=text_n + 1)
    js = JT.build_tablet_store(codes, min_rows=min_rows)
    store = _carry(js)
    text = C.decode_dna(codes)
    pats = Q.random_patterns(120, 1, max_len, seed=text_n) + [
        "A", text[-3:], text[:min(len(text), 16)], text + "A"]
    pats = [p[:max_len] for p in pats]
    _, jp, jl = JQ.encode_patterns(pats, 128)
    _, pp, pl = Q.encode_patterns(pats, 128, device=CPU)
    got = bounded_match_plain(store, pp, pl)
    want = JQ.query(js, jp, jl)
    for f, g in zip(FIELDS, got):
        w = np.asarray(getattr(want, f))
        assert g.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(g.numpy(), w, f)
    assert torch.equal(got[0], got[1] > 0)


@pytest.mark.parametrize("text_n,vocab", [(500, 7), (2000, 300)])
def test_token_query_matches_reference(text_n, vocab):
    rng = np.random.default_rng(text_n)
    codes = rng.integers(0, vocab, size=text_n).astype(np.int32)
    js = JT.build_tablet_store(codes, is_dna=False)
    store = _carry(js)
    B, L = 120, 6
    starts = rng.integers(0, text_n - L, size=B)
    lens = rng.integers(1, L + 1, size=B).astype(np.int32)
    q = np.zeros((B, L), np.int32)
    for i, (s, n) in enumerate(zip(starts, lens)):
        q[i, :n] = codes[s:s + n]
    q[::7, 0] = vocab + 1                      # some absent patterns
    res = Q.query(store, torch.from_numpy(q), torch.from_numpy(lens))
    _assert_same(res, JQ.query(js, jnp.asarray(q), jnp.asarray(lens)))
    for i in range(0, B, 11):
        want, first = Q.brute_force_count(codes, q[i, :lens[i]])
        assert int(res.count[i]) == want


def test_mississippi_counts():
    """Paper §III worked example, as in tests/test_paper_claims.py."""
    codes = np.frombuffer(b"MISSISSIPPI", dtype=np.uint8).astype(np.int32)
    store = T.build_tablet_store(codes, is_dna=False, device=CPU)
    js = JT.build_tablet_store(codes, is_dna=False)
    for pat, want in {b"PI": 1, b"ISS": 2, b"SSI": 2, b"MISS": 1,
                      b"IPPI": 1, b"X": 0}.items():
        q = np.frombuffer(pat, dtype=np.uint8).astype(np.int32)
        q = np.pad(q, (0, 8 - len(q)))[None]
        res = Q.query(store, torch.from_numpy(q),
                      torch.tensor([len(pat)], dtype=torch.int32))
        assert int(res.count[0]) == want, pat
        _assert_same(res, JQ.query(js, jnp.asarray(q),
                                   jnp.asarray([len(pat)])))


def test_query_counts_match_brute_force():
    codes = C.random_dna(700, seed=11)
    store = T.build_tablet_store(codes, device=CPU)
    pats = Q.random_patterns(60, 1, 6, seed=11)
    _, pp, pl = Q.encode_patterns(pats, 128, device=CPU)
    res = Q.query(store, pp, pl)
    for i, p in enumerate(pats):
        want, first = Q.brute_force_count(codes, C.encode_dna(p))
        assert int(res.count[i]) == want
        assert bool(res.found[i]) == (want > 0)


def test_encode_patterns_matches_reference():
    pats = ["", "A", "ACGTACGTACGTACGTA", "T" * 40]
    for got, want in zip(Q.encode_patterns(pats, 48, device=CPU),
                         JQ.encode_patterns(pats, 48)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = Q.encode_patterns([], 32, device=CPU)
    assert [tuple(t.shape) for t in empty] == [(0, 32), (0, 2), (0,)]
    assert Q.random_patterns(50, 1, 100, seed=4) == \
        JQ.random_patterns(50, 1, 100, seed=4)


def test_planner_scan_and_locate_match_reference():
    codes = C.random_dna(2000, seed=21)
    js = JT.build_tablet_store(codes, max_query_len=32)
    jplan = JP.ScanPlanner(js)
    plan = P.ScanPlanner(_carry(js))
    pats = Q.random_patterns(80, 1, 8, seed=21) + ["ACGTA", "ACGTA"]
    a, b = plan.scan(pats, top_k=4), jplan.scan(pats, top_k=4)
    for f in ("found", "count", "first_pos", "positions"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    np.testing.assert_array_equal(plan.locate(pats[:5], top_k=3),
                                  jplan.locate(pats[:5], top_k=3))
    assert plan.stats.cache_hits == jplan.stats.cache_hits
    assert plan.plan(512).mode == P.MODE_SINGLE
    patt, plen = plan.encode(pats[:3])
    with pytest.raises(ValueError, match="requires a mesh"):
        plan.scan_encoded(patt, plen, mode=P.MODE_ROUTED)
    with pytest.raises(ValueError):
        plan.encode(["A" * 33])
    # a mesh the store's rows do not divide over is refused, as in the
    # reference (rebuild with num_tablets=p)
    with pytest.raises(ValueError, match="not divisible"):
        P.ScanPlanner(plan.store, mesh=make_tablet_mesh(3, device=CPU))
