"""The port's kernels and their plain versions.

On the CPU: each plain version (what ``repro_torch.kernels.ops`` runs on
a CPU tensor) against the JAX Pallas kernel run in interpret mode
through ``repro.kernels.ops``, at the sizes ``tests/test_kernels.py``
sweeps, with exact equality.  The hand-written kernels themselves are
held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import codec as JC, query as JQ  # noqa: E402
from repro.kernels import ops as JOPS, ref as JREF  # noqa: E402
from repro.kernels import tier_scan as JTS  # noqa: E402
from repro_torch.core import codec as C, query as Q  # noqa: E402
from repro_torch.core.tablet import tierstack_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref, tier_scan as TS  # noqa: E402

CPU = "cpu"
STACK_FIELDS = ("text_packed", "text_codes", "sa", "n_real", "n_rows",
                "offset", "lo", "hi", "ov_rank", "hi_rank", "pad_cnt", "rmq")


def _stack_fields(stack) -> dict:
    f = {k: (None if getattr(stack, k) is None
             else np.asarray(getattr(stack, k))) for k in STACK_FIELDS}
    f.update(num_tiers=stack.num_tiers, rows=stack.rows,
             is_dna=stack.is_dna, max_query_len=stack.max_query_len)
    return f


def _live_stacks(base_n, chunks):
    """A JAX table with a run and a memtable live, its TierStack, and the
    same TierStack carried over to the port."""
    from repro.api import SuffixTable
    table = SuffixTable.from_codes(JC.random_dna(base_n, seed=base_n),
                                   is_dna=True, memtable_limit=260)
    for i in range(chunks):
        table.append(JC.random_dna(150, seed=1000 + i))
    jstack = table._tierset().stack
    assert jstack.num_tiers >= 2
    return jstack, tierstack_from_numpy(_stack_fields(jstack), device=CPU)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode) — CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 16384, 50001])
def test_pack2bit_plain_matches_pallas(n):
    c = C.random_dna(n, seed=n)
    got = ops.pack2bit(torch.from_numpy(c))
    want = np.asarray(JOPS.pack2bit(c))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    # the slot-major contract of repro.kernels.ref.pack2bit_ref
    nw = C.packed_length(n)
    lanes = np.zeros(nw * 16, np.uint32)
    lanes[:n] = c
    lanes = lanes.reshape(nw, 16).T
    np.testing.assert_array_equal(
        ref.pack2bit_ref(torch.from_numpy(lanes.astype(np.int64))).numpy(),
        np.asarray(JREF.pack2bit_ref(jnp.asarray(lanes))))


@pytest.mark.parametrize("B,W,text_n", [
    (1, 1, 64), (7, 2, 500), (300, 7, 3000), (512, 8, 3000), (1000, 4, 777),
])
def test_pattern_compare_plain_matches_pallas(B, W, text_n):
    codes = C.random_dna(text_n, seed=B)
    rng = np.random.default_rng(W)
    pos = rng.integers(0, text_n, size=B).astype(np.int32)
    pats = Q.random_patterns(B, 1, W * 16, seed=(B, W))
    _, jp, jl = JQ.encode_patterns(pats, W * 16)
    jwin = JC.extract_window(JC.pack_2bit(codes), jnp.asarray(pos), W)
    want = JOPS.pattern_compare(jwin, jp, jl, jnp.asarray(pos),
                                n_real=text_n)

    _, pp, pl = Q.encode_patterns(pats, W * 16, device=CPU)
    tpos = torch.from_numpy(pos)
    win = C.extract_window(C.pack_2bit(codes), tpos, W)
    got = ops.pattern_compare(win, pp, pl, tpos, n_real=text_n)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    raw = ref.pattern_compare_ref(win.T, pp.T, pl, tpos, n_real=text_n)
    jraw = JREF.pattern_compare_ref(jwin.T, jp.T, jl, jnp.asarray(pos),
                                    n_real=text_n)
    for g, w in zip(raw, jraw):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lt, eq = Q.compare_packed(C.pack_2bit(codes), text_n, tpos, pp, pl)
    np.testing.assert_array_equal(lt.numpy(), got[0].numpy())
    np.testing.assert_array_equal(eq.numpy(), got[2].numpy())


@pytest.mark.parametrize("nq,base_n,chunks", [
    (17, 900, 3), (130, 2500, 5), (260, 1400, 4),
])
def test_tier_scan_plain_matches_pallas_and_fused(nq, base_n, chunks):
    """On a live TierStack: the Pallas tier kernel (interpret) and the
    JAX binary-search path against the port's dense plain version and
    its binary-search twin."""
    jstack, stack = _live_stacks(base_n, chunks)
    pats = Q.random_patterns(nq, 1, 12, seed=nq)
    _, jp, jl = JQ.encode_patterns(pats, jstack.max_query_len)
    _, pp, pl = Q.encode_patterns(pats, stack.max_query_len, device=CPU)
    want = JOPS.tier_scan(jstack, jp, jl)              # Pallas, interpret
    want_fused = JTS.fused_tier_scan(jstack, jp, jl)
    got = ops.tier_scan(stack, pp, pl)                 # dense plain version
    twin = TS.fused_tier_scan(stack, pp, pl)
    for name, g, t, w, wf in zip(("count", "less", "matches", "first_g"),
                                 got, twin, want, want_fused):
        assert g.dtype == torch.int32 and t.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        np.testing.assert_array_equal(t.numpy(), np.asarray(wf), name)

    # dense ref over the same operands as the JAX dense ref
    W = pp.shape[1]
    jwin = jnp.transpose(jax.vmap(
        lambda pk, sa_t: JC.extract_window(pk, sa_t, W))(
            jstack.text_packed, jstack.sa), (0, 2, 1))
    meta = ops.tier_meta(stack)
    jref = JREF.tier_scan_ref(jp.T.astype(jnp.uint32), jl, jwin, jstack.sa,
                              jnp.asarray(meta.numpy()))
    rref = ref.tier_scan_ref(pp.T, pl, ops.tier_windows(stack, W),
                             stack.sa, meta, row_chunk=97)
    np.testing.assert_array_equal(ops.tier_windows(stack, W).numpy(),
                                  np.asarray(jwin))
    for g, w in zip(rref, jref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("nq,base_n,chunks", [(40, 900, 3), (90, 1400, 4)])
def test_fused_table_scan_and_merge_match_reference(nq, base_n, chunks):
    from repro.api import SuffixTable
    from repro_torch.core.tablet import store_from_numpy
    table = SuffixTable.from_codes(JC.random_dna(base_n, seed=base_n),
                                   is_dna=True, memtable_limit=260)
    for i in range(chunks):
        table.append(JC.random_dna(150, seed=2000 + i))
    js = table.store
    jstack = table._tierset().stack
    store = store_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in
         ("text_packed", "text_codes", "sa")}
        | {k: getattr(js, k) for k in
           ("n_real", "n_pad", "is_dna", "max_query_len")}, device=CPU)
    stack = tierstack_from_numpy(_stack_fields(jstack), device=CPU)
    pats = Q.random_patterns(nq, 1, 10, seed=nq + 5)
    _, jp, jl = JQ.encode_patterns(pats, 128)
    _, pp, pl = Q.encode_patterns(pats, 128, device=CPU)
    jmerged, jbase, jtiers = JOPS.fused_single(js, jstack, jp, jl)
    merged, base, tiers = ops.fused_single(store, stack, pp, pl)
    for name in ("found", "count", "first_rank", "first_pos"):
        for g, w in ((merged, jmerged), (base, jbase)):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)), name)
    for g, w in zip(tiers, jtiers):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("base_n,limit,chunks", [(900, 260, 3),
                                                 (1400, 200, 5)])
def test_own_tier_stack_matches_reference(base_n, limit, chunks):
    """``stack_tier_stores`` (and the whole append/seal path under it)
    builds the same TierStack as the reference."""
    from repro.api import SuffixTable as JTable
    from repro_torch.api import SuffixTable
    base = C.random_dna(base_n, seed=base_n)
    jt = JTable.from_codes(base, is_dna=True, memtable_limit=limit)
    pt = SuffixTable.from_codes(base, is_dna=True, memtable_limit=limit,
                                device=CPU)
    for i in range(chunks):
        chunk = C.random_dna(150, seed=3000 + i)
        jt.append(chunk)
        pt.append(chunk)
    want = _stack_fields(jt._tierset().stack)
    stack = pt._tierset().stack
    for k in STACK_FIELDS:
        np.testing.assert_array_equal(getattr(stack, k).numpy(), want[k], k)
    assert (stack.num_tiers, stack.rows, stack.max_query_len) == \
        (want["num_tiers"], want["rows"], want["max_query_len"])


@pytest.mark.parametrize("nq,text_n", [(16, 512), (150, 2000), (260, 4096)])
def test_tablet_scan_plain_matches_pallas_and_query(nq, text_n):
    """``ops.tablet_scan`` on the CPU (the plain version) against the
    Pallas kernel in interpret mode through JAX's ``ops.tablet_scan``,
    the JAX dense oracle, and the counts and lower bounds of
    ``query.query``."""
    from repro.core.tablet import build_tablet_store as j_build
    from repro_torch.core.tablet import store_from_numpy
    codes = C.random_dna(text_n, seed=text_n)
    js = j_build(codes)
    store = store_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in
         ("text_packed", "text_codes", "sa")}
        | {k: getattr(js, k) for k in
           ("n_real", "n_pad", "is_dna", "max_query_len")}, device=CPU)
    W = 7
    pats = Q.random_patterns(nq, 1, 12, seed=nq)
    _, jp, jl = JQ.encode_patterns(pats, W * 16)
    _, pp, pl = Q.encode_patterns(pats, W * 16, device=CPU)
    jwin = JC.extract_window(js.text_packed, js.sa, W)
    win = C.extract_window(store.text_packed, store.sa, W)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    got = ops.tablet_scan(pp, pl, win, store.sa, n_real=store.n_real)
    want = JOPS.tablet_scan(jp, jl, jwin, js.sa, n_real=js.n_real)
    jref = JREF.tablet_scan_ref(jp.T, jl, jwin.T, js.sa, n_real=js.n_real)
    rref = ref.tablet_scan_ref(pp.T, pl, win.T, store.sa,
                               n_real=store.n_real, row_chunk=97)
    for name, g, w, jr, r in zip(("count", "less", "first_row"), got, want,
                                 jref, rref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jr), name)
        np.testing.assert_array_equal(r.numpy(), g.numpy(), name)
    res = Q.query(store, pp, pl)
    np.testing.assert_array_equal(got[0].numpy(), res.count.numpy())
    f = res.found.numpy()
    lb = res.first_rank.numpy() + store.pad_count
    np.testing.assert_array_equal(got[1].numpy()[f], lb[f])
    np.testing.assert_array_equal(got[2].numpy()[f], lb[f])
