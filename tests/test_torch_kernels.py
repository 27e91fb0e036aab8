"""The port's kernels and their plain versions.

On the CPU: each plain version (what ``repro_torch.kernels.ops`` runs on
a CPU tensor) against the JAX Pallas kernel run in interpret mode
through ``repro.kernels.ops``, at the sizes ``tests/test_kernels.py``
sweeps, with exact equality.  The tablet and tier scans' plain versions
are the CUDA kernels' 17-ary search (``kernels.kary``); they are also
held against the dense plain versions (the TPU kernels' algorithm) at
the edges of that search.  The hand-written kernels themselves are
held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import functools

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


@functools.lru_cache(maxsize=None)
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
    JAX binary-search path against the port's plain version (the
    kernel's 17-ary search) and its binary-search twin; the port's dense
    plain version against JAX's."""
    jstack, stack = _live_stacks(base_n, chunks)
    pats = Q.random_patterns(nq, 1, 12, seed=nq)
    _, jp, jl = JQ.encode_patterns(pats, jstack.max_query_len)
    _, pp, pl = Q.encode_patterns(pats, stack.max_query_len, device=CPU)
    want = JOPS.tier_scan(jstack, jp, jl)              # Pallas, interpret
    want_fused = JTS.fused_tier_scan(jstack, jp, jl)
    got = ops.tier_scan(stack, pp, pl)                 # 17-ary plain version
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
    rref = ref.tier_scan_ref(pp.T, pl, ref.tier_windows(stack, W),
                             stack.sa, meta, row_chunk=97)
    np.testing.assert_array_equal(ref.tier_windows(stack, W).numpy(),
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
    """``ops.tablet_scan`` on the CPU (the plain version, the kernel's
    17-ary search) against the Pallas kernel in interpret mode through
    JAX's ``ops.tablet_scan``, the JAX dense oracle, the port's dense
    plain version, and the counts and lower bounds of ``query.query``."""
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


# ---------------------------------------------------------------------------
# the 17-ary search at its edges — CPU
# ---------------------------------------------------------------------------
def _tiny_stacks():
    """A table whose base (30 bases) is shorter than ``max_query_len``, a
    sealed run and a memtable: every tier's text (n_real 64) is shorter
    than patterns of 65-128 bases."""
    from repro.api import SuffixTable
    table = SuffixTable.from_codes(JC.random_dna(30, seed=1), is_dna=True,
                                   memtable_limit=16)
    table.append(JC.random_dna(20, seed=2))
    table.append(JC.random_dna(10, seed=3))
    jstack = table._tierset().stack
    return jstack, tierstack_from_numpy(_stack_fields(jstack), device=CPU)


def _dense_tier_refs(jstack, stack, jp, jl, pp, pl, meta):
    """The JAX and the port's dense plain versions on the same meta."""
    W = pp.shape[1]
    jwin = jnp.transpose(jax.vmap(
        lambda pk, sa_t: JC.extract_window(pk, sa_t, W))(
            jstack.text_packed, jstack.sa), (0, 2, 1))
    jref = JREF.tier_scan_ref(jp.T.astype(jnp.uint32), jl, jwin, jstack.sa,
                              jnp.asarray(meta.numpy()))
    rref = ref.tier_scan_ref(pp.T, pl, ref.tier_windows(stack, W), stack.sa,
                             meta)
    return [np.asarray(x) for x in jref], [x.numpy() for x in rref]


@pytest.mark.parametrize("case", ["short_patterns", "longer_than_tier"])
def test_tier_scan_plain_search_edges(case):
    """The plain 17-ary tier search on 1- to 3-base patterns (runs of a
    quarter of a tier) and on patterns longer than every tier's text,
    against the Pallas kernel (interpret), JAX's binary search, both
    dense plain versions and the port's binary-search twin."""
    if case == "short_patterns":
        jstack, stack = _live_stacks(900, 3)
        pats = ["A", "C", "G", "T", "AC", "TTT"] + \
            Q.random_patterns(14, 1, 3, seed=7)
    else:
        jstack, stack = _tiny_stacks()
        text = C.decode_dna(np.concatenate(
            [JC.random_dna(30, seed=1), JC.random_dna(20, seed=2),
             JC.random_dna(10, seed=3)]))
        pats = Q.random_patterns(12, 65, 128, seed=8) + [
            "A", text, (text * 3)[:128], text[40:] + "ACGT"]
        assert max(map(len, pats)) > int(stack.n_real.max())
    _, jp, jl = JQ.encode_patterns(pats, jstack.max_query_len)
    _, pp, pl = Q.encode_patterns(pats, stack.max_query_len, device=CPU)
    got = [x.numpy() for x in TS.tier_scan_plain(
        pp.T, pl, stack.text_packed, stack.sa, stack.pad_cnt,
        ops.tier_meta(stack))]
    wants = [[np.asarray(x) for x in JOPS.tier_scan(jstack, jp, jl)],
             [np.asarray(x) for x in JTS.fused_tier_scan(jstack, jp, jl)],
             [x.numpy() for x in TS.fused_tier_scan(stack, pp, pl)],
             *_dense_tier_refs(jstack, stack, jp, jl, pp, pl,
                               ops.tier_meta(stack))]
    for want in wants:
        for name, g, w in zip(("count", "less", "matches", "first_g"), got,
                              want):
            np.testing.assert_array_equal(g, w, name)
    if case == "short_patterns":
        assert got[2][:, 0].min() > 16      # 'A' runs longer than a round


@pytest.mark.parametrize("n_rows", [0, 1, 16, 17, 18, 300])
def test_tier_scan_plain_rows_below_stack(n_rows):
    """Tiers whose sorted rows stop below the stack's R (``n_rows`` from
    0, an empty tier, through intervals of 16-18 rows, where splitters
    repeat): the rows past ``n_rows`` are never probed.  The plain
    17-ary search against JAX's and the port's dense plain versions on
    the same meta."""
    jstack, stack = _live_stacks(900, 3)
    pats = ["A", "C", "GT"] + Q.random_patterns(20, 1, 6, seed=n_rows)
    _, jp, jl = JQ.encode_patterns(pats, jstack.max_query_len)
    _, pp, pl = Q.encode_patterns(pats, stack.max_query_len, device=CPU)
    meta = ops.tier_meta(stack)
    meta[:, 1] = meta[:, 1].clamp(max=n_rows)
    assert int(meta[:, 1].max()) < stack.rows
    got = TS.tier_scan_plain(pp.T, pl, stack.text_packed, stack.sa,
                             stack.pad_cnt, meta)
    for want in _dense_tier_refs(jstack, stack, jp, jl, pp, pl, meta):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    if n_rows == 0:
        assert not any(int(x.abs().sum()) for x in got[:3])
        assert bool((got[3] == TS.BIG).all())


def _tablet_case(text_n, W):
    from repro.core.tablet import build_tablet_store as j_build
    from repro_torch.core.tablet import store_from_numpy
    codes = C.random_dna(text_n, seed=text_n)
    js = j_build(codes)
    store = store_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in
         ("text_packed", "text_codes", "sa")}
        | {k: getattr(js, k) for k in
           ("n_real", "n_pad", "is_dna", "max_query_len")}, device=CPU)
    return codes, js, store, C.extract_window(store.text_packed, store.sa, W)


@pytest.mark.parametrize("case", ["short_patterns", "mid_run_slices",
                                  "tiny_intervals", "longer_than_text",
                                  "empty"])
def test_tablet_scan_plain_search_edges(case):
    """The plain 17-ary tablet search against the Pallas kernel
    (interpret) and both dense plain versions: 1-base patterns over a
    whole store, slices of sorted rows that start and end inside a
    match run, slices of 1-33 rows (splitters repeat), patterns longer
    than the text (every prefix-equal row is truncated), and no rows."""
    W = 8 if case == "longer_than_text" else 4
    text_n = 20 if case == "longer_than_text" else 2000
    codes, js, store, win = _tablet_case(text_n, W)
    pats = ["A", "C", "G", "T", "AC", "GGT"] + \
        Q.random_patterns(20, 1, 4, seed=11)
    slices = [slice(None)]
    if case == "mid_run_slices":
        _, pp, pl = Q.encode_patterns(["C", "GA"], W * 16, device=CPU)
        lb, ub = (int(x) for x in Q.search_bounds_plain(store, pp[:1],
                                                         pl[:1]))
        lb2, ub2 = (int(x) for x in Q.search_bounds_plain(store, pp[1:],
                                                           pl[1:]))
        assert lb > 2 and ub - lb > 40 and ub2 - lb2 > 20
        slices = [slice(lb + 3, ub - 5), slice(lb - 2, lb + 7),
                  slice(ub - 4, ub + 9), slice(lb2 + 1, ub2 - 1)]
    elif case == "tiny_intervals":
        slices = [slice(700, 700 + n) for n in (1, 16, 17, 18, 33)]
    elif case == "longer_than_text":
        text = C.decode_dna(codes)
        pats = Q.random_patterns(10, 21, 128, seed=12) + [
            text + "A", text[5:] + "ACGT", text[5:], text, "A"]
    elif case == "empty":
        slices = [slice(5, 5)]
    _, jp, jl = JQ.encode_patterns(pats, W * 16)
    _, pp, pl = Q.encode_patterns(pats, W * 16, device=CPU)
    jwin = jnp.asarray(win.numpy())
    for i, sl in enumerate(slices):
        got = ops.tablet_scan(pp, pl, win[sl], store.sa[sl],
                              n_real=store.n_real)
        wants = [ref.tablet_scan_ref(pp.T, pl, win[sl].T, store.sa[sl],
                                     n_real=store.n_real)]
        if case == "empty":       # JAX's versions need a row
            wants.append((torch.zeros(len(pats)), torch.zeros(len(pats)),
                          torch.full((len(pats),), 2**30)))
        else:
            wants.append(JREF.tablet_scan_ref(jp.T, jl, jwin[sl].T,
                                              js.sa[sl], n_real=js.n_real))
        if case != "empty" and i == 0:   # one Pallas compile per case
            wants.append(JOPS.tablet_scan(jp, jl, jwin[sl], js.sa[sl],
                                          n_real=js.n_real))
        for want in wants:
            for name, g, w in zip(("count", "less", "first_row"), got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              f"{name} {sl}")


@pytest.mark.parametrize("n", [0, 1, 16, 17, 288, 289, 2**19, 2**26])
def test_kary_rounds_bound_the_search(n):
    """``kary.max_rounds`` is floor(log17 n) + 1 (7 for 2**26 rows, 5 for
    2**19), and every interval of n rows ends within it."""
    from repro_torch.kernels import kary
    want = 0 if n == 0 else int(np.floor(np.log(n) / np.log(17) + 1e-9)) + 1
    assert kary.max_rounds(n) == want
    if n <= 289:                  # walk every partition point
        for p in range(n + 1):
            def probe(rows, p=p):
                lt = rows < p
                return lt, torch.zeros_like(lt), torch.ones_like(rows)
            trace = []
            lb, ub = kary.search(n, 1, probe, device=CPU, trace=trace)
            assert (int(lb[0]), int(ub[0])) == (p, p)
            assert all(int(r.max()) < n for r, _ in trace if r.numel())


def test_build_digest_covers_headers(tmp_path, monkeypatch):
    """A library is named by its source AND every shared ``csrc/*.cuh``,
    so an edited header cannot load a stale library (no nvcc needed)."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert before == {n: _build.library_path(n) for n in _build.SOURCES}
    header = csrc / "search.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    assert all(after[n].name.startswith(n + "-") for n in _build.SOURCES)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 255, 256, 2**26])
def test_kary_binary_arity_bounds_the_search(n):
    """``arity=2`` (the binary search ``chip_smoke.py`` counts the bytes
    the searches need from) takes floor(log2 n) + 1 rounds at most and
    ends at every partition point, as the 17-ary search does."""
    from repro_torch.kernels import kary
    assert kary.max_rounds(n, 2) == (0 if n == 0 else n.bit_length())
    if n <= 256:
        for p in range(n + 1):
            def probe(rows, p=p):
                assert rows.shape[-1] == 1
                lt = rows < p
                return lt, torch.zeros_like(lt), torch.ones_like(rows)
            trace = []
            lb, ub = kary.search(n, 1, probe, device=CPU, trace=trace,
                                 arity=2)
            assert (int(lb[0]), int(ub[0])) == (p, p)
            assert sum(1 for r, _ in trace if r.numel()) <= n.bit_length()


@pytest.mark.parametrize("kernel", ["tablet", "tier"])
def test_plain_scans_binary_arity_match(kernel):
    """The tablet and tier plain versions give the same outputs by a
    binary search (``arity=2``) as by the kernels' 17-ary one, and the
    binary search probes no row past the sorted rows."""
    from repro_torch.kernels.tablet_scan import tablet_scan_plain
    if kernel == "tier":
        _, stack = _live_stacks(900, 3)
        pats = ["A", "C", "GT"] + Q.random_patterns(30, 1, 8, seed=21)
        _, pp, pl = Q.encode_patterns(pats, stack.max_query_len, device=CPU)
        meta = ops.tier_meta(stack)
        args = (pp.T, pl, stack.text_packed, stack.sa, stack.pad_cnt, meta)
        traces = []
        got = TS.tier_scan_plain(*args, trace=traces, arity=2)
        want = TS.tier_scan_plain(*args)
        for t, tr in enumerate(traces):
            assert all(int(r.max()) < int(meta[t, 1]) for r, _ in tr
                       if r.numel())
    else:
        _, _, store, win = _tablet_case(2000, 4)
        pats = ["A", "C", "GT"] + Q.random_patterns(30, 1, 8, seed=22)
        _, pp, pl = Q.encode_patterns(pats, 64, device=CPU)
        args = (pp.T, pl, win.T, store.sa)
        trace = []
        got = tablet_scan_plain(*args, n_real=store.n_real, trace=trace,
                                arity=2)
        want = tablet_scan_plain(*args, n_real=store.n_real)
        assert all(int(r.max()) < store.n_pad for r, _ in trace
                   if r.numel())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("base_n,chunks", [(900, 3), (2500, 5), (1400, 4)])
def test_tier_pad_prefix_is_padding(base_n, chunks):
    """The rows the tier sweep skips (``pad_prefix``) are every row of a
    tier whose position lies past its own text, all of them first in the
    sorted order; on a live stack the skip is taken."""
    _, stack = _live_stacks(base_n, chunks)
    skip = TS.pad_prefix(stack.pad_cnt)
    meta = ops.tier_meta(stack)
    for t in range(stack.num_tiers):
        n_rows = int(meta[t, 1])
        tl = int(meta[t, 4]) - int(meta[t, 2])
        pads = (stack.sa[t, :n_rows] >= tl).numpy()
        assert int(skip[t]) == pads.sum() > 0
        assert pads[:int(skip[t])].all()
    # a real row (the stack's last) moved to the front: no skip
    is_pad = torch.roll(stack.pad_cnt.diff(dim=1), 1, dims=1)
    bad = torch.nn.functional.pad(torch.cumsum(is_pad, 1), (1, 0))
    assert not TS.pad_prefix(bad).any()
