"""The frozen FM tier of the port against ``repro``'s, on the CPU.

Exact equality everywhere (every output is an integer): the index
arrays ``FMIndex.build`` makes; on one index carried across with
``FMIndex.from_numpy``, the backward search (against the JAX oracle and
the Pallas ``fm_scan_pallas`` kernel in interpret mode), rank, the LF
walks and ``ops.fm_search``; frozen tables against frozen ``repro``
tables base-only, after ``append`` and after ``minor_compact``; the
``fm_threshold`` policy.  Sizes include ``rows = n + 1`` multiples of 64
(n = 63, 127), where rank reaches one block past the BWT."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import SuffixTable as JTable  # noqa: E402
from repro.api.fm import FMIndex as JFM  # noqa: E402
from repro.api.fm import sa_is_fully_sorted as j_sorted  # noqa: E402
from repro.core import query as JQ  # noqa: E402
from repro.kernels import fm_scan as JFS, ops as JOPS  # noqa: E402
from repro_torch.api import FMIndex, SuffixTable  # noqa: E402
from repro_torch.api.fm import (MAX_VOCAB, sa_is_fully_sorted,  # noqa: E402
                                segment_bounds)
from repro_torch.core import codec as C, query as Q  # noqa: E402
from repro_torch.core.planner import MODE_FM, MODE_SINGLE  # noqa: E402
from repro_torch.kernels import _build, fm_scan as FS, ops  # noqa: E402

CPU = "cpu"
DNA_N = [63, 127, 130, 2048]
PATS = ["A", "ACGT", "GATTACA", "TTTT", "CCGG", "A" * 24, "ACGT" * 6]
FIELDS = ("found", "count", "first_rank", "first_pos")


def _assert_same_index(mine: FMIndex, want: JFM) -> None:
    got = mine.state_dict()
    for k, v in want.state_dict().items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, k)
    assert mine.extra_dict() == want.extra_dict()
    assert mine.resident_bytes() == want.resident_bytes()


def _dna_index(n: int, sample_rate: int = 8):
    codes = C.random_dna(n, seed=n)
    jfm = JFM.build(codes, None, is_dna=True, sample_rate=sample_rate)
    return codes, jfm, FMIndex.from_numpy(jfm.state_dict(),
                                          jfm.extra_dict(), device=CPU)


def _dna_patterns(codes, nq: int, seed: int) -> list[str]:
    """Random patterns (mostly misses past a few bases) plus substrings
    of the text (hits), at most 16 bases."""
    rng = np.random.default_rng(seed)
    text = C.decode_dna(codes)
    pats = Q.random_patterns(nq, 1, 12, seed=seed)
    for _ in range(40):
        lo = int(rng.integers(0, len(codes)))
        pats.append(text[lo:lo + int(rng.integers(1, 17))])
    return [p for p in pats if p]


# ---------------------------------------------------------------------------
# (a) the index arrays
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sample_rate", [8, 32])
@pytest.mark.parametrize("n", DNA_N)
def test_build_dna_matches_reference(n, sample_rate):
    codes = C.random_dna(n, seed=n)
    want = JFM.build(codes, None, is_dna=True, sample_rate=sample_rate)
    _assert_same_index(FMIndex.build(codes, None, is_dna=True,
                                     sample_rate=sample_rate, device=CPU),
                       want)
    # from a given (live) suffix array, as freeze() passes it
    live = SuffixTable.from_codes(codes, is_dna=True, device=CPU)
    _assert_same_index(FMIndex.build(codes, live.store.sa.numpy(),
                                     is_dna=True, sample_rate=sample_rate,
                                     device=CPU), want)


@pytest.mark.parametrize("vocab", [2, 5, 40])
def test_build_tokens_matches_reference(vocab):
    rng = np.random.default_rng(vocab)
    tokens = rng.integers(0, vocab, 1200).astype(np.int32)
    _assert_same_index(FMIndex.build(tokens, None, is_dna=False, device=CPU),
                       JFM.build(tokens, None, is_dna=False))


# ---------------------------------------------------------------------------
# (b) one index, both packages: search, rank, LF walks, fm_search
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", DNA_N)
def test_backward_search_matches_pallas_and_oracle(n):
    codes, jfm, fm = _dna_index(n)
    pats = _dna_patterns(codes, 150, seed=n)
    _, jp, jl = JQ.encode_patterns(pats, 16)
    _, pp, pl = Q.encode_patterns(pats, 16, device=CPU)
    jsyms = JFS.syms_from_packed(jp, jl, 16)
    syms = FS.syms_from_packed(pp, pl, 16)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(jsyms))
    lo, hi = FS.search_syms(fm.arrays, syms)
    jlo, jhi = JFS.search_syms(jfm.arrays, jsyms)
    padded, B = JOPS._pad_to(jsyms, JFS.BLOCK_Q, 1, fill=-1)
    klo, khi = JFS.fm_scan_pallas(padded, jfm.arrays.bwt, jfm.arrays.occ,
                                  JFS.pallas_meta(jfm.arrays),
                                  interpret=True)
    for got, want, kern in ((lo, jlo, klo), (hi, jhi, khi)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(kern)[:B])
    np.testing.assert_array_equal(FS.fm_meta(fm.arrays).numpy(),
                                  np.asarray(JFS.pallas_meta(jfm.arrays)))
    count, first_rank = fm.count(pp, pl)
    jcount, jfirst = jfm.count(jp, jl)
    np.testing.assert_array_equal(count, jcount)
    np.testing.assert_array_equal(first_rank, jfirst)
    cc = codes.astype(np.int32)
    for i, p in enumerate(pats[:30]):
        want, _ = Q.brute_force_count(cc, C.encode_dna(p).astype(np.int32))
        assert int(count[i]) == want, p


@pytest.mark.parametrize("W", [1, 2, 8])
@pytest.mark.parametrize("n", [63, 127, 130])
def test_fm_scan_packed_contract_matches_pallas(n, W):
    """The ``fm_scan`` kernel's contract over packed patterns (its plain
    version, ``backward_search``: ``search_syms`` over ``syms_from_packed(
    patt, plen, 16 W)``) against ``fm_scan_pallas`` in interpret mode
    over JAX's plan, with plen in {0, 1, 15, 16, 17, 16 W} and past 16 W
    (the plan's clamps), on indices with rows % 64 == 0 (n = 63, 127)
    and not (n = 130)."""
    codes, jfm, fm = _dna_index(n)
    text = C.decode_dna(codes)
    width = 16 * W
    lens = sorted({0, 1, 15, 16, 17, width, width + 5, 2 * width + 3})
    pats, plens = [], []
    for k, L in enumerate(lens):
        take = min(L, width)
        for src in (text[k:k + take], Q.random_patterns(1, take, take,
                                                        seed=k)[0]):
            pats.append(src[:take] if take else "")
            plens.append(L)
    _, jp, _ = JQ.encode_patterns(pats, width)
    _, pp, _ = Q.encode_patterns(pats, width, device=CPU)
    plen = np.asarray(plens, np.int32)
    lo, hi = FS.backward_search(fm.arrays, pp, torch.from_numpy(plen))
    jsyms = JFS.syms_from_packed(jp, jnp.asarray(plen), width)
    padded, B = JOPS._pad_to(jsyms, JFS.BLOCK_Q, 1, fill=-1)
    klo, khi = JFS.fm_scan_pallas(padded, jfm.arrays.bwt, jfm.arrays.occ,
                                  JFS.pallas_meta(jfm.arrays),
                                  interpret=True)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(klo)[:B])
    np.testing.assert_array_equal(hi.numpy(), np.asarray(khi)[:B])
    assert (int(lo[0]), int(hi[0])) == (0, n + 1)       # plen 0: all rows
    assert fm.arrays.meta is fm.arrays.meta             # built once
    np.testing.assert_array_equal(fm.arrays.meta.numpy(),
                                  np.asarray(JFS.pallas_meta(jfm.arrays)))


def test_fm_search_kernel_path_builds_no_plan(monkeypatch):
    """On the kernel's path (``ops._fm_kernel`` true, as for a packed
    CUDA batch) ``ops.fm_search`` hands the packed patterns and the
    index's cached meta to ``fm_scan_cuda`` and builds no symbol plan."""
    codes, _jfm, fm = _dna_index(130)
    pats = _dna_patterns(codes, 40, seed=3)
    _, pp, pl = Q.encode_patterns(pats, 32, device=CPU)
    want = ops.fm_search(fm.arrays, pp, pl)
    lo_hi = FS.backward_search(fm.arrays, pp, pl)
    calls = []

    def fake_kernel(patterns, plen, bwt, occ, meta):
        calls.append((patterns, plen, bwt, occ, meta))
        return lo_hi

    def no_plan(*_a, **_k):
        raise AssertionError("the kernel path built a symbol plan")

    monkeypatch.setattr(ops, "_fm_kernel", lambda arrays, patterns: True)
    monkeypatch.setattr(FS, "fm_scan_cuda", fake_kernel)
    monkeypatch.setattr(FS, "syms_from_packed", no_plan)
    monkeypatch.setattr(FS, "syms_from_codes", no_plan)
    got = ops.fm_search(fm.arrays, pp, pl)
    assert len(calls) == 1
    patterns, plen, bwt, occ, meta = calls[0]
    assert patterns is pp and plen is pl and meta is fm.arrays.meta
    assert bwt is fm.arrays.bwt and occ is fm.arrays.occ
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("n", DNA_N)
def test_rank_and_lf_walk_match_reference(n):
    """Every (symbol, row) rank — i = rows included, which reaches past
    the BWT when rows % 64 == 0 — and the LF walk of every row."""
    _codes, jfm, fm = _dna_index(n)
    rows = n + 1
    i = np.tile(np.arange(rows + 1, dtype=np.int32), 4)
    c = np.repeat(np.arange(4, dtype=np.int32), rows + 1)
    got = FS.rank(fm.arrays, torch.from_numpy(c), torch.from_numpy(i))
    want = JFS.rank(jfm.arrays, jnp.asarray(c), jnp.asarray(i))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    r = np.arange(rows, dtype=np.int64)
    np.testing.assert_array_equal(fm.ranks_to_positions(r).numpy(),
                                  jfm.ranks_to_positions(r))
    np.testing.assert_array_equal(
        FS.lf_walk(fm.arrays, torch.from_numpy(r)).numpy(),
        np.asarray(JFS.lf_walk(jfm.arrays, jnp.asarray(r, jnp.int32))))
    np.testing.assert_array_equal(fm.suffix_array().numpy(),
                                  jfm.suffix_array())
    # segment minimums over runs of rows: the text-order first_pos
    starts = np.array([1, 5, rows - 3, 2], np.int64)
    counts = np.array([4, 1, 3, rows - 2], np.int64)
    want = [jfm.ranks_to_positions(np.arange(s, s + k)).min()
            for s, k in zip(starts, counts)]
    np.testing.assert_array_equal(
        fm.segment_min_positions(starts, counts)[0].numpy(), want)


@pytest.mark.parametrize("n", DNA_N)
def test_fm_search_matches_reference(n):
    codes, jfm, fm = _dna_index(n)
    pats = _dna_patterns(codes, 120, seed=n + 1)
    _, jp, jl = JQ.encode_patterns(pats, 32)
    _, pp, pl = Q.encode_patterns(pats, 32, device=CPU)
    got = ops.fm_search(fm.arrays, pp, pl)
    want = JOPS.fm_search(jfm.arrays, jp, jl)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert bool((got.first_rank[~got.found] == -1).all())


@pytest.mark.parametrize("n", DNA_N)
def test_fm_search_can_skip_the_first_pos_walk(n):
    """The table path derives text-order positions itself: without the
    walk every field but ``first_pos`` (then -1) is unchanged."""
    codes, _jfm, fm = _dna_index(n)
    pats = _dna_patterns(codes, 60, seed=n + 2)
    _, pp, pl = Q.encode_patterns(pats, 32, device=CPU)
    full = ops.fm_search(fm.arrays, pp, pl)
    bare = ops.fm_search(fm.arrays, pp, pl, first_pos=False)
    for f in ("found", "count", "first_rank"):
        assert torch.equal(getattr(bare, f), getattr(full, f)), f
    assert bool((bare.first_pos == -1).all())


@pytest.mark.parametrize("vocab", [2, 5, 40])
def test_token_search_matches_reference(vocab):
    rng = np.random.default_rng(vocab)
    tokens = rng.integers(0, vocab, 1200).astype(np.int32)
    jfm = JFM.build(tokens, None, is_dna=False)
    fm = FMIndex.from_numpy(jfm.state_dict(), jfm.extra_dict(), device=CPU)
    patt = np.zeros((12, 8), np.int32)
    plen = np.zeros(12, np.int32)
    for i in range(10):
        lo = int(rng.integers(0, 1190))
        k = int(rng.integers(1, 9))
        patt[i, :k] = tokens[lo:lo + k]
        plen[i] = k
    patt[10, :2] = [vocab + 7, 0]            # out-of-vocab: empty run
    plen[10] = 2
    plen[11] = 0                             # matches every row
    got = ops.fm_search(fm.arrays, torch.from_numpy(patt),
                        torch.from_numpy(plen))
    want = JOPS.fm_search(jfm.arrays, jnp.asarray(patt), jnp.asarray(plen))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert int(got.count[10]) == 0
    r = np.arange(1201)
    np.testing.assert_array_equal(fm.ranks_to_positions(r).numpy(),
                                  jfm.ranks_to_positions(r))


# ---------------------------------------------------------------------------
# (c) frozen tables: base only, after append, after minor_compact
# ---------------------------------------------------------------------------
def _assert_tables_agree(jt, pt, pats, top_k=5):
    a, b = jt.scan(pats, top_k=top_k), pt.scan(pats, top_k=top_k)
    for f in ("found", "count", "first_pos", "positions"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    jp, jl = jt.planner.encode(pats)
    pp, pl = pt.planner.encode(pats)
    for j_res, p_res in ((jt.planner.scan_encoded(jp, jl),
                          pt.planner.scan_encoded(pp, pl)),
                         (jt.scan_encoded(jp, jl), pt.scan_encoded(pp, pl))):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(p_res, f).numpy(),
                                          np.asarray(getattr(j_res, f)), f)
    np.testing.assert_array_equal(pt.locate(pats, top_k=3),
                                  jt.locate(pats, top_k=3))


@pytest.mark.parametrize("n", [127, 2048])
def test_frozen_table_matches_reference_through_appends(n):
    codes = C.random_dna(n, seed=n + 2)
    kw = dict(is_dna=True, max_query_len=32)
    jt = JTable.from_codes(codes, **kw)
    jt.freeze()
    pt = SuffixTable.from_codes(codes, device=CPU, **kw)
    assert pt.freeze() is pt and pt.is_frozen
    live = SuffixTable.from_codes(codes, device=CPU, **kw)
    pats = [p for p in PATS if len(p) <= n] + _dna_patterns(codes, 30, n)
    _assert_tables_agree(jt, pt, pats)
    _assert_tables_agree(jt, live, pats)             # frozen == live
    extra = "GATTACA" * 2 + C.decode_dna(C.random_dna(300, seed=n))
    for t in (jt, pt, live):
        t.append(extra)                           # boundary-straddling
    _assert_tables_agree(jt, pt, pats)
    _assert_tables_agree(jt, live, pats)
    for t in (jt, pt, live):
        t.minor_compact()
        t.append(C.random_dna(90, seed=n + 3))
    assert len(pt.runs) == 1 and pt.memtable.size == 90
    _assert_tables_agree(jt, pt, pats)
    _assert_tables_agree(jt, live, pats)
    for p in ("AC", "GATTA"):
        np.testing.assert_array_equal(pt.locate_range(p, limit=None),
                                      jt.locate_range(p, limit=None))
    s = pt.stats()["planner"]
    assert s["mode_counts"][MODE_FM] > 0 and s["mode_counts"][MODE_SINGLE] == 0
    assert s["fused_batches"] > 0


@pytest.mark.parametrize("vocab", [2, 5, 40])
def test_frozen_token_table_matches_reference(vocab):
    rng = np.random.default_rng(vocab)
    tokens = rng.integers(0, vocab, 1200).astype(np.int32)
    kw = dict(is_dna=False, max_query_len=32)
    jt = JTable.from_codes(tokens, **kw)
    jt.freeze()
    pt = SuffixTable.from_codes(tokens, device=CPU, **kw).freeze()
    W = 8
    patt = np.zeros((10, W), np.int32)
    plen = np.zeros(10, np.int32)
    for i in range(8):
        lo = int(rng.integers(0, 1200 - W))
        k = int(rng.integers(1, W + 1))
        patt[i, :k] = tokens[lo:lo + k]
        plen[i] = k
    patt[8, :4] = rng.integers(0, vocab, 4)
    plen[8] = 4
    patt[9, :2] = [vocab + 7, 0]             # out-of-vocab symbol
    plen[9] = 2
    for step in range(2):
        a = jt.scan_batch(jnp.asarray(patt), jnp.asarray(plen), top_k=4)
        b = pt.scan_batch(torch.from_numpy(patt), torch.from_numpy(plen),
                          top_k=4)
        for f in ("count", "first_pos", "positions"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
        assert int(b.count[9]) == 0
        more = rng.integers(0, vocab, 150).astype(np.int32)
        jt.append(more)
        pt.append(more)


def test_frozen_planner_modes_and_unported_persistence(tmp_path):
    pt = SuffixTable.from_codes(C.random_dna(500, seed=1), is_dna=True,
                                device=CPU).freeze()
    patt, plen = pt.planner.encode(["ACG", "T"])
    assert pt.planner.plan(2).mode == MODE_FM
    with pytest.raises(ValueError, match="frozen"):
        pt.planner.scan_encoded(patt, plen, mode=MODE_SINGLE)
    live = SuffixTable.from_codes(C.random_dna(500, seed=1), is_dna=True,
                                  device=CPU)
    with pytest.raises(ValueError, match="frozen"):
        live.planner.scan_encoded(patt, plen, mode=MODE_FM)
    # frozen tables serve single-replica: the planner has no mesh
    assert pt.planner.mesh is None and pt.mesh is None
    for mode in ("broadcast", "routed"):
        with pytest.raises(ValueError, match="requires a mesh"):
            pt.planner.scan_encoded(patt, plen, mode=mode)
    with pytest.raises(ValueError, match="unknown"):
        pt.planner.scan_encoded(patt, plen, mode="nope")
    # persistence is ported: the artifact round-trips, a missing one
    # loads as None (the caller rebuilds from codes)
    pt.fm.save(str(tmp_path / "fm"), 0)
    back = FMIndex.load(str(tmp_path / "fm"), device=CPU)
    assert back.n == pt.fm.n and back.sample_rate == pt.fm.sample_rate
    np.testing.assert_array_equal(back.bwt, pt.fm.bwt)
    assert FMIndex.load(str(tmp_path / "missing"), device=CPU) is None
    assert pt.count(["A"])[0] > 0
    assert "dispatch_fm" in pt.stats()["latency"]


# ---------------------------------------------------------------------------
# (d) the fm_threshold policy, the vocab cap, sa_is_fully_sorted
# ---------------------------------------------------------------------------
def test_fm_threshold_policy_and_vocab_cap():
    t = SuffixTable.from_codes(C.random_dna(500, seed=7), is_dna=True,
                               fm_threshold=600, device=CPU)
    assert not t.is_frozen
    t.append(C.decode_dna(C.random_dna(200, seed=8)))
    assert not t.is_frozen                      # the memtable doesn't count
    t2 = SuffixTable.from_codes(C.random_dna(600, seed=7), is_dna=True,
                                fm_threshold=600, device=CPU)
    assert t2.is_frozen and t2.stats()["tiers"]["frozen"]
    big = np.random.default_rng(0).integers(0, 50_000, 300).astype(np.int32)
    tb = SuffixTable.from_codes(big, is_dna=False, max_query_len=16,
                                fm_threshold=10, device=CPU)
    assert not tb.is_frozen                     # policy no-op above the cap
    with pytest.raises(ValueError, match="vocab"):
        tb.freeze()
    with pytest.raises(ValueError, match="vocab"):
        FMIndex.build(np.arange(MAX_VOCAB + 1, dtype=np.int32), None,
                      is_dna=False, device=CPU)
    with pytest.raises(ValueError, match="empty"):
        FMIndex.build(np.zeros(0, np.uint8), None, is_dna=True, device=CPU)
    with pytest.raises(ValueError, match="does not match"):
        t._attach_frozen(FMIndex.build(C.random_dna(499, seed=1), None,
                                       is_dna=True, device=CPU))


def test_sa_is_fully_sorted_matches_reference():
    codes = C.encode_dna("A" * 64)
    n = codes.size
    true_sa = np.arange(n - 1, -1, -1).astype(np.int64)   # shortest first
    rng = np.random.default_rng(3)
    dna = C.random_dna(300, seed=3)
    sa = SuffixTable.from_codes(dna, is_dna=True,
                                device=CPU).store.sa.numpy()
    swapped = sa.copy()
    swapped[[10, 11]] = swapped[[11, 10]]
    cases = [(codes, true_sa, True), (codes, true_sa[::-1].copy(), False),
             (codes, np.zeros(n, np.int64), False),
             (codes, true_sa[:-1].copy(), False),
             (dna, sa, True), (dna, swapped, False),
             (dna, rng.permutation(300), False),
             (codes[:1], np.zeros(1, np.int64), True),
             (codes[:0], np.zeros(0, np.int64), True)]
    for c, s, want in cases:
        assert bool(sa_is_fully_sorted(c, s)) is want
        assert bool(j_sorted(c, s)) is want
    # out-of-range rows are no order (the reference indexes past its
    # rank array there)
    assert not sa_is_fully_sorted(codes, np.full(n, n, np.int64))
    assert not sa_is_fully_sorted(codes, np.full(n, -1, np.int64))


def test_lf_walk_chunks_split_segments(monkeypatch):
    """Chunks of the device LF walk cut through segments and rows; the
    results do not depend on where."""
    _codes, _jfm, fm = _dna_index(2048)
    starts = np.array([1, 300, 1000, 1500], np.int64)
    counts = np.array([40, 3, 450, 549], np.int64)
    rows = np.arange(1, 2049, dtype=np.int64)
    want_min = fm.segment_min_positions(starts, counts)[0].numpy()
    want_pos = fm.ranks_to_positions(rows).numpy()
    monkeypatch.setattr("repro_torch.api.fm.LF_CHUNK", 37)
    np.testing.assert_array_equal(
        fm.segment_min_positions(starts, counts)[0].numpy(), want_min)
    np.testing.assert_array_equal(fm.ranks_to_positions(rows).numpy(),
                                  want_pos)
    np.testing.assert_array_equal(
        want_min, [want_pos[s - 1:s - 1 + k].min()
                   for s, k in zip(starts, counts)])


# ---------------------------------------------------------------------------
# (e) the lf_walk kernel's contract, as far as the CPU reaches it
# ---------------------------------------------------------------------------
def _segments(n: int, sent_row: int):
    """(starts, counts) of SA$ row segments inside [1, n]: one-row
    segments, segments at row 1 and ending at row n, segments just
    before, over and just after ``sent_row``, and one over every row."""
    def cut(s, k):                    # kept inside [1, n]
        s = min(max(1, s), n)
        return s, min(k, n + 1 - s)
    segs = [cut(1, 1), cut(n, 1), cut(1, 5), cut(n - 4, 5),
            cut(sent_row - 3, 3), cut(sent_row - 1, 3), cut(sent_row, 1),
            cut(sent_row + 1, 4), cut(n // 2, 1), cut(1, n)]
    return (np.array([s for s, _ in segs], np.int64),
            np.array([k for _, k in segs], np.int64))


@pytest.mark.parametrize("n", DNA_N)
def test_segment_bounds_give_the_reference_minimum(n):
    """The host bounds the kernel takes (starts over the prefix sums of
    the counts, and their total) name exactly each segment's rows, and
    the minimum over them is the JAX index's, on indexes whose ``rows``
    is a multiple of 64 (n = 63, 127) and not."""
    _codes, jfm, fm = _dna_index(n)
    starts, counts = _segments(n, fm.sent_row)
    bounds, total = segment_bounds(starts, counts)
    assert bounds.dtype == np.int64 and bounds.shape == (2, len(starts))
    np.testing.assert_array_equal(bounds[0], starts)
    np.testing.assert_array_equal(bounds[1], np.cumsum(counts))
    assert total == int(counts.sum())
    # each flat index k belongs to the first segment whose end is past k
    k = np.arange(total)
    seg = np.searchsorted(bounds[1], k, side="right")
    begin = np.concatenate(([0], bounds[1][:-1]))
    rows = bounds[0][seg] + (k - begin[seg])
    np.testing.assert_array_equal(
        rows, np.concatenate([np.arange(s, s + c)
                              for s, c in zip(starts, counts)]))
    want = [jfm.ranks_to_positions(np.arange(s, s + c)).min()
            for s, c in zip(starts, counts)]
    np.testing.assert_array_equal(
        fm.segment_min_positions(starts, counts)[0].numpy(), want)
    assert segment_bounds([], [])[1] == 0
    assert fm.segment_min_positions([], [])[0].numel() == 0


def test_lf_walk_wrappers_raise_off_the_kernel_contract(monkeypatch):
    """The kernel's wrappers take a packed-DNA index on CUDA and int64
    rows or (2, S) bounds on its device; everything else raises before
    anything is built."""
    def no_build(*a, **kw):
        raise AssertionError("the kernel was built")
    monkeypatch.setattr(_build, "launcher", no_build)
    _codes, _jfm, fm = _dna_index(127)
    fa = fm.arrays
    rows = torch.arange(1, 9, dtype=torch.int64)
    bounds = torch.from_numpy(segment_bounds([1, 5], [3, 2])[0])
    with pytest.raises(ValueError, match="CUDA"):
        FS.lf_walk_cuda(fa, rows)
    with pytest.raises(ValueError, match="CUDA"):
        FS.lf_walk_min_cuda(fa, bounds, 5)
    with pytest.raises(ValueError, match="int64"):
        FS.lf_walk_cuda(fa, rows.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous 1-D"):
        FS.lf_walk_cuda(fa, rows[::2])
    with pytest.raises(ValueError, match="int64"):
        FS.lf_walk_min_cuda(fa, bounds.to(torch.int32), 5)
    with pytest.raises(ValueError, match=r"\(2, S\)"):
        FS.lf_walk_min_cuda(fa, bounds.reshape(-1), 5)
    tokens = np.random.default_rng(5).integers(0, 5, 300).astype(np.int32)
    tfa = FMIndex.build(tokens, None, is_dna=False, device=CPU).arrays
    with pytest.raises(ValueError, match="packed-DNA"):
        FS.lf_walk_cuda(tfa, rows)
    with pytest.raises(ValueError, match="packed-DNA"):
        FS.lf_walk_min_cuda(tfa, bounds, 5)


@pytest.mark.parametrize("is_dna", [True, False])
def test_cpu_walks_take_the_plain_walk(monkeypatch, is_dna):
    """On the CPU (and for a token index anywhere) every LF walk is the
    plain ``lf_walk``: nothing is built or launched, and the answers are
    the JAX index's."""
    def no_build(*a, **kw):
        raise AssertionError("the kernel was built")
    monkeypatch.setattr(_build, "launcher", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    before = dict(_build.LAUNCHES)
    if is_dna:
        codes, jfm, fm = _dna_index(130)
    else:
        codes = np.random.default_rng(9).integers(0, 6, 130).astype(np.int32)
        jfm = JFM.build(codes, None, is_dna=False)
        fm = FMIndex.from_numpy(jfm.state_dict(), jfm.extra_dict(),
                                device=CPU)
    assert not FS.walks_on_kernel(fm.arrays)
    r = np.arange(131, dtype=np.int64)
    np.testing.assert_array_equal(fm.ranks_to_positions(r).numpy(),
                                  jfm.ranks_to_positions(r))
    np.testing.assert_array_equal(FS.walk_rows(fm.arrays, r).numpy(),
                                  jfm.ranks_to_positions(r))
    np.testing.assert_array_equal(fm.suffix_array().numpy(),
                                  jfm.suffix_array())
    starts, counts = _segments(130, fm.sent_row)
    mins, walked = fm.segment_min_positions(starts, counts)
    np.testing.assert_array_equal(
        mins.numpy(),
        [jfm.ranks_to_positions(np.arange(s, s + c)).min()
         for s, c in zip(starts, counts)])
    assert walked == 0
    assert _build.LAUNCHES == before


def test_build_names_the_lf_walk_kernel():
    """The walk kernel is one of the built sources, counted per launch,
    and its source is where the build looks for it."""
    assert "lf_walk" in _build.SOURCES and "lf_walk" in _build.LAUNCHES
    assert (_build.CSRC / "lf_walk.cu").is_file()
    assert _build.library_path("lf_walk").name.startswith("lf_walk-")
