"""The hand-written CUDA kernels against their plain PyTorch versions.

Marked ``cuda``: they need the card (a CUDA kernel has no CPU mode) and
skip without one.  This file imports no JAX, so it runs on the card's
machine as is::

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import codec as C, query as Q  # noqa: E402
from repro_torch.kernels import ops, ref, tier_scan as TS  # noqa: E402


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: kernels run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 1000, 50001])
def test_pack2bit_kernel_matches_plain(cuda, n):
    from repro_torch.kernels.pack2bit import pack2bit_cuda
    c = torch.from_numpy(C.random_dna(n, seed=n)).to(cuda)
    got = pack2bit_cuda(c)
    torch.cuda.synchronize()
    want = ops.pack2bit(c.cpu())
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,text_n", [(1, 1, 64), (300, 7, 3000),
                                        (1000, 4, 777)])
def test_pattern_compare_and_search_kernels_match_plain(cuda, B, W, text_n):
    from repro_torch.core.tablet import build_tablet_store
    from repro_torch.kernels.pattern_scan import (bounded_search_cuda,
                                                  bounded_search_plain,
                                                  pattern_compare_cuda)
    store = build_tablet_store(C.random_dna(text_n, seed=B), device=cuda)
    pats = Q.random_patterns(B, 1, W * 16, seed=(B, W))
    _, pp, pl = Q.encode_patterns(pats, W * 16, device=cuda)
    pos = store.sa[:B].repeat(B // store.n_pad + 1)[:B]
    win = C.extract_window(store.text_packed, pos, W)
    got = pattern_compare_cuda(win, pp, pl, pos, n_real=store.n_real)
    want = ref.pattern_compare_ref(win.T, pp.T, pl, pos,
                                   n_real=store.n_real)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    lb, ub = bounded_search_cuda(store.sa, store.text_packed, store.n_real,
                                 pp, pl, store.n_pad)
    plb, pub = Q.search_bounds_plain(store, pp, pl)
    assert torch.equal(lb, plb) and torch.equal(ub, pub)
    klb, kub = bounded_search_plain(store.sa, store.text_packed,
                                    store.n_real, pp, pl, store.n_pad)
    assert torch.equal(lb, klb) and torch.equal(ub, kub)


def _search_case(cuda, case):
    """(store, patterns) for one edge of the base search: 1- to 3-base
    patterns; patterns of exactly 16 W = 128 bases; patterns longer than
    a 20-base text; a store with 200 pad rows (and the empty pattern);
    stores of 1, 16, 17 and 18 rows."""
    from repro_torch.core.tablet import build_tablet_store
    if case.startswith("rows_"):
        n, min_rows = int(case[5:]), 0
    else:
        n = {"longer_than_text": 20, "pad_rows": 1000}.get(case, 2000)
        min_rows = 1200 if case == "pad_rows" else 0
    codes = C.random_dna(n, seed=n)
    store = build_tablet_store(codes, min_rows=min_rows, device=cuda)
    text = C.decode_dna(codes)
    if case.startswith("rows_"):
        pats = Q.random_patterns(30, 1, 8, seed=5) + [
            text, text[1:], text + "A", "A", "C"]
    elif case == "longer_than_text":
        pats = Q.random_patterns(20, 21, 128, seed=12) + [
            text + "A", text[5:] + "ACGT", text[5:], text, "A"]
    elif case == "short_patterns":
        pats = ["A", "C", "G", "T"] + Q.random_patterns(300, 1, 3, seed=7)
    elif case == "full_width":
        pats = Q.random_patterns(10, 128, 128, seed=9) + [
            text[i:i + 128] for i in (0, 17, 500, len(text) - 128)]
    else:
        pats = ["", "A", "AAAA", "T" * 9] + Q.random_patterns(
            30, 1, 40, seed=13) + [text[-5:], text[-1:]]
    return store, pats


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["short_patterns", "full_width",
                                  "longer_than_text", "pad_rows", "rows_1",
                                  "rows_16", "rows_17", "rows_18"])
def test_bounded_search_kernel_search_edges(cuda, case):
    """The 17-ary warp search against its plain version and the binary
    search, exactly, at the search's edges."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.pattern_scan import (bounded_search_cuda,
                                                  bounded_search_plain)
    store, pats = _search_case(cuda, case)
    _, pp, pl = Q.encode_patterns(pats, 128, device=cuda)
    args = (store.sa, store.text_packed, store.n_real, pp, pl, store.n_pad)
    before = _build.LAUNCHES["bounded_search"]
    lb, ub = bounded_search_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bounded_search"] == before + 1
    for want in (bounded_search_plain(*args),
                 Q.search_bounds_plain(store, pp, pl)):
        assert torch.equal(lb, want[0]) and torch.equal(ub, want[1])
    res = Q.query(store, pp, pl)                       # the kernel path
    assert torch.equal(res.count, ub - lb)


def _tier_outputs_agree(stack, pats, meta=None):
    """The tier kernel on the stacked packed text and sa against its
    plain 17-ary version and the dense plain version on ``meta``, and,
    with the stack's own meta, the binary-search twin."""
    _, pp, pl = Q.encode_patterns(pats, stack.max_query_len,
                                  device=stack.device)
    own = meta is None
    meta = ops.tier_meta(stack) if own else meta
    args = (pp.T, pl, stack.text_packed, stack.sa, stack.pad_cnt, meta)
    got = TS.tier_scan_cuda(*args)
    torch.cuda.synchronize()
    wants = [TS.tier_scan_plain(*args),
             ref.tier_scan_ref(pp.T, pl, ref.tier_windows(stack, pp.shape[1]),
                               stack.sa, meta)]
    if own:
        wants.append(TS.fused_tier_scan(stack, pp, pl))
    for want in wants:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    return got


def _cuda_stack(cuda, base_n, limit, chunks):
    from repro_torch.api import SuffixTable
    table = SuffixTable.from_codes(C.random_dna(base_n, seed=3), is_dna=True,
                                   memtable_limit=limit, device=cuda)
    for i, n in enumerate(chunks):
        table.append(C.random_dna(n, seed=1000 + i))
    return table._tierset().stack


@pytest.mark.cuda
def test_tier_scan_kernel_matches_plain(cuda):
    from repro_torch.kernels import _build
    stack = _cuda_stack(cuda, 1400, 260, [150] * 4)
    pats = Q.random_patterns(130, 1, 12, seed=130)
    _tier_outputs_agree(stack, pats)
    _, pp, pl = Q.encode_patterns(pats, stack.max_query_len, device=cuda)
    before = _build.LAUNCHES["tier_scan"]
    ops.fused_tiers(stack, pp, pl)             # the merged read's route
    assert _build.LAUNCHES["tier_scan"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["short_patterns", "longer_than_tier",
                                  "rows_below_stack"])
def test_tier_scan_kernel_search_edges(cuda, case):
    """1- to 3-base patterns (runs of a quarter of a tier, swept by a
    whole block), patterns longer than every tier's text (base 30 <
    max_query_len), and tiers cut to 0, 1, 16, 17, 18 sorted rows."""
    if case == "longer_than_tier":
        stack = _cuda_stack(cuda, 30, 16, [20, 10])
        pats = Q.random_patterns(40, 65, 128, seed=8) + ["A"]
        assert max(map(len, pats)) > int(stack.n_real.max())
        _tier_outputs_agree(stack, pats)
        return
    stack = _cuda_stack(cuda, 5000, 2000, [3000, 1500])
    pats = ["A", "C", "G", "T", "AC", "TTT"] + \
        Q.random_patterns(200, 1, 3, seed=7)
    if case == "short_patterns":
        got = _tier_outputs_agree(stack, pats)
        assert int(got[2][:, 0].min()) > 256       # 'A': longer than a block
        return
    for n_rows in (0, 1, 16, 17, 18):
        meta = ops.tier_meta(stack)
        meta[:, 1] = meta[:, 1].clamp(max=n_rows)
        got = _tier_outputs_agree(stack, pats, meta)
        if n_rows == 0:
            assert bool((got[3] == TS.BIG).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nq,text_n,rows", [(16, 512, None),
                                            (150, 2000, slice(0, 1999)),
                                            (260, 4096, slice(1000, 2001))])
def test_tablet_scan_kernel_matches_plain(cuda, nq, text_n, rows):
    from repro_torch.core.tablet import build_tablet_store
    from repro_torch.kernels.tablet_scan import (tablet_scan_cuda,
                                                 tablet_scan_plain)
    store = build_tablet_store(C.random_dna(text_n, seed=text_n),
                               device=cuda)
    W = 7
    pats = Q.random_patterns(nq, 1, 12, seed=nq)
    _, pp, pl = Q.encode_patterns(pats, W * 16, device=cuda)
    wt = C.extract_window(store.text_packed, store.sa, W).T.contiguous()
    sl = slice(None) if rows is None else rows   # ragged slices of rows
    got = tablet_scan_cuda(pp.T.contiguous(), pl, wt[:, sl], store.sa[sl],
                           n_real=store.n_real)
    want = ref.tablet_scan_ref(pp.T, pl, wt[:, sl], store.sa[sl],
                               n_real=store.n_real)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    plain = tablet_scan_plain(pp.T, pl, wt[:, sl], store.sa[sl],
                              n_real=store.n_real)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)
    if rows is None:                 # over the whole table: the bounds
        lb, ub = Q.search_bounds_plain(store, pp, pl)
        assert torch.equal(got[0], ub - lb)
        assert torch.equal(got[1], lb)
        assert torch.equal(got[2], torch.where(ub > lb, lb, 2**30))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["short_patterns", "mid_run_slices",
                                  "tiny_intervals", "longer_than_text",
                                  "empty"])
def test_tablet_scan_kernel_search_edges(cuda, case):
    """The tablet kernel against its plain 17-ary version and the dense
    plain version: 1-base patterns, slices that start and end inside a
    match run, slices of 1-33 rows, patterns longer than the text (W =
    8, 128 bases), and no rows."""
    from repro_torch.core.tablet import build_tablet_store
    from repro_torch.kernels.tablet_scan import (tablet_scan_cuda,
                                                 tablet_scan_plain)
    text_n = 20 if case == "longer_than_text" else 20000
    W = 8 if case == "longer_than_text" else 4
    codes = C.random_dna(text_n, seed=text_n)
    store = build_tablet_store(codes, device=cuda)
    wt = C.extract_window(store.text_packed, store.sa, W).T.contiguous()
    pats = ["A", "C", "G", "T", "AC", "GGT"] + \
        Q.random_patterns(300, 1, 6, seed=11)
    slices = [slice(None)]
    if case == "mid_run_slices":
        _, pp, pl = Q.encode_patterns(["C", "GA"], W * 16, device=cuda)
        (lb, lb2), (ub, ub2) = (x.tolist() for x in
                                Q.search_bounds_plain(store, pp, pl))
        slices = [slice(lb + 3, ub - 5), slice(lb - 2, lb + 7),
                  slice(ub - 4, ub + 9), slice(lb2 + 1, ub2 - 1)]
    elif case == "tiny_intervals":
        slices = [slice(7000, 7000 + n) for n in (1, 16, 17, 18, 33)]
    elif case == "longer_than_text":
        text = C.decode_dna(codes)
        pats = Q.random_patterns(50, 21, 128, seed=12) + [
            text + "A", text[5:] + "ACGT", text[5:], text, "A"]
    elif case == "empty":
        slices = [slice(5, 5)]
    _, pp, pl = Q.encode_patterns(pats, W * 16, device=cuda)
    pt = pp.T.contiguous()
    for sl in slices:
        got = tablet_scan_cuda(pt, pl, wt[:, sl], store.sa[sl],
                               n_real=store.n_real)
        torch.cuda.synchronize()
        for want in (tablet_scan_plain(pt, pl, wt[:, sl], store.sa[sl],
                                       n_real=store.n_real),
                     ref.tablet_scan_ref(pt, pl, wt[:, sl], store.sa[sl],
                                         n_real=store.n_real)):
            for g, w in zip(got, want):
                assert torch.equal(g, w), sl


@pytest.mark.cuda
@pytest.mark.parametrize("n", [127, 130, 4095])   # rows = 128, 4096: % 64 == 0
def test_fm_scan_kernel_matches_plain(cuda, n):
    from repro_torch.api import FMIndex
    from repro_torch.kernels import fm_scan as FM
    codes = C.random_dna(n, seed=n)
    fm = FMIndex.build(codes, None, is_dna=True, sample_rate=8, device=cuda)
    pats = Q.random_patterns(300, 1, 40, seed=n) + [
        C.decode_dna(codes[3:40]), C.decode_dna(codes[-20:])]
    _, pp, pl = Q.encode_patterns(pats, 48, device=cuda)
    fa = fm.arrays
    syms = FM.syms_from_packed(pp, pl, pp.shape[1] * 16)
    got = FM.fm_scan_cuda(pp, pl, fa.bwt, fa.occ, fa.meta)
    want = FM.search_syms(fa, syms)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cpu = FMIndex.build(codes, None, is_dna=True, sample_rate=8,
                        device="cpu")
    for g, w in zip(got, FM.search_syms(cpu.arrays, syms.cpu())):
        assert torch.equal(g.cpu(), w)
    res = ops.fm_search(fa, pp, pl)                    # kernel path
    res_cpu = ops.fm_search(cpu.arrays, pp.cpu(), pl.cpu())
    for name in ("found", "count", "first_rank", "first_pos"):
        assert torch.equal(getattr(res, name).cpu(), getattr(res_cpu, name))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2, 8])
@pytest.mark.parametrize("n", [63, 127, 130])
def test_fm_scan_kernel_plen_edges(cuda, n, W):
    """plen in {0, 1, 15, 16, 17, 16 W} and past 16 W (the plan's
    clamps), on indices with rows % 64 == 0 (n = 63, 127) and not: the
    kernel over packed patterns against ``search_syms`` over the plan,
    exactly, and ``ops.fm_search`` launches it."""
    from repro_torch.api import FMIndex
    from repro_torch.kernels import _build
    from repro_torch.kernels import fm_scan as FM
    codes = C.random_dna(n, seed=n)
    fa = FMIndex.build(codes, None, is_dna=True, sample_rate=8,
                       device=cuda).arrays
    text = C.decode_dna(codes)
    width = 16 * W
    pats, plens = [], []
    for k, L in enumerate(sorted({0, 1, 15, 16, 17, width, width + 5,
                                  2 * width + 3})):
        take = min(L, width)
        pats += [text[k:k + take], Q.random_patterns(1, take, take,
                                                     seed=k)[0][:take]]
        plens += [L, L]
    _, pp, _ = Q.encode_patterns(pats, width, device=cuda)
    pl = torch.tensor(plens, dtype=torch.int32, device=cuda)
    got = FM.fm_scan_cuda(pp, pl, fa.bwt, fa.occ, fa.meta)
    torch.cuda.synchronize()
    want = FM.search_syms(fa, FM.syms_from_packed(pp, pl, width))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    before = _build.LAUNCHES["fm_scan"]
    res = ops.fm_search(fa, pp, pl, first_pos=False)
    assert _build.LAUNCHES["fm_scan"] == before + 1
    assert torch.equal(res.count, (want[1] - want[0]).to(torch.int32))


@pytest.mark.cuda
def test_frozen_table_matches_live_on_the_card(cuda):
    from repro_torch.api import SuffixTable
    codes = C.random_dna(5000, seed=5)
    kw = dict(is_dna=True, memtable_limit=400, device=cuda)
    live = SuffixTable.from_codes(codes, **kw)
    froz = SuffixTable.from_codes(codes, fm_threshold=1000, **kw)
    assert froz.is_frozen and froz.store.device.type == "cuda"
    pats = Q.random_patterns(200, 1, 12, seed=5) + ["A", "ACGT"]
    for step in range(3):
        a, b = live.scan(pats, top_k=4), froz.scan(pats, top_k=4)
        for f in ("count", "first_pos", "positions"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
        chunk = C.random_dna(300, seed=50 + step)
        live.append(chunk)
        froz.append(chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["short_patterns", "full_width",
                                  "longer_than_text", "pad_rows", "rows_1",
                                  "rows_17"])
def test_search_epilogue_kernel_matches_plain(cuda, case):
    """The search launch with the compare epilogue against its plain
    version (binary search + result_from_bounds + the compare at the
    lower bound), exactly; ``query.query`` takes it, and the standalone
    compare is not launched."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.pattern_scan import (bounded_match_cuda,
                                                  bounded_match_plain)
    store, pats = _search_case(cuda, case)
    _, pp, pl = Q.encode_patterns(pats, 128, device=cuda)
    got = bounded_match_cuda(store.sa, store.text_packed, store.n_real, pp,
                             pl, store.n_pad, store.pad_count)
    torch.cuda.synchronize()
    want = bounded_match_plain(store, pp, pl)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[0], got[1] > 0)
    before = dict(_build.LAUNCHES)
    res = Q.query(store, pp, pl)
    assert _build.LAUNCHES["bounded_search"] == before["bounded_search"] + 1
    assert _build.LAUNCHES["pattern_compare"] == before["pattern_compare"]
    for f, w in zip(("found", "count", "first_rank", "first_pos"), want):
        assert torch.equal(getattr(res, f), w), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random_dna", "repetitive", "small_delta",
                                  "token"])
def test_merge_on_the_card_matches_plain(cuda, case):
    """``merge_delta_sa`` on the card (the bounded_search kernel's
    insertion search over the clean rows, pack2bit for the combined text)
    equals the plain merge on the CPU bit for bit."""
    from repro_torch.api.compaction import merge_delta_sa
    from repro_torch.core.suffix_array import build_suffix_array
    from repro_torch.kernels import _build
    rng = np.random.default_rng(3)
    L, is_dna = 32, True
    if case == "random_dna":
        combined, n0 = C.random_dna(20000, seed=1), 18000
    elif case == "repetitive":
        combined = np.concatenate([np.zeros(3000, np.uint8),
                                   C.encode_dna("ACGTACGTAAAC" * 4)])
        combined, n0, L = combined, 2500, 16
    elif case == "small_delta":
        combined, n0, L = C.random_dna(5000, seed=2), 4999, 128
    else:
        combined = rng.integers(0, 300, 6000).astype(np.int32)
        n0, is_dna = 5600, False
    base_sa = build_suffix_array(torch.from_numpy(combined[:n0]))
    before = dict(_build.LAUNCHES)
    got = merge_delta_sa(combined, n0, base_sa.to(cuda), is_dna=is_dna,
                         max_query_len=L, device=cuda)
    torch.cuda.synchronize()
    want = merge_delta_sa(combined, n0, base_sa, is_dna=is_dna,
                          max_query_len=L, device="cpu")
    assert torch.equal(got.cpu(), want)
    searched = _build.LAUNCHES["bounded_search"] - before["bounded_search"]
    assert searched == (1 if is_dna else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True])
def test_compact_on_the_card_matches_cpu(cuda, frozen):
    from repro_torch.api import SuffixTable
    codes = C.random_dna(6000, seed=8)
    tables = [SuffixTable.from_codes(codes, is_dna=True, memtable_limit=500,
                                     max_query_len=64, device=d)
              for d in (cuda, "cpu")]
    pats = Q.random_patterns(150, 1, 10, seed=8) + ["A", "ACGT"]
    for t in tables:
        if frozen:
            t.freeze(sample_rate=8)
        for step in range(3):
            t.append(C.random_dna(300, seed=80 + step))
        assert t.compact() == 1 and t.is_frozen == frozen
    a, b = tables[1].scan(pats, top_k=4), tables[0].scan(pats, top_k=4)
    for f in ("count", "first_pos", "positions"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    if not frozen:
        assert torch.equal(tables[0].store.sa.cpu(), tables[1].store.sa)


def _wide_case(mq):
    """A DNA text in which patterns up to ``mq`` bases match more than
    once (a stretch of ``mq`` bases planted twice more), and patterns of
    1 to ``mq`` bases: cut from the text, random, the planted stretch,
    the stretch with its last base changed, and a 17-base text tail."""
    codes = C.random_dna(6000, seed=mq)
    stretch = codes[100:100 + mq]
    codes = np.concatenate([codes, stretch, C.random_dna(500, seed=mq + 1),
                            stretch])
    text = C.decode_dna(codes)
    rng = np.random.default_rng(mq)
    pats = []
    for _ in range(60):
        L = int(rng.integers(1, mq + 1))
        s = int(rng.integers(0, len(text) - L))
        pats.append(text[s:s + L])
    planted = text[100:100 + mq]
    other = "A" if planted[-1] != "A" else "C"
    pats += Q.random_patterns(30, 1, mq, seed=mq) + [
        planted, planted[:-1] + other, "A", text[-17:]]
    return codes, pats, planted


@pytest.mark.cuda
@pytest.mark.parametrize("mq", [257, 512, 1024])
def test_search_kernels_take_wide_patterns(cuda, mq):
    """Patterns past 16 words (W = 17, 32, 64): bounded_search and its
    epilogue, tablet_scan over every sorted row, tier_scan over a run
    and a memtable, and fm_scan, each against its plain versions,
    exactly."""
    from repro_torch.api import FMIndex, SuffixTable
    from repro_torch.kernels import fm_scan as FM
    from repro_torch.kernels.pattern_scan import (bounded_match_cuda,
                                                  bounded_match_plain,
                                                  bounded_search_cuda,
                                                  bounded_search_plain)
    from repro_torch.kernels.tablet_scan import (tablet_scan_cuda,
                                                 tablet_scan_plain)
    codes, pats, planted = _wide_case(mq)
    table = SuffixTable.from_codes(codes, is_dna=True, max_query_len=mq,
                                   memtable_limit=1000 + 2 * mq, device=cuda)
    store = table.store
    pp, pl = table.planner.encode(pats)
    W = int(pp.shape[1])
    assert W == (mq + 15) // 16 > 16
    args = (store.sa, store.text_packed, store.n_real, pp, pl, store.n_pad)
    lb, ub = bounded_search_cuda(*args)
    torch.cuda.synchronize()
    for want in (bounded_search_plain(*args),
                 Q.search_bounds_plain(store, pp, pl)):
        assert torch.equal(lb, want[0]) and torch.equal(ub, want[1])
    assert int((ub - lb)[len(pats) - 4]) == 3       # the planted stretch
    got = bounded_match_cuda(*args, store.pad_count)
    for g, w in zip(got, bounded_match_plain(store, pp, pl)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    wt = C.extract_window(store.text_packed, store.sa, W).T.contiguous()
    pt = pp.T.contiguous()
    got = tablet_scan_cuda(pt, pl, wt, store.sa, n_real=store.n_real)
    for g, w in zip(got, tablet_scan_plain(pt, pl, wt, store.sa,
                                           n_real=store.n_real)):
        assert torch.equal(g, w)
    for i, n in enumerate((500, 500, 300)):         # a run and a memtable
        chunk = C.random_dna(n, seed=mq + 10 + i)
        table.append(np.concatenate([chunk, C.encode_dna(planted)]))
    assert len(table.runs) == 1 and table.memtable.size > 0
    _tier_outputs_agree(table._tierset().stack, pats)
    fa = FMIndex.build(codes, None, is_dna=True, sample_rate=8,
                       device=cuda).arrays
    got = FM.fm_scan_cuda(pp, pl, fa.bwt, fa.occ, fa.meta)
    for want in (FM.backward_search(fa, pp, pl),
                 FM.search_syms(fa, FM.syms_from_packed(pp, pl, 16 * W))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("mq", [257, 512, 1024])
def test_wide_pattern_tables_match_cpu(cuda, mq, frozen):
    """Tables at max_query_len 257, 512 and 1024 on the card answer
    exactly as on the CPU, base only, merged (a run and a memtable) and
    compacted, live and frozen."""
    from repro_torch.api import SuffixTable
    codes, pats, planted = _wide_case(mq)
    tables = [SuffixTable.from_codes(codes, is_dna=True, max_query_len=mq,
                                     memtable_limit=1000 + 2 * mq, device=d)
              for d in (cuda, "cpu")]

    def agree():
        a, b = tables[1].scan(pats, top_k=3), tables[0].scan(pats, top_k=3)
        for f in ("count", "first_pos", "positions"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)

    for t in tables:
        if frozen:
            t.freeze(sample_rate=8)
    agree()
    for i, n in enumerate((500, 500, 300)):
        chunk = np.concatenate([C.random_dna(n, seed=mq + 10 + i),
                                C.encode_dna(planted)])
        for t in tables:
            t.append(chunk)
    agree()
    for t in tables:
        assert t.compact() == 1 and t.is_frozen == frozen
    agree()


@pytest.mark.cuda
def test_database_round_trip_on_the_card_matches_cpu(cuda, tmp_path):
    """The client frontend on the card: create_table, coalesced submits,
    paged read_rows, a client append and compact, each equal to the same
    script on the CPU."""
    from repro_torch.api import Database, Query
    pats = Q.random_patterns(40, 1, 12, seed=4) + ["ACG", "A"]
    runs = {}
    for dev in ("cpu", "cuda"):
        db = Database(str(tmp_path / dev), device=dev)
        table = db.create_table("dna", C.random_dna(4000, seed=3),
                                is_dna=True, memtable_limit=700, device=dev)
        assert table.device.type == dev
        futs = [db.submit(Query.scan("dna", [p], top_k=3)) for p in pats]
        out = [f.result(timeout=60.0) for f in futs]
        assert all(r.ok for r in out)
        pages = [p.positions for p in
                 db.read_rows("dna", "ACG", page_size=7).pages()]
        db.append("dna", C.random_dna(900, seed=5))
        after = db.query(Query.scan("dna", pats, top_k=3))
        version = db.compact("dna")
        compacted = db.query(Query.scan("dna", pats, top_k=3))
        db.close()
        runs[dev] = (out, pages, after, version, compacted)
    (a_out, a_pages, a_after, a_v, a_comp), (b_out, b_pages, b_after, b_v,
                                              b_comp) = runs["cpu"], \
        runs["cuda"]
    for x, y in zip(a_out + [a_after, a_comp], b_out + [b_after, b_comp]):
        for f in ("count", "found", "first_pos", "positions"):
            np.testing.assert_array_equal(getattr(y, f), getattr(x, f), f)
    assert len(a_pages) == len(b_pages) > 1 and a_v == b_v == 2
    for x, y in zip(a_pages, b_pages):
        np.testing.assert_array_equal(y, x)
