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


@pytest.mark.cuda
def test_tier_scan_kernel_matches_plain(cuda):
    from repro_torch.api import SuffixTable
    table = SuffixTable.from_codes(C.random_dna(1400, seed=3), is_dna=True,
                                   memtable_limit=260, device=cuda)
    for i in range(4):
        table.append(C.random_dna(150, seed=1000 + i))
    stack = table._tierset().stack
    pats = Q.random_patterns(130, 1, 12, seed=130)
    _, pp, pl = Q.encode_patterns(pats, stack.max_query_len, device=cuda)
    got = TS.tier_scan_cuda(pp.T, pl, ops.tier_windows(stack, pp.shape[1]),
                            stack.sa, ops.tier_meta(stack))
    want = TS.fused_tier_scan(stack, pp, pl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,text_n,rows", [(16, 512, None),
                                            (150, 2000, slice(0, 1999)),
                                            (260, 4096, slice(1000, 2001))])
def test_tablet_scan_kernel_matches_plain(cuda, nq, text_n, rows):
    from repro_torch.core.tablet import build_tablet_store
    from repro_torch.kernels.tablet_scan import tablet_scan_cuda
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
    if rows is None:                 # over the whole table: the bounds
        lb, ub = Q.search_bounds_plain(store, pp, pl)
        assert torch.equal(got[0], ub - lb)
        assert torch.equal(got[1], lb)
        assert torch.equal(got[2], torch.where(ub > lb, lb, 2**30))


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
    got = FM.fm_scan_cuda(syms, fa.bwt, fa.occ, FM.fm_meta(fa))
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
