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
