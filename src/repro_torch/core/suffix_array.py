"""Suffix-array construction — the port of ``repro.core.suffix_array``.

``build_suffix_array`` is Manber–Myers prefix doubling, as in the
reference: dense initial ranks from the codes, then rounds that sort by
``(rank, rank k positions later)`` and relabel.  The reference sorts with
``lax.sort(num_keys=2)``; here each round is ONE ``torch.sort(stable=
True)`` of the order-preserving int64 key ``rank * (n + 1) + (nxt + 1)``
(8 bytes per key plus int64 sort indices), and the relabel is a scatter
with unique indices.

The reference runs a fixed ``ceil(log2 n)`` rounds.  Once every rank is
distinct the order can no longer change, so the loop stops there: the
suffix array is the same (it is unique), and random DNA needs ~log4(n)
characters of context instead of n.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codec import as_tensor


def suffix_array_naive(codes: np.ndarray) -> np.ndarray:
    """Reference: sort suffix start positions lexicographically."""
    codes = np.asarray(codes)
    n = len(codes)
    buf = codes.tobytes() if codes.dtype == np.uint8 else codes.astype(">u4").tobytes()
    item = codes.dtype.itemsize if codes.dtype == np.uint8 else 4
    return np.array(
        sorted(range(n), key=lambda i: buf[i * item:]), dtype=np.int32
    )


def _relabel(keys_sorted: torch.Tensor, order: torch.Tensor):
    """Dense new ranks (ties share) for keys in sorted order, scattered
    back to text order.  Returns (rank (n,) int32, number of distinct
    keys)."""
    n = int(keys_sorted.shape[0])
    new_sorted = torch.zeros(n, dtype=torch.int32, device=keys_sorted.device)
    torch.cumsum(keys_sorted[1:] != keys_sorted[:-1], dim=0,
                 dtype=torch.int32, out=new_sorted[1:])
    rank = torch.empty_like(new_sorted)
    rank[order] = new_sorted                  # order is a permutation
    return rank, int(new_sorted[-1]) + 1


def build_suffix_array(codes) -> torch.Tensor:
    """Suffix array of ``codes`` (any integer dtype, tensor or numpy) as
    int32 positions, on the codes' device (numpy input: the CPU)."""
    c = as_tensor(codes)
    n = int(c.shape[0])
    dev = c.device
    if n <= 1:
        return torch.zeros((n,), dtype=torch.int32, device=dev)
    num_steps = max(1, int(np.ceil(np.log2(n))))
    vals, sa = torch.sort(c.to(torch.int64), stable=True)
    rank, distinct = _relabel(vals, sa)
    del vals
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    k = 1
    for _ in range(num_steps):
        # rank of the suffix k positions later; -1 (before all) past end
        nxt = torch.where(idx + k < n, torch.roll(rank, -k), -1)
        key = rank.to(torch.int64) * (n + 1) + (nxt.to(torch.int64) + 1)
        del nxt
        key, sa = torch.sort(key, stable=True)
        rank, distinct = _relabel(key, sa)
        del key
        k *= 2
        if distinct == n:
            break
    return sa.to(torch.int32)


def build_suffix_array_staged(codes, **kw) -> np.ndarray:
    """Out-of-core build (see ``repro_torch.core.build_pipeline``),
    returning the assembled SA (numpy int32).  Accepts ``chunk_rows`` /
    ``max_device_bytes`` / ``spill_dir`` / ``device`` etc.; bit-identical
    to ``build_suffix_array``."""
    from repro_torch.core.build_pipeline import staged_suffix_array
    sa, _ = staged_suffix_array(codes, **kw)
    return sa


def rank_array(sa: torch.Tensor) -> torch.Tensor:
    """Inverse permutation: rank[pos] = index of suffix pos in the SA."""
    n = int(sa.shape[0])
    rank = torch.empty(n, dtype=torch.int32, device=sa.device)
    rank[sa.to(torch.int64)] = torch.arange(n, dtype=torch.int32,
                                            device=sa.device)
    return rank


# --------------------------------------------------------------------------
# LCP of adjacent SA rows (blocked compare, depth-capped) — used by dedup.
# --------------------------------------------------------------------------
# Bytes a (row, offset) cell of one chunk holds at once, at most: two
# int64 index grids, a gathered int32 grid, two int32 value grids and the
# bool masks, rounded up.
LCP_CELL_BYTES = 32
LCP_MAX_BYTES = 256 << 20        # default cap on one chunk's intermediates


def adjacent_lcp(codes: torch.Tensor, sa: torch.Tensor, max_lcp: int, *,
                 max_bytes: int = LCP_MAX_BYTES) -> torch.Tensor:
    """lcp[i] = longest common prefix (capped at ``max_lcp``) of suffixes
    sa[i] and sa[i+1]; shape (n-1,) int32, on ``sa``'s device.  The
    reference's O(n * max_lcp) compare (past the end ``-1`` for row i
    against ``-2`` for row i+1, so a suffix that runs out never equals
    another), over chunks of rows whose (rows, max_lcp) intermediates stay
    under ``max_bytes``; the result is the same for every chunking."""
    n = int(codes.shape[0])
    rows = max(n - 1, 0)
    out = torch.zeros(rows, dtype=torch.int32, device=sa.device)
    if rows == 0 or max_lcp <= 0:
        return out
    chunk_rows = max(1, max_bytes // (LCP_CELL_BYTES * max_lcp))
    c = codes.to(sa.device)
    offs = torch.arange(max_lcp, dtype=torch.int64, device=sa.device)[None]
    for r0 in range(0, rows, chunk_rows):
        r1 = min(r0 + chunk_rows, rows)
        ia = sa[r0:r1].to(torch.int64)[:, None] + offs
        ib = sa[r0 + 1:r1 + 1].to(torch.int64)[:, None] + offs
        va = torch.where(ia < n, c[ia.clamp_(0, n - 1)], -1)
        vb = torch.where(ib < n, c[ib.clamp_(0, n - 1)], -2)
        del ia, ib
        # the leading run of equal columns ends at the first mismatch
        ne = va != vb
        del va, vb
        first = ne.to(torch.uint8).argmax(dim=1)
        out[r0:r1] = torch.where(ne.any(dim=1), first, max_lcp).to(
            torch.int32)
    return out
