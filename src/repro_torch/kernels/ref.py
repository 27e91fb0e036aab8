"""Plain PyTorch versions of the scan kernels, with the contracts of
``repro.kernels.ref`` (``pack2bit_ref``, ``pattern_compare_ref``,
``tier_scan_ref``, ``tablet_scan_ref``); the backward search's is
``fm_scan.search_syms``.  They run on any device: the CPU tests hold
them against the Pallas kernels, and the chip check holds each CUDA
kernel against them on the card."""
from __future__ import annotations

import torch

from repro_torch.core import query as Q
from repro_torch.core.codec import MASK32, words_i64, words_u32

BIG = 2**30


def pack2bit_ref(codes_lanes: torch.Tensor) -> torch.Tensor:
    """(16, n_words) slot-major codes -> (n_words,) uint32 packed."""
    c = codes_lanes.to(torch.int64)
    shifts = 30 - 2 * torch.arange(16, dtype=torch.int64, device=c.device)
    return words_u32(((c << shifts[:, None]) & MASK32).sum(dim=0))


def pattern_compare_ref(windows_t, patterns_t, plen, pos, *, n_real: int):
    """windows_t/patterns_t (W, B) uint32, plen/pos (B,): returns
    (lt, le, eq) int8 (B,)."""
    W, _B = windows_t.shape
    mask = Q.word_masks(plen, W)
    lt_raw, eq_all = Q.prefix_compare(words_i64(windows_t.T) & mask,
                                      words_i64(patterns_t.T) & mask)
    truncated = pos.to(torch.int64) + plen.to(torch.int64) > n_real
    lt = lt_raw | (eq_all & truncated)
    eq = eq_all & ~truncated
    return (lt.to(torch.int8), (lt | eq).to(torch.int8), eq.to(torch.int8))


def tier_scan_ref(patterns_t, plen, windows_t, sa, meta, *,
                  row_chunk: int = 4096):
    """Dense (T, BQ, BR) compare + straddle masks; shapes as in
    ``tier_scan.tier_scan_cuda``; returns four (T, BQ) int32.  Rows are
    taken ``row_chunk`` at a time so memory stays bounded; sums and
    minimums are the same in any order."""
    T, W, BR = windows_t.shape
    BQ = patterns_t.shape[1]
    dev = patterns_t.device
    plen64 = plen.to(torch.int64)
    mask = Q.word_masks(plen, W)[:, None, :]                # (BQ, 1, W)
    b = words_i64(patterns_t.T)[:, None, :] & mask          # (BQ, 1, W)
    outs = []
    for t in range(T):
        n_real, n_rows, offset, lo_b, hi_b = (int(v) for v in
                                              meta[t, :5].tolist())
        cnt = torch.zeros(BQ, dtype=torch.int64, device=dev)
        less = torch.zeros_like(cnt)
        mat = torch.zeros_like(cnt)
        first = torch.full((BQ,), BIG, dtype=torch.int64, device=dev)
        for r0 in range(0, BR, row_chunk):
            r1 = min(BR, r0 + row_chunk)
            a = words_i64(windows_t[t, :, r0:r1].T)[None] & mask
            lt, eq_all = Q.prefix_compare(a, b)             # (BQ, rc)
            sa_c = sa[t, r0:r1].to(torch.int64)[None, :]
            truncated = sa_c + plen64[:, None] > n_real
            eq = eq_all & ~truncated
            lt = lt | (eq_all & truncated)
            valid = torch.arange(r0, r1, device=dev)[None, :] < n_rows
            eq = eq & valid
            lt = lt & valid
            g = sa_c + offset
            e = g + plen64[:, None]
            owned = eq & (e > lo_b) & (e <= hi_b)
            cnt += owned.sum(dim=1)
            less += lt.sum(dim=1)
            mat += eq.sum(dim=1)
            first = torch.minimum(
                first, torch.where(owned, g, BIG).min(dim=1).values)
        outs.append((cnt, less, mat, first))
    return tuple(torch.stack([o[i] for o in outs]).to(torch.int32)
                 for i in range(4))


def tablet_scan_ref(patterns_t, plen, windows_t, pos, *, n_real: int,
                    row_chunk: int = 4096):
    """Dense (BQ, BR) compare then reductions: patterns_t (W, BQ) and
    windows_t (W, BR) uint32, plen (BQ,), pos (BR,); returns (count,
    less, first_row) int32 (BQ,), first_row ``2**30`` when no row
    matches.  Rows are taken ``row_chunk`` at a time, as in
    :func:`tier_scan_ref`."""
    W, BQ = patterns_t.shape
    BR = windows_t.shape[1]
    dev = patterns_t.device
    plen64 = plen.to(torch.int64)
    mask = Q.word_masks(plen, W)[:, None, :]                # (BQ, 1, W)
    b = words_i64(patterns_t.T)[:, None, :] & mask          # (BQ, 1, W)
    cnt = torch.zeros(BQ, dtype=torch.int64, device=dev)
    less = torch.zeros_like(cnt)
    first = torch.full((BQ,), BIG, dtype=torch.int64, device=dev)
    for r0 in range(0, BR, row_chunk):
        r1 = min(BR, r0 + row_chunk)
        a = words_i64(windows_t[:, r0:r1].T)[None] & mask
        lt, eq_all = Q.prefix_compare(a, b)                 # (BQ, rc)
        truncated = pos[r0:r1].to(torch.int64)[None, :] + plen64[:, None] \
            > n_real
        eq = eq_all & ~truncated
        lt = lt | (eq_all & truncated)
        rows = torch.arange(r0, r1, device=dev)[None, :]
        cnt += eq.sum(dim=1)
        less += lt.sum(dim=1)
        first = torch.minimum(
            first, torch.where(eq, rows, BIG).min(dim=1).values)
    return cnt.to(torch.int32), less.to(torch.int32), first.to(torch.int32)
