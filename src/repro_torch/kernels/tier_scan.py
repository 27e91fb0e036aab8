"""Fused multi-tier scan — the port of ``repro.kernels.tier_scan``.

Per query and per delta tier, over the tier's real rows:

====== =====================================================================
field  meaning
====== =====================================================================
count    occurrences the tier OWNS (straddle rule ``lo < g + plen <= hi``)
less     rows strictly before the pattern — the enumeration lower bound
matches  raw prefix-match run length (bounds NOT applied)
first_g  minimum owned GLOBAL start position (``BIG`` when count == 0)
====== =====================================================================

Three implementations with that contract:

* :func:`fused_tier_scan` — plain PyTorch: a batched binary search per
  tier plus :func:`_owned_tail`, the production path on the CPU;
* :func:`tier_scan_cuda` — the hand-written kernel (``csrc/tier_scan.cu``),
  the path on a CUDA device for packed DNA: one warp per (query, tier)
  runs the 17-ary search of both bounds over the stacked packed text and
  ``sa``, then the 4 warps of its block apply the straddle rule over
  each of the block's match runs, past the tier's padding rows
  (:func:`pad_prefix`);
* :func:`tier_scan_plain` — that kernel's algorithm in plain PyTorch
  (``kernels.kary`` plus the run scan), what ``kernels.ops.tier_scan``
  runs on a CPU tensor.

Contract of the last two: each tier's rows ``[0, n_rows)`` are sorted
suffix rows (rows past ``n_rows`` are bucket padding and never read), so
``less`` is the lower bound ``lb``, ``matches`` is ``ub - lb`` and the
rows ``[lb, ub)`` are exactly the matching ones; those of them that are
padding (position past the tier's own text) are never owned.
``ref.tier_scan_ref``
is the dense (tier, query, row) plain version, the TPU kernel's own
algorithm, kept as the yardstick.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import codec
from repro_torch.core import query as Q
from repro_torch.core.tablet import fill_straddle
from repro_torch.kernels import _build, kary

BIG = 2**30     # "no match" sentinel for first_g


def _owned_tail(ov_rank_t, hi_rank_t, pad_cnt_t, rmq_t, offset_t, lo_t,
                hi_t, plen, lb, ub):
    """From one tier's search bounds [lb, ub) to its four outputs in
    O(B * (max_query_len + log R)): overlap rows by ``ov_rank``, end rows
    by ``hi_rank``, bucket-pad rows by the ``pad_cnt`` prefix sums, and
    ``first_g`` from the sparse-table range minimum ``rmq`` (see the
    reference for the derivation).  ``offset_t``/``lo_t``/``hi_t`` are
    Python ints."""
    K, R = rmq_t.shape
    OV = ov_rank_t.shape[0]
    dev = lb.device
    plen_i = plen.to(torch.int64)
    lb = lb.to(torch.int64)
    ub = ub.to(torch.int64)
    overlap = lo_t - offset_t
    tl = hi_t - offset_t
    L = ub - lb
    p_idx = torch.arange(OV, dtype=torch.int64, device=dev)[None, :]
    ovr = ov_rank_t.to(torch.int64)[None, :]
    hir = hi_rank_t.to(torch.int64)[None, :]

    # low bound: overlap rows (p < overlap) present in the window
    in_lo = (ovr >= lb[:, None]) & (ovr < ub[:, None])
    stops_in = p_idx + plen_i[:, None] <= overlap
    excl_lo = (in_lo & stops_in).sum(dim=1)
    own_lo = in_lo & ~stops_in & (p_idx + plen_i[:, None] <= tl)
    c_ov = torch.where(own_lo, p_idx + offset_t, BIG).min(dim=1).values

    # high bound: end rows (p = tl - 1 - q) with the match running past tl
    in_hi = (hir >= lb[:, None]) & (hir < ub[:, None])
    excl_hi = (in_hi & (p_idx <= plen_i[:, None] - 2)).sum(dim=1)

    # bucket-pad rows (p >= tl): never owned, counted by prefix sums
    pc = pad_cnt_t.to(torch.int64)
    excl_pad = pc[ub] - pc[lb]

    count = L - excl_lo - excl_hi - excl_pad
    k = torch.zeros_like(L)                        # floor(log2 L), L >= 1
    for j in range(1, K):
        k = k + (L >= (1 << j)).to(L.dtype)
    h = torch.ones_like(k) << k
    flat = rmq_t.reshape(-1).to(torch.int64)
    m = torch.minimum(flat[k * R + lb.clamp(0, R - 1)],
                      flat[k * R + (ub - h).clamp(0, R - 1)])
    ok = (L > 0) & (m - offset_t <= tl - plen_i)
    c_rmq = torch.where(ok, m, BIG)
    return (count.to(torch.int32), lb.to(torch.int32), L.to(torch.int32),
            torch.minimum(c_ov, c_rmq).to(torch.int32))


def fused_tier_scan(stack, patt, plen):
    """Scan every tier of a ``TierStack``: (count, less, matches,
    first_g), each (T, B) int32.  Both bounds of a tier ride one loop
    (the lower bound in row 0, the upper in row 1 of a (2, B) batch)."""
    fill_straddle(stack)
    R = stack.rows
    steps = Q.search_steps(R)
    use_packed = stack.is_dna and patt.dtype == torch.uint32
    cmp = Q.compare_packed if use_packed else Q.compare_codes
    B = patt.shape[0]
    dev = patt.device
    patt2 = torch.cat([patt, patt], dim=0)
    plen2 = torch.cat([plen, plen], dim=0)
    is_ub = torch.tensor([[False], [True]], device=dev)
    meta = {k: getattr(stack, k).tolist()
            for k in ("n_real", "n_rows", "offset", "lo", "hi")}
    outs = []
    for t in range(stack.num_tiers):
        text_t = (stack.text_packed[t] if use_packed
                  else stack.text_codes[t])
        sa_t = stack.sa[t]
        lo = torch.zeros((2, B), dtype=torch.int32, device=dev)
        hi = torch.full((2, B), meta["n_rows"][t], dtype=torch.int32,
                        device=dev)
        for _ in range(steps):
            mid = (lo + hi) // 2
            pos = sa_t[mid.reshape(-1).clamp(0, R - 1).to(torch.int64)]
            lt, eq = cmp(text_t, meta["n_real"][t], pos, patt2, plen2)
            pred = lt.reshape(2, B) | (eq.reshape(2, B) & is_ub)
            active = lo < hi
            lo = torch.where(active & pred, mid + 1, lo)
            hi = torch.where(active & ~pred, mid, hi)
        outs.append(_owned_tail(
            stack.ov_rank[t], stack.hi_rank[t], stack.pad_cnt[t],
            stack.rmq[t], meta["offset"][t], meta["lo"][t], meta["hi"][t],
            plen, lo[0], lo[1]))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(4))


def fused_table_scan(store, stack, patt, plen):
    """The plain single-device merged read search: the base store's
    bounds and every delta tier's outputs, returned as ``(base
    MatchResult, (count, less, matches, first_g))``.  The reference runs
    base and tiers inside one ``fori_loop`` to save launches; eager
    PyTorch has none to save, so the two plain searches run one after
    the other.  Results are identical (a finished search's extra rounds
    change nothing)."""
    lb, ub = Q.search_bounds_plain(store, patt, plen)
    return Q.result_from_bounds(store, lb, ub), \
        fused_tier_scan(stack, patt, plen)


def merge_tier_results(base, tier_count, tier_first):
    """Merge a base MatchResult with tier outputs: ``count`` sums the
    owners, ``first_pos`` is the minimum of the base's reported position
    and every tier's first owned position, ``first_rank`` keeps its
    base-only meaning (-1 when only delta tiers match)."""
    total = base.count + tier_count.sum(dim=0).to(base.count.dtype)
    dmin = tier_first.min(dim=0).values       # BIG when a tier owns none
    cand = torch.where(base.count > 0, base.first_pos, BIG)
    first_pos = torch.minimum(cand.to(torch.int32), dmin.to(torch.int32))
    found = total > 0
    first_pos = torch.where(found & (first_pos < BIG), first_pos, -1)
    return Q.MatchResult(found=found, count=total.to(torch.int32),
                         first_rank=base.first_rank,
                         first_pos=first_pos.to(torch.int32))


# ---------------------------------------------------------------------------
# The 17-ary search per tier + the straddle rule over the match run
# ---------------------------------------------------------------------------


def _run_scan(sa_t, lb, ub, plen, offset, lo_b, hi_b):
    """(count, first_g) int64 (B,): the straddle rule over every query's
    rows ``[lb, ub)`` of one tier, flattened into one pass."""
    B = lb.shape[0]
    dev = lb.device
    length = ub - lb
    seg = torch.repeat_interleave(torch.arange(B, device=dev), length)
    start = torch.cumsum(length, 0) - length
    k = torch.arange(seg.shape[0], device=dev)
    g = sa_t[lb[seg] + k - start[seg]] + offset
    e = g + plen.to(torch.int64)[seg]
    owned = (e > lo_b) & (e <= hi_b)
    count = torch.zeros(B, dtype=torch.int64, device=dev).scatter_add_(
        0, seg, owned.to(torch.int64))
    first = torch.full((B,), BIG, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, seg, torch.where(owned, g, BIG), "amin")
    return count, first


def pad_prefix(pad_cnt):
    """(T,) int64: per tier, the rows ``[0, n)`` that are all padding
    (never owned) and that the kernel's sweep skips: ``n = pad_cnt[t,
    -1]``, every such row of the tier, when ``pad_cnt[t, n] == n``; else
    0.  Padding holds the smallest symbol, so its suffixes sort first."""
    pc = pad_cnt.to(torch.int64)
    n = pc[:, -1]
    return torch.where(pc.gather(1, n[:, None])[:, 0] == n, n, 0)


def tier_scan_plain(patterns_t, plen, text_packed, sa, pad_cnt, meta, *,
                    trace=None, arity: int = kary.ARITY):
    """The kernel's algorithm in plain PyTorch; arguments and results as
    :func:`tier_scan_cuda`.  With a ``trace`` list, one list per tier of
    the rows the kernel probes is appended to it; ``arity`` as in
    ``kary.search`` (2 for a binary search)."""
    W, B = patterns_t.shape
    T, R = sa.shape
    patt = patterns_t.T
    skip = pad_prefix(pad_cnt).tolist()
    outs = []
    for t in range(T):
        n_real, n_rows, offset, lo_b, hi_b = (int(v) for v in
                                              meta[t, :5].tolist())
        n_rows = max(0, min(n_rows, R))
        sa_t = sa[t].to(torch.int64)

        def probe(rows, sa_t=sa_t, text_t=text_packed[t], n_real=n_real):
            pos = sa_t[rows]
            win = codec.extract_window(text_t, pos, W)
            return kary.compare(win, pos, patt, plen, n_real)

        tr = None if trace is None else []
        lb, ub = kary.search(n_rows, B, probe, device=patt.device, trace=tr,
                             arity=arity)
        if trace is not None:
            trace.append(tr)
        start = lb.clamp(min=skip[t]).minimum(ub)
        count, first = _run_scan(sa_t, start, ub, plen, offset, lo_b, hi_b)
        outs.append((count, lb, ub - lb, first))
    return tuple(torch.stack([o[i] for o in outs]).to(torch.int32)
                 for i in range(4))


def tier_scan_cuda(patterns_t: torch.Tensor, plen: torch.Tensor,
                   text_packed: torch.Tensor, sa: torch.Tensor,
                   pad_cnt: torch.Tensor, meta: torch.Tensor):
    """The ``tier_scan_pallas`` contract on CUDA.  patterns_t: (W, B)
    uint32; plen: (B,) int32; text_packed: (T, n_words) uint32, every
    tier's packed text (words past a tier's end read 0); sa: (T, R)
    int32 local positions, each tier's rows ``[0, n_rows)`` sorted;
    pad_cnt: (T, R + 1) int32, the ``TierStack`` prefix counts of rows
    whose position lies at or past ``hi - offset`` (the sweep skips them,
    :func:`pad_prefix`); meta: (T, 8) int32 rows ``[n_real, n_rows,
    offset, lo, hi, 0, 0, 0]``.  Returns (count, less, matches, first_g)
    int32 (T, B)."""
    for name, x in (("patterns_t", patterns_t), ("text_packed", text_packed)):
        if not x.is_cuda or x.dtype != torch.uint32 or x.dim() != 2:
            raise ValueError(f"{name} must be a 2-D uint32 CUDA tensor")
    W, B = (int(d) for d in patterns_t.shape)
    T, R = (int(d) for d in sa.shape)
    if text_packed.shape[0] != T or tuple(meta.shape) != (T, 8) \
            or tuple(pad_cnt.shape) != (T, R + 1) or tuple(plen.shape) != (B,):
        raise ValueError(
            f"shape mismatch: patterns_t {tuple(patterns_t.shape)}, "
            f"text_packed {tuple(text_packed.shape)}, sa {tuple(sa.shape)}, "
            f"pad_cnt {tuple(pad_cnt.shape)}, meta {tuple(meta.shape)}, "
            f"plen {tuple(plen.shape)}")
    _build.check_width(W, "tier_scan")
    for name, x in (("plen", plen), ("sa", sa), ("pad_cnt", pad_cnt),
                    ("meta", meta)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
    dev = patterns_t.device
    pt = patterns_t.contiguous()
    text = text_packed.contiguous()
    sa = sa.to(torch.int32).contiguous()
    pad_cnt = pad_cnt.to(torch.int32).contiguous()
    meta = meta.to(torch.int32).contiguous()
    plen = plen.to(torch.int32).contiguous()
    outs = tuple(torch.empty((T, B), dtype=torch.int32, device=dev)
                 for _ in range(4))
    if T == 0 or B == 0:
        return outs
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.launcher("tier_scan", "tier_scan_launch",
                         [P, P, P, ctypes.c_longlong, P, P, P, I, I, I, I,
                          P, P, P, P, P])
    _build.check(fn(_build.ptr(pt), _build.ptr(plen), _build.ptr(text),
                    int(text.shape[1]), _build.ptr(sa), _build.ptr(pad_cnt),
                    _build.ptr(meta), T, B, W, R,
                    *(_build.ptr(o) for o in outs),
                    _build.stream_of(pt)), "tier_scan")
    _build.LAUNCHES["tier_scan"] += 1
    return outs
