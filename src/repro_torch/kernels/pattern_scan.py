"""CUDA masked packed compare and the two-bound search of the base
suffix array — the port of ``repro.kernels.pattern_scan``.

Entry points over ``csrc/pattern_scan.cu``:

* :func:`pattern_compare_cuda` — the exact ``pattern_compare_pallas``
  contract over explicit windows: ``(lt, le, eq)`` int8;
* :func:`bounded_search_cuda` — both bounds of ``query.
  _bounded_search`` in one launch: the 17-ary warp search of
  ``csrc/search.cuh`` (one warp per query), each probe gathering
  ``sa[row]`` and funnel-shifting the window out of the packed text.
  The compaction merge's insertion search launches it;
* :func:`bounded_match_cuda` — the same launch with the compare at the
  reported row as its epilogue: ``query.MatchResult``'s four fields
  (``found``, ``count``, ``first_rank``, ``first_pos``) straight from
  the kernel.  ``query.query`` launches it on CUDA, so the serving path
  runs ``pattern_compare``'s function inside the search.

Plain versions: ``ref.pattern_compare_ref``; for the search,
:func:`bounded_search_plain` (the kernel's 17-ary search, through
``kernels.kary``) and ``query.search_bounds_plain`` (the reference's
binary search), which all give the same bounds; for the epilogue,
:func:`bounded_match_plain`.  Layouts are the natural (B, W); the GPU
kernels bound-check instead of padding to a block multiple.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import codec
from repro_torch.core import query as Q
from repro_torch.kernels import _build, kary

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def _cuda_words(x: torch.Tensor, name: str) -> torch.Tensor:
    if not x.is_cuda or x.dtype != torch.uint32:
        raise ValueError(f"{name} must be a uint32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    return x.contiguous()


def _cuda_i32(x: torch.Tensor, name: str) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    return x.to(torch.int32).contiguous()


def pattern_compare_cuda(windows: torch.Tensor, patterns: torch.Tensor,
                         plen: torch.Tensor, pos: torch.Tensor, *,
                         n_real: int):
    """windows/patterns (B, W) uint32, plen/pos (B,) -> (lt, le, eq)
    int8 (B,), on CUDA."""
    win = _cuda_words(windows, "windows")
    patt = _cuda_words(patterns, "patterns")
    if win.shape != patt.shape or win.dim() != 2:
        raise ValueError(f"windows {tuple(win.shape)} and patterns "
                         f"{tuple(patt.shape)} must both be (B, W)")
    B, W = win.shape
    plen = _cuda_i32(plen, "plen")
    pos = _cuda_i32(pos, "pos")
    if plen.shape != (B,) or pos.shape != (B,):
        raise ValueError("plen and pos must be (B,)")
    outs = [torch.empty(B, dtype=torch.int8, device=win.device)
            for _ in range(3)]
    if B == 0:
        return tuple(outs)
    fn = _build.launcher("pattern_scan", "pattern_compare_launch",
                         [_P, _P, _P, _P, _LL, _I, _I, _P, _P, _P, _P])
    _build.check(fn(_build.ptr(win), _build.ptr(patt), _build.ptr(plen),
                    _build.ptr(pos), int(n_real), B, W,
                    *(_build.ptr(o) for o in outs), _build.stream_of(win)),
                 "pattern_compare")
    _build.LAUNCHES["pattern_compare"] += 1
    return tuple(outs)


def bounded_search_plain(sa: torch.Tensor, text_packed: torch.Tensor,
                         n_real: int, patterns: torch.Tensor,
                         plen: torch.Tensor, n_rows: int, *, trace=None,
                         arity: int = kary.ARITY):
    """The kernel's 17-ary search in plain PyTorch; arguments and
    results as :func:`bounded_search_cuda`.  ``trace`` and ``arity`` as
    in ``kary.search`` (the rows the kernel probes; 2 for the binary
    search of ``query.search_bounds_plain``)."""
    W = int(patterns.shape[1])
    sa = sa.to(torch.int64)

    def probe(rows):
        pos = sa[rows]
        win = codec.extract_window(text_packed, pos, W)
        return kary.compare(win, pos, patterns, plen, n_real)

    lb, ub = kary.search(int(n_rows), int(patterns.shape[0]), probe,
                         device=patterns.device, trace=trace, arity=arity)
    return lb.to(torch.int32), ub.to(torch.int32)


def _search_launch(sa, text_packed, n_real: int, patterns, plen,
                   n_rows: int, pad_count: int, *, bounds: bool,
                   match: bool):
    """One launch of ``bounded_search_kernel``: (lb, ub) when
    ``bounds``, then (found, count, first_rank, first_pos) when
    ``match``."""
    patt = _cuda_words(patterns, "patterns")
    text = _cuda_words(text_packed, "text_packed")
    sa = _cuda_i32(sa, "sa")
    plen = _cuda_i32(plen, "plen")
    if patt.dim() != 2:
        raise ValueError(f"patterns must be (B, W), got {tuple(patt.shape)}")
    B, W = patt.shape
    if plen.shape != (B,):
        raise ValueError("plen must be (B,)")
    _build.check_width(W, "bounded_search")
    if not 0 < n_rows <= sa.shape[0]:
        raise ValueError(f"n_rows={n_rows} out of range for "
                         f"{sa.shape[0]} SA rows")
    dev = patt.device
    i32 = [torch.empty(B, dtype=torch.int32, device=dev)
           for _ in range(2 * bounds + 3 * match)]
    found = (torch.empty(B, dtype=torch.bool, device=dev) if match
             else None)
    lb, ub = (i32[0], i32[1]) if bounds else (None, None)
    count, rank, pos = i32[2 * bounds:] if match else (None,) * 3
    out = ((lb, ub) if bounds else ()) + ((found, count, rank, pos)
                                          if match else ())
    if B == 0:
        return out

    def p(t):
        return _build.ptr(t) if t is not None else None

    fn = _build.launcher("pattern_scan", "bounded_search_launch",
                         [_P, _I, _P, _LL, _LL, _P, _P, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P])
    _build.check(fn(_build.ptr(sa), int(n_rows), _build.ptr(text),
                    int(text.shape[0]), int(n_real), _build.ptr(patt),
                    _build.ptr(plen), B, W, int(pad_count), p(lb), p(ub),
                    p(found), p(count), p(rank), p(pos),
                    _build.stream_of(patt)), "bounded_search")
    _build.LAUNCHES["bounded_search"] += 1
    if match:
        _build.LAUNCHES["pattern_compare_fused"] += 1
    return out


def bounded_search_cuda(sa: torch.Tensor, text_packed: torch.Tensor,
                        n_real: int, patterns: torch.Tensor,
                        plen: torch.Tensor, n_rows: int):
    """(lb, ub) int32 (B,): the lower (pred = lt) and upper (pred =
    lt | eq) bounds of every query over the sorted rows ``sa[:n_rows]``,
    exactly ``query.search_bounds_plain``.  patterns (B, W) uint32 with
    W <= ``_build.MAX_PATTERN_WORDS`` (256); plen (B,); text_packed the
    store's packed text."""
    return _search_launch(sa, text_packed, n_real, patterns, plen, n_rows,
                          0, bounds=True, match=False)


def bounded_match_cuda(sa: torch.Tensor, text_packed: torch.Tensor,
                       n_real: int, patterns: torch.Tensor,
                       plen: torch.Tensor, n_rows: int, pad_count: int):
    """The search of :func:`bounded_search_cuda` with the compare at the
    lower bound as its epilogue, one launch: (found bool, count,
    first_rank, first_pos int32), each (B,).  ``found`` is the suffix
    at ``sa[lb]`` equal to the pattern (``lb < n_rows``); ``count = ub -
    lb``; ``first_rank = lb - pad_count`` and ``first_pos = sa[lb]``
    where found, -1 elsewhere — ``query.MatchResult``'s contract."""
    return _search_launch(sa, text_packed, n_real, patterns, plen, n_rows,
                          pad_count, bounds=False, match=True)


def bounded_match_plain(store, patterns: torch.Tensor, plen: torch.Tensor):
    """The epilogue's plain version on ``store``: the binary search
    (``query.search_bounds_plain``), ``query.result_from_bounds`` and
    the compare at the lower bound, as :func:`bounded_match_cuda`
    computes them; (found, count, first_rank, first_pos)."""
    lb, ub = Q.search_bounds_plain(store, patterns, plen)
    res = Q.result_from_bounds(store, lb, ub)
    n = store.n_pad
    pos = store.sa[lb.clamp(0, n - 1).to(torch.int64)]
    _lt, eq = Q.compare_packed(store.text_packed, store.n_real, pos,
                               patterns, plen)
    found = eq & (lb < n)
    return (found, res.count,
            torch.where(found, lb - store.pad_count, -1).to(torch.int32),
            torch.where(found, pos, -1).to(torch.int32))
