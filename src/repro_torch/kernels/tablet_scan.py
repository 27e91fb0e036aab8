"""Tablet range scan — the port of ``repro.kernels.tablet_scan``.

Compares a batch of patterns against consecutive sorted suffix rows and
returns, per pattern: ``count`` (matching rows), ``less`` (rows strictly
before the pattern; over a whole sorted table this is the lower bound)
and ``first_row`` (the smallest matching row, ``2**30`` when none).

Contract: the rows are consecutive sorted suffix rows (a whole store or
a slice of one), as the TPU kernel's docstring requires.  Over them
"row < pattern" is monotone, so ``less`` is the lower bound ``lb``,
``count`` is ``ub - lb`` and ``first_row`` is ``lb`` where ``ub > lb``
(``kernels.kary``).

* :func:`tablet_scan_cuda` — the hand-written kernel
  (``csrc/tablet_scan.cu``): one warp per query runs the 17-ary search
  of both bounds;
* :func:`tablet_scan_plain` — the same 17-ary search in plain PyTorch,
  what ``kernels.ops.tablet_scan`` runs on a CPU tensor.

``ref.tablet_scan_ref`` is the dense (query x row) plain version, the
TPU kernel's own algorithm, kept as the yardstick.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, kary

BIG = 2**30     # "no match" sentinel for first_row


def _outputs(lb, ub):
    count = ub - lb
    first = torch.where(count > 0, lb, BIG)
    return tuple(x.to(torch.int32) for x in (count, lb, first))


def tablet_scan_plain(patterns_t, plen, windows_t, pos, *, n_real: int,
                      trace=None, arity: int = kary.ARITY):
    """The kernel's 17-ary search in plain PyTorch; arguments and
    results as :func:`tablet_scan_cuda`.  ``trace`` and ``arity`` as in
    ``kary.search`` (the rows the kernel probes; 2 for a binary
    search)."""
    R = int(windows_t.shape[1])
    patt = patterns_t.T
    pos = pos.to(torch.int64)
    words = windows_t.view(torch.int32)     # CUDA cannot index uint32

    def probe(rows):
        win = words[:, rows].permute(1, 2, 3, 0)           # (2, B, 16, W)
        return kary.compare(win, pos[rows], patt, plen, n_real)

    lb, ub = kary.search(R, int(patt.shape[0]), probe,
                         device=patterns_t.device, trace=trace, arity=arity)
    return _outputs(lb, ub)


def tablet_scan_cuda(patterns_t: torch.Tensor, plen: torch.Tensor,
                     windows_t: torch.Tensor, pos: torch.Tensor, *,
                     n_real: int):
    """The ``tablet_scan_pallas`` contract on CUDA.  patterns_t: (W, BQ)
    uint32; plen: (BQ,); windows_t: (W, BR) uint32 packed windows of
    consecutive sorted rows; pos: (BR,) their text positions; every row
    counts (callers pass a slice to scan fewer).  Returns (count, less,
    first_row) int32 (BQ,)."""
    for name, x in (("patterns_t", patterns_t), ("windows_t", windows_t)):
        if not x.is_cuda or x.dtype != torch.uint32 or x.dim() != 2:
            raise ValueError(f"{name} must be a 2-D uint32 CUDA tensor")
    W, B = (int(d) for d in patterns_t.shape)
    W2, R = (int(d) for d in windows_t.shape)
    if W2 != W or tuple(plen.shape) != (B,) or tuple(pos.shape) != (R,):
        raise ValueError(
            f"shape mismatch: patterns_t {tuple(patterns_t.shape)}, "
            f"windows_t {tuple(windows_t.shape)}, plen {tuple(plen.shape)}, "
            f"pos {tuple(pos.shape)}")
    _build.check_width(W, "tablet_scan")
    if not plen.is_cuda or not pos.is_cuda:
        raise ValueError("plen and pos must be CUDA tensors")
    dev = patterns_t.device
    pt = patterns_t.contiguous()
    wt = windows_t.contiguous()
    plen = plen.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    count, less, first = (torch.empty(B, dtype=torch.int32, device=dev)
                          for _ in range(3))
    if B == 0:
        return count, less, first
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.launcher("tablet_scan", "tablet_scan_launch",
                         [P, P, P, P, ctypes.c_longlong, I, I, I, P, P, P, P])
    _build.check(fn(_build.ptr(pt), _build.ptr(plen), _build.ptr(wt),
                    _build.ptr(pos), int(n_real), B, W, R,
                    _build.ptr(count), _build.ptr(less), _build.ptr(first),
                    _build.stream_of(pt)), "tablet_scan")
    _build.LAUNCHES["tablet_scan"] += 1
    return count, less, first
