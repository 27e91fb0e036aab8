"""Dense tablet range scan — the port of ``repro.kernels.tablet_scan``.

Compares a batch of patterns against consecutive sorted suffix rows and
returns, per pattern: ``count`` (matching rows), ``less`` (rows strictly
before the pattern; over a whole sorted table this is the lower bound)
and ``first_row`` (the smallest matching row, ``2**30`` when none).

:func:`tablet_scan_cuda` is the hand-written kernel
(``csrc/tablet_scan.cu``); its plain version is ``ref.tablet_scan_ref``
and ``kernels.ops.tablet_scan`` picks one by the tensor's device.  The
kernel bound-checks its ragged edges, so unlike the Pallas kernel it
needs no padding to a block multiple.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BIG = 2**30     # "no match" sentinel for first_row
MAX_WORDS = 16  # shared-memory staging: W <= 16 words (256 bases)


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
    if W > MAX_WORDS:
        raise ValueError(f"{W} pattern words > {MAX_WORDS}: the kernel "
                         f"stages at most {MAX_WORDS} in shared memory")
    if not plen.is_cuda or not pos.is_cuda:
        raise ValueError("plen and pos must be CUDA tensors")
    dev = patterns_t.device
    pt = patterns_t.contiguous()
    wt = windows_t.contiguous()
    plen = plen.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    less = torch.zeros_like(count)
    first = torch.full((B,), BIG, dtype=torch.int32, device=dev)
    if B == 0 or R == 0:
        return count, less, first
    fn = _build.load("tablet_scan").tablet_scan_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, ctypes.c_longlong, I, I, I, P, P, P, P]
    fn.restype = I
    _build.check(fn(_build.ptr(pt), _build.ptr(plen), _build.ptr(wt),
                    _build.ptr(pos), int(n_real), B, W, R,
                    _build.ptr(count), _build.ptr(less), _build.ptr(first),
                    _build.stream_of(pt)), "tablet_scan")
    _build.LAUNCHES["tablet_scan"] += 1
    return count, less, first
