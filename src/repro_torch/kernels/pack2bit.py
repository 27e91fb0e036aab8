"""CUDA 2-bit DNA pack — the port of ``repro.kernels.pack2bit``.

The TPU kernel takes slot-major ``(16, n_words)`` codes so its shift/OR
reduction runs along sublanes.  On Hopper the kernel reads the flat code
stream directly (one thread per word, one 16-byte load per full word),
so no transpose is made; its plain version is ``ref.pack2bit_ref`` on the
slot-major view (``ops.pack2bit`` builds it on the CPU).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import codec
from repro_torch.kernels import _build


def pack2bit_cuda(codes: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 codes {0..3} on a CUDA device -> (n_words,) uint32
    words.  Launches ``csrc/pack2bit.cu``; raises on a failed launch."""
    if not codes.is_cuda:
        raise ValueError("pack2bit_cuda needs a CUDA tensor")
    if codes.dim() != 1:
        raise ValueError(f"codes must be 1-D, got shape {tuple(codes.shape)}")
    codes = codes.to(torch.uint8).contiguous()
    if codes.data_ptr() % 16:
        codes = codes.clone()           # the kernel's 16-byte loads
    n = int(codes.shape[0])
    n_words = codec.packed_length(n)
    out = torch.empty(n_words, dtype=torch.uint32, device=codes.device)
    if n_words == 0:
        return out
    fn = _build.launcher("pack2bit", "pack2bit_launch",
                         [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_void_p])
    _build.check(fn(_build.ptr(codes), n, _build.ptr(out), n_words,
                    _build.stream_of(codes)), "pack2bit")
    _build.LAUNCHES["pack2bit"] += 1
    return out
