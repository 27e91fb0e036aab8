"""Public wrappers that pick a kernel or its plain version — the port of
``repro.kernels.ops``.

The choice follows the tensor, as ``repro.kernels.ops`` follows the
backend: on a CUDA tensor a packed-DNA batch launches the hand-written
kernel (and a failed build or launch raises); on a CPU tensor the plain
PyTorch version runs.  Token (non-DNA) tables take the plain versions on
every device, as the reference has no kernel for them either.
"""
from __future__ import annotations

import torch

from repro_torch.core import codec
from repro_torch.core import query as Q
from repro_torch.kernels import fm_scan as _fm
from repro_torch.kernels import ref
from repro_torch.kernels import tier_scan as _tier
from repro_torch.kernels.pack2bit import pack2bit_cuda
from repro_torch.kernels.pattern_scan import pattern_compare_cuda
from repro_torch.kernels.tablet_scan import (tablet_scan_cuda,
                                             tablet_scan_plain)


def pack2bit(codes: torch.Tensor) -> torch.Tensor:
    """(n,) codes {0..3} -> (n_words,) packed uint32 words."""
    if codes.is_cuda:
        return pack2bit_cuda(codes)
    n = int(codes.shape[0])
    n_words = codec.packed_length(n)
    flat = torch.nn.functional.pad(codes.to(torch.int64),
                                   (0, n_words * 16 - n))
    return ref.pack2bit_ref(flat.reshape(n_words, 16).T)  # slot-major


def pattern_compare(windows, patterns, plen, pos, *, n_real: int):
    """(B, W) windows/patterns, (B,) plen/pos -> (lt, le, eq) bool (B,)."""
    if windows.is_cuda:
        out = pattern_compare_cuda(windows, patterns, plen, pos,
                                   n_real=n_real)
    else:
        out = ref.pattern_compare_ref(windows.T, patterns.T, plen, pos,
                                      n_real=n_real)
    return tuple(o.to(torch.bool) for o in out)


def tablet_scan(patterns, plen, windows, pos, *, n_real: int):
    """Scan of BR consecutive sorted-row windows by BQ patterns:
    patterns (BQ, W), plen (BQ,), windows (BR, W), pos (BR,).  Returns
    (count, less, first_row) int32 (BQ,); first_row is 2**30 when no row
    matches.  The kernel on CUDA, its plain 17-ary search elsewhere."""
    args = (patterns.T, plen.to(torch.int32), windows.T, pos)
    if patterns.is_cuda:
        return tablet_scan_cuda(*args, n_real=n_real)
    return tablet_scan_plain(*args, n_real=n_real)


def tier_meta(stack) -> torch.Tensor:
    """(T, 8) int32 rows ``[n_real, n_rows, offset, lo, hi, 0, 0, 0]``."""
    meta = torch.zeros((stack.num_tiers, 8), dtype=torch.int32,
                       device=stack.device)
    for k, name in enumerate(("n_real", "n_rows", "offset", "lo", "hi")):
        meta[:, k] = getattr(stack, name).to(torch.int32)
    return meta


def tier_scan(stack, patterns, plen):
    """The tier scan kernel's path (packed-DNA tables only): the CUDA
    kernel on a CUDA device, its plain 17-ary search
    ``tier_scan.tier_scan_plain`` elsewhere.  Both read the stacked
    packed text and ``sa`` directly.  Returns (count, less, matches,
    first_g) int32 (T, B) — the ``tier_scan.fused_tier_scan`` contract."""
    args = (patterns.T, plen.to(torch.int32), stack.text_packed, stack.sa,
            stack.pad_cnt, tier_meta(stack))
    if patterns.is_cuda:
        return _tier.tier_scan_cuda(*args)
    return _tier.tier_scan_plain(*args)


def _use_kernels(stack, patterns) -> bool:
    return bool(patterns.is_cuda and stack.is_dna
                and patterns.dtype == torch.uint32)


def fused_tiers(stack, patterns, plen):
    """Every delta tier in one scan: (count, less, matches, first_g),
    each (T, B) int32.  Frozen tables merge their FM base read with
    this.  The ``tier_scan`` kernel on CUDA for packed DNA, the plain
    binary search elsewhere."""
    if _use_kernels(stack, patterns):
        return tier_scan(stack, patterns, plen)
    return _tier.fused_tier_scan(stack, patterns, plen)


def fused_single(store, stack, patterns, plen):
    """THE single-device merged read: base search + all delta tiers +
    the merge.  Returns (merged MatchResult, base MatchResult, (count,
    less, matches, first_g)).  On CUDA with packed DNA the base runs the
    ``bounded_search`` kernel (through ``query.query``) and the tiers
    the ``tier_scan`` kernel; elsewhere ``tier_scan.fused_table_scan``."""
    if _use_kernels(stack, patterns):
        base = Q.query(store, patterns, plen)
        tiers = tier_scan(stack, patterns, plen)
    else:
        base, tiers = _tier.fused_table_scan(store, stack, patterns, plen)
    merged = _tier.merge_tier_results(base, tiers[0], tiers[3])
    return merged, base, tiers


def fm_search(arrays, patterns, plen, *, first_pos: bool = True):
    """Frozen-tier base read: FM backward search + one LF walk for
    ``first_pos``, with ``query``'s MatchResult contract.  A packed-DNA
    batch on CUDA runs the ``fm_scan`` kernel; everything else (the
    CPU, token tables on every device) runs ``fm_scan.search_syms``.
    ``first_rank`` is -1 where nothing matched (``fm_scan.
    finish_match``); ``first_pos=False`` skips the LF walk and reports
    ``first_pos`` -1."""
    packed = arrays.is_dna and patterns.dtype == torch.uint32
    if packed:
        syms = _fm.syms_from_packed(patterns, plen, patterns.shape[1] * 16)
    else:
        syms = _fm.syms_from_codes(patterns, plen, patterns.shape[1])
    if packed and patterns.is_cuda:
        lo, hi = _fm.fm_scan_cuda(syms, arrays.bwt, arrays.occ,
                                  _fm.fm_meta(arrays))
    else:
        lo, hi = _fm.search_syms(arrays, syms)
    found, count, first_rank, pos = _fm.finish_match(arrays, lo, hi,
                                                     walk=first_pos)
    return Q.MatchResult(found=found, count=count, first_rank=first_rank,
                         first_pos=pos)
