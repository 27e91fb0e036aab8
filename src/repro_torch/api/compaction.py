"""Major compaction by merging — the port of ``repro.api.compaction``.

Every compare of the store is depth-capped at ``max_query_len`` (= L),
so the suffix array only has to be sorted by each suffix's first L
symbols.  Appending ``d`` symbols perturbs that key only for the dirty
suffixes, those starting within L - 1 of the old end; the ``n0 - L +
1`` clean entries of the old SA keep their order.  So:

1. **dirty-range doubling**: ``build_suffix_array`` (prefix doubling,
   on the table's device) over the tail ``combined[n0 - (L-1):]`` only;
   every dirty or new suffix runs to the text end, so the tail's SA is
   their true mutual order;
2. **insertion search**: the lower bound of each dirty suffix's depth-L
   window among the clean suffixes.  On CUDA a packed-DNA merge is one
   launch of the ``bounded_search`` kernel (``kernels/csrc/
   pattern_scan.cu``) over the clean positions, with the combined text
   packed by the ``pack2bit`` kernel; elsewhere (the CPU, token tables)
   the plain binary search of ``query._bounded_search``.  Both give the
   exact partition point;
3. **interleave**: ``np.insert``'s order, on the device — new entries go
   before the clean entry at their insertion point, and among equal
   insertion points keep their (true suffix) order.

Tie rule, as the reference's: suffixes sharing an entire L window are
ordered with the new/dirty entries first, so on such text the merged SA
may differ from a from-scratch build in the order inside a tie block;
counts and positions stay exact.
"""
from __future__ import annotations

import torch

from repro_torch.core import codec
from repro_torch.core import query as Q
from repro_torch.core.suffix_array import build_suffix_array
from repro_torch.device import DeviceLike, resolve_device


def insertion_points(clean: torch.Tensor, combined: torch.Tensor,
                     n1: int, new_pos: torch.Tensor, plen: torch.Tensor,
                     *, is_dna: bool, max_query_len: int) -> torch.Tensor:
    """Per new suffix (text position ``new_pos``, compare depth
    ``plen``), the first index in ``[0, len(clean)]`` whose clean suffix
    is not less than its window: int32 (B,).  ``combined`` holds the
    text (codes) on the search's device."""
    B = int(new_pos.shape[0])
    n_clean = int(clean.shape[0])
    L = int(max_query_len)
    if is_dna:
        from repro_torch.kernels import ops
        packed = ops.pack2bit(combined.to(torch.uint8))
        patt = codec.extract_window(packed, new_pos,
                                    codec.packed_length(L))
        if clean.is_cuda:
            from repro_torch.kernels.pattern_scan import bounded_search_cuda
            lb, _ub = bounded_search_cuda(clean, packed, n1, patt, plen,
                                          n_clean)
            return lb
        return Q._bounded_search(
            clean, lambda pos: Q.compare_packed(packed, n1, pos, patt,
                                                plen)[0], B, n_clean)
    codes = combined.to(torch.int32)
    patt = Q.gather_suffix_codes(codes, n1, new_pos, L)
    return Q._bounded_search(
        clean, lambda pos: Q.compare_codes(codes, n1, pos, patt, plen)[0],
        B, n_clean)


def interleave(clean: torch.Tensor, ins: torch.Tensor,
               new_pos: torch.Tensor) -> torch.Tensor:
    """``np.insert(clean, ins, new_pos)`` on the tensors' device: entry
    k lands before ``clean[ins[k]]``, and entries with equal insertion
    points keep their order (numpy's stable argsort of ``ins``)."""
    B = int(ins.shape[0])
    dev = clean.device
    ins, order = torch.sort(ins.to(torch.int64), stable=True)
    dest = ins + torch.arange(B, dtype=torch.int64, device=dev)
    out = torch.empty(int(clean.shape[0]) + B, dtype=torch.int32,
                      device=dev)
    keep = torch.ones(out.shape, dtype=torch.bool, device=dev)
    keep[dest] = False
    out[dest] = new_pos[order].to(torch.int32)
    out[keep] = clean.to(torch.int32)
    return out


def merge_delta_sa(combined, n0: int, base_sa_real, *, is_dna: bool,
                   max_query_len: int,
                   device: DeviceLike = None) -> torch.Tensor:
    """Real-row suffix array of ``combined`` (the old text of ``n0``
    symbols plus the appended delta), merged from ``base_sa_real`` (numpy
    or tensor) instead of rebuilt: int32 on ``device`` (``cuda`` when
    None).  ``d <= 0`` returns the base unchanged; a base no longer
    than one compare window (nothing clean to keep) is built in full."""
    dev = resolve_device(device)
    c = codec.as_tensor(combined, dev)
    n1 = int(c.shape[0])
    n0 = int(n0)
    d = n1 - n0
    L = int(max_query_len)
    base = codec.as_tensor(base_sa_real, dev).to(torch.int32)
    if d <= 0:
        return base
    if n0 <= L:
        return build_suffix_array(c.to(torch.int32))
    if base.shape[0] != n0:
        raise ValueError(f"base SA has {base.shape[0]} rows for {n0} base "
                         f"symbols")
    cut = n0 - L                              # clean suffixes: start <= cut
    clean = base[base <= cut]                 # (n0 - L + 1,)
    del base
    # 1) dirty-range doubling: suffixes starting in [cut+1, n1) all run to
    # the text end, so the tail's SA is their true mutual order
    sa_tail = build_suffix_array(c[cut + 1:].to(torch.int32))
    new_pos = sa_tail.to(torch.int64) + (cut + 1)          # (d + L - 1,)
    plen = torch.clamp(n1 - new_pos, max=L).to(torch.int32)
    # 2) lower-bound insertion points, 3) np.insert's interleave
    ins = insertion_points(clean, c, n1, new_pos, plen, is_dna=is_dna,
                           max_query_len=L)
    return interleave(clean, ins, new_pos)
