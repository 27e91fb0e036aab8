"""Distributed suffix-array construction over the tablet mesh — the
port of ``repro.core.dsa`` (the paper's pre-processing phase).

Prefix doubling where every sort is a distributed sort over the tablets
(``core.dsort``): each tablet only ever holds n/p rows, the Accumulo
tablet-ingest analogue.  The text is padded to p*m with a virtual
minimal symbol (initial rank -1, below every real code); that keeps the
blocks equal for the collectives and leaves the order of the real
suffixes that of the unpadded text, so the pad suffixes take the first
``pad_count`` rows of the sorted order and no query sees them.

The per-tablet functions take and return lists of per-tablet tensors
(single controller: ``distributed.collectives``); every rank, position
and ``gpos`` is int32, as in the reference.
:func:`build_suffix_array_distributed` is the host-side wrapper.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dsort import (bitonic_sort_sharded, lex_sort,
                                    sample_sort_sharded, sort_sharded_auto)
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import mesh_axis_size

METHODS = ("bitonic", "sample", "sample_unsafe")


def _sort(blocks, num_keys: int, method: str):
    if method == "sample":
        return sort_sharded_auto(blocks, num_keys=num_keys)
    if method == "sample_unsafe":          # the pure sample sort, no check
        out, _ = sample_sort_sharded(blocks, num_keys=num_keys)
        return out
    if method != "bitonic":
        raise ValueError(f"unknown sort method {method!r}; one of "
                         f"{METHODS}")
    return bitonic_sort_sharded(blocks, num_keys=num_keys)


def _cols(blocks, i: int) -> list:
    return [b[i] for b in blocks]


def _gpos(d: int, m: int, device) -> torch.Tensor:
    return d * m + torch.arange(m, dtype=torch.int32, device=device)


def _shift_ranks(rank, k: int, n_pad: int) -> list:
    """``nxt[i] = rank[gpos_i + k]`` in text-order sharding, -1 past the
    end: tablet d receives from ``(d + s0) % p`` and ``(d + s0 + 1) % p``
    (``k`` spans at most two neighbour blocks)."""
    p = len(rank)
    m = int(rank[0].shape[0])
    s0 = (k // m) % p
    from0 = (C.ppermute(rank, [(r, (r - s0) % p) for r in range(p)])
             if s0 else list(rank))
    from1 = C.ppermute(rank, [(r, (r - s0 - 1) % p) for r in range(p)])
    r = k % m
    out = []
    for d in range(p):
        nxt = torch.cat([from0[d], from1[d]])[r:r + m]
        gpos = _gpos(d, m, nxt.device)
        out.append(torch.where(gpos + k < n_pad, nxt, -1).to(torch.int32))
    return out


def _relabel_sharded(rank_s, nxt_s) -> list:
    """Dense new ranks for globally sorted (rank, nxt) rows: tablet d
    gets its left neighbour's last row, counts its changes, and offsets
    them by the tablets before it."""
    p = len(rank_s)
    perm = [(r, (r + 1) % p) for r in range(p)]
    prev_rank = C.ppermute([x[-1:] for x in rank_s], perm)
    prev_nxt = C.ppermute([x[-1:] for x in nxt_s], perm)
    cums = []
    for d in range(p):
        pr = torch.cat([prev_rank[d], rank_s[d][:-1]])
        pn = torch.cat([prev_nxt[d], nxt_s[d][:-1]])
        changed = ((rank_s[d] != pr) | (nxt_s[d] != pn)).to(torch.int32)
        if d == 0:                   # global row 0 is never "changed"
            changed[0] = 0
        cums.append(torch.cumsum(changed, 0, dtype=torch.int32))
    totals = C.all_gather([c[-1] for c in cums])
    return [(totals[d][:d].sum().to(torch.int32) + cums[d]).to(torch.int32)
            for d in range(p)]


def build_suffix_array_sharded(codes_local, *, n_real: int,
                               method: str = "bitonic",
                               num_steps: int | None = None):
    """``codes_local[d]`` is tablet d's text block (m,), the text padded
    to p*m (pad values ignored: their ranks are -1).  Returns (sa, rank)
    lists: tablet d holds sorted rows ``[d*m, (d+1)*m)`` of the padded
    suffix array and the text-order ranks.  Runs all ``num_steps``
    doubling rounds (``ceil(log2(p*m))`` when None), as the reference."""
    p = len(codes_local)
    m = int(codes_local[0].shape[0])
    n_pad = p * m
    gpos = [_gpos(d, m, c.device) for d, c in enumerate(codes_local)]
    rank = [torch.where(g < n_real, c.to(torch.int32), -1).to(torch.int32)
            for g, c in zip(gpos, codes_local)]
    if num_steps is None:
        num_steps = max(1, int(np.ceil(np.log2(n_pad))))

    # densify the initial ranks: sort by rank, relabel, scatter back
    srt = _sort(list(zip(rank, gpos)), 1, method)
    r_s, g_s = _cols(srt, 0), _cols(srt, 1)
    new_r = _relabel_sharded(r_s, r_s)
    rank = _cols(_sort(list(zip(g_s, new_r)), 1, method), 1)
    sa = gpos
    k = 1
    for _ in range(num_steps):
        nxt = _shift_ranks(rank, k, n_pad)
        srt = _sort(list(zip(rank, nxt, gpos)), 2, method)
        r_s, n_s, sa = _cols(srt, 0), _cols(srt, 1), _cols(srt, 2)
        new_r = _relabel_sharded(r_s, n_s)
        rank = _cols(_sort(list(zip(sa, new_r)), 1, method), 1)
        k *= 2
    return sa, rank


def _split(x: np.ndarray, mesh) -> list:
    """A host array cut into ``mesh.size`` equal blocks, block d on
    tablet d's device (the reference's ``in_specs=P(axis)``)."""
    p = mesh.size
    m = x.shape[0] // p
    return [torch.from_numpy(np.ascontiguousarray(x[d * m:(d + 1) * m]))
            .to(mesh.devices[d]) for d in range(p)]


def make_superchunk_sorter(mesh, axis_name: str = "tablets",
                           method: str = "sample"):
    """The mesh sort of one (key, nxt, idx) super-chunk for the staged
    build (``core.build_pipeline``): three int32 host arrays of a length
    divisible by the tablet count, sorted ascending by the full triple
    (idx last makes ties explicit, so the result is a stable 2-key sort
    of text-ordered rows).  Returns three numpy arrays."""

    def run(key, nxt, idx):
        cols = [_split(np.asarray(a, np.int32), mesh)
                for a in (key, nxt, idx)]
        out = _sort(list(zip(*cols)), 3, method)
        return tuple(torch.cat([b[i].cpu() for b in out]).numpy()
                     for i in range(3))

    return run


def build_suffix_array_distributed(codes: np.ndarray, mesh,
                                   axis_name: str = "tablets",
                                   method: str = "bitonic"):
    """Host-side wrapper: pads, runs the per-tablet build, returns
    ``(sa_padded, pad_count)`` with ``sa_padded`` int32 on the first
    tablet's device.  The real suffix array is ``sa_padded[pad_count:]``."""
    p = mesh_axis_size(mesh, axis_name)
    n_real = int(len(codes))
    m = int(np.ceil(n_real / p))
    n_pad = m * p
    padded = np.zeros((n_pad,), dtype=np.int32)
    padded[:n_real] = np.asarray(codes, dtype=np.int32)
    sa, _rank = build_suffix_array_sharded(_split(padded, mesh),
                                           n_real=n_real, method=method)
    dev0 = mesh.devices[0]
    return torch.cat([s.to(dev0) for s in sa]), n_pad - n_real
