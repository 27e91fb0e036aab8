"""Gradient compression for cross-pod reduction (the port of
``repro.distributed.compression``).

int8 block-quantized gradient exchange with error feedback: gradients
are quantized to int8 with a per-block fp32 scale, exchanged through
``collectives.all_gather`` (int8 and the scales are what moves), then
dequantized and averaged locally.  The quantization residual is carried
in an error-feedback buffer so the bias vanishes over steps
(Karimireddy et al. 2019).

Single controller: a value is a list of per-shard tensors (or trees),
one per shard of the mesh, and the mean runs over ``axis_name``'s
groups (every shard when ``axis_name`` is None).  The reference's op
order is kept, so the int8 blocks and scales are the reference's.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch import tree as TR
from repro_torch.distributed import collectives as COL

BLOCK = 256


def _quantize(x: torch.Tensor):
    """fp32 (n,) -> (int8 blocks (nb, BLOCK), scales (nb,), pad)."""
    n = x.shape[0]
    pad = (-n) % BLOCK
    xb = F.pad(x, (0, pad)).reshape(-1, BLOCK)
    amax = torch.amax(torch.abs(xb), dim=1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which can round the scale one ulp off the division
    scale = amax / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(xb / torch.clamp(scale, min=1e-20)),
                    -127, 127).to(torch.int8)
    return q, scale[:, 0], pad


def compressed_pmean(xs: Sequence[torch.Tensor], axis_name,
                     errs: Sequence[torch.Tensor], *, mesh=None):
    """Mean-reduce the shards' ``xs`` over ``axis_name`` with an int8
    payload.  Returns (means, new_errs), lists like ``xs``; ``errs``
    match ``xs``' shapes (error feedback).  Shards of a group that share
    a device share one dequantized mean."""
    qs, scales, new_errs = [], [], []
    for x, err in zip(xs, errs):
        flat = (x.to(torch.float32) + err.to(torch.float32)).reshape(-1)
        q, scale, _ = _quantize(flat)
        sent = (q.to(torch.float32) * scale[:, None]).reshape(-1)[
            :flat.shape[0]]
        new_errs.append((flat - sent).reshape(x.shape).to(x.dtype))
        qs.append(q)
        scales.append(scale)
    q_all = COL.all_gather(qs, axis_name, mesh=mesh)   # (p, nb, BLOCK) int8
    s_all = COL.all_gather(scales, axis_name, mesh=mesh)   # (p, nb) fp32
    means, done = [], {}
    for x, qa, sa in zip(xs, q_all, s_all):
        key = (id(qa), id(sa))
        if key not in done:
            deq = torch.sum(qa.to(torch.float32) * sa[..., None], dim=0) \
                / qa.shape[0]
            done[key] = deq.reshape(-1)[:x.numel()].reshape(x.shape
                                                            ).to(x.dtype)
        means.append(done[key])
    return means, new_errs


def compressed_pmean_tree(trees: Sequence, axis_name, err_trees: Sequence,
                          *, mesh=None):
    """``compressed_pmean`` leaf by leaf over the shards' trees.  Returns
    (mean trees, new error trees), one per shard."""
    if mesh is not None:
        mesh.require_room(
            sum(8 * x.numel() for x in TR.leaves(trees[0]))
            + mesh.size * wire_bytes(trees[0]),
            "compressed gradient exchange")
    flat = [TR.leaves(t) for t in trees]
    flat_e = [TR.leaves(t) for t in err_trees]
    means = [[] for _ in trees]
    errs = [[] for _ in trees]
    for j in range(len(flat[0])):
        m, e = compressed_pmean([f[j] for f in flat], axis_name,
                                [f[j] for f in flat_e], mesh=mesh)
        for i in range(len(trees)):
            means[i].append(m[i])
            errs[i].append(e[i])
    return ([TR.unflatten_like(t, v) for t, v in zip(trees, means)],
            [TR.unflatten_like(t, v) for t, v in zip(trees, errs)])


def zeros_like_tree(tree):
    """Zero error buffers shaped like ``tree``: zero-stride views, which
    hold no storage (the exchange only reads them)."""
    return TR.map_structure(
        lambda x: torch.zeros((), dtype=x.dtype, device=x.device
                              ).expand(x.shape), tree)


def wire_bytes(tree) -> int:
    """Bytes on the slow link per exchange: int8 payload + fp32 scales."""
    total = 0
    for x in TR.leaves(tree):
        n = int(x.numel())
        total += n + 4 * ((n + BLOCK - 1) // BLOCK)
    return total
