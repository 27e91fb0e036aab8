"""GPipe-style pipeline parallelism over a mesh axis (the port of
``repro.distributed.pipeline``).

The layer stack is split into ``p`` contiguous stages, one per shard
along ``axis_name``; microbatches stream through with
``collectives.ppermute`` hand-offs.  The forward runs ``p + n_micro - 1``
ticks; the backward is autograd's through the list moves (the hand-off's
transpose is the reverse move), the GPipe fill-drain schedule without a
hand-written backward.

Single controller: per-shard values are lists in the mesh's shard
order.  A stage's bubble ticks (no microbatch is in flight there) are
not computed: their outputs never reach the last stage's writes, so the
outputs and gradients are the reference's.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch import tree as TR
from repro_torch.distributed import collectives as COL


def stage_slice(stacked_params, axis_name, n_layers_total: int, mesh):
    """Each shard's stage of a ``(L, ...)`` stacked param tree:
    ``(L / p, ...)`` views on the layer dim, one tree per shard."""
    p = mesh.axis_size(axis_name)
    per = n_layers_total // p
    return [TR.map_structure(lambda x, _d=d: x[_d * per:(_d + 1) * per],
                             stacked_params)
            for d in COL.axis_index(mesh, axis_name)]


def pipeline_apply(stage_fn: Callable, stage_params: Sequence,
                   x_micro: Sequence[torch.Tensor], axis_name, mesh):
    """Run ``stage_fn(params, h) -> h`` over the ``p`` stages of
    ``axis_name``.

    stage_params: each shard's stage params (``stage_slice``).
    x_micro: each shard's ``(n_micro, mb, ...)`` microbatched input,
    replicated along the pipeline axis (only stage 0's is injected).
    Returns each shard's ``(n_micro, mb, ...)`` outputs: the last
    stage's, given to every stage (a masked ``psum``, as in the
    reference)."""
    p = mesh.axis_size(axis_name)
    stage = COL.axis_index(mesh, axis_name)
    n_micro = x_micro[0].shape[0]
    ticks = n_micro + p - 1
    mesh.require_room(
        max(sum(x.numel() * x.element_size() for x in TR.leaves(sp))
            for sp in stage_params)
        + 2 * x_micro[0].numel() * x_micro[0].element_size(),
        "pipeline stage")
    fwd_perm = [(r, (r + 1) % p) for r in range(p)]

    recv = [torch.zeros_like(x[0]) for x in x_micro]
    outs: list = [[] for _ in x_micro]
    for t in range(ticks):
        h_out = []
        for i, d in enumerate(stage):
            if not 0 <= t - d < n_micro:          # a bubble tick
                h_out.append(torch.zeros_like(recv[i]))
                continue
            h_in = x_micro[i][t] if d == 0 else recv[i]
            h = stage_fn(stage_params[i], h_in)
            if d == p - 1:                        # microbatch t - (p - 1)
                outs[i].append(h)
            h_out.append(h)
        recv = COL.ppermute(h_out, fwd_perm, axis_name, mesh=mesh)
    last = [torch.stack(o) if o else torch.zeros_like(x)
            for o, x in zip(outs, x_micro)]
    return COL.psum(last, axis_name, mesh=mesh)
