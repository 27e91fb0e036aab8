"""The mesh's collectives over per-tablet tensors, single-controller.

One process drives every tablet of a ``launch.mesh.TabletMesh``: a
sharded value is a list of ``p`` tensors, entry ``d`` on tablet ``d``'s
device.  Each collective here has the semantics of its ``jax.lax``
namesake inside ``shard_map`` over that axis, so a per-tablet body of
the reference ports as phases: the local work of every tablet, then a
collective, then more local work.  Where tablets share a device (p
tablets on one card, or on the CPU) the moves are no-ops or on-device
copies; across cards they are ``.to(device)`` copies.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def _replicated(value: torch.Tensor, xs: Sequence[torch.Tensor]
                ) -> list[torch.Tensor]:
    """``value`` on every tablet's device, one copy per distinct device."""
    by_dev: dict = {}
    out = []
    for x in xs:
        if x.device not in by_dev:
            by_dev[x.device] = _on(value, x.device)
        out.append(by_dev[x.device])
    return out


def psum(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.psum``: the elementwise sum of every tablet's tensor, on
    every tablet, in the tensors' dtype (int32 stays int32)."""
    total = xs[0]
    for x in xs[1:]:
        total = total + _on(x, total.device)
    return _replicated(total, xs)


def all_gather(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.all_gather`` (not tiled): every tablet gets the (p, ...)
    stack of all tablets' tensors, in tablet order."""
    dev0 = xs[0].device
    stacked = torch.stack([_on(x, dev0) for x in xs])
    return _replicated(stacked, xs)


def all_to_all(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0)`` (not
    tiled) over (p, ...) tensors: tablet ``d`` receives row ``d`` of
    every tablet's tensor, stacked in tablet order."""
    p = len(xs)
    for x in xs:
        if int(x.shape[0]) != p:
            raise ValueError(f"all_to_all needs a leading axis of {p} "
                             f"(the tablet count), got {tuple(x.shape)}")
    return [torch.stack([_on(x[d], xs[d].device) for x in xs])
            for d in range(p)]


def ppermute(xs: Sequence[torch.Tensor], perm) -> list[torch.Tensor]:
    """``lax.ppermute``: ``perm`` holds ``(source, destination)`` pairs;
    tablet ``dst`` receives tablet ``src``'s tensor, and a tablet that
    is no destination gets zeros."""
    out = [None] * len(xs)
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError(f"ppermute: tablet {dst} is the destination "
                             f"of more than one pair in {perm}")
        out[dst] = _on(xs[src], xs[dst].device)
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]
