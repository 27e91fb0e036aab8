"""The mesh's collectives over per-shard tensors, single-controller.

One process drives every shard of a mesh (``launch.mesh.TabletMesh`` or
the LM ``launch.mesh.Mesh``): a sharded value is a list of tensors,
entry ``i`` on shard ``i``'s device, in the mesh's row-major shard
order.  Each collective here has the semantics of its ``jax.lax``
namesake inside ``shard_map``, so a per-shard body of the reference
ports as phases: the local work of every shard, then a collective, then
more local work.  With no ``axis_name`` a collective spans every shard
(the tablet mesh's one axis); with one (a name or a tuple of names) and
the ``mesh``, it works within each group of shards that share every
other axis coordinate.  Where shards share a device (many shards on one
card, or on the CPU) a group's result is made once per device and the
moves are no-ops; across cards they are ``.to(device)`` copies.

Inside ``with counting() as c:`` every collective adds one to its kind's
count in ``c`` and its operand's bytes on one shard to that kind's
bytes, the convention of the reference's ``launch/hlo_analysis.py``
(which sums the operand bytes of each collective of the per-device
program).  ``counting(shards=n)`` counts a call over fewer than ``n``
shards (one group of a loop over groups) as that share of one, so a
loop that covers every shard once counts one collective a shard.  The
kinds are ``psum``, ``all_gather``, ``all_to_all`` and ``ppermute``
here, and the sharded train step's ``gather`` (a param
leaf joined from its blocks) and ``scatter`` (a gradient cut into its
blocks), which it records itself (``training.train_step``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Sequence

import torch

KINDS = ("psum", "all_gather", "all_to_all", "ppermute", "gather",
         "scatter")


class Counts:
    """Count and bytes (operand bytes on one shard) per collective kind,
    over a mesh of ``shards`` shards (None: every call counts one)."""

    def __init__(self, shards: int = None):
        self.shards = shards
        self.count = dict.fromkeys(KINDS, 0.0)
        self.bytes = dict.fromkeys(KINDS, 0.0)

    def add(self, kind: str, n_bytes: int, n_shards: int = None) -> None:
        share = 1.0 if self.shards is None or n_shards is None \
            else n_shards / self.shards
        self.count[kind] += share
        self.bytes[kind] += share * n_bytes

    def summary(self) -> dict:
        """The reference's ``collective_bytes`` record, and the counts
        per kind: ``{"bytes", "count", "by_kind", "count_by_kind"}``
        (kinds never seen left out)."""
        seen = [k for k in KINDS if self.count[k]]
        return {"bytes": round(sum(self.bytes.values())),
                "count": round(sum(self.count.values())),
                "by_kind": {k: round(self.bytes[k]) for k in seen},
                "count_by_kind": {k: round(self.count[k]) for k in seen}}


_COUNTS: contextvars.ContextVar = contextvars.ContextVar(
    "collective_counts", default=None)


@contextlib.contextmanager
def counting(shards: int = None) -> Iterator[Counts]:
    """Count the collectives run inside the block (nested blocks count
    into the innermost one only) over a mesh of ``shards`` shards."""
    counts = Counts(shards)
    token = _COUNTS.set(counts)
    try:
        yield counts
    finally:
        _COUNTS.reset(token)


def record(kind: str, operand: torch.Tensor, n_shards: int = None
           ) -> None:
    """Count one ``kind`` collective of ``operand`` (one shard's) over
    ``n_shards`` shards (None: the whole mesh)."""
    counts = _COUNTS.get()
    if counts is not None:
        counts.add(kind, operand.numel() * operand.element_size(),
                   n_shards)


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


def _groups(xs: Sequence, axis_name, mesh) -> list:
    """Shard indices per group: every shard when ``axis_name`` is None,
    else ``mesh.groups(axis_name)``."""
    if axis_name is None:
        return [list(range(len(xs)))]
    if mesh is None:
        raise ValueError(f"a collective over axis {axis_name!r} needs the "
                         f"mesh")
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shards given for a mesh of "
                         f"{mesh.size}")
    return mesh.groups(axis_name)


def _per_group(xs, axis_name, mesh, fn) -> list:
    """``fn(group's tensors)`` once per group, on every shard of it."""
    out = [None] * len(xs)
    for g in _groups(xs, axis_name, mesh):
        got = _replicated(fn([xs[i] for i in g]), [xs[i] for i in g])
        for i, t in zip(g, got):
            out[i] = t
    return out


def axis_index(mesh, axis_name) -> list[int]:
    """``lax.axis_index``: each shard's index along ``axis_name``."""
    return [mesh.index_along(i, axis_name) for i in range(mesh.size)]


def psum(xs: Sequence[torch.Tensor], axis_name=None, *,
         mesh=None) -> list[torch.Tensor]:
    """``lax.psum``: the elementwise sum of the group's tensors, summed
    in shard order, on every shard of the group, in the tensors' dtype
    (int32 stays int32)."""
    record("psum", xs[0], len(xs))

    def total(g):
        t = g[0]
        for x in g[1:]:
            t = t + _on(x, t.device)
        return t
    return _per_group(xs, axis_name, mesh, total)


def all_gather(xs: Sequence[torch.Tensor], axis_name=None, *, mesh=None,
               axis: int = 0, tiled: bool = False) -> list[torch.Tensor]:
    """``lax.all_gather``: every shard of a group gets its tensors in
    group order, stacked on a new dim ``axis`` or, ``tiled``,
    concatenated along ``axis`` (a group of one keeps its tensor)."""
    record("all_gather", xs[0], len(xs))

    def gather(g):
        dev0 = g[0].device
        if tiled:
            return g[0] if len(g) == 1 else \
                torch.cat([_on(x, dev0) for x in g], dim=axis)
        return torch.stack([_on(x, dev0) for x in g], dim=axis)
    return _per_group(xs, axis_name, mesh, gather)


def all_to_all(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0)`` (not
    tiled) over (p, ...) tensors: tablet ``d`` receives row ``d`` of
    every tablet's tensor, stacked in tablet order."""
    p = len(xs)
    for x in xs:
        if int(x.shape[0]) != p:
            raise ValueError(f"all_to_all needs a leading axis of {p} "
                             f"(the tablet count), got {tuple(x.shape)}")
    record("all_to_all", xs[0], len(xs))
    return [torch.stack([_on(x[d], xs[d].device) for x in xs])
            for d in range(p)]


def ppermute(xs: Sequence[torch.Tensor], perm, axis_name=None, *,
             mesh=None) -> list[torch.Tensor]:
    """``lax.ppermute``: ``perm`` holds ``(source, destination)`` pairs
    of indices within a group; shard ``dst`` of each group receives
    shard ``src``'s tensor, and a shard that is no destination gets
    zeros."""
    record("ppermute", xs[0], len(xs))
    out = [None] * len(xs)
    for g in _groups(xs, axis_name, mesh):
        seen = set()
        for src, dst in perm:
            if dst in seen:
                raise ValueError(f"ppermute: shard {dst} is the "
                                 f"destination of more than one pair in "
                                 f"{perm}")
            seen.add(dst)
            out[g[dst]] = _on(xs[g[src]], xs[g[dst]].device)
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]
