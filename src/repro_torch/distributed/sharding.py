"""Sharding rules: logical names -> ``PartitionSpec`` for LM parameters,
optimizer state, decode caches, batches and activations (the port of
``repro.distributed.sharding``), plus ``mesh_axis_size`` for the
suffix-array store.

Strategy: 2-D FSDP x TP.
  * ``model`` axis: TP -- attention heads, FFN hidden, experts (EP), vocab.
  * ``data`` axis (+ ``pod`` when present): DP for the batch, FSDP for the
    non-TP dim of every large weight, ZeRO-1 for optimizer state (it
    inherits the param specs).
Param specs come from an explicit name-based table (the last path segment
plus enclosing module), applied to the trailing dims: stacked tensors
carry a leading ``n_periods`` dim that is never sharded.  Paths are jax's
key-path strings (``repro_torch.tree.flatten_with_path``), so the
reference's regexes apply as they are.

The port is eager and single-controller: a sharded tensor is a list of
per-shard pieces in the mesh's row-major shard order (``split`` /
``join``), and an activation constraint has nothing to constrain
(``make_shard_fn``).  A placed state leaf is a :class:`Sharded`: each
distinct block stored once, shared by every shard on its device that
holds it (``place_tree``, the reference's ``named`` + ``device_put``;
``join_tree`` is its inverse).
"""
from __future__ import annotations

import functools
import math
import re
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree as TR
from repro_torch.launch.mesh import TabletMesh


class PartitionSpec(tuple):
    """One entry per dim: ``None`` (replicated), an axis name, or a tuple
    of names (row-major over them).  A tuple subclass, so a tree of specs
    keeps it as one leaf (``repro_torch.tree``), as jax does."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def data_axes(mesh) -> tuple:
    """All DP-capable axes present in the mesh ('pod' folds into data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def mesh_axis_size(mesh: Optional[object], axis_name=None) -> int:
    """Shards along ``axis_name`` (a name, a tuple of names, or ``None``
    for every axis); ``mesh=None`` means one device (1).  A
    ``TabletMesh`` has the one axis ``"tablets"``, so every name of it
    gives its tablet count."""
    if mesh is None:
        return 1
    if isinstance(mesh, TabletMesh) or axis_name is None:
        return int(mesh.size)
    axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    return math.prod(mesh.shape[a] for a in axes)


# Role tables: trailing-dims spec templates.  'M' = model axis, 'D' = data
# (FSDP) axes, None = replicated.  Matched on (enclosing, leaf-name).
_RULES: list[tuple[str, str, tuple]] = [
    # (enclosing-regex, leaf-regex, trailing spec)
    (r"moe", r"^(wi|wg|wo)$",      ("M", "D", None)),   # (E, d, f)/(E, f, d)
    (r"moe", r"^router$",          (None, None)),
    (r"shared", r"^(wi|wg)$",      ("D", "M")),         # (d, f)
    (r"shared", r"^wo$",           ("M", "D")),         # (f, d)
    (r"(attn|mtp)", r"^(wq|wk|wv)$", ("D", "M", None)), # (d, H, dh)
    (r"(attn|mtp)", r"^(wq_b|wk_b|wv_b)$", ("D", "M", None)),  # (r, H, dh)
    (r"(attn|mtp)", r"^(wq_a|wkv_a)$",     ("D", "M")),        # (d, r)
    (r"(attn|mtp)", r"^wo$",       ("M", None, "D")),   # (H, dh, d)
    (r"(attn|mtp)", r"^(bq|bk|bv)$", ("M", None)),      # (H, dh)
    (r"ssm", r"^in_proj$",         ("D", "M")),         # (d, 2di+2N+H)
    (r"ssm", r"^out_proj$",        ("M", "D")),         # (di, d)
    (r"", r"^(wi|wg)$",            ("D", "M")),         # dense mlp
    (r"", r"^wo$",                 ("M", "D")),
    (r"", r"^embed$",              ("M", "D")),         # (V, d)
    (r"", r"^unembed$",            ("D", "M")),         # (d, V)
    (r"", r"^proj$",               ("D", "M")),         # mtp proj (2d, d)
]


def _leaf_name(path: str) -> tuple[str, str]:
    keys = re.findall(r"\['([^']+)'\]", path)
    leaf = keys[-1] if keys else path
    enclosing = "/".join(keys[:-1])
    return enclosing, leaf


def param_spec(path: str, shape: tuple, mesh, fsdp: bool = True) -> P:
    d_axes = data_axes(mesh) if fsdp else ()
    model_size = mesh.shape.get("model", 1)
    d_size = math.prod(mesh.shape[a] for a in d_axes)
    enclosing, leaf = _leaf_name(path)

    for enc_re, leaf_re, template in _RULES:
        if re.search(enc_re, enclosing) and re.match(leaf_re, leaf):
            n_tail = len(template)
            if len(shape) < n_tail:
                return P()
            lead = len(shape) - n_tail
            spec: list = [None] * len(shape)
            for i, role in enumerate(template):
                dim = lead + i
                if role == "M" and shape[dim] % model_size == 0 \
                        and shape[dim] >= model_size:
                    spec[dim] = "model"
                elif role == "D" and d_axes and shape[dim] % d_size == 0 \
                        and shape[dim] >= d_size:
                    spec[dim] = d_axes
            return P(*spec)
    return P()          # norms, biases, scalars: replicated


def param_specs(params, mesh, fsdp: bool = True):
    """Tree of PartitionSpecs matching ``params`` (tensors, meta tensors
    or anything with a ``shape``)."""
    return TR.unflatten_like(params, [
        param_spec(path, tuple(leaf.shape), mesh, fsdp)
        for path, leaf in TR.flatten_with_path(params)])


def make_shard_fn(mesh, seq_shard: bool = False):
    """Activation constraint callback for model code.  Eager code has
    nothing to constrain, so ``shard(x, name)`` returns ``x``;
    ``shard.spec(shape, name)`` is the spec the reference would apply
    (``None`` where it leaves ``x`` alone).

    Logical names:
      act       (B, S, d)  batch over data axes (+ optionally seq/model)
      tokens2d  (T, d)     flat tokens over data axes
      moe_ecd   (E, C, *)  experts over model (EP), capacity over data
      ssd_h2    (b, nc, h, ...)  batch over data, SSD heads over model
    """
    d_axes = data_axes(mesh)
    d_size = max(math.prod(mesh.shape[a] for a in d_axes), 1)
    m_size = mesh.shape.get("model", 1)

    def spec(shape, name) -> Optional[P]:
        nd = len(shape)
        out = [None] * nd
        if name == "act" and nd >= 2:
            if shape[0] % d_size == 0 and shape[0] >= d_size:
                out[0] = d_axes
            if seq_shard and nd >= 3 and shape[1] % m_size == 0:
                out[1] = "model"
        elif name == "tokens2d" and nd == 2:
            if shape[0] % d_size == 0 and shape[0] >= d_size:
                out[0] = d_axes
        elif name == "moe_ecd" and nd == 3:
            if shape[0] % m_size == 0 and shape[0] >= m_size:
                out[0] = "model"
            if shape[1] % d_size == 0 and shape[1] >= d_size:
                out[1] = d_axes
        elif name == "ssd_h2" and nd >= 3:
            if shape[0] % d_size == 0 and shape[0] >= d_size:
                out[0] = d_axes
            if shape[2] % m_size == 0 and shape[2] >= m_size:
                out[2] = "model"
        else:
            return None
        return P(*out)

    def shard(x, name):
        return x

    shard.spec = spec
    shard.mesh = mesh
    return shard


def batch_spec_tree(batch, mesh):
    """Input batch: shard leading (batch) dim over all data axes when it
    divides; otherwise replicate (long_500k has batch 1)."""
    d_axes = data_axes(mesh)
    d_size = math.prod(mesh.shape[a] for a in d_axes)

    def spec_for(v):
        nd = len(v.shape)
        if v.shape[0] % d_size == 0 and v.shape[0] >= d_size:
            return P(d_axes, *([None] * (nd - 1)))
        return P(*([None] * nd))

    return TR.map_structure(spec_for, batch)


def opt_state_specs(opt_cfg, params, pspecs):
    """ZeRO-1: optimizer moments inherit the param spec.  AdamW m/v mirror
    params exactly; Adafactor's factored stats drop the reduced dim."""
    if opt_cfg.kind == "adamw":
        return {"m": pspecs, "v": pspecs}

    def one(p, spec):
        parts = list(spec)
        parts += [None] * (len(p.shape) - len(parts))
        st = {}
        if len(p.shape) >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1:
            st["vr"] = P(*parts[:-1])
            st["vc"] = P(*(parts[:-2] + parts[-1:]))
        else:
            st["v"] = P(*parts)
        if opt_cfg.b1 > 0:
            st["m"] = P(*parts)
        return st

    return TR.unflatten_like(params, [
        one(p, s) for p, s in zip(TR.leaves(params), TR.leaves(pspecs))])


def cache_specs(caches, mesh, batch_size: int):
    """PartitionSpecs for decode caches.  Batch shards over data axes when
    divisible; otherwise the (long) cache sequence dim takes the data axes
    (long_500k: batch=1, 512k-token KV).  Heads/channels shard over model
    when divisible.  Cache layouts (see models/transformer.py):
      k/v     (B, S, KV, dh)   [+ leading n_periods when stacked]
      ckv     (B, S, r) ; krope (B, S, dr)
      ssm     (B, H, P, N) ; conv (B, K-1, ch) ; length scalars/vectors
    """
    d_axes = data_axes(mesh)
    d_size = math.prod(mesh.shape[a] for a in d_axes)
    m_size = mesh.shape.get("model", 1)
    batch_ok = batch_size % d_size == 0 and batch_size >= d_size

    def spec_for(path: str, leaf) -> P:
        _, name = _leaf_name(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name == "length" or nd == 0:
            return P()
        base: dict[int, Any] = {}
        if name in ("k", "v"):
            lead = nd - 4
            seq_axes = []
            if batch_ok:
                base[lead + 0] = d_axes
            else:
                seq_axes.extend(d_axes)
            if shape[lead + 2] % m_size == 0 and shape[lead + 2] >= m_size:
                base[lead + 2] = "model"       # TP over KV heads
            else:
                seq_axes.append("model")       # fall back: shard cache seq
            seq_sz = math.prod(mesh.shape[a] for a in seq_axes)
            if seq_axes and shape[lead + 1] % seq_sz == 0 \
                    and shape[lead + 1] >= seq_sz:
                base[lead + 1] = tuple(seq_axes)
        elif name in ("ckv", "krope"):
            lead = nd - 3
            seq_axes = ["model"]               # latent has no head dim
            if batch_ok:
                base[lead + 0] = d_axes
            else:
                seq_axes = list(d_axes) + seq_axes
            seq_sz = math.prod(mesh.shape[a] for a in seq_axes)
            if shape[lead + 1] % seq_sz == 0 and shape[lead + 1] >= seq_sz:
                base[lead + 1] = tuple(seq_axes)
        elif name == "ssm":
            lead = nd - 4
            if batch_ok:
                base[lead + 0] = d_axes
            if shape[lead + 1] % m_size == 0:
                base[lead + 1] = "model"
        elif name == "conv":
            lead = nd - 3
            if batch_ok:
                base[lead + 0] = d_axes
            if shape[lead + 2] % m_size == 0:
                base[lead + 2] = "model"
        return P(*[base.get(i) for i in range(nd)])

    return TR.unflatten_like(caches, [
        spec_for(path, x) for path, x in TR.flatten_with_path(caches)])


# ---------------------------------------------------------------------------
# Per-shard pieces: the reference's ``named`` placement, eagerly
# ---------------------------------------------------------------------------
def _blocks(shape, spec, mesh, i: int) -> list:
    """(dim, start, length) of shard ``i``'s block of a ``shape`` tensor."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more dims than shape {shape}")
    out = []
    for dim, part in enumerate(spec):
        if part is None:
            continue
        n = mesh.axis_size(part)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {n} pieces for spec {spec}")
        size = shape[dim] // n
        out.append((dim, mesh.index_along(i, part) * size, size))
    return out


def split(x: torch.Tensor, spec, mesh) -> list:
    """Shard ``i``'s piece of ``x`` for every shard of ``mesh``: a view
    of ``x`` (``narrow`` on each sharded dim), moved to the shard's
    device only where that differs from ``x``'s."""
    out = []
    for i in range(mesh.size):
        piece = x
        for dim, start, size in _blocks(x.shape, spec, mesh, i):
            piece = piece.narrow(dim, start, size)
        dev = mesh.devices[i]
        out.append(piece if piece.device == dev else piece.to(dev))
    return out


def join(pieces, spec, mesh) -> torch.Tensor:
    """The full tensor ``split`` cut into ``pieces``, on the first
    shard's device; each block is read from the first shard that holds
    it."""
    first = pieces[0]
    shape = list(first.shape)
    for dim, part in enumerate(spec):
        if part is not None:
            shape[dim] *= mesh.axis_size(part)
    out = first.new_empty(shape)
    seen = set()
    for i, piece in enumerate(pieces):
        blocks = tuple(_blocks(shape, spec, mesh, i))
        if blocks in seen:
            continue
        seen.add(blocks)
        idx = [slice(None)] * len(shape)
        for dim, start, size in blocks:
            idx[dim] = slice(start, start + size)
        out[tuple(idx)] = piece.to(out.device)
    return out


# ---------------------------------------------------------------------------
# Placed tensors: each distinct block once
# ---------------------------------------------------------------------------
class Layout(NamedTuple):
    """Where the blocks of a ``shape`` tensor placed by a spec lie:
    shard ``i`` holds block ``index[i]``; block ``j`` starts at
    ``starts[j]`` (one offset per dim), is ``size`` long on each dim and
    lies on shard ``first[j]``'s device; ``splits`` is the number of
    distinct block positions and ``own`` one block at each of them."""
    index: tuple
    starts: tuple
    first: tuple
    size: tuple
    splits: int
    own: tuple


@functools.lru_cache(maxsize=1024)
def layout(shape: tuple, spec, mesh) -> Layout:
    """The :class:`Layout` of ``shape`` under ``spec`` on ``mesh``: shards
    on one device that hold the same block share it."""
    size = list(shape)
    splits = 1
    for dim, part in enumerate(spec):
        if part is not None:
            n = mesh.axis_size(part)
            size[dim] //= n
            splits *= n
    ids: dict = {}
    index, starts, first = [], [], []
    for i in range(mesh.size):
        at = [0] * len(shape)
        for dim, start, _ in _blocks(shape, spec, mesh, i):
            at[dim] = start
        key = (mesh.devices[i], tuple(at))
        if key not in ids:
            ids[key] = len(starts)
            starts.append(tuple(at))
            first.append(i)
        index.append(ids[key])
    own = tuple(starts.index(at) for at in dict.fromkeys(starts))
    return Layout(tuple(index), tuple(starts), tuple(first), tuple(size),
                  splits, own)


class Sharded:
    """A tensor placed on ``mesh`` by ``spec`` (the reference's array
    under a ``NamedSharding``), held once per distinct block:
    ``blocks[j]`` lies on the device of the first shard that holds it,
    and shard ``i``'s piece is ``blocks[layout.index[i]]``.  A leaf of
    ``repro_torch.tree``."""

    __slots__ = ("blocks", "layout", "spec", "mesh", "shape")

    def __init__(self, blocks: list, layout: Layout, spec, mesh,
                 shape: tuple):
        self.blocks, self.layout = blocks, layout
        self.spec, self.mesh, self.shape = spec, mesh, tuple(shape)

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, spec={self.spec!r}, "
                f"blocks={len(self.blocks)} of {tuple(self.layout.size)})")

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def pieces(self) -> list:
        """Shard ``i``'s piece for every shard, in shard order."""
        return [self.blocks[j] for j in self.layout.index]

    @property
    def block_bytes(self) -> int:
        b = self.blocks[0]
        return b.numel() * b.element_size()

    def with_blocks(self, blocks: list) -> "Sharded":
        """The same placement holding ``blocks``."""
        return Sharded(blocks, self.layout, self.spec, self.mesh,
                       self.shape)

    def join(self) -> torch.Tensor:
        """The full tensor, on the first block's device."""
        if len(self.blocks) == 1 and self.layout.splits == 1:
            return self.blocks[0]
        first = self.blocks[0]
        out = first.new_empty(self.shape)
        for start, block in zip(self.layout.starts, self.blocks):
            idx = tuple(slice(a, a + n)
                        for a, n in zip(start, self.layout.size))
            out[idx] = block.to(out.device)
        return out

    def cut(self, full: torch.Tensor) -> "Sharded":
        """``full`` (this tensor's shape) cut into this placement's
        blocks, each a tensor of its own (a view would keep ``full``
        alive) on its block's device."""
        if tuple(full.shape) != self.shape:
            raise ValueError(f"cut: {tuple(full.shape)} is not the placed "
                             f"shape {self.shape}")
        out = []
        for start, i in zip(self.layout.starts, self.layout.first):
            piece = full
            for dim, (a, n) in enumerate(zip(start, self.layout.size)):
                if n != full.shape[dim]:
                    piece = piece.narrow(dim, a, n)
            dev = self.mesh.devices[i]
            if piece.device != dev:
                piece = piece.to(dev)
            elif self.layout.splits > 1:
                piece = piece.clone(memory_format=torch.contiguous_format)
            out.append(piece)
        return self.with_blocks(out)

    def total_along(self, parts: list, dim: int) -> list:
        """``parts[j]``: block ``j``'s partial sum over ``dim`` of the
        placed tensor.  Returns, per block, the sum of the partials of
        every block that differs from it only along ``dim`` (the grouped
        ``psum`` over the axes that split ``dim``), in order along
        ``dim``, on each block's device."""
        dim %= len(self.shape)
        groups: dict = {}
        for j, start in enumerate(self.layout.starts):
            key = (self.blocks[j].device,
                   start[:dim] + start[dim + 1:])
            groups.setdefault(key, []).append(j)
        out = [None] * len(parts)
        for members in groups.values():
            members.sort(key=lambda j: self.layout.starts[j][dim])
            total = parts[members[0]]
            for j in members[1:]:
                total = total + parts[j].to(total.device)
            for j in members:
                out[j] = total
        return out


def place(x: torch.Tensor, spec, mesh) -> Sharded:
    """``x`` placed on ``mesh`` by ``spec``: each distinct block a tensor
    of its own on its shard's device."""
    spec = P(*spec)
    lay = layout(tuple(x.shape), spec, mesh)
    return Sharded([], lay, spec, mesh, x.shape).cut(x)


def place_tree(tree, spec_tree, mesh):
    """Every tensor leaf of ``tree`` placed by the matching leaf of
    ``spec_tree`` (the reference's ``jax.device_put(tree, named(mesh,
    spec_tree))``); numpy leaves are made tensors first."""
    specs = TR.leaves(spec_tree)
    leaves = TR.leaves(tree)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves and {len(specs)} specs")
    out = []
    for x, spec in zip(leaves, specs):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        out.append(place(x, spec, mesh))
    return TR.unflatten_like(tree, out)


def join_tree(tree):
    """The inverse of ``place_tree``: every :class:`Sharded` leaf joined
    into its full tensor; other leaves as they are."""
    return TR.map_structure(
        lambda x: x.join() if isinstance(x, Sharded) else x, tree)


def shard_bytes(tree, spec_tree, mesh) -> int:
    """Bytes one shard holds of ``tree`` (tensors or meta tensors) placed
    by ``spec_tree`` on ``mesh``; every shard holds as many."""
    total = 0
    for x, spec in zip(TR.leaves(tree), TR.leaves(spec_tree)):
        splits = layout(tuple(x.shape), P(*spec), mesh).splits
        total += math.prod(x.shape) // splits * x.element_size()
    return total


def stored_bytes(tree) -> int:
    """Bytes of every distinct block of the :class:`Sharded` leaves of
    ``tree`` (the whole tree stored once on one device)."""
    return sum(b.numel() * b.element_size() for x in TR.leaves(tree)
               if isinstance(x, Sharded) for b in x.blocks)
