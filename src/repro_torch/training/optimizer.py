"""Optimizers: AdamW and Adafactor (factored second moment) — the port of
``repro.training.optimizer``.

Plain functions on trees of tensors with the reference's formulas in
the reference's order, not ``torch.optim``: ``torch.optim.AdamW`` orders
the decay and the bias correction differently, and torch's Adafactor is
another algorithm.  Functional, as in the reference: ``init(cfg, params)
-> state``, ``apply(cfg, grads, state, params, step) -> (new_params,
new_state, metrics)``; nothing is updated in place.  The step is an
int32 tensor and the schedule and bias corrections run in float32, as
under jax.  LR schedule = linear warmup + cosine decay.

ZeRO-1: a leaf may be a ``distributed.sharding.Sharded`` (params, grads
and moments placed by ``opt_state_specs``).  Each distinct block is
updated once; the global norm sums each block position once, and
Adafactor's factored means total the blocks' partial sums over the
axes that split the reduced dim (a grouped ``psum``) and divide by the
full dim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.distributed import collectives as COL
from repro_torch.distributed.sharding import Sharded


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9              # adafactor: 0.0 disables momentum
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32


def _step(step, device=None) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.int32)
    return torch.tensor(int(step), dtype=torch.int32, device=device)


def lr_schedule(cfg: OptConfig, step):
    step = _step(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _blocks(x) -> list:
    """A leaf's blocks: a ``Sharded``'s distinct blocks, else ``[x]``."""
    return x.blocks if isinstance(x, Sharded) else [x]


def _like(x, blocks: list):
    """``blocks`` in ``x``'s placement (a plain tensor: the one block)."""
    return x.with_blocks(blocks) if isinstance(x, Sharded) else blocks[0]


def _pick(src, dst, values: list) -> list:
    """Per block of ``dst``, the value of ``src``'s block held by the
    same shard (``values`` one per block of ``src``)."""
    if not isinstance(src, Sharded) or src.layout is dst.layout:
        return values
    return [values[src.layout.index[i]] for i in dst.layout.first]


def _mean(x, parts: list, dim: int) -> list:
    """Per block of ``x``, the mean over ``x``'s whole ``dim`` of
    ``parts`` (one tensor per block, shaped like it)."""
    if not isinstance(x, Sharded) or x.layout.size[dim] == x.shape[dim]:
        return [p.mean(dim) for p in parts]
    sums = [p.sum(dim) for p in parts]
    COL.record("psum", sums[0])
    return [s / x.shape[dim] for s in x.total_along(sums, dim)]


def global_norm(tree):
    total, split = None, False
    for x in T.leaves(tree):
        own = x.layout.own if isinstance(x, Sharded) else [0]
        split = split or (isinstance(x, Sharded) and x.layout.splits > 1)
        for j in own:
            b = _blocks(x)[j]
            s = torch.sum(torch.square(b.to(torch.float32)))
            total = s if total is None else total + s.to(total.device)
    if split:
        COL.record("psum", total)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)

    def clip(g):
        return _like(g, [(b.to(torch.float32) * scale.to(b.device)
                          ).to(b.dtype) for b in _blocks(g)])
    return T.map_structure(clip, grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(cfg: OptConfig, params):
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                  device=p.device)
    return {"m": T.map_structure(zeros, params),
            "v": T.map_structure(zeros, params)}


def adamw_apply(cfg: OptConfig, grads, state, params, step, lr):
    b1, b2 = cfg.b1, cfg.b2
    t = _step(step) + 1

    def upd_block(g, m, v, p):
        g = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mh = m32 / (1 - b1 ** t)
        vh = v32 / (1 - b2 ** t)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay \
            * p.to(torch.float32)
        return ((p.to(torch.float32) - lr * delta).to(p.dtype),
                m32.to(cfg.state_dtype), v32.to(cfg.state_dtype))

    def upd(g, m, v, p):
        outs = [upd_block(*b) for b in zip(_blocks(g), _blocks(m),
                                           _blocks(v), _blocks(p))]
        return tuple(_like(x, [o[k] for o in outs])
                     for k, x in enumerate((p, m, v)))

    out = T.map_structure(upd, grads, state["m"], state["v"], params)
    outs = [x for _, x in T.flatten_with_path(out)]
    pick = lambda k: T.unflatten_like(params, outs[k::3])
    return pick(0), {"m": pick(1), "v": pick(2)}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern) — factored v for matrices, full v for vectors
# ---------------------------------------------------------------------------
def _factored(shape):
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(cfg: OptConfig, params):
    def init_one(p):
        z = lambda shape: torch.zeros(shape, dtype=cfg.state_dtype,
                                      device=p.device)
        st = {}
        if _factored(p.shape):
            st["vr"] = z(p.shape[:-1])
            st["vc"] = z(p.shape[:-2] + p.shape[-1:])
        else:
            st["v"] = z(p.shape)
        if cfg.b1 > 0:
            st["m"] = z(p.shape)
        return st
    return T.map_structure(init_one, params)


def adafactor_apply(cfg: OptConfig, grads, state, params, step, lr):
    b2 = cfg.b2
    t = _step(step) + 1
    bias = 1 - b2 ** t

    def upd(g, st, p):
        gs = [x.to(torch.float32) for x in _blocks(g)]
        g2 = [x * x + 1e-30 for x in gs]
        new_st = {}

        def decay(s, fresh):
            return [b2 * x.to(torch.float32) + (1 - b2) * y
                    for x, y in zip(_blocks(s), fresh)]

        def keep(s, blocks):
            return _like(s, [x.to(cfg.state_dtype) for x in blocks])

        if "vr" in st:
            vr = decay(st["vr"], _pick(g, st["vr"], _mean(g, g2, -1)))
            vc = decay(st["vc"], _pick(g, st["vc"], _mean(g, g2, -2)))
            new_st["vr"] = keep(st["vr"], vr)
            new_st["vc"] = keep(st["vc"], vc)
            vr_mean = _mean(st["vr"], vr, -1)
            rms = [torch.sqrt((r[..., None] * c[..., None, :]
                               / torch.clamp(m[..., None, None], min=1e-30)
                               ) / bias)
                   for r, c, m in zip(_pick(st["vr"], g, vr),
                                      _pick(st["vc"], g, vc),
                                      _pick(st["vr"], g, vr_mean))]
        else:
            v = decay(st["v"], g2)
            new_st["v"] = keep(st["v"], v)
            rms = [torch.sqrt(x / bias) for x in v]
        delta = [x / torch.clamp(r, min=cfg.eps) for x, r in zip(gs, rms)]
        if cfg.b1 > 0:
            m = [cfg.b1 * x.to(torch.float32) + (1 - cfg.b1) * d
                 for x, d in zip(_blocks(st["m"]), delta)]
            new_st["m"] = keep(st["m"], m)
            delta = m
        new_p = [(x.to(torch.float32) - lr * (d + cfg.weight_decay
                                              * x.to(torch.float32))
                  ).to(x.dtype) for x, d in zip(_blocks(p), delta)]
        return _like(p, new_p), new_st

    flat_p = T.leaves(params)
    flat_g = T.leaves(grads)
    flat_s = _per_leaf(state, params)
    outs = [upd(g, s, p) for g, s, p in zip(flat_g, flat_s, flat_p)]
    return (T.unflatten_like(params, [o[0] for o in outs]),
            T.unflatten_like(params, [o[1] for o in outs]))


def _per_leaf(state, params) -> list:
    """Adafactor's per-param state dicts in the params' flatten order
    (``flatten_up_to``)."""
    out = []

    def take(st, _p):
        out.append(st)
        return st
    T.map_structure(lambda p, st: take(st, p), params, state)
    return out


def init(cfg: OptConfig, params):
    return (adamw_init if cfg.kind == "adamw" else adafactor_init)(cfg, params)


@torch.no_grad()
def apply(cfg: OptConfig, grads, state, params, step):
    lr = lr_schedule(cfg, _step(step, T.leaves(params)[0].device))
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    fn = adamw_apply if cfg.kind == "adamw" else adafactor_apply
    new_params, new_state = fn(cfg, grads, state, params, step, lr)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
