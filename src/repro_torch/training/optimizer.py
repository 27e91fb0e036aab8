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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree as T


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


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in T.leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return T.map_structure(lambda g: (g.to(torch.float32) * scale
                                      ).to(g.dtype), grads), norm


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

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mh = m32 / (1 - b1 ** t)
        vh = v32 / (1 - b2 ** t)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay \
            * p.to(torch.float32)
        return ((p.to(torch.float32) - lr * delta).to(p.dtype),
                m32.to(cfg.state_dtype), v32.to(cfg.state_dtype))

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
        g = g.to(torch.float32)
        g2 = g * g + 1e-30
        new_st = {}
        if "vr" in st:
            vr = b2 * st["vr"].to(torch.float32) + (1 - b2) * g2.mean(-1)
            vc = b2 * st["vc"].to(torch.float32) + (1 - b2) * g2.mean(-2)
            new_st["vr"] = vr.to(cfg.state_dtype)
            new_st["vc"] = vc.to(cfg.state_dtype)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=1e-30)
                     ) / bias
            rms = torch.sqrt(denom)
        else:
            v = b2 * st["v"].to(torch.float32) + (1 - b2) * g2
            new_st["v"] = v.to(cfg.state_dtype)
            rms = torch.sqrt(v / bias)
        delta = g / torch.clamp(rms, min=cfg.eps)
        if cfg.b1 > 0:
            m = cfg.b1 * st["m"].to(torch.float32) + (1 - cfg.b1) * delta
            new_st["m"] = m.to(cfg.state_dtype)
            delta = m
        delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), new_st

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
