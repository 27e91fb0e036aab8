"""Mixture-of-Experts FFN (token-choice top-k, capacity dropping, shared
experts) — the port of ``repro.models.moe``'s one-device path
(DeepSeek-V3 / Kimi-K2 / Jamba MoE blocks).

Routing is the reference's: an fp32 router, softmax, top-k with the
gates renormalised, the Switch load-balance aux loss, and sort-based
dispatch with choice-major priority (first choices win slots); tokens
beyond an expert's capacity ``C`` are dropped.  The data movement is
the reference's expert-parallel path (``_moe_ffn_ep``) on one device,
so that a run on the card is bit-reproducible: the sorted slots go back
to choice-major order, the buffer is filled per choice from ``xt``
itself (``index_add`` into a trash row for the drops; every real slot
is written once) and the combine is ``k`` gathers summed in order
``j = 0..k-1``.  The backward is gathers too, so no atomics sum a
token's gradient, and the ``(k*T, d)`` gathered copy never exists.
The expert products are ``torch.bmm``, as the reference's are ``jnp``
einsums outside any kernel.  The expert-parallel sharding itself
(``ep_sharding``) waits for the LM sharding slice (ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, init_mlp, mlp


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype):
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": _dense_init(gen, (d, E), d, torch.float32),  # fp32 router
        "wi": _dense_init(gen, (E, d, f), d, dtype),
        "wg": _dense_init(gen, (E, d, f), d, dtype),
        "wo": _dense_init(gen, (E, f, d), f, dtype),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(cfg, gen, dtype,
                               d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
    return p


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for ``T`` tokens: ceil(T * k / E * factor) in
    Python floats, rounded up to a multiple of 4, at least 4."""
    C = int(np.ceil(T * cfg.experts_per_token / cfg.num_experts
                    * cfg.moe_capacity_factor))
    return max(4, -(-C // 4) * 4)


def route(cfg: ModelConfig, p, xt):
    """Router and dispatch plan for ``xt`` (T, d).  Returns (gates (T, k)
    in fp32, slots (k, T) int64, C, aux): ``slots[j, t]`` is the buffer
    row ``e * C + pos`` that token ``t``'s ``j``-th choice fills, or
    ``E * C`` when that assignment is dropped."""
    T = xt.shape[0]
    k, E = cfg.experts_per_token, cfg.num_experts
    logits = xt.to(torch.float32) @ p["router"]                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)                   # (T, k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)

    # --- aux load-balance loss (Switch-style)
    me = torch.mean(probs, dim=0)                               # (E,)
    ce = torch.mean(F.one_hot(idx[:, 0], E).to(torch.float32), dim=0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_weight

    # --- dispatch plan (choice-major priority)
    C = capacity(cfg, T)
    flat_e = idx.T.reshape(-1)                                  # (k*T,)
    order = torch.sort(flat_e, stable=True).indices
    e_s = flat_e[order]
    start = torch.searchsorted(
        e_s, torch.arange(E, dtype=e_s.dtype, device=e_s.device),
        side="left")
    pos = torch.arange(k * T, dtype=e_s.dtype, device=e_s.device) \
        - start[e_s]
    slot_s = torch.where(pos < C, e_s * C + pos, E * C)
    slots = torch.empty_like(slot_s)
    slots[order] = slot_s            # back to choice-major (flat) order
    return gates, slots.reshape(k, T), C, aux


def moe_ffn(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (out, aux_loss).  Dropped assignments contribute
    nothing; a token dropped by every choice passes through the shared
    expert (and the residual) only."""
    B, S, d = x.shape
    T = B * S
    k, E = cfg.experts_per_token, cfg.num_experts
    xt = x.reshape(T, d)
    gates, slots, C, aux = route(cfg, p, xt)

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    for j in range(k):                 # row E*C is the trash row
        buf.index_add_(0, slots[j], xt)
    h = buf[:-1].reshape(E, C, d)

    # --- expert FFN
    if cfg.mlp_act == "swiglu":
        z = F.silu(torch.bmm(h, p["wg"])) * torch.bmm(h, p["wi"])
    else:
        z = F.gelu(torch.bmm(h, p["wi"]), approximate="tanh")
    y = torch.bmm(z, p["wo"]).reshape(E * C, d)

    # --- combine: k gathers, summed in choice order
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        sl = slots[j]
        contrib = torch.where((sl < E * C)[:, None],
                              y[torch.clamp(sl, max=E * C - 1)], 0)
        out = out + contrib * gates[:, j:j + 1].to(x.dtype)

    if cfg.num_shared_experts:
        out = out + mlp(cfg, p["shared"], xt)
    return out.reshape(B, S, d), aux
