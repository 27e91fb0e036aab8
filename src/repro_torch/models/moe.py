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
einsums outside any kernel.

Under ``ep_sharding(mesh)`` a call of at least ``EP_MIN_TOKENS`` tokens
takes the expert-parallel path (``_moe_ffn_ep``) over the mesh's shards,
single-controller: each ``model`` shard owns ``E / model`` experts and
computes a partial output for its data row, and one grouped ``psum``
completes it.
"""
from __future__ import annotations

import contextvars

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as COL
from repro_torch.distributed import sharding as SH
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, init_mlp, mlp

# EP pays off with real token volume; at decode (T ~ batch) the
# reference keeps the one-device path (its FSDP weight gather dominates)
EP_MIN_TOKENS = 4096

# the mesh set by ``ep_sharding``; None: the one-device path
_EP_MESH: contextvars.ContextVar = contextvars.ContextVar("ep_mesh",
                                                          default=None)


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
    # lax.top_k's order: equal probabilities put the lower expert first
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[:, :k], top.indices[:, :k]          # (T, k)
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


def _experts(cfg: ModelConfig, xt, gates, slots, n_exp: int, C: int,
             wi, wg, wo):
    """Dispatch ``xt`` (T, d) into ``n_exp`` experts' buffers by
    ``slots`` (k, T) (``n_exp * C`` drops), run the experts and combine
    their outputs with ``gates``: k gathers summed in choice order."""
    T, d = xt.shape
    rows = n_exp * C
    buf = torch.zeros((rows + 1, d), dtype=xt.dtype, device=xt.device)
    for j in range(slots.shape[0]):    # row n_exp*C is the trash row
        buf.index_add_(0, slots[j], xt)
    h = buf[:-1].reshape(n_exp, C, d)

    # --- expert FFN
    if cfg.mlp_act == "swiglu":
        z = F.silu(torch.bmm(h, wg)) * torch.bmm(h, wi)
    else:
        z = F.gelu(torch.bmm(h, wi), approximate="tanh")
    y = torch.bmm(z, wo).reshape(rows, d)

    # --- combine: k gathers, summed in choice order
    out = torch.zeros((T, d), dtype=xt.dtype, device=xt.device)
    for j in range(slots.shape[0]):
        sl = slots[j]
        contrib = torch.where((sl < rows)[:, None],
                              y[torch.clamp(sl, max=rows - 1)], 0)
        out = out + contrib * gates[:, j:j + 1].to(xt.dtype)
    return out


def moe_ffn(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (out, aux_loss).  Dropped assignments contribute
    nothing; a token dropped by every choice passes through the shared
    expert (and the residual) only.  Under ``ep_sharding(mesh)`` the
    reference's rule picks the expert-parallel path: ``E`` divides over
    the ``model`` axis and the call has ``EP_MIN_TOKENS`` tokens."""
    mesh = _EP_MESH.get()
    if mesh is not None \
            and cfg.num_experts % mesh.shape.get("model", 1) == 0 \
            and x.shape[0] * x.shape[1] >= EP_MIN_TOKENS:
        return _moe_ffn_ep(cfg, p, x, mesh)
    B, S, d = x.shape
    E = cfg.num_experts
    xt = x.reshape(B * S, d)
    gates, slots, C, aux = route(cfg, p, xt)
    out = _experts(cfg, xt, gates, slots, E, C, p["wi"], p.get("wg"),
                   p["wo"])
    if cfg.num_shared_experts:
        out = out + mlp(cfg, p["shared"], xt)
    return out.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Expert parallelism over a (data, model) mesh, single controller
# ---------------------------------------------------------------------------
class ep_sharding:
    """Context manager: ``moe_ffn`` calls inside it take the
    expert-parallel path over ``mesh`` where the reference's would."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._token = _EP_MESH.set(self.mesh)
        return self

    def __exit__(self, *exc):
        _EP_MESH.reset(self._token)
        return False


def _moe_ffn_ep(cfg: ModelConfig, p, x, mesh):
    """The reference's ``shard_map`` EP body, shard by shard.  Shard
    (row, m) sees its data row's tokens and owns experts
    ``[m * E_local, (m + 1) * E_local)``: it routes the row at the row's
    own capacity, keeps the assignments to its experts (the rest go to a
    trash row), runs them and combines its partial output in choice
    order.  The expert weights' FSDP dim is gathered one model column at
    a time, so one column's gathered copy exists at once; a grouped
    ``psum`` over ``model`` completes each row.  The shared expert runs
    on the full ``x``; ``aux`` is the mean of the rows' aux."""
    d_axes = SH.data_axes(mesh)
    m_size = mesh.shape["model"]
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    E_local = E // m_size
    B, S, _ = x.shape
    T_row = B * S // mesh.axis_size(d_axes)
    C = capacity(cfg, T_row)
    n_w = 3 if cfg.mlp_act == "swiglu" else 2
    mesh.require_room(
        x.element_size() * (E_local * n_w * d * f + E_local * C * d
                            + 2 * T_row * d),
        f"expert-parallel MoE ({cfg.name}, E={E}, d={d}, f={f})")

    rows = SH.split(x, SH.P(d_axes, None, None), mesh)
    w_in, w_out = SH.P("model", d_axes, None), SH.P("model", None, d_axes)
    wi = SH.split(p["wi"], w_in, mesh)
    wg = SH.split(p["wg"], w_in, mesh) if n_w == 3 else None
    wo = SH.split(p["wo"], w_out, mesh)
    e0 = [m * E_local for m in COL.axis_index(mesh, "model")]
    parts, auxes = [None] * mesh.size, [None] * mesh.size
    for col in mesh.groups(d_axes):
        def gather(ws, axis):
            return COL.all_gather([ws[i] for i in col], tiled=True,
                                  axis=axis)
        cwi, cwo = gather(wi, 1), gather(wo, 2)
        cwg = gather(wg, 1) if wg is not None else [None] * len(col)
        for n, i in enumerate(col):
            xt = rows[i].reshape(-1, d)
            gates, slots, C_row, aux = route(cfg, p, xt)
            local = slots - e0[i] * C_row
            local = torch.where((local >= 0) & (local < E_local * C_row),
                                local, E_local * C_row)
            parts[i] = _experts(cfg, xt, gates, local, E_local, C_row,
                                cwi[n], cwg[n], cwo[n])
            auxes[i] = aux
        del cwi, cwg, cwo
    full = COL.psum(parts, "model", mesh=mesh)
    out = SH.join([t.reshape(-1, S, d) for t in full],
                  SH.P(d_axes, None, None), mesh)
    aux = torch.stack([auxes[g[0]] for g in mesh.groups("model")]).mean()
    if cfg.num_shared_experts:
        out = out + mlp(cfg, p["shared"], x.reshape(-1, d)).reshape(B, S, d)
    return out, aux
