"""Mamba-2 block via the SSD (state-space duality) algorithm
[arXiv:2405.21060] — the port of ``repro.models.ssm``.

Train/prefill: chunked SSD — intra-chunk quadratic (attention-like) term
plus the inter-chunk recurrent state passed through a cumulative-decay
scan (the reference's ``lax.scan`` over chunks is a Python loop here).
Decode: the O(1) recurrent state update.  The products are
``torch.einsum``, as the reference's are ``jnp`` outside any kernel.

Shapes follow the paper: d_inner = expand*d_model, heads =
d_inner/headdim, single B/C group (G=1), scalar-per-head A.  The ``ssm``
state is fp32 even when the params are bf16.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, init_rmsnorm, rmsnorm


def init_ssm(cfg: ModelConfig, gen: torch.Generator, dtype):
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # fused input projection: [z (di), xBC (di+2N), dt (H)]
        "in_proj": _dense_init(gen, (d, 2 * di + 2 * N + H), d, dtype),
        "conv_w": _dense_init(gen, (cfg.ssm_conv, conv_ch), cfg.ssm_conv,
                              dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.zeros((H,), **f32),              # A = -exp(A_log)
        "dt_bias": torch.full((H,), float(np.float32(np.log(np.e - 1))),
                              **f32),
        "D": torch.ones((H,), **f32),
        "norm": init_rmsnorm(di, dtype, dev),
        "out_proj": _dense_init(gen, (di, d), di, dtype),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv, kernel K (static small): u (B,S,C), w (K,C)."""
    K = w.shape[0]
    out = torch.zeros_like(u)
    for i in range(K):
        shift = K - 1 - i
        if shift == 0:
            out = out + u * w[i]
        else:
            out = out + F.pad(u, (0, 0, shift, 0))[:, :-shift] * w[i]
    return out + b


def _segsum(a):
    """a: (..., Q) log-decays -> (..., Q, Q) lower-tri cumulative sums:
    out[i, j] = sum_{j < s <= i} a[s], -inf above the diagonal (masked
    before the ``exp``, so the backward sees no NaN)."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD forward.  x: (b, s, h, p); dt: (b, s, h) (discretization step,
    post-softplus); A: (h,) negative; B, C: (b, s, n).
    Returns (y (b,s,h,p), final_state (b,h,p,n))."""
    b, s, h, pdim = x.shape
    n = B.shape[-1]
    s_orig = s
    if s % chunk:
        # pad with dt=0 steps: decay=1, zero input -> state untouched
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, pdim)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    dA = dtc * A[None, None, None, :]                    # (b,nc,Q,h)
    dA = torch.movedim(dA, -1, 2)                        # (b,nc,h,Q)
    xbar = xc * dtc[..., None]                           # dt-weighted input

    # ---- intra-chunk (quadratic attention-like term)
    L = torch.exp(_segsum(dA))                           # (b,nc,h,Q,Q)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)     # (b,nc,Q,Q)
    y_intra = torch.einsum("bcls,bchls,bcshp->bclhp", scores, L, xbar)

    # ---- chunk final states (decay from step s+1 .. chunk end)
    cums = torch.cumsum(dA, dim=-1)
    decay_to_end = torch.exp(cums[..., -1:] - cums)      # (b,nc,h,Q)
    states = torch.einsum("bcsn,bchs,bcshp->bchpn", Bc, decay_to_end,
                          xbar)                          # (b,nc,h,p,n)

    # ---- inter-chunk scan over nc (emits the state BEFORE each chunk)
    chunk_decay = torch.exp(cums[..., -1])               # (b,nc,h)
    prev = torch.zeros((b, h, pdim, n), dtype=x.dtype, device=x.device)
    prev_states = []
    for c in range(nc):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev_states, dim=1)        # (b,nc,h,p,n)

    # ---- inter-chunk contribution
    decay_from_start = torch.exp(cums)                   # (b,nc,h,Q)
    y_inter = torch.einsum("bcln,bchl,bchpn->bclhp", Cc, decay_from_start,
                           prev_states)
    y = (y_intra + y_inter).reshape(b, s, h, pdim)
    return y[:, :s_orig], prev


def ssm_block(cfg: ModelConfig, p, x, *, state=None):
    """Full Mamba-2 mixer.  Train/prefill (state None): returns (out,
    {"ssm" (B,H,P,N) fp32, "conv" (B, min(S, K-1), C_ch) pre-conv
    taps}).  Decode (S == 1, state = {"conv" (B, K-1, C_ch), "ssm"}):
    the new state is written INTO ``state["ssm"]``/``["conv"]`` (in
    place, as attention writes its cache) and returned.

    A prompt shorter than K-1 tokens leaves a conv state shorter than the
    kernel, as in the reference, and decode then raises (the reference
    fails to broadcast there; ROADMAP queue 3)."""
    B_, S, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    K = cfg.ssm_conv
    proj = x @ p["in_proj"]                               # (B,S,2di+2N+H)
    z, xBC, dt = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])                            # (H,)

    if state is None:
        xBC_raw = xBC                      # conv cache stores PRE-conv taps
        xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
        xs, Bmat, Cmat = torch.split(xBC, [di, N, N], dim=-1)
        xh = xs.reshape(B_, S, H, P)
        y, final = ssd_chunked(xh.to(torch.float32), dt, A,
                               Bmat.to(torch.float32),
                               Cmat.to(torch.float32), cfg.ssm_chunk)
        y = y + xh.to(torch.float32) * p["D"][None, None, :, None]
        new_state = {"ssm": final,
                     "conv": xBC_raw[:, -(K - 1):, :].clone()}
    else:
        if state["conv"].shape[1] != K - 1:
            raise ValueError(
                f"{cfg.name}: the conv state holds {state['conv'].shape[1]} "
                f"taps, not ssm_conv - 1 = {K - 1}: decode after a prompt "
                f"shorter than {K - 1} tokens cannot broadcast, as in the "
                f"reference (ROADMAP queue 3)")
        conv_in = torch.cat([state["conv"], xBC], dim=1)
        xBC = F.silu(torch.sum(conv_in * p["conv_w"], dim=1, keepdim=True)
                     + p["conv_b"])
        xs, Bmat, Cmat = torch.split(xBC, [di, N, N], dim=-1)
        xh = xs.reshape(B_, 1, H, P).to(torch.float32)
        dA = torch.exp(dt[:, 0] * A[None, :])             # (B,H)
        xbar = xh[:, 0] * dt[:, 0, :, None]               # (B,H,P)
        st = state["ssm"] * dA[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xbar, Bmat[:, 0].to(torch.float32))
        y = torch.einsum("bn,bhpn->bhp", Cmat[:, 0].to(torch.float32), st)
        y = (y + xh[:, 0] * p["D"][None, :, None])[:, None]
        state["ssm"].copy_(st)
        state["conv"].copy_(conv_in[:, 1:, :])
        new_state = {"ssm": state["ssm"], "conv": state["conv"]}

    y = y.reshape(B_, S, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], new_state
