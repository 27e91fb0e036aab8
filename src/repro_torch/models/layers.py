"""Shared transformer layers — the port of ``repro.models.layers``:
RMSNorm, RoPE, GQA/MHA attention, MLA, MLPs.

Functional style, as in the reference: params are nested dicts of
tensors (the leaves of :class:`repro_torch.models.transformer.
Transformer`), ``init_*`` builds them from a ``torch.Generator``, the
apply functions consume them.  Softmax and norms accumulate in fp32;
masked logits are ``-1e30``, not ``-inf``.  Attention is plain torch
(``einsum`` and a masked fp32 softmax), as the reference computes it
outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

# A leaf is drawn in slabs along its first axis, so its fp32 draw never
# holds more than this many values at once (a full-width deepseek-v3
# expert leaf is 3.76e9 values: 15 GB in fp32).  A leaf of at most this
# many values is one slab, the same draw as one ``randn`` of its shape.
INIT_SLAB_VALUES = 2**30


def _dense_init(gen: torch.Generator, shape, in_axis_size, dtype):
    scale = 1.0 / np.sqrt(max(in_axis_size, 1))
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, INIT_SLAB_VALUES // int(np.prod(shape[1:])))
    for r in range(0, shape[0], rows):
        n = min(rows, shape[0] - r)
        out[r:r + n] = (torch.randn((n,) + shape[1:], generator=gen,
                                    device=gen.device) * scale).to(dtype)
    return out


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_rmsnorm(d, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps):
    h = x.to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * params["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved pairs)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2 / head_dim))


def apply_rope(x, positions, theta):
    """x: (..., S, H, dh) with dh even; positions: broadcastable to (..., S).
    The frequencies are the reference's numpy float32 bits."""
    dh = x.shape[-1]
    freqs = torch.from_numpy(np.asarray(rope_freqs(dh, theta),
                                        np.float32)).to(x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MHA)
# ---------------------------------------------------------------------------
def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype):
    d, H, KV, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": _dense_init(gen, (d, H, dh), d, dtype),
        "wk": _dense_init(gen, (d, KV, dh), d, dtype),
        "wv": _dense_init(gen, (d, KV, dh), d, dtype),
        "wo": _dense_init(gen, (H, dh, d), H * dh, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, dh), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KV, dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KV, dh), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, dtype, dev)
        p["k_norm"] = init_rmsnorm(dh, dtype, dev)
    return p


# KV-chunked online-softmax attention kicks in above this sequence length:
# never materialize (Sq, Sk) score tensors for long prefill.
ATTN_CHUNK_THRESHOLD = 8192
ATTN_KV_CHUNK = 2048


class attn_chunking:
    """Context manager overriding the chunking policy (perf experiments):
    ``with attn_chunking(threshold=4096, chunk=1024): ...``"""

    def __init__(self, threshold: int, chunk: int):
        self.t, self.c = threshold, chunk

    def __enter__(self):
        global ATTN_CHUNK_THRESHOLD, ATTN_KV_CHUNK
        self._saved = (ATTN_CHUNK_THRESHOLD, ATTN_KV_CHUNK)
        ATTN_CHUNK_THRESHOLD, ATTN_KV_CHUNK = self.t, self.c
        return self

    def __exit__(self, *exc):
        global ATTN_CHUNK_THRESHOLD, ATTN_KV_CHUNK
        ATTN_CHUNK_THRESHOLD, ATTN_KV_CHUNK = self._saved
        return False


def _sdpa(q, k, v, *, causal: bool, q_offset=0, kv_len_mask=None):
    """q/k: (B, Sq|Sk, H|KV, dh), v: (B, Sk, KV, dv) with H % KV == 0;
    dv may differ from dh (MLA: q/k of 192, v of 128), and the scale is
    1/sqrt(dh).  fp32 softmax; returns (B, Sq, H, dv).  For Sq * Sk at or above the
    chunking threshold squared (and Sk a multiple of the chunk) the KV
    axis runs in online-softmax chunks, so peak memory is O(Sq x chunk);
    decode (Sq == 1) always takes the dense path, as in the reference."""
    Sk = k.shape[1]
    Sq = q.shape[1]
    if (Sq > 1 and Sq * Sk >= ATTN_CHUNK_THRESHOLD ** 2
            and Sk % ATTN_KV_CHUNK == 0):
        return _sdpa_chunked(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len_mask=kv_len_mask,
                             chunk=ATTN_KV_CHUNK)
    return _sdpa_dense(q, k, v, causal=causal, q_offset=q_offset,
                       kv_len_mask=kv_len_mask)


def _sdpa_dense(q, k, v, *, causal: bool, q_offset=0, kv_len_mask=None):
    """Scores scaled after the einsum (the reference's order)."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    dv = v.shape[3]
    rep = H // KV
    qg = q.reshape(B, Sq, KV, rep, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(torch.float32),
                          k.to(torch.float32)) / np.sqrt(dh)
    Sk = k.shape[1]
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = kpos <= qpos                                   # (Sq, Sk)
        logits = torch.where(mask[None, None, None], logits, -1e30)
    if kv_len_mask is not None:                               # (B, Sk) valid
        logits = torch.where(kv_len_mask[:, None, None, None, :],
                             logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v.to(torch.float32))
    return out.reshape(B, Sq, H, dv).to(q.dtype)


def _sdpa_chunked(q, k, v, *, causal: bool, q_offset=0, kv_len_mask=None,
                  chunk: int = ATTN_KV_CHUNK):
    """Online softmax over KV chunks (the flash-attention recurrence as a
    loop of torch ops, the reference's ``lax.scan``); q is scaled before
    the einsum (the reference's order on this path)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dv = v.shape[3]
    rep = H // KV
    nc = Sk // chunk
    dev = q.device
    qg = q.reshape(B, Sq, KV, rep, dh).to(torch.float32) / np.sqrt(dh)
    qpos = q_offset + torch.arange(Sq, dtype=torch.int32, device=dev)
    m = torch.full((B, KV, rep, Sq), -torch.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, KV, rep, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, rep, Sq, dv), dtype=torch.float32, device=dev)
    for c in range(nc):
        k0 = c * chunk
        kb = k[:, k0:k0 + chunk]
        vb = v[:, k0:k0 + chunk]
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb.to(torch.float32))
        kpos = k0 + torch.arange(chunk, dtype=torch.int32, device=dev)
        if kv_len_mask is not None:
            valid = kv_len_mask[:, k0:k0 + chunk][:, None, None, None, :]
        else:
            valid = torch.ones((B, 1, 1, 1, chunk), dtype=torch.bool,
                               device=dev)
        if causal:
            valid = valid & (kpos[None, None, None, None, :]
                             <= qpos[None, None, None, :, None])
        logits = torch.where(valid, logits, -1e30)
        m_blk = torch.amax(logits, dim=-1)
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p, vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.movedim(out, 3, 1).reshape(B, Sq, H, dv)
    return out.to(q.dtype)


def attention(cfg: ModelConfig, p, x, positions, *, kv_cache=None,
              kv_len_mask=None):
    """Causal self-attention.  Training/prefill: kv_cache None -> full seq,
    returns (out, {"k", "v"}).  Decode: kv_cache = dict(k (B,S,KV,dh), v,
    length 0-d int32) -> one step; the new keys and values are written
    INTO ``kv_cache["k"]``/``["v"]`` at ``length`` (in place, no host
    sync), and the returned cache holds those tensors and ``length +
    S``."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        out = _sdpa(q, k, v, causal=True)
        new_cache = {"k": k, "v": v}
    else:
        length = kv_cache["length"]                 # tokens already cached
        ck, cv = kv_cache["k"], kv_cache["v"]
        Sq = q.shape[1]
        at = (length.to(torch.int64)
              + torch.arange(Sq, dtype=torch.int64, device=x.device))
        ck.index_copy_(1, at, k.to(ck.dtype))
        cv.index_copy_(1, at, v.to(cv.dtype))
        S = ck.shape[1]
        valid = torch.arange(S, device=x.device)[None, :] < (length + Sq)
        out = _sdpa(q, ck, cv, causal=True, q_offset=length,
                    kv_len_mask=valid.expand(x.shape[0], S))
        new_cache = {"k": ck, "v": cv, "length": length + Sq}
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 family): low-rank Q/KV with decoupled RoPE, compressed
# KV cache, absorbed decode path.
# ---------------------------------------------------------------------------
def init_mla(cfg: ModelConfig, gen: torch.Generator, dtype):
    d, H = cfg.d_model, cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    p = {}
    if r_q:
        p["wq_a"] = _dense_init(gen, (d, r_q), d, dtype)
        p["q_a_norm"] = init_rmsnorm(r_q, dtype, gen.device)
        p["wq_b"] = _dense_init(gen, (r_q, H, dn + dr), r_q, dtype)
    else:
        p["wq"] = _dense_init(gen, (d, H, dn + dr), d, dtype)
    p["wkv_a"] = _dense_init(gen, (d, r_kv + dr), d, dtype)
    p["kv_a_norm"] = init_rmsnorm(r_kv, dtype, gen.device)
    p["wk_b"] = _dense_init(gen, (r_kv, H, dn), r_kv, dtype)
    p["wv_b"] = _dense_init(gen, (r_kv, H, dv), r_kv, dtype)
    p["wo"] = _dense_init(gen, (H, dv, d), H * dv, dtype)
    return p


def _mla_q(cfg, p, x):
    if cfg.q_lora_rank:
        cq = torch.einsum("bsd,dr->bsr", x, p["wq_a"])
        cq = rmsnorm(p["q_a_norm"], cq, cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    return torch.split(q, [cfg.head_dim, cfg.rope_head_dim], dim=-1)


def mla_attention(cfg: ModelConfig, p, x, positions, *, kv_cache=None):
    """Prefill/train (kv_cache None): materialized K/V in ``x.dtype``
    (q/k of head_dim + rope_head_dim, v of v_head_dim) through
    :func:`_sdpa`; the cache keeps only the compressed ``{"ckv" (B, S,
    r_kv), "krope" (B, S, dr)}``.  Decode (kv_cache with ``length``):
    absorbed attention over the latent cache with fp32 logits and a
    ``-1e30`` mask; the step's ``ckv``/``krope`` are written INTO the
    given cache at ``length`` (in place, as :func:`attention` does)."""
    B, S, _ = x.shape
    dn, dr = cfg.head_dim, cfg.rope_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    ckv, k_rope = torch.split(kv, [cfg.kv_lora_rank, dr], dim=-1)
    ckv = rmsnorm(p["kv_a_norm"], ckv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]

    if kv_cache is None:
        # materialized: k = [W_uk ckv ; k_rope], v = W_uv ckv
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wk_b"])
        v = torch.einsum("bsr,rhv->bshv", ckv, p["wv_b"])
        H = cfg.num_heads
        k_rope_h = k_rope[:, :, None, :].expand(B, S, H, dr)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope_h], dim=-1)
        out = _sdpa(q, k, v, causal=True)
        new_cache = {"ckv": ckv, "krope": k_rope}
    else:
        length = kv_cache["length"]
        cc, cr = kv_cache["ckv"], kv_cache["krope"]
        at = (length.to(torch.int64)
              + torch.arange(S, dtype=torch.int64, device=x.device))
        cc.index_copy_(1, at, ckv.to(cc.dtype))
        cr.index_copy_(1, at, k_rope.to(cr.dtype))
        # absorbed: q_lat = q_nope @ W_uk  (B,S,H,r)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
        Sc = cc.shape[1]
        ccf = cc.to(torch.float32)
        logits = (torch.einsum("bshr,btr->bhst", q_lat.to(torch.float32),
                               ccf)
                  + torch.einsum("bshk,btk->bhst",
                                 q_rope.to(torch.float32),
                                 cr.to(torch.float32)))
        logits = logits / np.sqrt(dn + dr)
        qpos = length + torch.arange(S, device=x.device)[:, None]
        valid = torch.arange(Sc, device=x.device)[None, :] <= qpos
        logits = torch.where(valid[None, None], logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        lat_out = torch.einsum("bhst,btr->bshr", w, ccf)
        out = torch.einsum("bshr,rhv->bshv", lat_out.to(x.dtype),
                           p["wv_b"])
        new_cache = {"ckv": cc, "krope": cr, "length": length + S}
    out = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype, d_ff=None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"wi": _dense_init(gen, (d, f), d, dtype),
                "wg": _dense_init(gen, (d, f), d, dtype),
                "wo": _dense_init(gen, (f, d), f, dtype)}
    return {"wi": _dense_init(gen, (d, f), d, dtype),
            "wo": _dense_init(gen, (f, d), f, dtype)}


def mlp(cfg: ModelConfig, p, x):
    """SwiGLU, or gelu with the tanh approximation (``jax.nn.gelu``'s
    default)."""
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
