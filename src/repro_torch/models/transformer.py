"""Decoder stacks — the port of ``repro.models.transformer``, dense half.

Layer layout, the reference's: an optional *prefix* of unrolled layers
followed by *periods*, the repeating structural unit.  Stacked params
keep a leading ``n_periods`` axis (``params["stack"][pos]`` leaves are
``(n_periods, ...)``) and period ``c`` applies ``leaf[c]``.  The layout
matters beyond checkpoints: Adafactor factors any leaf whose last two
dims exceed 1, so a stacked norm scale ``(n_periods, d)`` has its second
moment factored across layers, as in the reference.

Three entry points: ``forward_train`` (full-seq loss), ``prefill``
(last logits + caches), ``decode_step`` (one token against caches);
params are the reference's nested dict of tensors or a
:class:`Transformer` module holding them.  This slice runs dense GQA/MHA
stacks with SwiGLU or gelu MLPs and the ``audio_stub``/``vlm_stub``
frontends; a config with MoE, SSM or MLA layers, or with ``mtp_depth``,
raises ``NotImplementedError`` (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as Ls
from repro_torch.models.config import ModelConfig


def check_dense(cfg: ModelConfig) -> None:
    """Raise for what this slice does not run (no dense stand-in)."""
    gaps = []
    if cfg.attn_type == "mla":
        gaps.append("MLA attention")
    if cfg.is_moe:
        gaps.append("MoE layers")
    if cfg.ssm_state or cfg.attn_type == "none" or cfg.is_hybrid:
        gaps.append("Mamba2 SSD layers")
    if cfg.mtp_depth:
        gaps.append("multi-token prediction")
    if gaps:
        raise NotImplementedError(f"{cfg.name}: {', '.join(gaps)} "
                                  f"{Ls.NEXT_SLICE}")


# ---------------------------------------------------------------------------
# The model: the reference's params tree as registered parameters
# ---------------------------------------------------------------------------
class _Node(torch.nn.Module):
    """One dict or list of the params tree: tensor entries become
    parameters, containers child modules (list entries named by index)."""

    def __init__(self, node):
        super().__init__()
        self._is_list = isinstance(node, (list, tuple))
        self._keys = ([str(i) for i in range(len(node))] if self._is_list
                      else sorted(node))
        items = node if self._is_list else [node[k] for k in self._keys]
        for key, child in zip(self._keys, items):
            if isinstance(child, torch.Tensor):
                self.register_parameter(key, torch.nn.Parameter(
                    child.detach(), requires_grad=child.is_floating_point()))
            else:
                self.add_module(key, _Node(child))

    def tree(self):
        vals = [getattr(self, k) for k in self._keys]
        vals = [v.tree() if isinstance(v, _Node) else v for v in vals]
        return vals if self._is_list else dict(zip(self._keys, vals))


class Transformer(torch.nn.Module):
    """The port's model: ``cfg`` plus the reference's params tree, held as
    parameters in the same layout (``model.params.stack[0].attn.wq`` is
    ``params["stack"][0]["attn"]["wq"]``, ``(n_periods, d, H, dh)``).
    ``forward`` is :func:`forward_train`."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_dense(cfg)
        self.cfg = cfg
        self.params = _Node(params)

    def tree(self) -> dict:
        """The params tree (the module's own parameter tensors)."""
        return self.params.tree()

    def forward(self, batch, **kw):
        return forward_train(self.cfg, self, batch, **kw)


def as_tree(params):
    """The params tree of a :class:`Transformer` or of a tree."""
    return params.tree() if isinstance(params, Transformer) else params


def param_device(params) -> torch.device:
    return as_tree(params)["embed"].device


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, i: int, gen: torch.Generator, dtype):
    dev = gen.device
    p: dict[str, Any] = {"ln1": Ls.init_rmsnorm(cfg.d_model, dtype, dev),
                         "attn": Ls.init_attention(cfg, gen, dtype)}
    if cfg.d_ff > 0:
        p["ln2"] = Ls.init_rmsnorm(cfg.d_model, dtype, dev)
        p["mlp"] = Ls.init_mlp(cfg, gen, dtype)
    return p


def _stack_info(cfg: ModelConfig):
    prefix = cfg.first_dense_layers
    period = cfg.period
    rest = cfg.num_layers - prefix
    assert rest % period == 0, (cfg.name, rest, period)
    return prefix, period, rest // period


def init_params(cfg: ModelConfig, generator=0, dtype=torch.float32,
                device: DeviceLike = None) -> dict:
    """The reference's params tree with the reference's shapes and
    scales, drawn from ``generator`` (a ``torch.Generator``, or a seed
    for one on ``device``); the values differ from jax's PRNG.  The
    tensors end on ``device`` (``cuda`` when None)."""
    check_dense(cfg)
    dev = resolve_device(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(generator))
    prefix, period, n_periods = _stack_info(cfg)
    params: dict[str, Any] = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=gen.device) * 0.02).to(dtype),
        "ln_f": Ls.init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = Ls._dense_init(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, dtype)
    params["prefix"] = [_init_layer(cfg, i, gen, dtype)
                        for i in range(prefix)]
    stack = []
    for pos in range(period):
        per = [_init_layer(cfg, prefix + c * period + pos, gen, dtype)
               for c in range(n_periods)]
        stack.append(T.map_structure(lambda *xs: torch.stack(xs), *per))
    params["stack"] = stack
    return T.map_structure(lambda x: x.to(dev), params)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------
def _apply_layer(cfg: ModelConfig, p, x, positions, cache):
    """cache: None (train / prefill collects) | dict (decode consumes)."""
    h = Ls.rmsnorm(p["ln1"], x, cfg.norm_eps)
    mix, new_cache = Ls.attention(cfg, p["attn"], h, positions,
                                  kv_cache=cache)
    x = x + mix
    if "mlp" in p:
        h2 = Ls.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + Ls.mlp(cfg, p["mlp"], h2)
    return x, new_cache


def _period(tree, c: int):
    """Period ``c``'s slice of a stacked subtree."""
    return T.map_structure(lambda leaf: leaf[c], tree)


def _run_stack(cfg: ModelConfig, params, x, positions, caches,
               collect_cache: bool, remat: bool = False):
    """Prefix layers, then the periods in order.

    Modes: train (caches=None, collect_cache=False; ``remat`` recomputes
    each period in the backward, ``torch.utils.checkpoint``), prefill
    (caches=None, collect_cache=True -> caches emitted, stacked per
    period position), decode (caches given -> updated).  Returns (x, aux,
    caches); aux is 0 (no MoE in this slice)."""
    prefix, period, n_periods = _stack_info(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_prefix = []
    for i, p in enumerate(params["prefix"]):
        c = caches["prefix"][i] if caches else None
        x, nc = _apply_layer(cfg, p, x, positions, c)
        new_prefix.append(nc)

    def period_body(h, c, stacked_c):
        new_cs = []
        for pos in range(period):
            cc = _period(stacked_c[pos], c) if stacked_c is not None else None
            h, nc = _apply_layer(cfg, _period(params["stack"][pos], c), h,
                                 positions, cc)
            new_cs.append(nc)
        return h, new_cs

    per_period = []
    for c in range(n_periods):
        if caches is None and not collect_cache and remat:
            x = checkpoint(lambda h, _c=c: period_body(h, _c, None)[0], x,
                           use_reentrant=False)
            continue
        x, cs = period_body(x, c, caches["stack"] if caches else None)
        per_period.append(cs)

    new_stack = None
    if caches and n_periods:         # decode: k/v were written in place
        new_stack = [dict(caches["stack"][pos], length=torch.stack(
            [cs[pos]["length"] for cs in per_period]))
            for pos in range(period)]
    elif collect_cache and n_periods:
        new_stack = [T.map_structure(lambda *xs: torch.stack(xs),
                                     *[cs[pos] for cs in per_period])
                     for pos in range(period)]
    new_caches = ({"prefix": new_prefix, "stack": new_stack or []}
                  if (collect_cache or caches) else None)
    return x, aux, new_caches


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------
def _embed_inputs(cfg: ModelConfig, params, batch):
    """Returns (x (B,S,d), label_mask (B,S) or None).  ``audio_stub``
    consumes precomputed frame embeddings; ``vlm_stub`` prepends
    precomputed patch embeddings to the embedded text tokens.  The lookup
    is ``F.embedding``, whose backward sums repeated tokens by sorting,
    not by atomics."""
    if cfg.frontend == "audio_stub":
        return batch["embeds"], None
    tokens = batch["tokens"]
    x = F.embedding(tokens.to(torch.int64), params["embed"])
    if cfg.frontend == "vlm_stub":
        patches = batch["patches"]                      # (B, P, d)
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        mask = torch.cat(
            [torch.zeros(patches.shape[:2], dtype=torch.bool,
                         device=x.device),
             torch.ones(tokens.shape, dtype=torch.bool, device=x.device)],
            dim=1)
        return x, mask
    return x, None


def _logits(cfg: ModelConfig, params, x):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["unembed"])


def softmax_xent(logits, labels, mask=None):
    """fp32 cross-entropy, mean over valid positions."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def xent_from_hidden(cfg: ModelConfig, params, h, labels, *,
                     chunk: Optional[int] = None):
    """Cross-entropy from pre-logits hidden states.  ``chunk``: the loss
    over sequence chunks of (B, chunk, V) logits, each recomputed in the
    backward (``torch.utils.checkpoint``) so only one chunk's logits
    are ever live; the sum is divided by the unpadded ``B * S``."""
    if chunk is None or h.shape[1] <= chunk:
        return softmax_xent(_logits(cfg, params, h), labels)
    B, S, d = h.shape
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
    nc = h.shape[1] // chunk
    valid = torch.arange(h.shape[1], device=h.device) < S

    def body(hb, lb, vb):
        logits = _logits(cfg, params, hb).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            lb.to(torch.int64)[..., None])[..., 0]
        return torch.sum(torch.where(vb, logz - gold, 0.0))

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (h[:, sl], labels[:, sl], valid[None, sl])
        part = (checkpoint(body, *args, use_reentrant=False)
                if torch.is_grad_enabled() else body(*args))
        total = total + part
    return total / (B * S)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def forward_train(cfg: ModelConfig, params, batch, *, remat: bool = True,
                  loss_chunk: Optional[int] = None):
    """batch: tokens/embeds (+patches) and labels, tensors on the params'
    device.  Returns (loss, metrics): next-token loss on ``labels`` when
    given, else teacher forcing on ``tokens[1:]``."""
    check_dense(cfg)
    params = as_tree(params)
    x, _vis_mask = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    x, aux, _ = _run_stack(cfg, params, x, positions, None,
                           collect_cache=False, remat=remat)
    x = Ls.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    labels = batch["labels"] if "labels" in batch else batch["tokens"]
    if cfg.frontend == "vlm_stub":
        # text tokens start after the patches; predict next text token
        text_len = labels.shape[1]
        hx = x[:, -text_len:-1]
        loss = xent_from_hidden(cfg, params, hx, labels[:, 1:],
                                chunk=loss_chunk)
    else:
        loss = xent_from_hidden(cfg, params, x[:, :-1], labels[:, 1:],
                                chunk=loss_chunk)
    total = loss + aux
    return total, {"xent": loss, "aux": aux, "loss": total}


@torch.inference_mode()
def prefill(cfg: ModelConfig, params, batch, *, max_len: Optional[int] = None):
    """Full-sequence forward that also returns decode caches (capacity
    ``max_len`` >= S, padded to it).  Runs under ``inference_mode``."""
    check_dense(cfg)
    params = as_tree(params)
    x, _ = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    x, _, caches = _run_stack(cfg, params, x, positions, None,
                              collect_cache=True)
    x = Ls.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = _logits(cfg, params, x[:, -1:])
    caches = _pad_caches(cfg, caches, S, max_len or S)
    return logits, caches


def _pad_caches(cfg: ModelConfig, caches, cur_len: int, max_len: int):
    """Grow KV caches to capacity along the sequence axis (axis 1 for a
    prefix layer's, axis 2 for the stacked ones) and attach lengths: a
    0-d int32 per prefix layer, an (n_periods,) vector in the stack."""
    def pad(x, axis):
        if x.ndim > axis and x.shape[axis] == cur_len:
            widths = [0, 0] * (x.ndim - axis - 1) + [0, max_len - cur_len]
            return F.pad(x, widths)
        return x

    out = {"prefix": [], "stack": []}
    for c in caches["prefix"]:
        c = {k: pad(v, 1) for k, v in c.items()}
        c["length"] = torch.tensor(cur_len, dtype=torch.int32,
                                   device=c["k"].device)
        out["prefix"].append(c)
    n_periods = _stack_info(cfg)[2]
    for c in caches["stack"]:
        cc = {k: pad(v, 2) for k, v in c.items()}
        cc["length"] = torch.full((n_periods,), cur_len, dtype=torch.int32,
                                  device=cc["k"].device)
        out["stack"].append(cc)
    return out


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params, tokens, caches, *, embeds=None):
    """One decode step.  tokens: (B, 1) int (or embeds (B,1,d) for
    audio_stub).  Returns (logits (B,1,V), new_caches).  Runs under
    ``inference_mode`` and writes the step's keys and values INTO the
    given caches' ``k``/``v`` tensors (the returned caches hold the same
    tensors and new lengths), so a cache passed in is consumed."""
    check_dense(cfg)
    params = as_tree(params)
    if cfg.frontend == "audio_stub":
        x = embeds
    else:
        x = F.embedding(tokens.to(torch.int64), params["embed"])
    length = _cache_length(caches, x.device)
    positions = length + torch.zeros(x.shape[:2], dtype=torch.int32,
                                     device=x.device)
    x, _, new_caches = _run_stack(cfg, params, x, positions, caches,
                                  collect_cache=False)
    x = Ls.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return _logits(cfg, params, x), new_caches


def _cache_length(caches, device):
    for c in caches["prefix"]:
        if c is not None and "length" in c:
            return c["length"]
    for c in caches["stack"]:
        if c is not None and "length" in c:
            return c["length"][0]
    return torch.zeros((), dtype=torch.int32, device=device)


def init_decode_caches(cfg: ModelConfig, batch_size: int, max_len: int,
                       dtype=torch.float32, device: DeviceLike = None):
    """Fresh empty caches of capacity ``max_len`` (length 0)."""
    check_dense(cfg)
    dev = resolve_device(device)
    prefix, period, n_periods = _stack_info(cfg)
    shape = (batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)

    def attn_cache(lead=()):
        return {"k": torch.zeros(lead + shape, dtype=dtype, device=dev),
                "v": torch.zeros(lead + shape, dtype=dtype, device=dev)}

    caches = {"prefix": [], "stack": []}
    for _ in range(prefix):
        c = attn_cache()
        c["length"] = torch.zeros((), dtype=torch.int32, device=dev)
        caches["prefix"].append(c)
    for _ in range(period):
        c = attn_cache((n_periods,))
        c["length"] = torch.zeros((n_periods,), dtype=torch.int32,
                                  device=dev)
        caches["stack"].append(c)
    return caches
