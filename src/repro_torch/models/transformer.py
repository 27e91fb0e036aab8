"""Decoder stacks for every configured architecture — the port of
``repro.models.transformer``.

Layer layout, the reference's: an optional *prefix* of unrolled layers
(DeepSeek's first dense layers) followed by *periods*, the repeating
structural unit (1 for homogeneous stacks, 8 for Jamba's [7 mamba + 1
attn] interleave with alternating MoE).  Stacked params
keep a leading ``n_periods`` axis (``params["stack"][pos]`` leaves are
``(n_periods, ...)``) and period ``c`` applies ``leaf[c]``.  The layout
matters beyond checkpoints: Adafactor factors any leaf whose last two
dims exceed 1, so a stacked norm scale ``(n_periods, d)`` has its second
moment factored across layers, as in the reference.

Three entry points: ``forward_train`` (full-seq loss), ``prefill``
(last logits + caches), ``decode_step`` (one token against caches);
params are the reference's nested dict of tensors or a
:class:`Transformer` module holding them.  A layer's mixer is GQA/MHA
attention, MLA or a Mamba2 SSD block, its FFN an MLP or a MoE (whose
aux loss sums through the stack); DeepSeek-V3's multi-token prediction
adds the ``mtp`` subtree and metric.  Caches are ``{"k", "v"}`` (GQA),
``{"ckv", "krope"}`` (MLA, with ``length``) or ``{"ssm", "conv"}``
(SSD, no length); decode writes all of them in place.
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
from repro_torch.models import moe as Moe
from repro_torch.models import ssm as Ssm
from repro_torch.models.config import ModelConfig


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
    """Layer ``i``: its mixer (``attn``: GQA or MLA; or ``ssm``), then its
    FFN (``moe`` or ``mlp``, or none), drawn in that order."""
    dev = gen.device
    p: dict[str, Any] = {"ln1": Ls.init_rmsnorm(cfg.d_model, dtype, dev)}
    if cfg.layer_kind(i) == "attn":
        init = Ls.init_mla if cfg.attn_type == "mla" else Ls.init_attention
        p["attn"] = init(cfg, gen, dtype)
    else:
        p["ssm"] = Ssm.init_ssm(cfg, gen, dtype)
    if cfg.layer_is_moe(i):
        p["ln2"] = Ls.init_rmsnorm(cfg.d_model, dtype, dev)
        p["moe"] = Moe.init_moe(cfg, gen, dtype)
    elif cfg.d_ff > 0:
        p["ln2"] = Ls.init_rmsnorm(cfg.d_model, dtype, dev)
        p["mlp"] = Ls.init_mlp(cfg, gen, dtype)
    return p


def _stacked(*xs):
    """The periods' leaves stacked on a new leading axis (one period: a
    view, so a full-width leaf is not copied)."""
    return torch.stack(xs) if len(xs) > 1 else xs[0][None]


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
    tensors end on ``device`` (``cuda`` when None).  A leaf of more than
    ``layers.INIT_SLAB_VALUES`` values is drawn in slabs."""
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
        stack.append(T.map_structure(_stacked, *per))
    params["stack"] = stack
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": Ls._dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                   2 * cfg.d_model, dtype),
            "ln": Ls.init_rmsnorm(cfg.d_model, dtype, gen.device),
            "layer": _init_layer(cfg, cfg.num_layers - 1, gen, dtype),
        }
    return T.map_structure(lambda x: x.to(dev), params)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------
def _apply_layer(cfg: ModelConfig, p, x, positions, cache):
    """cache: None (train / prefill collects) | dict (decode consumes).
    Returns (x, new_cache, aux): aux is the MoE aux loss, None for a
    layer without MoE."""
    h = Ls.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if "ssm" in p:
        mix, new_cache = Ssm.ssm_block(cfg, p["ssm"], h, state=cache)
    elif cfg.attn_type == "mla":
        mix, new_cache = Ls.mla_attention(cfg, p["attn"], h, positions,
                                          kv_cache=cache)
    else:
        mix, new_cache = Ls.attention(cfg, p["attn"], h, positions,
                                      kv_cache=cache)
    x = x + mix
    aux = None
    if "moe" in p:
        h2 = Ls.rmsnorm(p["ln2"], x, cfg.norm_eps)
        f, aux = Moe.moe_ffn(cfg, p["moe"], h2)
        x = x + f
    elif "mlp" in p:
        h2 = Ls.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + Ls.mlp(cfg, p["mlp"], h2)
    return x, new_cache, aux


def _add_aux(total, aux):
    return total if aux is None else total + aux


def _period(tree, c: int):
    """Period ``c``'s slice of a stacked subtree."""
    return T.map_structure(lambda leaf: leaf[c], tree)


def _run_stack(cfg: ModelConfig, params, x, positions, caches,
               collect_cache: bool, remat: bool = False):
    """Prefix layers, then the periods in order.

    Modes: train (caches=None, collect_cache=False; ``remat`` recomputes
    each period in the backward, ``torch.utils.checkpoint``, and inside a
    period of more than one layer each layer too, as the reference nests
    them: a period-8 backward then holds one SSD layer's intermediates,
    not seven), prefill (caches=None, collect_cache=True -> caches
    emitted, stacked per period position), decode (caches given ->
    updated in place).  Returns (x, aux, caches); aux sums the MoE
    layers' aux losses in layer order."""
    prefix, period, n_periods = _stack_info(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_prefix = []
    for i, p in enumerate(params["prefix"]):
        c = caches["prefix"][i] if caches else None
        x, nc, a = _apply_layer(cfg, p, x, positions, c)
        aux = _add_aux(aux, a)
        new_prefix.append(nc)

    def one_layer(p_, h):
        h, _, a = _apply_layer(cfg, p_, h, positions, None)
        return h, a

    def period_body(h, auxc, c, stacked_c, layer_remat=False):
        new_cs = []
        for pos in range(period):
            cc = _period(stacked_c[pos], c) if stacked_c is not None else None
            p_ = _period(params["stack"][pos], c)
            if layer_remat:
                h, a = checkpoint(one_layer, p_, h, use_reentrant=False)
                nc = None
            else:
                h, nc, a = _apply_layer(cfg, p_, h, positions, cc)
            auxc = _add_aux(auxc, a)
            new_cs.append(nc)
        return h, auxc, new_cs

    train = caches is None and not collect_cache
    per_period = []
    for c in range(n_periods):
        if train and remat:
            x, aux = checkpoint(
                lambda h, a, _c=c: period_body(h, a, _c, None,
                                               period > 1)[:2],
                x, aux, use_reentrant=False)
            continue
        x, aux, cs = period_body(x, aux, c,
                                 caches["stack"] if caches else None)
        per_period.append(cs)

    new_stack = None
    if caches and n_periods:         # decode: caches were written in place
        new_stack = [dict(sc, length=torch.stack(
            [cs[pos]["length"] for cs in per_period]))
            if "length" in sc else sc
            for pos, sc in enumerate(caches["stack"])]
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
    given, else teacher forcing on ``tokens[1:]``; metrics ``xent``,
    ``aux`` (the MoE aux loss), ``mtp`` (with ``mtp_depth``) and
    ``loss`` = xent + aux + mtp_loss_weight * mtp."""
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
    metrics = {"xent": loss, "aux": aux}
    total = loss + aux
    if cfg.mtp_depth:
        mtp_loss = _mtp_loss(cfg, params, x, batch, positions)
        metrics["mtp"] = mtp_loss
        total = total + cfg.mtp_loss_weight * mtp_loss
    metrics["loss"] = total
    return total, metrics


def _mtp_loss(cfg: ModelConfig, params, h_final, batch, positions):
    """DeepSeek-V3 multi-token prediction (depth 1): combine the trunk's
    final hidden state at t with the embedding of token t+1 to predict
    t+2.  0 for a config with a frontend."""
    tokens = batch.get("labels", batch.get("tokens"))
    if tokens is None or cfg.frontend != "none":
        return torch.zeros((), dtype=torch.float32, device=h_final.device)
    p = params["mtp"]
    emb_next = F.embedding(tokens[:, 1:].to(torch.int64), params["embed"])
    h = h_final[:, :-1]
    comb = torch.cat([Ls.rmsnorm(p["ln"], h, cfg.norm_eps), emb_next],
                     dim=-1)
    x = comb @ p["proj"]
    x, _, _ = _apply_layer(cfg, p["layer"], x, positions[:, :-1], None)
    logits = _logits(cfg, params, x[:, :-1])
    return softmax_xent(logits, tokens[:, 2:])


@torch.inference_mode()
def prefill(cfg: ModelConfig, params, batch, *, max_len: Optional[int] = None):
    """Full-sequence forward that also returns decode caches (capacity
    ``max_len`` >= S, padded to it).  Runs under ``inference_mode``."""
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


def _is_attn_cache(c) -> bool:
    return "k" in c or "ckv" in c


def _pad_caches(cfg: ModelConfig, caches, cur_len: int, max_len: int):
    """Grow the attention caches (GQA ``k``/``v``, MLA ``ckv``/``krope``)
    to capacity along the sequence axis (axis 1 for a prefix layer's,
    axis 2 for the stacked ones) and attach lengths: a 0-d int32 per
    prefix layer, an (n_periods,) vector in the stack.  SSM caches stay
    as they are, without a length."""
    def pad(x, axis):
        if x.ndim > axis and x.shape[axis] == cur_len:
            widths = [0, 0] * (x.ndim - axis - 1) + [0, max_len - cur_len]
            return F.pad(x, widths)
        return x

    def grown(c, axis, length_shape):
        if not _is_attn_cache(c):
            return c
        c = {k: pad(v, axis) for k, v in c.items()}
        c["length"] = torch.full(length_shape, cur_len, dtype=torch.int32,
                                 device=next(iter(c.values())).device)
        return c

    n_periods = _stack_info(cfg)[2]
    return {"prefix": [grown(c, 1, ()) for c in caches["prefix"]],
            "stack": [grown(c, 2, (n_periods,)) for c in caches["stack"]]}


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params, tokens, caches, *, embeds=None):
    """One decode step.  tokens: (B, 1) int (or embeds (B,1,d) for
    audio_stub).  Returns (logits (B,1,V), new_caches).  Runs under
    ``inference_mode`` and writes the step INTO the given caches (keys
    and values, MLA latents, SSM states; the returned caches hold the
    same tensors and new lengths), so a cache passed in is consumed."""
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
    """Fresh empty caches of capacity ``max_len`` (length 0): GQA
    ``k``/``v``, MLA ``ckv``/``krope`` or SSM ``ssm`` (fp32) / ``conv``
    per layer."""
    dev = resolve_device(device)
    prefix, period, n_periods = _stack_info(cfg)

    def cache(kind, lead=()):
        def z(*shape, dt=dtype):
            return torch.zeros(lead + shape, dtype=dt, device=dev)
        if kind != "attn":
            return {"ssm": z(batch_size, cfg.ssm_heads, cfg.ssm_headdim,
                             cfg.ssm_state, dt=torch.float32),
                    "conv": z(batch_size, cfg.ssm_conv - 1,
                              cfg.d_inner + 2 * cfg.ssm_state)}
        if cfg.attn_type == "mla":
            c = {"ckv": z(batch_size, max_len, cfg.kv_lora_rank),
                 "krope": z(batch_size, max_len, cfg.rope_head_dim)}
        else:
            shape = (batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
            c = {"k": z(*shape), "v": z(*shape)}
        c["length"] = torch.zeros(lead, dtype=torch.int32, device=dev)
        return c

    return {"prefix": [cache(cfg.layer_kind(i)) for i in range(prefix)],
            "stack": [cache(cfg.layer_kind(prefix + pos), (n_periods,))
                      for pos in range(period)]}
