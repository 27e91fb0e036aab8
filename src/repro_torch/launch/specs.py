"""Shape stand-ins for every (arch x shape) cell (the port of
``repro.launch.specs``): ``torch.device("meta")`` tensors, so nothing is
ever allocated.  They feed the sharding rules
(``distributed.sharding``) at published widths.

Shape semantics:
  train_4k    : train_step,  tokens (256, 4096)
  prefill_32k : prefill,     tokens (32, 32768)
  decode_32k  : serve_step,  1 new token, batch 128, KV cache of 32768
  long_500k   : serve_step,  1 new token, batch 1,   cache of 524288
                (sub-quadratic archs only: mamba2, jamba)
VLM cells: seq_len counts patches + text (text = seq_len - num_patches).
Audio cells: precomputed frame embeddings replace tokens (frontend stub).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

META = torch.device("meta")

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# archs that run the long_500k cell (sub-quadratic sequence mixing)
LONG_OK_FAMILIES = ("ssm", "hybrid")


def cell_runnable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return False, ("skipped: pure full-attention arch at 512k context "
                       "(quadratic prefill / unbounded KV) per assignment")
    return True, ""


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: a shape and a dtype, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape_name: str,
                act_dtype=torch.bfloat16) -> dict:
    """Meta tensors for the model inputs of this cell."""
    info = SHAPES[shape_name]
    B, S = info["global_batch"], info["seq_len"]
    kind = info["kind"]
    if kind in ("train", "prefill"):
        if cfg.frontend == "audio_stub":
            return {"embeds": sds((B, S, cfg.d_model), act_dtype),
                    "labels": sds((B, S), torch.int32)}
        batch = {}
        if cfg.frontend == "vlm_stub":
            text = S - cfg.num_patches
            batch["tokens"] = sds((B, text), torch.int32)
            batch["patches"] = sds((B, cfg.num_patches, cfg.d_model),
                                   act_dtype)
        else:
            batch["tokens"] = sds((B, S), torch.int32)
        return batch
    # decode: one token
    if cfg.frontend == "audio_stub":
        return {"embeds": sds((B, 1, cfg.d_model), act_dtype)}
    return {"tokens": sds((B, 1), torch.int32)}


def decode_cache_shapes(cfg: ModelConfig, shape_name: str,
                        dtype=torch.bfloat16):
    """The decode caches of this cell as meta tensors."""
    from repro_torch.models import init_decode_caches
    info = SHAPES[shape_name]
    return init_decode_caches(cfg, info["global_batch"], info["seq_len"],
                              dtype=dtype, device=META)


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so ``init_params``
    draws every leaf on ``meta``: shapes, no values."""

    @property
    def device(self):
        return META


def param_shapes(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    """``models.init_params``'s tree as meta tensors (the reference takes
    it from ``jax.eval_shape``)."""
    from repro_torch.models import init_params
    return init_params(cfg, _MetaGenerator(), dtype, device=META)
