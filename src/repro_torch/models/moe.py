"""Mixture-of-experts FFN (``repro.models.moe``): not ported yet.

MoE, MLA and MTP are the next LM slice of ROADMAP queue 1, item 8.  Each
entry point raises ``NotImplementedError``; nothing runs a dense
stand-in.
"""
from __future__ import annotations

from repro_torch.models.layers import NEXT_SLICE


def init_moe(cfg, gen, dtype):
    raise NotImplementedError(f"{cfg.name}: MoE layers {NEXT_SLICE}")


def moe_ffn(cfg, p, x, shard=None):
    raise NotImplementedError(f"{cfg.name}: MoE layers {NEXT_SLICE}")
