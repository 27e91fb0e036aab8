"""Mamba2 SSD blocks (``repro.models.ssm``): not ported yet.

The SSD and the hybrid stack are the LM slice after MLA/MoE/MTP in
ROADMAP queue 1, item 8.  Each entry point raises
``NotImplementedError``; nothing runs a dense stand-in.
"""
from __future__ import annotations

_WHY = ("Mamba2 SSD layers are not ported yet: they are a later LM slice "
        "of ROADMAP queue 1 item 8, after MLA, MoE and MTP")


def init_ssm(cfg, gen, dtype):
    raise NotImplementedError(f"{cfg.name}: {_WHY}")


def ssd_chunked(x, dt, A, B, C, chunk: int, shard=None):
    raise NotImplementedError(_WHY)


def ssm_block(cfg, p, x, *, state=None, shard=None):
    raise NotImplementedError(f"{cfg.name}: {_WHY}")
