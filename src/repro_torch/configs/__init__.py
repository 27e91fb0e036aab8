"""Architecture registry, copied from ``repro.configs``: one module per
assigned arch (+ the paper's own DNA suffix-array engine config), each
built on the port's ``ModelConfig``.  ``get_config(name)`` / ``list_archs()``."""
from __future__ import annotations

import importlib

ARCHS = [
    "deepseek_v3_671b",
    "kimi_k2_1t_a32b",
    "yi_6b",
    "qwen15_110b",
    "qwen3_0_6b",
    "phi3_mini_3_8b",
    "jamba_v01_52b",
    "mamba2_780m",
    "musicgen_medium",
    "internvl2_26b",
]

_ALIAS = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "yi-6b": "yi_6b",
    "qwen1.5-110b": "qwen15_110b",
    "qwen3-0.6b": "qwen3_0_6b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "mamba2-780m": "mamba2_780m",
    "musicgen-medium": "musicgen_medium",
    "internvl2-26b": "internvl2_26b",
    "dna-suffix": "dna_suffix",
}


def get_config(name: str):
    mod_name = _ALIAS.get(name, name.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def list_archs():
    return list(_ALIAS.keys())[:-1]
