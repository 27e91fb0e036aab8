"""Weights carried across between ``repro`` and the port (port only).

The port keeps the reference's params tree, so the conversion is one
to one, leaf for leaf, in both directions: the reference's tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) becomes the port's
:class:`~repro_torch.models.transformer.Transformer`, and back.  The same
pair converts optimizer state (AdamW's ``{"m", "v"}`` of params trees,
Adafactor's per-leaf ``{"vr", "vc", "m"}`` / ``{"v", "m"}`` dicts), which
has no module and stays a tree of tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, as_tree


def _is_params(tree) -> bool:
    """A params tree (Adafactor's state has the same keys, with a dict of
    moments where params have an array)."""
    return (isinstance(tree, dict) and "stack" in tree
            and not isinstance(tree.get("embed"), (dict, type(None))))


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor, bit for bit; bfloat16 (``ml_dtypes``'s,
    which jax hands out) through its 16-bit pattern."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(cfg: ModelConfig, tree,
                          device: DeviceLike = None):
    """A reference tree of arrays -> the port's: a params tree becomes a
    :class:`Transformer` of ``cfg``, an optimizer state a tree of tensors.
    Values and dtypes (bfloat16 too) are kept bit for bit; tensors land
    on ``device`` (``cuda`` when None)."""
    dev = resolve_device(device)
    tensors = T.map_structure(lambda a: _tensor(a).to(dev), tree)
    return Transformer(cfg, tensors) if _is_params(tree) else tensors


def params_to_reference(cfg: ModelConfig, model) -> dict:
    """The port's model (or params / optimizer-state tree) -> the
    reference's tree of numpy arrays, leaf for leaf."""
    if isinstance(model, Transformer) and model.cfg != cfg:
        raise ValueError(f"model of {model.cfg.name}, not {cfg.name}")
    return T.map_structure(lambda t: t.detach().cpu().numpy(),
                           as_tree(model))
