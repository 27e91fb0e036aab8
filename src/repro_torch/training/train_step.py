"""Training step — the port of ``repro.training.train_step``: loss and
grads, microbatch accumulation, optimizer apply.

Eager PyTorch: gradients come from ``torch.autograd.grad`` over the
params tree's leaves; with ``microbatches > 1`` the batch is split along
its leading dim and grads and loss accumulate in fp32, then divide, as
the reference's ``lax.scan`` does.  The step is functional: it returns
a new :class:`TrainState` and leaves the old one as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.device import DeviceLike
from repro_torch.models import forward_train
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import as_tree, batch_to, param_device
from repro_torch.training import optimizer as opt


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor          # 0-d int32


def train_state_init(model_cfg: ModelConfig, opt_cfg: opt.OptConfig,
                     generator=0, dtype=torch.float32,
                     device: DeviceLike = None) -> TrainState:
    """Fresh params (``models.init_params``: a ``torch.Generator`` or a
    seed) and optimizer state on ``device`` (``cuda`` when None)."""
    from repro_torch.models import init_params
    params = init_params(model_cfg, generator, dtype, device)
    return TrainState(params=params, opt_state=opt.init(opt_cfg, params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=param_device(params)))


def make_train_step(model_cfg: ModelConfig, opt_cfg: opt.OptConfig,
                    *, microbatches: int = 1, remat: bool = True,
                    loss_chunk: Optional[int] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).  ``batch``
    (numpy or tensors) has a leading dim divisible by ``microbatches``;
    metrics are 0-d tensors."""

    def grad_fn(params, mb):
        flat = T.leaves(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss, metrics = forward_train(
                model_cfg, T.unflatten_like(params, leaves), mb,
                remat=remat, loss_chunk=loss_chunk)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                T.unflatten_like(params, grads))

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = as_tree(state.params)
        batch = batch_to(batch, param_device(params))
        if microbatches == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            mbs = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                                 + v.shape[1:])[i] for k, v in batch.items()}
                   for i in range(microbatches)]
            grads = T.map_structure(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=param_device(params))
            for mb in mbs:
                loss, _m, g = grad_fn(params, mb)
                grads = T.map_structure(
                    lambda a, b: a + b.to(torch.float32), grads, g)
                loss_sum = loss_sum + loss
            grads = T.map_structure(lambda g: g / microbatches, grads)
            metrics = {"loss": loss_sum / microbatches}
        new_params, new_opt, om = opt.apply(
            opt_cfg, grads, state.opt_state, params, state.step)
        metrics = dict(metrics)
        metrics.update(om)
        return (TrainState(params=new_params, opt_state=new_opt,
                           step=state.step + 1), metrics)

    return train_step
