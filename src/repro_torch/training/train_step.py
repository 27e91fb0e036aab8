"""Training step — the port of ``repro.training.train_step``: loss and
grads, microbatch accumulation, optimizer apply.

Eager PyTorch: gradients come from ``torch.autograd.grad`` over the
params tree's leaves; with ``microbatches > 1`` the batch is split along
its leading dim and grads and loss accumulate in fp32, then divide, as
the reference's ``lax.scan`` does.  The step is functional: it returns
a new :class:`TrainState` and leaves the old one as it was.

A sharded state (``distributed.sharding.place_tree`` by the param,
ZeRO-1 optimizer and replicated step specs) takes the same step and
stays in pieces: each param leaf is joined from its distinct blocks
(counted as a ``gather``: an all-gather over the spec's axes), the
one-device forward and backward run on the global batch, each gradient
is cut into its param's blocks (counted as a ``scatter``: GSPMD's
reduce-scatter), the gathered params and full gradients are freed, and
the optimizer updates each distinct block once.  This is the
reference's GSPMD contract: the sharded step computes what the
one-device step computes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.device import DeviceLike
from repro_torch.distributed import collectives as COL
from repro_torch.distributed.sharding import Sharded, join_tree
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


def _gather(x):
    """A param leaf whole: a ``Sharded`` joined from its blocks."""
    if not isinstance(x, Sharded):
        return x
    if x.layout.splits > 1:
        COL.record("gather", x.blocks[0])
    return x.join()


def _scatter(full: torch.Tensor, like):
    """A full gradient cut into ``like``'s blocks (as is for a plain
    ``like``)."""
    if not isinstance(like, Sharded):
        return full
    if like.layout.splits > 1:
        COL.record("scatter", full)
    return like.cut(full)


def make_train_step(model_cfg: ModelConfig, opt_cfg: opt.OptConfig,
                    *, microbatches: int = 1, remat: bool = True,
                    shard=None, loss_chunk: Optional[int] = None
                    ) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).  ``batch``
    (numpy, tensors or ``Sharded``) has a leading dim divisible by
    ``microbatches``; metrics are 0-d tensors.  ``shard`` is the
    reference's activation callback (``make_shard_fn(mesh)``): eager
    code constrains nothing, and a sharded state must lie on its mesh."""

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
        placed = state.params
        if shard is not None:
            for x in T.leaves(placed):
                if isinstance(x, Sharded) and x.mesh != shard.mesh:
                    raise ValueError("the state is placed on another mesh "
                                     "than the step's shard function's")
        params = T.map_structure(_gather, as_tree(placed))
        batch = batch_to(join_tree(batch), param_device(params))
        step = join_tree(state.step)
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
        if any(isinstance(x, Sharded) for x in T.leaves(placed)):
            del params              # the gathered copies go first
            full = T.leaves(grads)
            del grads
            pieces = []
            for k, like in enumerate(T.leaves(placed)):
                pieces.append(_scatter(full[k], like))
                full[k] = None
            grads, params = T.unflatten_like(placed, pieces), placed
        new_params, new_opt, om = opt.apply(
            opt_cfg, grads, state.opt_state, params, step)
        metrics = dict(metrics)
        metrics.update(om)
        new_step = step + 1
        if isinstance(state.step, Sharded):
            new_step = state.step.with_blocks([new_step.to(b.device)
                                               for b in state.step.blocks])
        return (TrainState(params=new_params, opt_state=new_opt,
                           step=new_step), metrics)

    return train_step
