"""Training launcher — the port of ``repro.launch.train``: mesh setup,
sharded state, checkpoint and auto-resume.

CPU-scale example::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen3-0.6b --reduced --steps 20 --batch 8 --seq 64 \\
        --ckpt-dir /tmp/ckpt

Same flags and output lines as the reference (``step ... loss ... gnorm
... lr ...``, ``[resume] from checkpoint step N``, ``[done] ...``), plus
``--device`` (default ``cuda``) and one ``[mesh  ]`` line before the
first step (axes, shards, descriptor or not, one shard's state bytes).
``--mesh auto`` is ``(n // model, model)`` over the visible devices
(``model`` 2 when ``n`` is even and above 1: (1, 1) on one card);
``single`` and ``multi`` are the production meshes, (16, 16)
and (2, 16, 16), which on fewer devices are descriptors whose shards
share them (``launch.mesh``).  The state is placed by the reference's
specs (params FSDP x TP, ZeRO-1 optimizer state, replicated step) and
steps through the sharded train step; a state whose shards the devices
cannot hold raises before anything is made (``Mesh.require_room``).
Checkpoints are the reference's format, restored onto this run's mesh:
either launcher resumes the other's.

MoE layers take the one-device path here.  The reference launcher
builds ``ep_sharding(mesh)`` only around creating ``jax.jit``, and jax
traces at the first call, after the context has closed, so its MoE
layers never take the expert-parallel path; the port matches it.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     visible_devices)
from repro_torch.training import (OptConfig, TrainState, make_train_step,
                                  train_state_init)
from repro_torch.training import optimizer as opt


def make_mesh_for(mesh: str, device: DeviceLike = None):
    """The reference's ``make_mesh_for``: ``single``/``multi`` the
    production meshes, ``auto`` a (data, model) mesh of the visible
    devices with a model axis of 1 or 2."""
    if mesh == "single":
        return make_production_mesh(multi_pod=False, device=device)
    if mesh == "multi":
        return make_production_mesh(multi_pod=True, device=device)
    n = len(visible_devices(device))
    model = 2 if n % 2 == 0 and n > 1 else 1
    return make_mesh((n // model, model), ("data", "model"), device)


def state_specs(cfg, opt_cfg: OptConfig, mesh, dtype=torch.float32):
    """``(state_specs, shard_bytes)``: the train state's spec tree on
    ``mesh`` and the bytes one shard holds of it, from meta tensors
    (nothing is allocated)."""
    params = SP.param_shapes(cfg, dtype)
    meta = TrainState(params=params, opt_state=opt.init(opt_cfg, params),
                      step=SP.sds((), torch.int32))
    pspecs = shd.param_specs(params, mesh)
    specs = TrainState(params=pspecs,
                       opt_state=shd.opt_state_specs(opt_cfg, params,
                                                     pspecs),
                       step=shd.P())
    return specs, shd.shard_bytes(meta, specs, mesh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", choices=["auto", "single", "multi"],
                    default="auto")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=5,
                        total_steps=max(args.steps, 10))
    data_cfg = DataConfig(seed=args.seed, global_batch=args.batch,
                          seq_len=args.seq)
    mesh = make_mesh_for(args.mesh, dev)
    sspecs, per_shard = state_specs(cfg, opt_cfg, mesh)
    mesh.require_room(per_shard, f"the train state of {cfg.name}")

    state = shd.place_tree(train_state_init(cfg, opt_cfg, args.seed,
                                            device=dev), sspecs, mesh)
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None:
        got = mgr.restore_latest(state, (mesh, sspecs))
        if got is not None:
            start_step, state, extra = got
            print(f"[resume] from checkpoint step {start_step}")

    bspecs = shd.batch_spec_tree(synthetic_batch(cfg, data_cfg, 0), mesh)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              shard=shd.make_shard_fn(mesh))
    print(f"[mesh  ] axes={dict(mesh.shape)} shards={mesh.size} "
          f"descriptor={mesh.descriptor} shard_state_bytes={per_shard}",
          flush=True)
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = shd.place_tree(synthetic_batch(cfg, data_cfg, step), bspecs,
                               mesh)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, extra={"data_step": step + 1})
    dt = time.time() - t0
    print(f"[done] {args.steps - start_step} steps in {dt:.1f}s "
          f"({(args.steps - start_step) / max(dt, 1e-9):.2f} it/s); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
