"""Training launcher — the port of ``repro.launch.train``: one device,
checkpoint and auto-resume.

CPU-scale example::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen3-0.6b --reduced --steps 20 --batch 8 --seq 64 \\
        --ckpt-dir /tmp/ckpt

Same flags and output lines as the reference (``step ... loss ... gnorm
... lr ...``, ``[resume] from checkpoint step N``, ``[done] ...``), plus
``--device`` (default ``cuda``).  ``--mesh auto`` is the one device;
``single``/``multi`` (the production meshes) wait for the LM sharding
slice of ROADMAP queue 1 item 8 and raise ``NotImplementedError``.
Checkpoints are the reference's format: either launcher resumes the
other's.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.training import OptConfig, make_train_step, train_state_init


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

    if args.mesh != "auto":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the sharded train step is ROADMAP "
            f"queue 1 item 2, not ported yet; --mesh auto trains on one "
            f"device")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=5,
                        total_steps=max(args.steps, 10))
    data_cfg = DataConfig(seed=args.seed, global_batch=args.batch,
                          seq_len=args.seq)

    state = train_state_init(cfg, opt_cfg, args.seed, device=dev)
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None:
        got = mgr.restore_latest(state)
        if got is not None:
            start_step, state, extra = got
            print(f"[resume] from checkpoint step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        state, metrics = step_fn(state, synthetic_batch(cfg, data_cfg, step))
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
