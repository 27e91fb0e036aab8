"""End-to-end training script of the PyTorch port: train a reduced-config
model with checkpoints and auto-resume through
``repro_torch.launch.train``, the launcher a deployment uses, as
``examples/train_lm.py`` does with the JAX package's.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \\
        --arch qwen3-0.6b --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --mesh single

``--mesh single`` (``multi``) trains over the production mesh, 256 (512)
shards of the visible devices; ``--device`` defaults to ``cuda``.
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", choices=["auto", "single", "multi"],
                    default="auto")
    args = ap.parse_args()
    losses = train_main([
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "64",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--log-every", "20",
        "--device", args.device, "--mesh", args.mesh,
    ])
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
