"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --reduced --steps 100 --batch 8 --seq 128 --out runs/qwen
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --reduced --device cpu

The reference's flags and JSON, plus ``--device`` (default ``cuda``; with
no card it raises, it never carries on on the CPU unless asked).  The run
auto-resumes from ``<out>/ckpt``, whose checkpoints the reference's
launcher reads too.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import build_model
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--out", default="runs/train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    data = SyntheticLMData(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, family=cfg.family, frame_dim=cfg.frame_dim,
        n_image_tokens=cfg.n_image_tokens, d_model=cfg.d_model)
    loop = TrainLoop(
        model, data,
        TrainLoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        out_dir=args.out, seed=args.seed,
                        compress_grads=args.compress_grads),
        opts=ModelOpts(attn_chunk=min(128, args.seq), ce_chunk=128,
                       remat="none"),
        device=device)
    result = loop.run(torch.Generator(device).manual_seed(args.seed))
    losses = result["losses"]
    print(json.dumps({
        "arch": cfg.name, "steps": result["final_step"],
        "loss_first10": sum(losses[:10]) / max(len(losses[:10]), 1),
        "loss_last10": sum(losses[-10:]) / max(len(losses[-10:]), 1),
    }, indent=2))


if __name__ == "__main__":
    main()
