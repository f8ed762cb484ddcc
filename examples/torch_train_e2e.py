"""End-to-end training driver on the PyTorch port: a small qwen-family
model trained for a few hundred steps with checkpoint/resume, loss
logging and (optional) int8 gradient compression.  The twin of
``examples/train_e2e.py``, with its flags plus ``--device`` (``cuda`` by
default, ``cpu`` to run here):

    PYTHONPATH=src python examples/torch_train_e2e.py --steps 200
    PYTHONPATH=src python examples/torch_train_e2e.py --device cpu --steps 20

Pass --dmodel 768 --layers 12 for the full ~100M run.  A second run with
the same ``--out`` resumes from its newest checkpoint.
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import build_model
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dmodel", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--out", default="runs/torch_train_e2e")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args) -> TrainLoop:
    """The model, its data and the loop, as the reference example sizes
    them."""
    cfg = dataclasses.replace(
        get_config("qwen1.5-4b"),
        n_layers=args.layers, d_model=args.dmodel,
        n_heads=max(4, args.dmodel // 64), n_kv_heads=max(4, args.dmodel // 64),
        head_dim=64, d_ff=args.dmodel * 3, vocab=args.vocab)
    model = build_model(cfg)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab} "
          f"-> {cfg.n_params()/1e6:.1f}M params")
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch)
    return TrainLoop(
        model, data,
        TrainLoopConfig(steps=args.steps, ckpt_every=50, out_dir=args.out,
                        log_every=20, compress_grads=args.compress_grads,
                        schedule_total=args.steps),
        opts=ModelOpts(attn_chunk=min(128, args.seq), ce_chunk=128,
                       remat="none"),
        device=args.device)


def run(loop: TrainLoop, out: str) -> dict:
    r = loop.run()
    losses = r["losses"]
    if losses:
        k = min(10, len(losses))
        first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
        print(f"loss: first{k}={first:.4f} last{k}={last:.4f} "
              f"(decreased: {last < first})")
    print(f"checkpoints + metrics.jsonl under {out}/")
    return r


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(build(args), args.out)


if __name__ == "__main__":
    main()
