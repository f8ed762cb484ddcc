"""Serving launcher: batched greedy decoding (port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3.5-moe-42b-a6.6b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --reduced --device cpu

Same flags and JSON as the reference, plus ``--device`` (default
``cuda``) and ``--use-kernel/--no-use-kernel`` (default on for cuda; the
server keeps it off where the family's decode step has no kernel, as for
ssm, hybrid and vlm).  hybrid and vlm serve through the server's
lockstep fallback; an encoder (audio) has no decode path and the
launcher exits.  Parameters come from a seeded ``torch.Generator`` on
the device, in float32.  The MoE archs and llama-3.2-vision-90b need
``--reduced`` on one card: phi3.5-moe-42b-a6.6b holds 167.5 GB of
float32 weights (83.7 GB in bf16) and the others more, beyond an 80 GB
H100, and the launcher says so before it draws any (``chip_smoke.py``
serves phi3.5-moe and llama-3.2-vision-90b at full width with their
depth cut).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import build_model
from repro_torch.runtime.serve import BatchedServer, Request


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="flash-decode CUDA kernel (default: on for cuda)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    use_kernel = (device.type == "cuda" if args.use_kernel is None
                  else args.use_kernel)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode path")
    model = build_model(cfg)
    if device.type == "cuda":
        need = cfg.n_params() * 4
        free, _ = torch.cuda.mem_get_info(device)
        if need > free:
            raise SystemExit(
                f"{cfg.name}: {need / 1e9:.1f} GB of float32 weights do "
                f"not fit the card's {free / 1e9:.1f} GB free; pass "
                "--reduced")
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab, rng.integers(4, 12)
                                    ).tolist(),
                max_new_tokens=args.new_tokens)
        for i in range(args.requests)
    ]
    server = BatchedServer(model, params, batch_size=args.batch,
                           max_seq=args.max_seq,
                           opts=ModelOpts(attn_chunk=64),
                           use_kernel=use_kernel, device=device)
    del params                  # the server holds its compute-dtype copy
    t0 = time.time()
    results = server.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in results.values())
    print(json.dumps({
        "arch": cfg.name, "requests": len(results),
        "generated_tokens": total_tokens,
        "tokens_per_s": round(total_tokens / dt, 2),
        "sample_output": results[0][:8],
    }, indent=2))


if __name__ == "__main__":
    main()
