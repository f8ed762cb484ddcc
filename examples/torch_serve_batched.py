"""Batched serving example on the PyTorch port: continuous-batching greedy
decoding on the SSM architecture (no KV cache growth — constant state).
The twin of ``examples/serve_batched.py``, with its flags plus
``--device`` (``cuda`` by default, ``cpu`` to run here):

    PYTHONPATH=src python examples/torch_serve_batched.py --arch mamba2-130m
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

Parameters are drawn from a seeded ``torch.Generator`` on the device;
:func:`build` takes a parameter tree instead (a test hands it the JAX
example's, converted).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import build_model
from repro_torch.runtime.serve import BatchedServer, Request


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def requests(args, vocab: int):
    """The reference example's requests: prompts of 3-9 tokens from
    ``numpy.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab,
                                        rng.integers(3, 10)).tolist(),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]


def build(args, cfg=None, params=None):
    """(server, requests).  ``cfg`` defaults to the arch's reduced config
    and ``params`` to a seeded draw on the device."""
    device = resolve_device(args.device)
    cfg = cfg or get_config(args.arch).reduced()
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(0))
    server = BatchedServer(model, params, batch_size=args.batch,
                           max_seq=128,
                           opts=ModelOpts(attn_chunk=64, remat="none"),
                           device=device)
    return server, requests(args, cfg.vocab)


def run(server, reqs) -> dict:
    t0 = time.time()
    out = server.run(reqs)
    dt = time.time() - t0
    tokens = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests / {tokens} tokens in {dt:.1f}s "
          f"({tokens/dt:.1f} tok/s, batch={server.B})")
    for rid in sorted(out)[:3]:
        print(f"  req {rid}: {out[rid]}")
    return out


def main(argv=None) -> dict:
    return run(*build(parse_args(argv)))


if __name__ == "__main__":
    main()
