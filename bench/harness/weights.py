"""The weights of a configuration, drawn on the device from the seed.

``layout`` names every leaf of a dense or MoE decoder with its shape, in
the port's tree (stacked over layers), from the configuration file
alone.  ``draw`` fills each leaf with one call in the served dtype:
norm scales are ones, every other leaf normal(0, ``init_std``) from a
generator of its own seeded by the run's seed and the leaf's name, so a
second draw (the reference's, once the program is gone) gives the same
values.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from harness.traffic import derive

Leaf = Tuple[Tuple[int, ...], str]          # shape, "normal" | "ones"
GATED = ("swiglu", "geglu")                  # FFNs of three matrices


def gated(cfg: Dict) -> bool:
    """Whether the configuration's FFN is gated (``wi``, ``wg``, ``wo``)
    or plain (``wi``, ``wo``)."""
    return cfg["activation"] in GATED


def layout(cfg: Dict) -> Dict[str, Leaf]:
    """Flat leaf names ("layers.attn.wq") -> (shape, init)."""
    d, V, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    q = cfg["n_heads"] * cfg["head_dim"]
    kv = cfg["n_kv_heads"] * cfg["head_dim"]
    f = cfg["d_ff"]
    out: Dict[str, Leaf] = {
        "embed.tok": ((V, d), "normal"),
        "ln_f.scale": ((d,), "ones"),
        "layers.ln1.scale": ((L, d), "ones"),
        "layers.ln2.scale": ((L, d), "ones"),
        "layers.attn.wq": ((L, d, q), "normal"),
        "layers.attn.wk": ((L, d, kv), "normal"),
        "layers.attn.wv": ((L, d, kv), "normal"),
        "layers.attn.wo": ((L, q, d), "normal"),
    }
    if not cfg.get("tie_embeddings"):
        out["embed.unembed"] = ((d, V), "normal")
    if cfg["family"] == "moe":
        E = cfg["n_experts"]
        out.update({
            "layers.moe.router": ((L, d, E), "normal"),
            "layers.moe.wi": ((L, E, d, f), "normal"),
            "layers.moe.wg": ((L, E, d, f), "normal"),
            "layers.moe.wo": ((L, E, f, d), "normal"),
        })
    elif cfg["family"] == "dense":
        out.update({
            "layers.mlp.wi": ((L, d, f), "normal"),
            "layers.mlp.wo": ((L, f, d), "normal"),
        })
        if gated(cfg):
            out["layers.mlp.wg"] = ((L, d, f), "normal")
    else:
        raise ValueError(f"family {cfg['family']!r}: the harness draws "
                         "dense and moe decoders")
    return out


def draw(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout(cfg)`` on ``device`` in ``cfg["dtype"]``."""
    device = torch.device(device)
    dtype = getattr(torch, cfg["dtype"])
    out = {}
    for name, (shape, init) in layout(cfg).items():
        if init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        gen = torch.Generator(device).manual_seed(derive(seed, name))
        out[name] = torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, cfg["init_std"], generator=gen)
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """The port's nested parameter tree from flat leaf names."""
    tree: Dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def n_bytes(cfg: Dict) -> int:
    """Bytes of every leaf in the served dtype."""
    elem = torch.finfo(getattr(torch, cfg["dtype"])).bits // 8
    total = 0
    for shape, _ in layout(cfg).values():
        n = 1
        for s in shape:
            n *= s
        total += n
    return total * elem
