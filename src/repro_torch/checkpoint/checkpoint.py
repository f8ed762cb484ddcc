"""Atomic checkpoints in the reference's format (port of
``repro/checkpoint/checkpoint.py``), so each package restores the other's.

Layout: ``<dir>/step_<N:08d>/`` with one ``.npy`` a leaf and
``manifest.json`` (``step``, ``time``, ``leaves[{name, shape, dtype}]``).
A leaf is named by its dict keys joined by ``_`` in sorted-key order, as
the reference's ``_leaf_paths`` names it (``params_layers_attn_wq``,
``opt_count``).  A write goes to ``step_<N>.tmp`` and is renamed, so a
crash mid-write never leaves a partial step that ``latest_step`` would
pick.  The training state is float32 and int32; a bfloat16 leaf is
refused, since numpy has no bfloat16 that the reference could read back.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaf_paths

MANIFEST = "manifest.json"


def _leaf_paths(tree) -> list:
    return [("_".join(path), leaf) for path, leaf in leaf_paths(tree)]


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomic save of a tree of tensors; returns the checkpoint's path."""
    named = _leaf_paths(tree)
    bad = [n for n, leaf in named if leaf.dtype == torch.bfloat16]
    if bad:
        raise TypeError(f"checkpoint leaves {bad[:5]} are bfloat16: save "
                        "float32 masters (numpy has no bfloat16 that the "
                        "reference's restore reads)")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "time": time.time(), "leaves": []}
    for name, leaf in named:
        arr = leaf.detach().cpu().numpy()
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, MANIFEST))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       device: Any = "cpu") -> Any:
    """The checkpoint's leaves, by name, in the structure of ``like`` (a
    tree of tensors, ``meta`` ones will do), on ``device``, in the dtypes
    they were saved in.  A leaf missing or shaped unlike ``like``'s
    raises."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        available = {m["name"] for m in json.load(f)["leaves"]}
    missing = [n for n, _ in _leaf_paths(like) if n not in available]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")

    def load(node, keys):
        if isinstance(node, dict):
            return {k: load(v, keys + (str(k),)) for k, v in node.items()}
        name = "_".join(keys)
        arr = np.load(os.path.join(path, name + ".npy"))
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"checkpoint leaf {name} is shaped "
                             f"{arr.shape}, not {tuple(node.shape)}")
        return torch.from_numpy(arr).to(device)

    return load(like, ())


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
