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

Elastic restart (``checkpoint.py:70`` places each leaf under a
``NamedSharding``): a tree of DTensors is saved whole, each leaf gathered
on every rank and written by rank 0 alone, every rank then waiting at a
barrier, so the format does not depend on the mesh that wrote it; a
restore places each leaf under its placements on the mesh it is given,
every rank reading the same ``.npy`` and keeping its own shard.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distrib.logical import _is_dtensor, place
from repro_torch.tree import leaf_paths

MANIFEST = "manifest.json"


def _leaf_paths(tree) -> list:
    return [("_".join(path), leaf) for path, leaf in leaf_paths(tree)]


class _Staging:
    """Two pinned host buffers of ``nbytes`` that CUDA leaves pass through,
    in turns, on their way to or from the disk: a copy into fresh
    pageable memory faults in every page first, the slowest part of a
    full-width checkpoint's write on an H100's host (PERF.md §6)."""

    def __init__(self, nbytes: int):
        self.nbytes, self.bufs, self.turn = nbytes, [], 0

    def take(self, dtype: torch.dtype, shape) -> torch.Tensor:
        if len(self.bufs) < 2:
            self.bufs.append(torch.empty(self.nbytes, dtype=torch.uint8,
                                         pin_memory=True))
        buf = self.bufs[self.turn % 2]
        self.turn += 1
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        return buf[:n].view(dtype).view(tuple(shape))


def _host(leaf: torch.Tensor, staging: Optional[_Staging]) -> np.ndarray:
    """``leaf``'s values as a numpy array, a CUDA leaf's through
    ``staging``."""
    if not leaf.is_cuda:
        return leaf.numpy()
    return staging.take(leaf.dtype, leaf.shape).copy_(leaf).numpy()


def _read(path: str, device: torch.device,
          staging: Optional[_Staging]) -> torch.Tensor:
    """One ``.npy`` on ``device``; onto a card through ``staging``."""
    if staging is None:
        return torch.from_numpy(np.load(path)).to(device)
    fmt = np.lib.format
    with open(path, "rb") as f:
        version = fmt.read_magic(f)
        header = {(1, 0): fmt.read_array_header_1_0,
                  (2, 0): fmt.read_array_header_2_0}[version]
        shape, fortran, dtype = header(f)
        if fortran:
            raise ValueError(f"{path} is in Fortran order")
        host = staging.take(torch.from_numpy(np.empty(0, dtype)).dtype,
                            shape)
        if f.readinto(host.view(-1).view(torch.uint8).numpy()) != \
                host.numel() * host.element_size():
            raise ValueError(f"{path} is shorter than its header says")
    return torch.empty(host.shape, dtype=host.dtype,
                       device=device).copy_(host)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomic save of a tree of tensors; returns the checkpoint's path.
    A tree that holds a DTensor is saved by every rank together: each
    leaf gathered whole, written by rank 0, and a barrier before any rank
    returns."""
    named = _leaf_paths(tree)
    bad = [n for n, leaf in named if leaf.dtype == torch.bfloat16]
    if bad:
        raise TypeError(f"checkpoint leaves {bad[:5]} are bfloat16: save "
                        "float32 masters (numpy has no bfloat16 that the "
                        "reference's restore reads)")
    sharded = any(_is_dtensor(leaf) for _, leaf in named)
    writer = not sharded or dist.get_rank() == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "time": time.time(), "leaves": []}
    staging = _Staging(max(leaf.numel() * leaf.element_size()
                           for _, leaf in named)) if named else None
    # one leaf is written while the next is copied to the host
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        written = None
        for name, leaf in named:
            leaf = leaf.detach()
            if _is_dtensor(leaf):
                leaf = leaf.full_tensor()        # every rank enters it
            if not writer:
                continue
            arr = _host(leaf, staging)
            if written is not None:
                written.result()
            written = pool.submit(np.save, os.path.join(tmp, name + ".npy"),
                                  arr)
            manifest["leaves"].append({"name": name, "shape": list(arr.shape),
                                       "dtype": str(arr.dtype)})
        if written is not None:
            written.result()
    if writer:
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                  # atomic commit
    if sharded:
        # no rank sees the directory before its commit
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, MANIFEST))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       device: Any = "cpu", shardings: Any = None,
                       mesh: Any = None) -> Any:
    """The checkpoint's leaves, by name, in the structure of ``like`` (a
    tree of tensors, ``meta`` ones will do), on ``device``, in the dtypes
    they were saved in.  A leaf missing or shaped unlike ``like``'s
    raises.

    ``shardings``, a tree like ``like``'s of DTensor placements (as
    ``distrib.logical.param_shardings`` gives them) or ``None`` for a
    leaf left whole, places each leaf on ``mesh``: every rank reads the
    whole leaf and keeps its own shard, with no collective."""
    if shardings is not None and mesh is None:
        raise ValueError("placements need the mesh they lie on")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        leaves = json.load(f)["leaves"]
    available = {m["name"] for m in leaves}
    missing = [n for n, _ in _leaf_paths(like) if n not in available]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")
    device = torch.device(device)
    staging = _Staging(max(math.prod(m["shape"]) * np.dtype(m["dtype"])
                           .itemsize for m in leaves)) \
        if device.type == "cuda" and leaves else None

    def load(node, placements, keys):
        if isinstance(node, dict):
            return {k: load(v, None if placements is None
                            else placements[k], keys + (str(k),))
                    for k, v in node.items()}
        name = "_".join(keys)
        leaf = _read(os.path.join(path, name + ".npy"), device, staging)
        if tuple(leaf.shape) != tuple(node.shape):
            raise ValueError(f"checkpoint leaf {name} is shaped "
                             f"{tuple(leaf.shape)}, not {tuple(node.shape)}")
        return place(leaf, placements, mesh)

    return load(like, shardings, ())


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
