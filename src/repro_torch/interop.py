"""Carry parameter trees between the JAX reference and the port.

A JAX parameter tree, as a nested dict of numpy arrays with the same keys
(``jax.tree.map(np.asarray, params)``), becomes the port's tree of tensors
on a given device, and back.  The layouts are the same, stacked layers
included, so nothing is transposed.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)    # a copy: writable


def params_from_numpy(tree, device: Any = "cpu"):
    """Nested dict of numpy arrays -> the same tree of tensors on device."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)


def tree_to_numpy(tree):
    """Nested dict of tensors -> numpy (bf16 leaves widened to f32)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def spec_tree(spec):
    """A spec tree as plain tuples (shape, axes, scale, init), for
    comparing two packages' specs leaf by leaf.  Any leaf with those four
    attributes will do, so the reference's spec converts too."""
    if isinstance(spec, dict):
        return {k: spec_tree(v) for k, v in spec.items()}
    return (tuple(spec.shape), tuple(spec.axes), spec.scale, spec.init)
