"""Declarative parameter specs and a no-op sharding context.

Port of ``repro/distrib/logical.py:129-203`` for one device: :class:`P`,
:func:`spec_map` and :func:`init_params` keep the reference's tree, and
:class:`ShardCtx` keeps the model code's signatures while constraining
nothing.  The logical axis names stay on every leaf, so the sharded path
of a later slice can map them onto a device mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Stand-in for ``repro.distrib.logical.ShardCtx`` (``:129``) with no
    mesh: every constraint returns its input unchanged."""

    def constrain(self, x: torch.Tensor, *logical: Optional[str]
                  ) -> torch.Tensor:
        return x


NOSHARD = ShardCtx()


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter leaf: shape + logical axes + init scale (``:162``)."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    scale: float = 0.02
    init: str = "normal"     # normal | zeros | ones

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def spec_map(fn, spec):
    """Map ``fn`` over every P leaf of a nested-dict spec (``:178``)."""
    if isinstance(spec, P):
        return fn(spec)
    return {k: spec_map(fn, v) for k, v in spec.items()}


def init_params(generator: torch.Generator, spec,
                dtype: torch.dtype = torch.float32):
    """Materialize parameters from a spec tree on ``generator.device``.

    Same leaves as ``repro.distrib.logical.init_params`` (``:185``):
    normal * scale, zeros or ones.  The numbers differ from JAX's, whose
    generator is another; parity tests load JAX's trees instead
    (``repro_torch.interop``).

    A leaf stacked over layers (over one or more leading ``layers`` axes:
    a grouped stack has two) is drawn one layer's slice at a time, so
    the f32 temporary never holds more than one slice (a full-width MoE
    expert stack in bf16 would otherwise need twice its size again in
    f32); a draw in another dtype equals the f32 draw rounded.
    """
    device = generator.device

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale)

    def make(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        lead = next((i for i, a in enumerate(p.axes) if a != "layers"),
                    len(p.axes))
        if not lead:
            return normal(p.shape, p.scale).to(dtype)
        out = torch.empty(p.shape, dtype=dtype, device=device)
        for layer in out.view(-1, *p.shape[lead:]):
            layer.copy_(normal(p.shape[lead:], p.scale))
        return out

    return spec_map(make, spec)

