"""Logical-axis sharding: named logical axes -> physical mesh axes
(port of ``repro/distrib/logical.py``).

Every parameter and activation carries *logical* axis names (``"embed"``,
``"ffn"``, ``"q_heads"``, ...).  An :class:`AxisRules` maps each logical
name to zero or more physical mesh axes: that mapping IS the parallelism
strategy, the inner configuration space of the sharding autotuner.  A
divisibility guard drops a physical axis from a mapping when the
dimension does not divide by the mesh axis' size.

A spec is a plain tuple, one entry a tensor dim (``None``, an axis name
or a tuple of names; trailing ``None`` trimmed), where the reference has
a ``PartitionSpec``.  :class:`ShardCtx` turns a spec into DTensor
placements on a ``DeviceMesh`` (``repro_torch.launch.mesh``) and
redistributes activations to them; with no mesh (``NOSHARD``, every
single-device path) it constrains nothing.

:class:`P`, :func:`spec_map` and :func:`init_params` keep the
reference's declarative parameter tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Physical = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Physical, ...]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis name -> physical mesh axis (or tuple of axes, or None)."""
    rules: Dict[str, Physical]

    def get(self, name: str) -> Physical:
        return self.rules.get(name)

    def replace(self, **kw: Physical) -> "AxisRules":
        d = dict(self.rules)
        d.update(kw)
        return AxisRules(d)


def fsdp_tp_rules(multi_pod: bool) -> AxisRules:
    """``logical.py:46``: the paper-faithful default strategy: batch over
    (pod, data), parameters model-parallel over "model" on the wide dim
    and FSDP over "data" on the embed dim, the residual stream's sequence
    over "model"."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return AxisRules({
        "batch": dp,
        "seq": "model",
        "kv_seq": None,
        "embed": "data",
        "vocab": "model",
        "q_heads": "model",
        "kv_heads": "model",
        "kv_hd": "model",
        "ffn": "model",
        "experts": "model",
        "inner": "model",
        "ssm_heads": "model",
        "ssm_hd": "model",
        "state": None,
        "conv": None,
        "img": None,
        "layers": None,
        "act_embed": None,      # activation d_model dim
        "act_heads": "model",   # activation head dim
        "act_ffn": "model",
        "act_kv_seq": None,     # KV-cache sequence dim
        "expert_cap": None,
    })


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any object whose
    ``shape`` is already such a dict (the reference's ``Mesh.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _names(axes: Physical) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _divisible(mesh, axes: Physical, dim: int) -> bool:
    if mesh is None or axes is None:
        return True
    sizes = axis_sizes(mesh)
    return dim % math.prod(sizes[a] for a in _names(axes)) == 0


def _best_prefix(mesh, axes: Physical, dim: int) -> Physical:
    """Longest prefix of the axis tuple whose size divides ``dim``: batch
    256 on ('pod', 'data', 'model') = 512 falls back to ('pod', 'data')
    = 32 instead of replicating entirely."""
    if mesh is None or axes is None:
        return axes
    sizes = axis_sizes(mesh)
    names = _names(axes)
    for k in range(len(names), 0, -1):
        if dim % math.prod(sizes[a] for a in names[:k]) == 0:
            return names[:k] if k > 1 else names[0]
    return None


def logical_to_spec(logical: Sequence[Optional[str]], rules: AxisRules,
                    shape: Optional[Sequence[int]] = None,
                    mesh=None) -> Spec:
    """``logical.py:101``: a tuple of logical axis names -> a spec tuple.
    A physical axis is used once; trailing ``None`` entries are trimmed."""
    used: set = set()
    out = []
    for i, name in enumerate(logical):
        phys = rules.get(name) if name else None
        if phys is not None and shape is not None and not _divisible(
                mesh, phys, shape[i]):
            phys = _best_prefix(mesh, phys, shape[i])
        names = () if phys is None else _names(phys)
        names = tuple(n for n in names if n not in used)
        used.update(names)
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(names)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``, one per mesh dim: tensor
    dim d split over axes (a, b) is ``Shard(d)`` on both mesh dims, a
    major to b minor, which is the layout of JAX's ``PartitionSpec``
    when the axes keep the mesh's order (every rule here does)."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(order)
    for d, phys in enumerate(spec):
        if phys is None:
            continue
        idx = [order.index(a) for a in _names(phys)]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: axes {phys} are out of the mesh's order "
                f"{tuple(order)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Threaded through the model code to apply activation sharding
    (``logical.py:129``).  ``mesh=None`` makes every constraint a no-op:
    the single-device paths run it so."""
    mesh: object = None
    rules: Optional[AxisRules] = None

    def sharding_for(self, logical: Sequence[Optional[str]],
                     shape: Sequence[int]) -> Optional[tuple]:
        """The placements of a tensor of ``shape`` with these logical
        axes, or ``None`` with no mesh."""
        if self.mesh is None or self.rules is None:
            return None
        return spec_placements(
            logical_to_spec(logical, self.rules, shape, self.mesh),
            self.mesh)

    def weights(self, tree):
        """A block's parameters as its products use them: each leaf
        gathered over the mesh axes the "embed" rule maps to (FSDP's
        per-layer all-gather, whose backward reduce-scatters the
        gradient), its model-parallel sharding kept.  Called inside the
        block, so remat gathers again instead of keeping the gathered
        copy.  ``tree`` itself with no mesh or no FSDP axis."""
        if self.mesh is None or self.rules is None:
            return tree
        fsdp = self.rules.get("embed")
        if fsdp is None:
            return tree
        from torch.distributed.tensor import Replicate, Shard
        order = list(self.mesh.mesh_dim_names)
        dims = [order.index(a) for a in _names(fsdp)]

        def one(x):
            if isinstance(x, dict):
                return {k: one(v) for k, v in x.items()}
            pl = list(x.placements)
            if not any(isinstance(pl[i], Shard) for i in dims):
                return x
            for i in dims:
                pl[i] = Replicate()
            return x.redistribute(self.mesh, tuple(pl))

        return one(tree)

    def constrain(self, x: torch.Tensor, *logical: Optional[str]
                  ) -> torch.Tensor:
        """``x`` redistributed to the placements of its logical axes (a
        DTensor in, a DTensor out); ``x`` itself with no mesh."""
        if self.mesh is None or self.rules is None:
            return x
        placements = self.sharding_for(logical, x.shape)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)


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


def abstract_params(spec, dtype: torch.dtype = torch.float32):
    """``logical.py:209``: ``meta`` tensors of the spec's shapes, no
    allocation (the dry-run's parameters)."""
    return spec_map(lambda p: torch.empty(p.shape, dtype=dtype,
                                          device="meta"), spec)


def param_shardings(spec, ctx: ShardCtx):
    """``logical.py:215``: placements aligned with the param tree."""
    return spec_map(lambda p: ctx.sharding_for(p.axes, p.shape), spec)


def count_params(spec) -> int:
    total = 0

    def add(p):
        nonlocal total
        total += math.prod(p.shape)

    spec_map(add, spec)
    return total


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

