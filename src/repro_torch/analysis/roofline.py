"""Three-term roofline of one step traced on fake DTensors (port of
``repro/analysis/roofline.py`` for the H100).

    compute term    = FLOPs per chip      / peak FLOP/s
    memory term     = bytes per chip      / HBM bandwidth
    collective term = collective bytes    / link bandwidth

The reference reads these from XLA's compiled module.  The port traces
the step instead: :func:`trace_plan` runs a ``LoweringPlan`` on DTensors
whose local shards are fake tensors (``FakeTensorMode``) over the fake
process group of ``repro_torch.launch.mesh``, and :func:`cost_mode`
counts what rank 0 runs:

* FLOPs of the LOCAL operations DTensor issues for rank 0, by
  ``torch.utils.flop_counter``'s formulas (matrix products, convolutions,
  attention; elementwise work counts none).  Work that is replicated
  counts on every chip, as in XLA's per-chip module.  The shape
  inference DTensor runs at global shapes to place an op is not counted;
* bytes: every local operation reads its tensor inputs and writes its
  outputs once, views and allocations moving nothing (unfused, so above
  what a fused program moves);
* collective bytes by kind, the output bytes of each functional
  collective (``_c10d_functional.*``), per chip, the reference's
  convention.  A move from one sharded dim to another is an all-to-all
  on NCCL, but on a CPU mesh DTensor runs it as an all-gather and a
  chunk (gloo has no all-to-all); it is counted as the all-gather it
  runs, so ``all-to-all`` reads 0 and such a move counts the mesh dim's
  size times the all-to-all's bytes;
* peak memory: the most bytes live at once in the storages rank 0 holds,
  the step's arguments included.  The port's steps update their donated
  arguments (parameters, optimizer state, decode cache) in place, so
  those count once, as the reference's ``temp + arg - alias`` counts
  them; ``peak_memory_adjusted`` equals the peak.

An operation DTensor has no sharding strategy for (or cannot place as
the step asks) raises: the cell does not trace, on the torch it runs on.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional

import torch

#: NVIDIA H100 80GB HBM3 (SXM5), 700 W, per card, from NVIDIA's H100
#: datasheet: dense bf16 tensor-core peak (no sparsity), HBM3 bandwidth,
#: HBM capacity, and NVLink 4 at 900 GB/s both directions, 450 GB/s one
#: way.  The collective term keeps the reference's single bandwidth: a
#: 256-card mesh spans 32 nodes of 8, and across nodes a card's share of
#: InfiniBand NDR is about 50 GB/s, so the NVLink figure makes that term
#: optimistic.
HW = {
    "peak_flops": 989e12,     # bf16 FLOP/s
    "hbm_bw": 3.35e12,        # B/s
    "ici_bw": 450e9,          # B/s per direction, NVLink 4
    "hbm_bytes": 80e9,        # capacity
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: functional collective op name -> the reference's HLO kind
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

_PART_WRITES = frozenset(("scatter_", "index_put_", "index_copy_"))
_WHOLE_WRITES = frozenset(("copy_", "fill_", "zero_"))

#: allocations move no bytes (their storages still count as memory)
_NO_TRAFFIC = frozenset(("empty", "empty_strided", "empty_like",
                         "new_empty", "new_empty_strided"))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, int]
    peak_memory_per_chip: Optional[float]
    model_flops: float            # 6·N_active·D tokens-based estimate
    peak_memory_adjusted: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / HW["peak_flops"]

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HW["hbm_bw"]

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / HW["ici_bw"]

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        """Overlap-optimistic step time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS/(chips·peak) ÷ t_step — 'MFU at the roofline'."""
        ideal = self.model_flops / (self.chips * HW["peak_flops"])
        return ideal / self.t_step if self.t_step else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "peak_memory_per_chip": self.peak_memory_per_chip,
            "peak_memory_adjusted": self.peak_memory_adjusted,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck, "t_step": self.t_step,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) for train; 2·N·D forward-only.

    Decode shapes process global_batch tokens per step.
    """
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.tokens
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.tokens
        mult = 2.0
    else:                              # decode: one token per sequence
        tokens = shape.global_batch
        mult = 2.0
    return mult * n_active * tokens


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------
def _tensors(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _traffic(name: str, ins, outs) -> int:
    """Bytes an operation moves: its inputs read and its outputs written
    once; a write into part of a tensor (a scatter, an indexed write)
    reads its index and source and writes the source's worth, and a
    whole overwrite (a copy, a fill) does not read what it replaces."""
    if name in _PART_WRITES:
        return sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[-1])
    if name in _WHOLE_WRITES:
        return sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[0])
    return sum(_nbytes(t) for t in ins + outs)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def cost_mode():
    """A fresh counting ``FakeTensorMode``: rank 0's local work while a
    step runs on fake DTensors.

    The fake local shards belong to it, so every local operation DTensor
    issues for them reaches its ``__torch_dispatch__``; it is never on
    the mode stack itself (see :func:`trace_plan`).  Only top-level calls
    count (a fake kernel's own decompositions re-enter it).  The class is
    made here, so that importing this module imports no tracing
    machinery."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import flop_registry

    class _CostMode(FakeTensorMode):
        def __init__(self):
            super().__init__(allow_non_fake_inputs=True)
            self.flops = 0
            self.bytes = 0
            self.coll = {k: 0 for k in _COLLECTIVES}
            self.live = 0
            self.peak = 0
            self._depth = 0
            self._seen: Dict[int, Any] = {}

        def _alloc(self, t: torch.Tensor) -> None:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen and self._seen[key]() is st:
                return
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._seen[key] = weakref.ref(st)
            weakref.finalize(st, self._free, key, n)

        def _free(self, key: int, n: int) -> None:
            self.live -= n
            self._seen.pop(key, None)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            top = self._depth == 0
            self._depth += 1
            try:
                out = super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self._depth -= 1
            if out is NotImplemented or not top:
                return out
            ins = _tensors((args, kwargs))
            if any(isinstance(x, DTensor) for x in ins):
                return out
            outs = _tensors(out)
            name = func._overloadpacket.__name__
            if func.namespace == "_c10d_functional":
                # the waits and autograd wrappers hand the collective's
                # buffer on: no allocation, no traffic
                kind = _FUNCOL_KIND.get(name)
                if kind is not None:
                    for t in outs:
                        self._alloc(t)
                    self.coll[kind] += sum(_nbytes(t) for t in outs)
                return out
            for t in outs:
                self._alloc(t)
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if outs and name not in _NO_TRAFFIC and not _is_view(func):
                self.bytes += _traffic(name, ins, outs)
            return out

    return _CostMode()


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def _local_shape(shape, placements, mesh) -> tuple:
    from torch.distributed.tensor import Shard
    local = list(shape)
    for size, pl in zip(mesh.shape, placements):
        if isinstance(pl, Shard):
            if local[pl.dim] % size:
                raise ValueError(f"{tuple(shape)} {placements}: dim "
                                 f"{pl.dim} does not split {size} ways")
            local[pl.dim] //= size
    return tuple(local)


def materialize(abstract, placements, mesh):
    """A fake DTensor tree of the ``meta`` tree ``abstract``: rank 0's
    local shard of each leaf, a fake tensor of the current fake mode.
    ``placements`` ``None`` gives a plain fake tensor of the leaf."""
    from torch.distributed.tensor import DTensor
    if isinstance(abstract, dict):
        return {k: materialize(v, placements[k], mesh)
                for k, v in abstract.items()}
    if placements is None:
        return torch.empty(abstract.shape, dtype=abstract.dtype)
    local = torch.empty(_local_shape(abstract.shape, placements, mesh),
                        dtype=abstract.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=abstract.shape,
                              stride=_contiguous_stride(abstract.shape))


@dataclasses.dataclass
class TraceCost:
    flops: float
    bytes: float
    coll: Dict[str, int]
    arg_bytes: float
    peak_bytes: float


def trace_plan(plan) -> TraceCost:
    """Run ``plan.fn`` once on fake DTensors of its arguments and count
    rank 0's work (:func:`cost_mode`).  An op DTensor has no sharding
    strategy for raises, as it would on real tensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    mode = cost_mode()
    with mode:
        args = tuple(materialize(a, s, plan.mesh)
                     for a, s in zip(plan.args, plan.in_shardings))
    arg_bytes = mode.live
    mode.flops = mode.bytes = 0
    mode.peak = mode.live
    # the counting mode is off the stack while the step runs: DTensor's
    # own bookkeeping runs on real tensors and its shape inference in a
    # fake mode of its own; only operations on the fake local shards
    # enter the counting mode
    with implicit_replication():
        out = plan.fn(*args)
    del out
    return TraceCost(flops=float(mode.flops), bytes=float(mode.bytes),
                     coll={k: int(v) for k, v in mode.coll.items()},
                     arg_bytes=float(arg_bytes),
                     peak_bytes=float(mode.peak))


def roofline_from_trace(plan, *, cfg, shape, mesh_name: str,
                        chips: int) -> RooflineReport:
    """Trace ``plan`` and score it: the counterpart of the reference's
    ``roofline_from_compiled``."""
    c = trace_plan(plan)
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_chip=c.flops, bytes_per_chip=c.bytes,
        coll_bytes_per_chip=float(sum(c.coll.values())),
        coll_breakdown=c.coll, peak_memory_per_chip=c.peak_bytes,
        model_flops=model_flops_estimate(cfg, shape),
        peak_memory_adjusted=c.peak_bytes)

