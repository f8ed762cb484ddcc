"""Compile-cost objective: f_k(x) = roofline step time of the traced cell
(port of ``repro/tuner/objective.py``).

Each evaluation traces the train/serve step under the candidate (strategy,
config) on fake DTensors (``repro_torch.analysis.roofline.trace_plan``)
and scores it with the three-term roofline on the H100's constants — an
*expensive black-box evaluation* (seconds to minutes), which is exactly
the regime CloudBandit is designed for.  Configurations that exceed
the per-chip HBM budget are penalized proportionally to the overrun (they
are "feasible but terrible", like an undersized cloud VM, rather than
excluded — mirroring how the paper's objective treats swapping configs).

Memoization of repeat evaluations is the engine result store's job, not
this module's: :func:`eval_compile_cost` is the ``compile_cost``
objective's worker-importable evaluate fn (see
:mod:`repro_torch.core.objectives`), and every evaluation it performs lands as
a content-keyed record the store replays with ``computed=0``.
"""
from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Any, Dict, Optional, Tuple

from repro_torch.analysis.roofline import HW, roofline_from_trace
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import mesh_chip_count
from repro_torch.launch.steps import build_plan
from repro_torch.models.blocks import ModelOpts

#: the ModelOpts knobs a search config may set; anything else is a
#: typo'd search space and must fail loudly, not evaluate the base model
CONFIG_KEYS = ("remat", "attn_chunk", "ce_chunk", "banded_local")


def opts_from_config(config: dict, base: Optional[ModelOpts] = None
                     ) -> ModelOpts:
    unknown = sorted(set(config) - set(CONFIG_KEYS))
    if unknown:
        raise ValueError(
            f"unknown config key(s) {unknown}; accepts: {list(CONFIG_KEYS)}")
    base = base or ModelOpts()
    return dataclasses.replace(
        base,
        remat=config.get("remat", base.remat),
        attn_chunk=int(config.get("attn_chunk", base.attn_chunk)),
        ce_chunk=int(config.get("ce_chunk", base.ce_chunk)),
        banded_local=bool(config.get("banded_local", base.banded_local)),
    )


@dataclasses.dataclass
class CompileCostObjective:
    cfg: ArchConfig
    shape: ShapeSpec
    mesh: object
    hbm_budget: float = HW["hbm_bytes"]
    verbose: bool = True

    def evaluate(self, strategy: str, config: dict) -> Tuple[float, dict]:
        opts = opts_from_config(config)
        plan = build_plan(self.cfg, self.shape, self.mesh,
                          strategy=strategy, opts=opts)
        report = roofline_from_trace(
            plan, cfg=self.cfg, shape=self.shape,
            mesh_name="tuner", chips=mesh_chip_count(self.mesh))
        t = report.t_step
        # feasibility uses the donation-adjusted peak
        peak = report.peak_memory_adjusted \
            or report.peak_memory_per_chip or 0.0
        if peak > self.hbm_budget:
            t *= (peak / self.hbm_budget) ** 2       # infeasibility penalty
        result = report.to_dict()
        result["objective"] = t
        result["strategy"] = strategy
        result["config"] = dict(config)
        if self.verbose:
            # diagnostics go to stderr: stdout belongs to --out/JSON
            # piping (the benchmarks/run.py convention)
            print(f"  eval [{strategy}] {config} -> t={t:.3f}s "
                  f"(bottleneck={report.bottleneck}, "
                  f"mem={peak/1e9:.1f}GB)", file=sys.stderr, flush=True)
        return t, result

    def __call__(self, strategy: str, config: dict) -> float:
        return self.evaluate(strategy, config)[0]


@functools.lru_cache(maxsize=None)
def _objective_for(arch: str, shape: str, mesh: str) -> CompileCostObjective:
    """One CompileCostObjective per (arch, shape, mesh) parameterization,
    built lazily worker-side.  This caches the *objective instance*
    (mesh construction, config lookup), never evaluation results — the
    engine store is the result memoizer."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.mesh import make_production_mesh
    return CompileCostObjective(
        get_config(arch), get_shape(shape),
        make_production_mesh(multi_pod=(mesh == "multipod")))


#: rough per-strategy collective traffic, in units of one full
#: parameter-set transfer over the links per step — the term that separates
#: the strategy families before any HLO exists
_STRATEGY_TRAFFIC = {
    "fsdp_tp": 2.0,         # param all-gather + grad reduce-scatter
    "fsdp_tp_nosp": 2.4,    # same, plus unsharded-activation all-reduces
    "fsdp_dp": 3.0,         # pure-DP grad all-reduce dominates
    "ddp_tp": 4.0,          # replicated params: full grad all-reduce
    "tp_serve": 0.6,        # activation collectives only
}

#: recompute multiplier per remat policy (flops actually executed)
_REMAT_FLOPS = {"full": 4.0 / 3.0, "dots": 1.15, "none": 1.0}


def eval_sharding_analytic(params: Dict[str, Any],
                           context: Dict[str, Any]) -> dict:
    """The ``hlo_cost`` objective: rung 0 of the sharding ladder.

    A compile-free roofline sketch — model FLOPs over peak compute,
    plus a per-strategy collective-traffic term and coarse config
    multipliers (remat recompute, chunking overhead).  Deliberately a
    *ranking* model, not a timing model: it costs microseconds, traces
    nothing, and only needs to correlate with ``compile_cost`` well
    enough to screen candidates before traces are spent.
    """
    from repro_torch.analysis.roofline import model_flops_estimate
    from repro_torch.configs import get_config, get_shape

    cfg = get_config(params["arch"])
    shape = get_shape(params["shape"])
    chips = 512 if params.get("mesh", "pod") == "multipod" else 256
    strategy = params["provider"]
    config = dict(params["config"])
    if strategy not in _STRATEGY_TRAFFIC:
        raise ValueError(
            f"hlo_cost: unknown strategy {strategy!r}; knows "
            f"{sorted(_STRATEGY_TRAFFIC)}")
    flops = model_flops_estimate(cfg, shape)
    flops *= _REMAT_FLOPS.get(str(config.get("remat", "none")), 1.0)
    if config.get("banded_local") and cfg.sliding_window:
        flops *= 0.92                   # banded local layers skip far keys
    # chunked attention / CE re-launch overhead: small, favors the
    # incumbent chunk sizes over tiny chunks
    overhead = 1.0
    if "attn_chunk" in config:
        overhead *= 1.0 + 16.0 / max(int(config["attn_chunk"]), 1)
    if "ce_chunk" in config:
        overhead *= 1.0 + 16.0 / max(int(config["ce_chunk"]), 1)
    t_compute = flops / (chips * HW["peak_flops"]) * overhead
    param_bytes = 2.0 * cfg.n_params()
    t_comms = _STRATEGY_TRAFFIC[strategy] * param_bytes / \
        (chips * HW["ici_bw"])
    t = t_compute + t_comms
    return {"value": float(t), "t_compute": float(t_compute),
            "t_comms": float(t_comms), "flops": float(flops)}


def eval_compile_cost(params: Dict[str, Any],
                      context: Dict[str, Any]) -> dict:
    """Evaluate one (provider, config) candidate for the ``compile_cost``
    objective registry entry: trace under the candidate sharding, score
    by roofline step time.  The full report rides along
    in the payload so the autotuner's ``best_report`` is a store hit."""
    obj = _objective_for(params["arch"], params["shape"],
                         params.get("mesh", "pod"))
    t, report = obj.evaluate(params["provider"], dict(params["config"]))
    return {"value": float(t), "report": report}
