"""The sharding-autotuner search domain — Eq. 1 instantiated for device
meshes (copy of ``repro/tuner/strategies.py``).

Outer selection ("provider" in the paper): the parallelism-strategy family.
Inner configuration ("VM type"): per-family knobs (remat policy, attention
chunking).  Shared parameter (the paper's cluster-size `n`): the
cross-entropy chunk, which is family-independent exactly like node count is
provider-independent.

The domain adapts to the workload: serve shapes drop training-only arms,
attention-free (SSM) archs drop attention-chunk knobs (DESIGN.md §6).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.domain import Domain, ParamSpace, ProviderSpace


def sharding_domain(cfg: ArchConfig, shape: ShapeSpec) -> Domain:
    # value order matters: index 0 of each space is the incumbent/default
    # configuration (model-based BBOs seed it first — SMAC-style)
    remat = ParamSpace("remat", ("full", "dots", "none"))
    attn = ParamSpace("attn_chunk", (512, 256, 1024))
    banded = ParamSpace("banded_local", (False, True)) \
        if cfg.sliding_window else None

    def params(*extra):
        out = []
        if shape.kind == "train":
            out.append(remat)
        if cfg.has_attention:
            out.append(attn)
            if banded is not None:
                out.append(banded)
        out.extend(e for e in extra if e is not None)
        return tuple(out)

    providers = [
        ProviderSpace("fsdp_tp", params()),
        ProviderSpace("fsdp_tp_nosp", params()),
    ]
    if shape.kind == "train":
        # pure-DP arm needs the global batch to split across every chip and
        # conflicts with expert parallelism (EP owns the 'model' axis)
        if cfg.n_experts == 0:
            providers.append(ProviderSpace("fsdp_dp", params()))
        providers.append(ProviderSpace("ddp_tp", params()))
    else:
        providers.append(ProviderSpace("tp_serve", params()))

    shared = (ParamSpace("ce_chunk", (1024, 512, 2048)),) \
        if shape.kind == "train" else ()
    return Domain(providers=tuple(providers), shared=shared)
