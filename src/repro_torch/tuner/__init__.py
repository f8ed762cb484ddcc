from repro_torch.tuner.strategies import sharding_domain
from repro_torch.tuner.objective import CompileCostObjective
from repro_torch.tuner.autotune import autotune, autotune_reference, autotune_search

__all__ = ["sharding_domain", "CompileCostObjective", "autotune",
           "autotune_reference", "autotune_search"]
