from repro_torch.core.optimizers.base import BlackBoxOptimizer, History
from repro_torch.core.optimizers.random_search import (
    RandomSearch, CoordinateDescent, ExhaustiveSearch)
from repro_torch.core.optimizers.bo import BO, cherrypick, bilal
from repro_torch.core.optimizers.smac import SMACLike
from repro_torch.core.optimizers.tpe import TPE
from repro_torch.core.optimizers.rbfopt import RBFOpt

__all__ = [
    "BlackBoxOptimizer", "History", "RandomSearch", "CoordinateDescent",
    "ExhaustiveSearch", "BO", "cherrypick", "bilal", "SMACLike", "TPE",
    "RBFOpt",
]
