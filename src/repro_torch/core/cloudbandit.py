"""CloudBandit (Algorithm 1 of the paper).

Best-arm identification over providers: each arm pull runs ONE iteration of
an arbitrary component black-box optimizer on that provider's inner
configuration problem.  Each round pulls every active arm b_m times,
eliminates the arm whose best-found loss is worst, and grows the budget
multiplicatively (b_{m+1} = η · b_m), so surviving providers get
exponentially more search.

Total budget: B = Σ_{m=1..K} (K − m + 1) · b1 · η^(m−1)
(K = 3, η = 2  ⇒  B = 11 · b1 — the paper's budget grid 11, 22, …, 88).

This closed-loop :meth:`CloudBandit.run` is the retained reference
implementation; the suspendable equivalent that yields each round's arm
pulls as evaluation-request batches is
:class:`repro_torch.core.drivers.CloudBanditDriver` (bit-identical histories,
enforced by ``tests/test_drivers.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.domain import Domain
from repro_torch.core.optimizers.base import BlackBoxOptimizer, History

# factory: (candidates, encode, seed) -> BlackBoxOptimizer
BBOFactory = Callable[..., BlackBoxOptimizer]


def total_budget(K: int, b1: int, eta: float = 2.0) -> int:
    return int(sum((K - m + 1) * b1 * eta ** (m - 1) for m in range(1, K + 1)))


def b1_for_budget(B: int, K: int, eta: float = 2.0) -> int:
    """Largest b1 whose total budget does not exceed B."""
    b1 = 1
    while total_budget(K, b1 + 1, eta) <= B:
        b1 += 1
    if total_budget(K, b1, eta) > B:
        raise ValueError(f"budget {B} below minimum {total_budget(K, 1, eta)}")
    return b1


@dataclasses.dataclass
class CloudBanditResult:
    provider: str                     # k*
    config: Any                       # p_{k*}
    loss: float
    history: History                  # global evaluation order
    eliminated: List[Tuple[str, int]]  # (provider, round) in elimination order
    pulls: Dict[str, int]


class CloudBandit:
    def __init__(self, domain: Domain, bbo_factory: BBOFactory, *,
                 b1: int = 1, eta: float = 2.0, seed: int = 0):
        self.domain = domain
        self.bbo_factory = bbo_factory
        self.b1 = b1
        self.eta = eta
        self.seed = seed

    def run(self, objective: Callable[[str, dict], float]) -> CloudBanditResult:
        """objective(provider, config) -> loss (runtime or cost)."""
        rng = np.random.default_rng(self.seed)
        arms = list(self.domain.provider_names)
        K = len(arms)
        opts: Dict[str, BlackBoxOptimizer] = {}
        for i, k in enumerate(arms):
            cands = self.domain.inner_candidates(k)
            enc = self.domain.inner_encoder(k)
            opts[k] = self.bbo_factory(
                cands, enc.encode, seed=int(rng.integers(2 ** 31)))

        active = list(arms)
        history = History()
        eliminated: List[Tuple[str, int]] = []
        pulls = {k: 0 for k in arms}
        best: Dict[str, Tuple[Any, float]] = {}

        b_m = self.b1
        for m in range(1, K + 1):
            for k in list(active):
                for _ in range(b_m):
                    o = opts[k]
                    idx = o.ask()
                    cfg = o.candidates[idx]
                    val = float(objective(k, cfg))
                    o.tell(idx, val)
                    history.append((k, cfg), val)
                    pulls[k] += 1
                best[k] = opts[k].best()
            if len(active) > 1:
                worst = max(active, key=lambda k: best[k][1])
                active.remove(worst)
                eliminated.append((worst, m))
            b_m = int(round(self.eta * b_m))

        k_star = min(active, key=lambda k: best[k][1])
        cfg_star, loss_star = best[k_star]
        return CloudBanditResult(
            provider=k_star, config=cfg_star, loss=loss_star,
            history=history, eliminated=eliminated, pulls=pulls)
