"""Rising Bandits (Li et al., AAAI 2020) adapted to multi-cloud configuration.

Arms = providers; one pull = one BO iteration (our GP + gp-hedge, mirroring
the paper's use of scikit-optimize defaults).  RB assumes each arm's
best-so-far curve has diminishing returns; after a warm-up it linearly
extrapolates the recent improvement slope to bound what an arm could still
reach, and eliminates an arm when even its optimistic bound cannot beat
another arm's pessimistic bound.  The paper notes (and our experiments
confirm) that this assumption does not translate perfectly to multi-cloud.

This closed-loop :meth:`RisingBandits.run` is the retained reference
implementation; the suspendable equivalent that yields evaluation
requests instead of calling the objective is
:class:`repro_torch.core.drivers.RisingBanditsDriver` (bit-identical histories,
enforced by ``tests/test_drivers.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.domain import Domain
from repro_torch.core.optimizers.base import History
from repro_torch.core.optimizers.bo import BO


class RisingBandits:
    def __init__(self, domain: Domain, *, seed: int = 0, warmup: int = 3,
                 slope_window: int = 3):
        self.domain = domain
        self.seed = seed
        self.warmup = warmup
        self.slope_window = slope_window

    def run(self, objective: Callable[[str, dict], float],
            budget: int) -> Tuple[str, dict, float, History]:
        rng = np.random.default_rng(self.seed)
        arms = list(self.domain.provider_names)
        opts: Dict[str, BO] = {
            k: BO(self.domain.inner_candidates(k),
                  self.domain.inner_encoder(k).encode,
                  seed=int(rng.integers(2 ** 31)),
                  surrogate="gp", acq="gp_hedge")
            for k in arms
        }
        curves: Dict[str, List[float]] = {k: [] for k in arms}
        active = list(arms)
        history = History()
        used = 0

        while used < budget:
            for k in list(active):
                if used >= budget:
                    break
                o = opts[k]
                idx = o.ask()
                cfg = o.candidates[idx]
                val = float(objective(k, cfg))
                o.tell(idx, val)
                history.append((k, cfg), val)
                used += 1
                curves[k].append(min(val, curves[k][-1]) if curves[k]
                                 else val)
            # elimination by extrapolated confidence bounds
            if len(active) > 1 and all(
                    len(curves[k]) >= self.warmup for k in active):
                remaining = budget - used
                lower: Dict[str, float] = {}
                current: Dict[str, float] = {}
                for k in active:
                    c = curves[k]
                    w = min(self.slope_window, len(c) - 1)
                    slope = (c[-1] - c[-1 - w]) / max(w, 1)  # ≤ 0
                    # optimistic achievable loss if the recent improvement
                    # rate continues for every remaining pull on this arm
                    lower[k] = c[-1] + slope * max(
                        remaining // max(len(active), 1), 1)
                    current[k] = c[-1]
                best_current = min(current.values())
                for k in list(active):
                    if len(active) > 1 and lower[k] > best_current:
                        active.remove(k)

        best_k = min(arms, key=lambda k: opts[k].best()[1]
                     if len(opts[k].history) else np.inf)
        cfg, loss = opts[best_k].best()
        return best_k, cfg, loss, history
