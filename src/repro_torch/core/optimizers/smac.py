"""SMAC-style sequential model-based optimization.

RF surrogate with EI, over the *hierarchical* encoding: provider one-hot +
shared params + per-provider conditional params (inactive ones encoded as
NA), which is how SMAC models conditional configuration spaces — the
property the paper credits for its strong multi-cloud results.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.optimizers.bo import BO


class SMACLike(BO):
    def __init__(self, candidates, encode, seed: int = 0, n_init: int = 3):
        super().__init__(candidates, encode, seed,
                         surrogate="rf", acq="ei", n_init=n_init)
