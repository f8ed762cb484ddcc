"""Vectorized BO surrogates over the fixed finite candidate grid.

Every model-based search method in this repo (CherryPick-style GP/EI,
Bilal-style RF/PI, SMAC-like RF/EI, gp-hedge) refits its surrogate on every
``ask()`` against at most the 88 encoded configurations the domain
enumerates up front.  This package exploits that structure:

* :mod:`repro_torch.core.surrogates.rf` — random forests with a vectorized
  (argsort + prefix/suffix-sum SSE) split search and fitted trees flattened
  into contiguous ``(feature, thresh, left, right, value)`` arrays so
  ``predict`` is a batched descent over all query rows and all trees at
  once.
* :mod:`repro_torch.core.surrogates.gp` — Matern-5/2 GP that computes the
  pairwise squared-distance matrix once per fit, shares it across the
  lengthscale MLL grid via a stacked ``(g, n, n)`` Cholesky, and accepts a
  precomputed candidate-grid distance matrix (see :func:`grid_sqdist`) so
  BO fits reduce to indexing + Cholesky.
* :mod:`repro_torch.core.surrogates.reference` — the verbatim pre-vectorization
  implementations, retained as the bit-identity ground truth (mirroring the
  ``build_dataset_reference`` pattern) and exercised by
  ``tests/test_surrogates.py`` and ``benchmarks/surrogates.py``.
"""
from repro_torch.core.surrogates.gp import GP, grid_sqdist, matern52, pairwise_sqdist
from repro_torch.core.surrogates.reference import GPReference, RandomForestReference
from repro_torch.core.surrogates.rf import RandomForest

__all__ = [
    "GP", "RandomForest", "GPReference", "RandomForestReference",
    "grid_sqdist", "matern52", "pairwise_sqdist",
]
