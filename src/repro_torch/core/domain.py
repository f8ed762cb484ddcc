"""Hierarchical selection-configuration domain (Eq. 1 of the paper);
a copy of ``repro/core/domain.py``, so that the port imports nothing from
``repro``.

The outer variable selects a *provider* k ∈ K (cloud provider in the paper;
parallelism-strategy family in the sharding autotuner); each provider has its
own categorical parameter space X^(k); *shared* parameters (cluster size n in
the paper; microbatch/remat in the tuner) are common to all providers.

Everything is finite and enumerable — the paper's spaces are 88 configs
total — so optimizers rank candidates instead of optimizing continuous
acquisitions.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

Config = Dict[str, Any]          # param name -> value
Point = Tuple[str, Config]       # (provider name, config incl shared params)


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    name: str
    values: Tuple[Any, ...]

    @property
    def numeric(self) -> bool:
        return all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in self.values)


@dataclasses.dataclass(frozen=True)
class ProviderSpace:
    name: str
    params: Tuple[ParamSpace, ...]


@dataclasses.dataclass(frozen=True)
class Domain:
    providers: Tuple[ProviderSpace, ...]
    shared: Tuple[ParamSpace, ...] = ()

    @property
    def provider_names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.providers)

    def provider(self, name: str) -> ProviderSpace:
        for p in self.providers:
            if p.name == name:
                return p
        raise KeyError(name)

    # ---------------- enumeration ----------------
    def inner_candidates(self, provider: str) -> List[Config]:
        p = self.provider(provider)
        spaces = list(p.params) + list(self.shared)
        names = [s.name for s in spaces]
        out = []
        for combo in itertools.product(*[s.values for s in spaces]):
            out.append(dict(zip(names, combo)))
        return out

    def all_candidates(self) -> List[Point]:
        out: List[Point] = []
        for p in self.providers:
            out.extend((p.name, c) for c in self.inner_candidates(p.name))
        return out

    def size(self) -> int:
        return len(self.all_candidates())

    # ---------------- encoders ----------------
    def inner_encoder(self, provider: str) -> "Encoder":
        p = self.provider(provider)
        return Encoder(tuple(p.params) + tuple(self.shared))

    def flat_encoder(self) -> "Encoder":
        """Flattened-domain encoding ('x1' adaptation): provider choice +
        shared params + the union of every provider's params (inactive
        params encoded as NA) — exactly the structure the paper criticises.
        """
        spaces: List[ParamSpace] = [
            ParamSpace("provider", self.provider_names)]
        spaces.extend(self.shared)
        for p in self.providers:
            for s in p.params:
                spaces.append(ParamSpace(f"{p.name}.{s.name}", s.values))
        return Encoder(tuple(spaces), hierarchical_names=True)


@dataclasses.dataclass(frozen=True)
class Encoder:
    """Mixed numeric / one-hot feature encoding over a finite space.

    Numeric params are min-max scaled; categoricals are one-hot.  Missing
    (inactive) params encode as all-zeros one-hot / -1 numeric — the SMAC
    convention for conditional parameters.

    Per-space lookup state (min/max bounds, value→column tables, feature
    offsets) is precomputed once at construction, so :meth:`encode` does
    dict lookups instead of linear ``values.index`` scans and min/max
    passes per call, and :meth:`encode_many` fills the feature matrix
    with vectorized column assignments.  Both are bit-identical to the
    retained scalar :meth:`encode_reference`
    (``tests/test_domain.py``).
    """
    spaces: Tuple[ParamSpace, ...]
    hierarchical_names: bool = False

    def __post_init__(self) -> None:
        # frozen dataclass: stash derived lookup tables via
        # object.__setattr__; they are pure functions of `spaces`, so
        # eq/hash (field-based) stay consistent
        specs = []
        offset = 0
        for s in self.spaces:
            if s.numeric:
                lo, hi = min(s.values), max(s.values)
                specs.append((s.name, True, offset, lo, hi, None))
                offset += 1
            else:
                index: Optional[Dict[Any, int]] = {}
                try:
                    for i, v in enumerate(s.values):
                        index.setdefault(v, i)  # first match, like .index
                except TypeError:               # unhashable values: fall
                    index = None                # back to the linear scan
                specs.append((s.name, False, offset, None, None, index))
                offset += len(s.values)
        object.__setattr__(self, "_specs", tuple(specs))
        object.__setattr__(self, "_dim", offset)

    @property
    def dim(self) -> int:
        return self._dim

    def _as_config(self, point_or_config) -> dict:
        """Normalize an input (point tuple or config dict) to the flat
        name→value dict the per-space lookups read from."""
        if isinstance(point_or_config, tuple):
            provider, config = point_or_config
            cfg = dict(config)
            cfg["provider"] = provider
            if self.hierarchical_names:
                for k, v in config.items():
                    cfg[k] = v                  # shared names stay as-is
                    cfg[f"{provider}.{k}"] = v  # provider-local prefixed
        else:
            cfg = dict(point_or_config)
        return cfg

    def _lookup(self, index: Optional[Dict[Any, int]], space: ParamSpace,
                val) -> Optional[int]:
        if index is not None:
            try:
                return index.get(val)
            except TypeError:
                pass        # unhashable query value: scan like reference
        return space.values.index(val) if val in space.values else None

    def encode(self, point_or_config) -> np.ndarray:
        cfg = self._as_config(point_or_config)
        out = np.zeros(self._dim, dtype=np.float64)
        for (name, numeric, off, lo, hi, index), s in zip(self._specs,
                                                          self.spaces):
            val = cfg.get(name, None)
            if numeric:
                if val is None:
                    out[off] = -1.0
                elif hi > lo:
                    out[off] = (float(val) - lo) / (hi - lo)
                # else: degenerate single-value space stays 0.0
            elif val is not None:
                i = self._lookup(index, s, val)
                if i is not None:
                    out[off + i] = 1.0
        return out

    def encode_many(self, items: Sequence) -> np.ndarray:
        """Vectorized batch encode: one column assignment per space
        instead of one row vector per item."""
        cfgs = [self._as_config(it) for it in items]
        out = np.zeros((len(cfgs), self._dim), dtype=np.float64)
        for (name, numeric, off, lo, hi, index), s in zip(self._specs,
                                                          self.spaces):
            vals = [cfg.get(name, None) for cfg in cfgs]
            if numeric:
                missing = np.fromiter((v is None for v in vals), dtype=bool,
                                      count=len(vals))
                if hi > lo:
                    raw = np.fromiter(
                        (0.0 if v is None else float(v) for v in vals),
                        dtype=np.float64, count=len(vals))
                    out[:, off] = (raw - lo) / (hi - lo)
                out[missing, off] = -1.0
            else:
                rows, cols = [], []
                for r, val in enumerate(vals):
                    if val is None:
                        continue
                    i = self._lookup(index, s, val)
                    if i is not None:
                        rows.append(r)
                        cols.append(off + i)
                out[rows, cols] = 1.0
        return out

    def encode_reference(self, point_or_config) -> np.ndarray:
        """Pre-optimization scalar implementation (linear value scans,
        per-call min/max), retained as the bit-identity ground truth."""
        if isinstance(point_or_config, tuple):
            provider, config = point_or_config
            cfg = dict(config)
            cfg["provider"] = provider
            if self.hierarchical_names:
                prefixed = {}
                for k, v in config.items():
                    prefixed[k] = v                       # shared names stay
                    prefixed[f"{provider}.{k}"] = v       # provider-local
                cfg.update(prefixed)
        else:
            cfg = dict(point_or_config)
        feats: List[float] = []
        for s in self.spaces:
            val = cfg.get(s.name, None)
            if s.numeric:
                if val is None:
                    feats.append(-1.0)
                else:
                    lo, hi = min(s.values), max(s.values)
                    feats.append((float(val) - lo) / (hi - lo) if hi > lo
                                 else 0.0)
            else:
                onehot = [0.0] * len(s.values)
                if val is not None and val in s.values:
                    onehot[s.values.index(val)] = 1.0
                feats.extend(onehot)
        return np.asarray(feats, dtype=np.float64)
