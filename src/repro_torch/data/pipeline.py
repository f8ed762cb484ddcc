"""Deterministic synthetic data pipeline (port of
``repro/data/pipeline.py``).

``SyntheticLMData`` is the reference's, line for line and in numpy, so its
batches are bit-equal to the reference's: an order-2 integer recurrence
with seeded noise, a pure function of (seed, step), which makes
checkpoint/restart exact with no iterator state to persist.
``make_batch_iterator`` moves each batch to a device, or places each field
under its DTensor placements on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.distrib.logical import place


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    family: str = "dense"          # audio/vlm need extra stub inputs
    frame_dim: int = 0
    n_image_tokens: int = 0
    d_model: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # corpus-level recurrence coefficients (fixed by the data seed, not
        # per sequence): a learnable trigram-like structure
        crng = np.random.default_rng(np.random.SeedSequence([self.seed]))
        a = np.full((B, 1), int(crng.integers(2, 8)))
        b = np.full((B, 1), int(crng.integers(1, max(V - 1, 2))))
        x = np.empty((B, S + 1), np.int64)
        x[:, 0] = rng.integers(0, V, size=B)
        x[:, 1] = rng.integers(0, V, size=B)
        for t in range(2, S + 1):
            x[:, t] = (a[:, 0] * x[:, t - 1] + x[:, t - 2] + b[:, 0]) % V
        # noise makes 10% of targets unpredictable
        noise = rng.random((B, S + 1)) < 0.1
        x = np.where(noise, rng.integers(0, V, size=(B, S + 1)), x)
        batch: Dict[str, np.ndarray] = {
            "tokens": x[:, :S].astype(np.int32),
            "labels": x[:, 1:].astype(np.int32),
        }
        if self.family == "audio":
            batch = {
                "frames": rng.standard_normal(
                    (B, S, self.frame_dim)).astype(np.float32),
                "labels": (x[:, 1:] % min(self.vocab, 504)).astype(np.int32),
            }
        elif self.family == "vlm":
            batch["image_embeds"] = rng.standard_normal(
                (B, self.n_image_tokens, self.d_model)).astype(np.float32)
        return batch

    def host_shard(self, batch: Dict[str, np.ndarray], host: int,
                   n_hosts: int) -> Dict[str, np.ndarray]:
        """Per-host slice along the batch dim (multi-host data loading)."""
        B = self.global_batch
        if B % n_hosts:
            raise ValueError(f"global batch {B} does not split over "
                             f"{n_hosts} hosts")
        lo = host * (B // n_hosts)
        hi = lo + B // n_hosts
        return {k: v[lo:hi] for k, v in batch.items()}


def to_device(batch: Dict[str, np.ndarray], device: Any
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``, dtypes kept."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def place_batch(batch: Dict[str, np.ndarray], device: Any,
                shardings: Optional[dict] = None, mesh: Any = None
                ) -> Dict[str, Any]:
    """``to_device``, then each field ``k`` placed on ``mesh`` under
    ``shardings.get(k)``'s placements (a field with none stays a plain
    tensor), as ``pipeline.py:77`` puts each under its sharding.  Every
    rank holds the whole batch and keeps its own shard: no collective."""
    out = to_device(batch, device)
    if shardings is None:
        return out
    if mesh is None:
        raise ValueError("placements need the mesh they lie on")
    return {k: place(v, shardings.get(k), mesh) for k, v in out.items()}


def make_batch_iterator(data: SyntheticLMData, start_step: int = 0,
                        device: Any = "cpu", shardings: Optional[dict] = None,
                        mesh: Any = None) -> Iterator[Dict[str, Any]]:
    """Batches from ``start_step`` on, each moved to ``device`` and, with
    ``shardings``, placed on ``mesh`` (``pipeline.py:72``)."""
    step = start_step
    while True:
        yield place_batch(data.batch_at(step), device, shardings, mesh)
        step += 1
