"""One decode step as a CUDA graph: the port's counterpart of the
reference servers' ``jax.jit`` around ``Model.decode_step``
(``repro/runtime/serve.py:65-66``, ``:183-185``).

A server's batch and cache length are fixed for its life, so one graph a
server covers every step.  :class:`StepGraph` runs ``Model.decode_step``
and the step's argmax on the server's cache:

* on the CPU, eagerly, as the caller asked;
* on the card, its first step warms up on a copy of the cache (cuBLAS's
  workspace, the decode kernel's library, scratch and counters, all on
  the capture stream), then captures the step on the real cache and
  replays it; every later step replays it.  The served cache is left as
  an eager step leaves it: the warm-up writes only the copy, and a
  capture runs nothing.

The step's inputs are static device buffers, token ``(B, 1)`` and pos
``(B,)`` or 0-d, both int32, filled from pinned host buffers before each
replay; the argmax is read back into a pinned buffer, the step's one host
sync (the reference's ``np.asarray(argmax)``).  Nothing may replace a
cache tensor once the graph holds its address: the servers update the
cache in place only.

A step that cannot be captured raises :class:`CaptureError` naming the op
that failed; nothing retries eagerly.  The kernel wrappers count their
launches as they launch (``COUNT``), which a replay does not: the
launches the capture recorded are taken back off the counts and added
again on each replay.  The warm-up's launches are real and stay counted.
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.distrib.logical import NOSHARD
from repro_torch.kernels import decode_attention, flash_attention, ssd_scan

_COUNTS = (decode_attention.COUNT, flash_attention.COUNT, ssd_scan.COUNT)


class CaptureError(RuntimeError):
    """A decode step that cannot be captured in a CUDA graph."""


def _counts() -> List[Dict[str, int]]:
    return [dataclasses.asdict(c) for c in _COUNTS]


def _add_counts(delta: List[Dict[str, int]], sign: int = 1) -> None:
    for c, d in zip(_COUNTS, delta):
        for key, n in d.items():
            setattr(c, key, getattr(c, key) + sign * n)


def _where(exc: BaseException) -> str:
    """The line that called the op that failed: the innermost frame of
    ``exc``'s traceback outside torch's own package."""
    frames = traceback.extract_tb(exc.__traceback__)
    torch_dir = os.path.dirname(torch.__file__) + os.sep
    ours = [f for f in frames if not f.filename.startswith(torch_dir)]
    if not (ours or frames):
        return "?"
    f = (ours or frames)[-1]
    return f"{os.path.basename(f.filename)}:{f.lineno} `{f.line}`"


class StepGraph:
    """``Model.decode_step`` plus its argmax at a fixed batch, on one
    cache, for one server.  ``per_slot`` takes ``pos`` as ``(B,)``, else
    as one shared position (a 0-d int32 tensor, as the reference's
    ``jnp.asarray(pos, jnp.int32)``).

    ``captures`` and ``replays`` count the graph's captures and replays;
    ``capture_s`` is the host seconds of the first step's warm-up and
    capture; ``pool_bytes`` is the device memory its pool reserved at
    capture;
    ``logits`` holds the last step's (B, V) f32 logits (on the card a
    static tensor that the next replay overwrites)."""

    def __init__(self, model, params, cache: Dict[str, torch.Tensor], opts,
                 *, batch: int, per_slot: bool, device: torch.device):
        self.model = model
        self.params = params
        self.cache = cache
        self.opts = opts
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.logits: Optional[torch.Tensor] = None
        if device.type != "cuda":
            return
        pos_shape = (batch,) if per_slot else ()
        pinned = dict(dtype=torch.int32, pin_memory=True)
        self._host = {"token": torch.zeros((batch, 1), **pinned),
                      "pos": torch.zeros(pos_shape, **pinned)}
        self._inputs = {k: torch.zeros_like(v, device=device)
                        for k, v in self._host.items()}
        self._out = torch.zeros(batch, dtype=torch.int64, pin_memory=True)
        self._argmax: Optional[torch.Tensor] = None
        self._stream = torch.cuda.Stream(device)
        self._launches: List[Dict[str, int]] = []

    def _decode(self, inputs, cache) -> torch.Tensor:
        return self.model.decode_step(self.params, inputs, cache, NOSHARD,
                                      self.opts)[0]

    def step(self, token: np.ndarray, pos) -> np.ndarray:
        """One decode step at ``token`` (B, 1) and ``pos`` ((B,) or an int)
        -> the greedy tokens (B,) as numpy."""
        if self.device.type != "cuda":
            self.logits = self._decode(
                {"token": torch.from_numpy(np.asarray(token, np.int32)),
                 "pos": torch.as_tensor(pos, dtype=torch.int32)},
                self.cache)
            return self.logits.argmax(dim=-1).numpy()
        with torch.cuda.device(self.device):
            for key, value in (("token", token), ("pos", pos)):
                self._host[key].numpy()[...] = value
                self._inputs[key].copy_(self._host[key], non_blocking=True)
            if self.graph is None:
                self._capture()
            self.replay()
            self._out.copy_(self._argmax, non_blocking=True)
            torch.cuda.current_stream().synchronize()
        return self._out.numpy().copy()

    def replay(self) -> None:
        """Replay the captured step on the inputs last copied in, on the
        current stream, counting its kernels' launches; no host sync."""
        self.graph.replay()
        self.replays += 1
        _add_counts(self._launches)

    def _capture(self) -> None:
        """Warm up on a copy of the cache, then capture the step on the
        cache itself, both on the capture stream."""
        t0 = time.perf_counter()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            spare = {k: v.clone() for k, v in self.cache.items()}
            self._decode(self._inputs, spare).argmax(dim=-1)
            del spare
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        failed: Optional[BaseException] = None
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="global"):
                try:
                    logits = self._decode(self._inputs, self.cache)
                    argmax = logits.argmax(dim=-1)
                except Exception as exc:   # noqa: BLE001 - re-raised below
                    failed = exc
        except Exception as exc:           # noqa: BLE001 - the capture's end
            failed = failed or exc
        self._launches = [{k: n - b[k] for k, n in a.items()}
                          for a, b in zip(_counts(), before)]
        _add_counts(self._launches, -1)
        if failed is not None:
            raise CaptureError(
                f"{self.model.cfg.name}: the decode step cannot be captured "
                f"in a CUDA graph at {_where(failed)}: {failed}") from failed
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.graph, self.logits, self._argmax = graph, logits, argmax
        self.captures += 1
        self.capture_s = time.perf_counter() - t0
