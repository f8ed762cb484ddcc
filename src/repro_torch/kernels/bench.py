"""Kernel config-space domain and timing harness (port of
``repro/kernels/bench.py``).

The port's own kernels as a search problem: the block sizes of
``flash_attention``, ``decode_attention`` and ``ssd_scan`` form a
hierarchical :class:`~repro_torch.core.domain.Domain` (one provider per
kernel), scored by the two rungs of the ``kernel`` fidelity ladder:

``eval_kernel_analytic`` (rung 0)
    The reference's grid-step cost sketch, kept verbatim so that both
    packages score a candidate alike.  It models the TPU emulator's
    per-grid-step overhead, not a GPU; how well it ranks the candidates on
    the card is measured by ``chip_smoke.py``.
``eval_kernel_time`` (top rung)
    The candidate's measured time in microseconds, via :func:`time_fn`:
    device time from CUDA events on the card, ``time.perf_counter`` on the
    CPU (where the wrappers run their plain versions).  The plain
    version's time rides along as ``ratio`` and the max error against the
    oracle as ``maxerr``.

Both keep the reference's ``(params, context) -> dict`` signature and
payload.  ``params["device"]`` picks the device (absent: ``cuda``).
Shapes are named presets, as in the reference.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.domain import Domain, ParamSpace, ProviderSpace
from repro_torch.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


#: device cycles the card spins before each timed rep (about 1 ms), so
#: that the host has queued the rep's launches before the start event runs
_SPIN_CYCLES = 2_000_000


def time_fn(fn, *args, reps: int = 5) -> float:
    """Median time of ``fn(*args)`` in microseconds.

    One warm-up call, synchronised before any timer starts; each rep is
    timed on its own: on the card with a pair of CUDA events, on the CPU
    with the monotonic ``time.perf_counter`` (never ``time.time``).  On
    the card each rep's events and launches are queued behind a spin of
    ``_SPIN_CYCLES``, so the events read device time: a kernel of a few
    microseconds would otherwise be timed as the wrapper's host-side
    work, which is the same for every block size.  The median, not the
    mean, so one hiccup cannot skew the result; with an even count, the
    mean of the middle two.
    """
    device = _device_of(args)
    fn(*args)
    _sync(device)
    times = []
    for _ in range(int(reps)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SPIN_CYCLES)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            _sync(device)
            times.append(time.perf_counter() - t0)
    times.sort()
    n = len(times)
    mid = n // 2
    med = times[mid] if n % 2 else 0.5 * (times[mid - 1] + times[mid])
    return med * 1e6


#: preset -> per-kernel shape tuples (the reference's values).  All
#: sequence lengths are powers of two so every block size divides them.
PRESETS: Dict[str, Dict[str, Tuple[int, ...]]] = {
    # flash: (B, Hq, Hkv, S, D); decode: (B, Hq, Hkv, S, D, length);
    # ssd: (B, L, H, P, N)
    "tiny": {
        "flash_attention": (1, 2, 1, 128, 32),
        "decode_attention": (1, 2, 1, 256, 32, 200),
        "ssd_scan": (1, 128, 1, 16, 16),
    },
    "small": {
        "flash_attention": (1, 4, 2, 256, 64),
        "decode_attention": (1, 4, 2, 1024, 64, 1000),
        "ssd_scan": (1, 256, 2, 32, 32),
    },
}

#: per-preset block-size values; index 0 is the incumbent/default
_BLOCKS: Dict[str, Dict[str, Tuple[int, ...]]] = {
    "tiny": {
        "flash": (128, 64, 32),
        "decode": (256, 128, 64),
        "ssd": (128, 64, 32),
    },
    "small": {
        "flash": (128, 256, 64),
        "decode": (512, 256, 128),
        "ssd": (128, 64, 32),
    },
}


def kernel_domain(preset: str = "small") -> Domain:
    """The kernel autotuning search space for one shape preset: one
    provider per kernel, block sizes as categorical parameters."""
    if preset not in PRESETS:
        raise KeyError(
            f"unknown kernel preset {preset!r}; knows {sorted(PRESETS)}")
    blocks = _BLOCKS[preset]
    return Domain(providers=(
        ProviderSpace("flash_attention", (
            ParamSpace("bq", blocks["flash"]),
            ParamSpace("bk", blocks["flash"]))),
        ProviderSpace("decode_attention", (
            ParamSpace("bk", blocks["decode"]),)),
        ProviderSpace("ssd_scan", (
            ParamSpace("chunk", blocks["ssd"]),)),
    ))


@functools.lru_cache(maxsize=None)
def _inputs(provider: str, preset: str, device: str = "cpu"):
    """Kernel inputs per (provider, preset), all float32, from a
    ``torch.Generator`` seeded with 0 (on the CPU, then moved, so every
    device sees the same values); built once per process."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float32)
    shape = PRESETS[preset][provider]
    if provider == "flash_attention":
        B, Hq, Hkv, S, D = shape
        out = (randn(B, Hq, S, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D))
    elif provider == "decode_attention":
        B, Hq, Hkv, S, D, _length = shape
        out = (randn(B, Hq, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D))
    elif provider == "ssd_scan":
        B, L, H, P, N = shape
        out = (randn(B, L, H, P) * 0.5,
               torch.nn.functional.softplus(randn(B, L, H)) * 0.5,
               -torch.exp(randn(H) * 0.3),
               randn(B, L, N) * 0.3,
               randn(B, L, N) * 0.3,
               torch.ones(H))
    else:
        raise KeyError(f"unknown kernel provider {provider!r}")
    return tuple(t.to(device) for t in out)


def _decode_length(preset: str, device: str) -> torch.Tensor:
    """The decode preset's scalar length for each sequence, placed on the
    device once (a Python int would be copied there on every call)."""
    shape = PRESETS[preset]["decode_attention"]
    return torch.full((shape[0],), shape[5], dtype=torch.int32,
                      device=device)


def _kernel_fn(provider: str, preset: str, config: Dict[str, Any],
               device: str = "cpu"):
    """(callable, args) for one candidate, through the port's ``ops``."""
    from repro_torch.kernels import ops
    args = _inputs(provider, preset, device)
    if provider == "flash_attention":
        bq, bk = int(config["bq"]), int(config["bk"])
        return (lambda q, k, v: ops.flash_attention(
            q, k, v, causal=True, bq=bq, bk=bk)), args
    if provider == "decode_attention":
        bk = int(config["bk"])
        ln = _decode_length(preset, device)
        return (lambda q, k, v: ops.decode_attention(
            q, k, v, ln, bk=bk)), args
    if provider == "ssd_scan":
        chunk = int(config["chunk"])
        return (lambda *a: ops.ssd(*a, chunk=chunk)[0]), args
    raise KeyError(f"unknown kernel provider {provider!r}")


def _oracle_fn(provider: str, preset: str, device: str = "cpu"):
    """The plain torch oracle of one provider (``kernels/ref.py``)."""
    from repro_torch.kernels.ref import decode_mha_ref, mha_ref, ssd_ref
    if provider == "flash_attention":
        return lambda q, k, v: mha_ref(q, k, v, causal=True)
    if provider == "decode_attention":
        ln = _decode_length(preset, device)
        return lambda q, k, v: decode_mha_ref(q, k, v, length=ln)
    if provider == "ssd_scan":
        return lambda *a: ssd_ref(*a, chunk=128)[0]
    raise KeyError(f"unknown kernel provider {provider!r}")


@functools.lru_cache(maxsize=None)
def _ref_us(provider: str, preset: str, reps: int,
            device: str = "cpu") -> float:
    """The plain oracle's time, measured once per process and device."""
    return time_fn(_oracle_fn(provider, preset, device),
                   *_inputs(provider, preset, device), reps=reps)


def grid_steps(provider: str, preset: str, config: Dict[str, Any]) -> int:
    """Number of pallas grid steps one candidate launches — the
    quantity interpret-mode wall time is proportional to."""
    shape = PRESETS[preset][provider]
    if provider == "flash_attention":
        B, Hq, _Hkv, S, _D = shape
        return B * Hq * (S // int(config["bq"])) * (S // int(config["bk"]))
    if provider == "decode_attention":
        B, Hq, _Hkv, S, _D, _length = shape
        return B * Hq * (S // int(config["bk"]))
    if provider == "ssd_scan":
        B, L, H, _P, _N = shape
        return B * H * (L // int(config["chunk"]))
    raise KeyError(f"unknown kernel provider {provider!r}")


#: interpreter overhead per grid step, measured in block-elements of
#: useful work — the single constant the analytic rung trades against
_STEP_OVERHEAD_ELEMS = 4096.0

#: nominal interpreter throughput scaling the analytic element count
#: to microseconds — only the *scale* of the low rung, never its
#: ranking, so precision is irrelevant (prefilters recalibrate anyway)
_ELEMS_PER_US = 64.0


def _work_elems(provider: str, preset: str) -> float:
    """Total elements of useful work, block-shape independent."""
    shape = PRESETS[preset][provider]
    if provider == "flash_attention":
        B, Hq, _Hkv, S, _D = shape
        return float(B * Hq * S * S)
    if provider == "decode_attention":
        B, Hq, _Hkv, S, D, _length = shape
        return float(B * Hq * S * D)
    if provider == "ssd_scan":
        B, L, _H, P, N = shape
        return float(B * L * (P + N))
    raise KeyError(f"unknown kernel provider {provider!r}")


def eval_kernel_analytic(params: Dict[str, Any],
                         context: Dict[str, Any]) -> dict:
    """Rung 0 of the kernel ladder: estimated interpret-mode wall time
    ``(work + overhead·steps) / throughput`` microseconds — no
    execution, deterministic.  Absolute (work included), not
    per-element: a relative score would erase the real cross-kernel
    cost differences the search must rank."""
    provider, preset = params["provider"], params["preset"]
    config = dict(params["config"])
    steps = grid_steps(provider, preset, config)
    work = _work_elems(provider, preset)
    value = (work + _STEP_OVERHEAD_ELEMS * steps) / _ELEMS_PER_US
    return {"value": float(value), "grid_steps": int(steps)}


def eval_kernel_time(params: Dict[str, Any],
                     context: Dict[str, Any]) -> dict:
    """Top rung of the kernel ladder: the candidate's measured time in
    microseconds, the plain oracle's time and their ratio (a diagnostic,
    not the value), and the max |err| against the oracle (a fast but
    wrong block shape must be visible).  ``params["device"]`` picks the
    device, absent meaning ``cuda``; the objective registry's units always
    carry it, so it is part of their identity; tests pass ``"cpu"``."""
    device = str(resolve_device(params.get("device")))
    provider, preset = params["provider"], params["preset"]
    reps = int(params.get("reps", 5))
    config = dict(params["config"])
    with torch.no_grad():
        fn, args = _kernel_fn(provider, preset, config, device)
        kernel_us = time_fn(fn, *args, reps=reps)
        ref_us = _ref_us(provider, preset, reps, device)
        oracle = _oracle_fn(provider, preset, device)(*args)
        maxerr = float((fn(*args).float() - oracle.float()).abs().max())
    return {"value": float(kernel_us),
            "kernel_us": float(kernel_us), "ref_us": float(ref_us),
            "ratio": float(kernel_us / ref_us), "maxerr": maxerr}
