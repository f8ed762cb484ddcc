"""Flash-decode: one query token per sequence against its KV cache.

Port of the Pallas TPU kernel ``repro/kernels/decode_attention.py:59``
(``decode_attention``; body ``_kernel`` at ``:23``).  The kernel is
hand-written CUDA C++ for ``sm_90a`` in ``csrc/decode_attention.cu``,
built with ``nvcc`` at first use and bound with ``ctypes``: one launch a
call, its combine included.

:func:`decode_attention` takes the reference's layout: q ``(B,Hq,D)``,
k and v ``(B,Hkv,S,D)``, ``length`` a scalar or ``(B,)``; it returns
``(B,Hq,D)`` in q's dtype.  k and v may be any strided view whose last
dimension is contiguous, such as ``cache.transpose(1, 2)`` of the model's
``(B,S,Hkv,D)`` cache, so the model passes its cache without a copy.

The keys of each (b, kv head) are cut into ranges of a key budget, one
block each; blocks past a slot's length return at once (:func:`plan`).
``bk=None`` (the serving path) lets the wrapper choose the budget from
the card's SM count, and then ``S`` need not be a multiple of anything.
An int ``bk`` follows the reference: ``bk = min(bk, S)``, ``S % bk == 0``
or ``ValueError``, and each range covers ``bk`` keys.  The kernel search
domain (``kernels/bench.py``) searches exactly this ``bk``.
:func:`decode_split_ref` is that partition in plain torch.

The kernel has instances for the head dims in ``HEAD_DIMS``; on the card
any other D raises.  On CPU tensors it runs :func:`decode_attention_plain`
at any D and counts that in ``COUNT.plain``; on CUDA tensors it launches
the kernel (``COUNT.launches``) or raises.

The wrapper may run under a CUDA graph's capture (the servers' decode
step, ``runtime/graph.py``): its launch goes on the capture stream, its
length must be a device tensor, and its scratch must exist on that
stream before the capture.  A captured launch counts once, at capture;
``StepGraph`` moves that count onto each replay.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)   # the kernel's, on the card
MAX_HEADS = 8          # query heads one block holds; more run in groups
WAVES = 4              # block waves a full-length cache fills
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = 1.4426950408889634


@dataclasses.dataclass
class LaunchCount:
    launches: int = 0        # kernel launches, on CUDA tensors
    plain: int = 0           # plain-version calls, on CPU tensors

    def reset(self) -> None:
        self.launches = 0
        self.plain = 0


COUNT = LaunchCount()


def _lengths(length, B: int, device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and not isinstance(length, torch.Tensor) \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("decode_attention: a host length would be baked "
                           "into the CUDA graph being captured; pass it as "
                           "a device tensor")
    ln = torch.as_tensor(length, device=device).to(torch.int32)
    return ln.reshape(-1).expand(B).contiguous()


def decode_attention_plain(q, k, v, length) -> torch.Tensor:
    """The kernel's function in plain torch: f32 scores and softmax,
    masked with the finite NEG_INF, divided by ``max(l, 1e-30)``.
    ``length == 0`` gives the mean of v over all S, as in the reference."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    G = Hq // Hkv
    ln = _lengths(length, B, q.device)
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * (1.0 / math.sqrt(D))
    kpos = torch.arange(S, device=q.device)
    s = torch.where(kpos[None, None, None, :] < ln[:, None, None, None],
                    s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v.float()) / l.clamp_min(1e-30)
    return o.reshape(B, Hq, D).to(q.dtype)


def decode_split_ref(q, k, v, length, keys: int) -> torch.Tensor:
    """The kernel's partition in plain torch, for tests and the chip
    check (never on the main path): ranges of ``keys`` keys; a range at or
    past ``n = min(length, S)`` (all S where ``length <= 0``) does not run;
    each range that runs takes its own softmax in base 2 (scores scaled
    by log2(e) / sqrt(D), as the kernel's q is), and the ranges are
    merged by log-sum-exp and divided by ``max(l, 1e-30)``."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    G = Hq // Hkv
    ln = _lengths(length, B, q.device).long()
    n = torch.where(ln <= 0, S, ln.clamp(max=S))                 # (B,)
    qg = q.float().reshape(B, Hkv, G, D) * (_LOG2E / math.sqrt(D))
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
    s = torch.where((ln <= 0)[:, None, None, None], NEG_INF, s)
    kpos = torch.arange(S, device=q.device)
    ms, ls, accs, runs = [], [], [], []
    for lo in range(0, S, keys):
        hi = min(S, lo + keys)
        keep = (kpos[lo:hi][None, :] < n[:, None])[:, None, None, :]
        sr = torch.where(keep, s[..., lo:hi], -math.inf)
        run = (lo < n)[:, None, None]                            # (B,1,1)
        m = torch.where(run, sr.amax(dim=-1), 0.0)               # (B,Hkv,G)
        p = torch.exp2(sr - m[..., None])
        ms.append(torch.where(run, m, -math.inf))
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgs,bhsd->bhgd", p, v[:, :, lo:hi].float()))
        runs.append(run)
    m = torch.stack(ms)                                          # (R,B,Hkv,G)
    w = torch.where(torch.stack(runs), torch.exp2(m - m.amax(dim=0)), 0.0)
    L = (torch.stack(ls) * w).sum(dim=0)
    A = (torch.stack(accs) * w[..., None]).sum(dim=0)
    return (A / L.clamp_min(1e-30)[..., None]).reshape(B, Hq, D).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ``ranges`` ranges of ``keys`` keys per (b, kv head),
    blocks of ``heads`` query heads (the instance), ``groups`` of them per
    kv head; the grid is (ranges, Hkv * groups, B)."""
    keys: int
    ranges: int
    heads: int
    groups: int
    grid: Tuple[int, int, int]
    part_floats: int     # f32 partials (m, l, acc) of every range; 0 if one
    counters: int        # int32 counters, one per (b, kv head, group)


def _heads(G: int) -> int:
    """The instance for G query heads per kv head: 1, 2, 4 or 8 heads a
    block."""
    return MAX_HEADS if G > MAX_HEADS else 1 << (G - 1).bit_length()


def plan(B: int, Hkv: int, G: int, S: int, D: int, *,
         bk: Optional[int] = None, sms: int, round_keys: int,
         resident: int) -> Plan:
    """The launch of one call.  ``bk`` (already checked by ``_block``) is
    the key budget as it is; else the budget is cut so that a full-length
    cache fills ``WAVES`` waves of ``sms`` SMs holding ``resident`` blocks
    each, in multiples of ``round_keys`` (the keys one block round
    reads)."""
    heads = _heads(G)
    groups = -(-G // heads)
    if bk is None:
        ranges = max(1, WAVES * sms * resident // (B * Hkv * groups))
        keys = -(-S // ranges)
        keys = -(-keys // round_keys) * round_keys
    else:
        keys = bk
    ranges = -(-S // keys)
    return Plan(keys=keys, ranges=ranges, heads=heads, groups=groups,
                grid=(ranges, Hkv * groups, B),
                part_floats=B * Hkv * ranges * G * (D + 2) if ranges > 1
                else 0,
                counters=B * Hkv * groups)


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("decode_attention")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.decode_attention_launch.argtypes = (
            [i, i, i] + [p] * 7 + [i] * 8 + [i64] * 8 + [ctypes.c_float, p])
        lib.decode_attention_launch.restype = i
        lib.decode_attention_info.argtypes = [i, i, i, i]
        lib.decode_attention_info.restype = i
        _lib = lib
    return _lib


class _Device:
    """What one card's launches reuse: its SM count, each instance's
    round keys and resident blocks, and per stream the partials' scratch
    and the counters (zero between launches).

    Under a CUDA graph's capture the stream's scratch must exist already
    (a call on that stream before the capture makes it), and the graph
    keeps its address: scratch that a capture used is never freed, only
    set aside when its stream needs more."""

    def __init__(self, device: torch.device):
        self.sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.instances: Dict[tuple, Tuple[int, int]] = {}
        self.scratch: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.captured: set = set()      # streams whose scratch a graph holds
        self.held: list = []            # scratch set aside for those graphs

    def plan(self, code, B, Hkv, G, S, D, bk) -> Plan:
        heads = _heads(G)
        inst = self.instances.get((code, D, heads))
        if inst is None:
            lib = _library()
            inst = (lib.decode_attention_info(code, D, heads, 0),
                    lib.decode_attention_info(code, D, heads, 1))
            if min(inst) < 1:
                raise RuntimeError(f"decode_attention: no instance for "
                                   f"D={D}, {heads} heads ({inst})")
            self.instances[(code, D, heads)] = inst
        return plan(B, Hkv, G, S, D, bk=bk, sms=self.sms,
                    round_keys=inst[0], resident=inst[1])

    def buffers(self, stream: int, pl: Plan, device) -> Tuple[int, int]:
        old = self.scratch.get(stream)
        part, counter = old or (None, None)
        grow_part = part is None or part.numel() < pl.part_floats
        grow_counter = counter is None or counter.numel() < pl.counters
        capturing = torch.cuda.is_current_stream_capturing()
        if (grow_part or grow_counter) and capturing:
            raise RuntimeError(
                "decode_attention: no scratch of this size on the capture "
                "stream; make the same call on that stream before capturing")
        if grow_part:
            part = torch.empty(max(pl.part_floats, 1), dtype=torch.float32,
                               device=device)
        if grow_counter:
            counter = torch.zeros(pl.counters, dtype=torch.int32,
                                  device=device)
        if (grow_part or grow_counter) and stream in self.captured:
            self.held.append(old)
            self.captured.discard(stream)
        if capturing:
            self.captured.add(stream)
        self.scratch[stream] = (part, counter)
        return part.data_ptr(), counter.data_ptr()


_devices: Dict[int, _Device] = {}


def _device(device: torch.device) -> _Device:
    st = _devices.get(device.index)
    if st is None:
        st = _devices[device.index] = _Device(device)
    return st


def plan_for(q, k, bk: Optional[int] = None) -> Plan:
    """The plan of a call on these CUDA tensors."""
    return _prepare(q, k, k, bk)[1]


def _check(q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"want q (B,Hq,D), k = v (B,Hkv,S,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dimension of q, k and v must be contiguous")
    if B > 65535 or k.shape[1] > 65535:
        raise ValueError("batch and kv heads must each be below 65536")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every row of ``t`` is 16 bytes from the next along each dimension
    that has more than one (its 16-byte loads stay aligned wherever its
    base is)."""
    e = t.element_size()
    return all(st * e % 16 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
               if n > 1)


def _block(bk: Optional[int], S: int) -> Optional[int]:
    """The reference's ``bk = min(bk, S)``; raises where it asserts."""
    if bk is None:
        return None
    if bk < 1:
        raise ValueError(f"bk must be positive; got {bk}")
    bk = min(bk, S)
    if S % bk:
        raise ValueError(f"S={S} is not a multiple of bk={bk}")
    return bk


def _prepare(q, k, v, bk: Optional[int]) -> Optional[Tuple[_Device, Plan]]:
    """Checks a call's shapes, dtypes and devices and plans its launch;
    ``None`` for CPU tensors (the plain version's)."""
    _check(q, k, v)
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    bk = _block(bk, S)
    device = q.device
    if k.device != device or v.device != device:
        raise ValueError(f"q, k, v on different devices: "
                         f"{ {q.device, k.device, v.device} }")
    if device.type == "cpu":
        return None
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    state = _device(device)
    return state, state.plan(_DTYPE_CODE[q.dtype], B, Hkv, Hq // Hkv, S, D,
                             bk)


def _launch(q, k, v, length, state: _Device, pl: Plan) -> torch.Tensor:
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    device = q.device
    ln = _lengths(length, B, device)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    part, counter = state.buffers(stream, pl, device)
    kp, vp = k.data_ptr(), v.data_ptr()
    aligned = _rows_aligned(k) and _rows_aligned(v) and (kp | vp) % 16 == 0
    rc = _library().decode_attention_launch(
        _DTYPE_CODE[q.dtype], D, pl.heads, q.data_ptr(), kp, vp,
        ln.data_ptr(), out.data_ptr(), part, counter, B, Hkv, Hq // Hkv,
        pl.groups, S, pl.keys, pl.ranges, int(aligned), *q.stride()[:2],
        *k.stride()[:3], *v.stride()[:3], _LOG2E / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    COUNT.launches += 1
    return out


def decode_attention(q, k, v, length, *, bk: Optional[int] = None
                     ) -> torch.Tensor:
    """q: (B,Hq,D); k,v: (B,Hkv,S,D); attends positions < length -> (B,Hq,D).
    ``bk``: keys per range, or ``None`` for the budget the card's SM count
    gives."""
    prepared = _prepare(q, k, v, bk)
    if prepared is None:
        COUNT.plain += 1
        return decode_attention_plain(q, k, v, length)
    if torch.cuda.current_device() != q.device.index:
        with torch.cuda.device(q.device):
            return _launch(q, k, v, length, *prepared)
    return _launch(q, k, v, length, *prepared)
