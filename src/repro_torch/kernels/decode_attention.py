"""Flash-decode: one query token per sequence against its KV cache.

Port of the Pallas TPU kernel ``repro/kernels/decode_attention.py:59``
(``decode_attention``; body ``_kernel`` at ``:23``).  The kernel is
hand-written CUDA C++ for ``sm_90a`` in ``csrc/decode_attention.cu``,
built with ``nvcc`` at first use and bound with ``ctypes``.

:func:`decode_attention` takes the reference's layout: q ``(B,Hq,D)``,
k and v ``(B,Hkv,S,D)``, ``length`` a scalar or ``(B,)``; it returns
``(B,Hq,D)`` in q's dtype.  k and v may be any strided view whose last
dimension is contiguous, such as ``cache.transpose(1, 2)`` of the model's
``(B,S,Hkv,D)`` cache, so the model passes its cache without a copy.

``bk=None`` (the serving path) lets the wrapper cut the KV sequence into
splits from the card's SM count, and then ``S`` need not be a multiple
of anything.  An int ``bk`` follows the reference: ``bk = min(bk, S)``,
``S % bk == 0`` or ``ValueError``, and each split covers ``bk`` keys,
combined by log-sum-exp when there is more than one.  The kernel search
domain (``kernels/bench.py``) searches exactly this ``bk``.

The kernel has instances for the head dims in ``HEAD_DIMS``; on the card
any other D raises.  On CPU tensors it runs :func:`decode_attention_plain`
at any D and counts that in
``COUNT.plain``; on CUDA tensors it launches the kernel (``COUNT.launches``)
or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)   # the kernel's, on the card
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232_448          # bytes of shared memory one H100 block can use


@dataclasses.dataclass
class LaunchCount:
    launches: int = 0        # kernel launches, on CUDA tensors
    plain: int = 0           # plain-version calls, on CPU tensors

    def reset(self) -> None:
        self.launches = 0
        self.plain = 0


COUNT = LaunchCount()


def _lengths(length, B: int, device: torch.device) -> torch.Tensor:
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


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("decode_attention")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.decode_attention_launch.argtypes = (
            [i, i] + [p] * 8 + [i] * 6 + [i64] * 8 + [ctypes.c_float, p])
        lib.decode_attention_launch.restype = i
        lib.decode_attention_tile_keys.argtypes = [i]
        lib.decode_attention_tile_keys.restype = i
        lib.decode_attention_smem_bytes.argtypes = [i, i]
        lib.decode_attention_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


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


def _n_split(B: int, Hkv: int, S: int, tile: int, device) -> int:
    """KV chunks per (b, kv head): enough blocks for two per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_tiles = -(-S // tile)
    return max(1, min(n_tiles, -(-2 * sms // (B * Hkv))))


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


def decode_attention(q, k, v, length, *, bk: Optional[int] = None
                     ) -> torch.Tensor:
    """q: (B,Hq,D); k,v: (B,Hkv,S,D); attends positions < length -> (B,Hq,D).
    ``bk``: keys per KV split, or ``None`` for a split by the SM count."""
    _check(q, k, v)
    bk = _block(bk, k.shape[2])
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if q.device.type == "cpu":
        COUNT.plain += 1
        return decode_attention_plain(q, k, v, length)
    B, Hq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")

    lib = _library()
    _, Hkv, S, _ = k.shape
    G = Hq // Hkv
    if lib.decode_attention_smem_bytes(D, G) > _MAX_SMEM:
        raise ValueError(f"G={G} query heads per kv head at D={D} do not fit "
                         "in shared memory")
    if bk is None:
        tile = lib.decode_attention_tile_keys(D)
        n_split = _n_split(B, Hkv, S, tile, q.device)
        chunk = -(-S // (n_split * tile)) * tile
    else:
        chunk = bk
    n_split = -(-S // chunk)
    ln = _lengths(length, B, q.device)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if n_split > 1:
        part_m = torch.empty((B, Hkv, n_split, G), dtype=torch.float32,
                             device=q.device)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((B, Hkv, n_split, G, D), dtype=torch.float32,
                               device=q.device)
        parts = (part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr())
    else:
        parts = (None, None, None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention_launch(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), ln.data_ptr(), out.data_ptr(), *parts,
            B, Hkv, G, S, chunk, n_split,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    COUNT.launches += 1
    return out
