"""Flash-attention forward: q tiles against KV tiles with an online softmax.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py:75``
(``flash_attention``; body ``_kernel`` at ``:28``).  The kernels are
hand-written CUDA C++ for ``sm_90a`` in ``csrc/flash_attention.cu``,
built with ``nvcc`` at first use and bound with ``ctypes``.  The dtype
alone picks one: bfloat16 runs ``flash_fwd_wgmma_kernel`` on the tensor
cores (wgmma, K and V by TMA, p.v as bf16(p) + bf16(p - bf16(p)) in f32),
float32 runs ``flash_fwd_kernel`` on CUDA cores.  The kernels have head
dims 32, 64, 128 and 256 (bfloat16 at 256 runs ``flash_fwd_kernel``, which
has a bfloat16 instance there alone); any other D up to 256 is padded with
zero columns to the next of them, scaled by ``1/sqrt(D)`` of the true D and
sliced back, which leaves every score and output unchanged.  A bfloat16
call that the tensor-core kernel cannot take raises; it never falls back.

:func:`flash_attention` takes the reference's layout: q ``(B,Hq,Sq,D)``,
k and v ``(B,Hkv,Sk,D)`` in one of float32 or bfloat16, ``Hq`` a multiple
of ``Hkv`` (query head ``h`` reads KV head ``h // G``, nothing is
repeated); it returns ``(B,Hq,Sq,D)`` in q's dtype.  As in the reference,
``bq = min(bq, Sq)`` and ``bk = min(bk, Sk)`` must divide ``Sq`` and
``Sk``; a ``window`` without ``causal`` bounds only the past.  q, k and
v may be any strided views whose last dimension is contiguous, so
:func:`mha` hands over its ``(B,S,H,D)`` tensors without a copy.

The plain version is ``kernels.ref.mha_ref``, the same function.  On CPU
tensors the wrapper runs it and counts ``COUNT.plain``; on CUDA tensors it
launches a kernel (``COUNT.launches``; ``COUNT.wgmma`` counts those of the
bfloat16 kernel) or raises.  It raises when
autograd would need a gradient: the reference defines none.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mha_ref

HEAD_DIMS = (32, 64, 128, 256)   # the kernels' instances on the card
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232_448          # bytes of shared memory one H100 block can use
_TMA_ALIGN = 16              # bytes: TMA base address and stride alignment


@dataclasses.dataclass
class LaunchCount:
    launches: int = 0        # kernel launches, on CUDA tensors
    wgmma: int = 0           # of them, bfloat16 tensor-core launches
    plain: int = 0           # plain-version calls, on CPU tensors

    def reset(self) -> None:
        self.launches = 0
        self.wgmma = 0
        self.plain = 0


COUNT = LaunchCount()

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [i, i] + [p] * 4 + [i] * 9 + [p, ctypes.c_float, p])
        lib.flash_attention_launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i, i, i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _check(q, k, v, window: int, bq: int, bk: int):
    """Raise on what the kernel does not take; return ``(bq, bk)``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"want q (B,Hq,Sq,D), k = v (B,Hkv,Sk,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if Sq < 1 or Sk < 1 or bq < 1 or bk < 1:
        raise ValueError(f"empty sequence or block: Sq={Sq}, Sk={Sk}, "
                         f"bq={bq}, bk={bk}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    bq, bk = min(bq, Sq), min(bk, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"Sq={Sq} and Sk={Sk} must be multiples of "
                         f"bq={bq} and bk={bk}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dimension of q, k and v must be contiguous")
    if B > 65535 or Hq > 65535:
        raise ValueError("batch and query heads must each be below 65536")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: call it under torch.no_grad() "
            "or with inputs that do not require grad")
    return bq, bk


def _check_wgmma(q, k, v, out) -> None:
    """Raise on what the bfloat16 tensor-core kernel does not take: a base
    address or stride of q, k, v or out that is not a multiple of 16 bytes
    (TMA reads q, k and v; out is written two columns at a time).  A
    stride of a dimension of size 1 is never used and is not checked."""
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        nbytes = t.element_size()
        if t.data_ptr() % _TMA_ALIGN or any(
                (st * nbytes) % _TMA_ALIGN
                for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(
                f"bfloat16 flash attention needs {name}'s base address and "
                f"strides to be multiples of {_TMA_ALIGN} bytes; got "
                f"strides {t.stride()} at address {t.data_ptr()}")


def instance_dim(D: int) -> int:
    """The head dim of the kernel instance that runs D on the card: D
    itself or the next instance above it, its extra columns zero."""
    for Dk in HEAD_DIMS:
        if D <= Dk:
            return Dk
    raise ValueError(f"head dim {D} is above the kernels' largest, "
                     f"{HEAD_DIMS[-1]}")


def _pad(t, Dk: int):
    """t with its head dim zero-padded to Dk (a new contiguous tensor)."""
    out = t.new_zeros(t.shape[:-1] + (Dk,))
    out[..., :t.shape[-1]] = t
    return out


def _strides(t):
    """(sb, sh, ss) of a (B,H,S,D) tensor, a dimension of size 1 given the
    largest extent in elements, so every stride is a valid TMA stride."""
    far = max(st * n for st, n in zip(t.stride(), t.shape))
    return [st if n > 1 else far for st, n in zip(t.stride()[:3],
                                                  t.shape[:3])]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = 128, bk: int = 128,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Hq,Sq,D); k,v: (B,Hkv,Sk,D) -> (B,Hq,Sq,D) in q's dtype.

    ``out``, if given, is a ``(B,Hq,Sq,D)`` view in q's dtype with its last
    dimension contiguous; the result is written there and returned."""
    bq, bk = _check(q, k, v, window, bq, bk)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    elif out.shape != q.shape or out.dtype != q.dtype \
            or out.stride(3) != 1 or out.device != q.device:
        raise ValueError("out must be shaped, typed and placed like q, with "
                         "its last dimension contiguous")
    if q.device.type == "cpu":
        COUNT.plain += 1
        return out.copy_(mha_ref(q, k, v, causal=causal, window=window))
    Dk = instance_dim(q.shape[3])
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if Dk == q.shape[3]:
        return _launch(q, k, v, out, causal, window, bq, bk)
    padded = _launch(_pad(q, Dk), _pad(k, Dk), _pad(v, Dk),
                     torch.empty(q.shape[:3] + (Dk,), dtype=q.dtype,
                                 device=q.device),
                     causal, window, bq, bk, scale=1.0 / math.sqrt(q.shape[3]))
    return out.copy_(padded[..., :q.shape[3]])


def _launch(q, k, v, out, causal, window, bq, bk, scale=None):
    """One launch at an instance's head dim; ``scale`` defaults to
    ``1/sqrt(D)``."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    tensor_core = q.dtype == torch.bfloat16 and D <= 128
    if tensor_core:
        _check_wgmma(q, k, v, out)
    lib = _library()
    smem = lib.flash_attention_smem_bytes(_DTYPE_CODE[q.dtype], D, bq, bk)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"bq={bq}, bk={bk} at D={D} do not fit in shared "
                         "memory")
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in _strides(t)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, Hq, Hq // Hkv, Sq, Sk, bq, bk,
            int(bool(causal)), int(window), strides,
            1.0 / math.sqrt(D) if scale is None else scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} (10000 + n: TMA tensor map encoding "
                           f"failed with CUresult n)")
    COUNT.launches += 1
    COUNT.wgmma += tensor_core
    return out
