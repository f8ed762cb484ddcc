"""Flash-attention forward: q tiles against KV tiles with an online softmax.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py:75``
(``flash_attention``; body ``_kernel`` at ``:28``).  The kernels are
hand-written CUDA C++ for ``sm_90a`` in ``csrc/flash_attention.cu``,
built with ``nvcc`` at first use and bound with ``ctypes``.  The instance
rule :func:`kernel_for` names one from dtype, head dim and alignment
alone, before any launch: bfloat16 runs ``flash_fwd_wgmma_kernel`` on the
tensor cores (wgmma, K and V by TMA, p.v as bf16(p) + bf16(p - bf16(p))
in f32); float32 runs ``flash_fwd_tf32_kernel`` on the tensor cores, each
f32 product as three tf32 products (big.big + big.small + small.big, big
= tf32(x), small = tf32(x - big); at head dim 256 q.k as the sum of its
two 128-column halves; :func:`flash_tf32x3_ref` emulates it).  Both read
q, k and v by TMA, which needs 16-byte aligned base addresses and
strides (of out too, which they store in pairs), except where the head
dim is padded into new tensors.  Where TMA cannot read one of them, the
call is staged (:func:`staged_for`): that tensor's values are copied into
a new contiguous one (out: written there and copied back), so the output
is the TMA kernel's on those values, bit for bit.  ``flash_fwd_kernel``
(f32 FMAs on CUDA cores) runs only when named
(:func:`_flash_attention_instance`).  The kernels have head dims 32, 64,
128 and 256; any other D up to 256 is padded with zero columns to the
next of them, scaled by ``1/sqrt(D)`` of the true D and sliced back,
which leaves every score and output unchanged.  Nothing falls back or is
retried.

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
launches a kernel (``COUNT.launches``; ``COUNT.wgmma`` and ``COUNT.tf32``
count those of the bfloat16 and the float32 tensor-core kernel,
``COUNT.staged`` those of them on staged copies) or raises.  It raises
when autograd would need a gradient: the reference defines none.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF, mha_ref

HEAD_DIMS = (32, 64, 128, 256)   # the kernels' instances on the card
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CUDA_CORE_KERNEL = "flash_fwd_kernel"
WGMMA_KERNEL = "flash_fwd_wgmma_kernel"      # bfloat16, tensor cores
TF32_KERNEL = "flash_fwd_tf32_kernel"        # float32, tensor cores
_KERNEL_CODE = {CUDA_CORE_KERNEL: 0, WGMMA_KERNEL: 1, TF32_KERNEL: 2}
_MAX_SMEM = 232_448          # bytes of shared memory one H100 block can use
_TMA_ALIGN = 16              # bytes: TMA base address and stride alignment


@dataclasses.dataclass
class LaunchCount:
    launches: int = 0        # kernel launches, on CUDA tensors
    wgmma: int = 0           # of them, bfloat16 tensor-core launches
    tf32: int = 0            # of them, float32 tensor-core launches
    staged: int = 0          # of them, on copies of what TMA cannot read
    plain: int = 0           # plain-version calls, on CPU tensors

    def reset(self) -> None:
        self.launches = 0
        self.wgmma = 0
        self.tf32 = 0
        self.staged = 0
        self.plain = 0


COUNT = LaunchCount()

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [i, i, i] + [p] * 4 + [i] * 9 + [p, ctypes.c_float, p])
        lib.flash_attention_launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i] * 5
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


def _tma_aligned(t) -> bool:
    """Whether TMA can read t: its base address and the strides of its
    first three dimensions are multiples of 16 bytes.  A stride of a
    dimension of size 1 is never used and is not checked."""
    nbytes = t.element_size()
    return t.data_ptr() % _TMA_ALIGN == 0 and all(
        (st * nbytes) % _TMA_ALIGN == 0
        for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def _check_tma(kernel, q, k, v, out) -> None:
    """Raise on what a TMA kernel does not take: a base address or stride
    of q, k, v or out that is not a multiple of 16 bytes (TMA reads q, k
    and v; out is written two columns at a time)."""
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not _tma_aligned(t):
            raise ValueError(
                f"{kernel} needs {name}'s base address and strides to be "
                f"multiples of {_TMA_ALIGN} bytes; got strides {t.stride()} "
                f"at address {t.data_ptr()}")


def kernel_for(q, k, v, out=None) -> str:
    """The kernel a call on the card runs for these tensors (the instance
    rule), before any launch: ``flash_fwd_wgmma_kernel`` for bfloat16 and
    ``flash_fwd_tf32_kernel`` for float32, on the tensor cores at every
    head dim and every layout (what TMA cannot read is staged first,
    :func:`staged_for`).  ``flash_fwd_kernel`` runs only when named
    (:func:`_flash_attention_instance`)."""
    return WGMMA_KERNEL if q.dtype == torch.bfloat16 else TF32_KERNEL


def staged_for(q, k, v, out=None) -> tuple:
    """The tensors, by name (``"q"``, ``"k"``, ``"v"``, ``"out"``), that a
    call on the card copies into new contiguous tensors before its launch
    because TMA cannot read them (:func:`_tma_aligned`); none where the
    head dim is padded, as the padded copies are new tensors already."""
    if instance_dim(q.shape[3]) != q.shape[3]:
        return ()
    named = (("q", q), ("k", k), ("v", v), ("out", out))
    return tuple(n for n, t in named if t is not None and not _tma_aligned(t))


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


def _copy(t):
    """t's values in a new contiguous tensor, which TMA can read."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


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
    kernel = kernel_for(q, k, v, out)
    if Dk == q.shape[3]:
        staged = staged_for(q, k, v, out)
        if not staged:
            return _launch(q, k, v, out, kernel, causal, window, bq, bk)
        qs, ks, vs = (_copy(t) if n in staged else t
                      for n, t in (("q", q), ("k", k), ("v", v)))
        dst = torch.empty(q.shape, dtype=q.dtype, device=q.device) \
            if "out" in staged else out
        got = _launch(qs, ks, vs, dst, kernel, causal, window, bq, bk,
                      staged=True)
        return got if dst is out else out.copy_(got)
    padded = _launch(_pad(q, Dk), _pad(k, Dk), _pad(v, Dk),
                     torch.empty(q.shape[:3] + (Dk,), dtype=q.dtype,
                                 device=q.device),
                     kernel, causal, window, bq, bk,
                     scale=1.0 / math.sqrt(q.shape[3]))
    return out.copy_(padded[..., :q.shape[3]])


def _flash_attention_instance(q, k, v, *, kernel: str, causal: bool = True,
                              window: int = 0, bq: int = 128, bk: int = 128):
    """:func:`flash_attention` on the card through the named kernel, at an
    instance head dim, unstaged: the one the rule names or
    ``flash_fwd_kernel`` on CUDA cores (float32 at any head dim, bfloat16
    at head dim 256), to time the two side by side; raises where that
    kernel does not take the inputs (a tensor-core kernel on a layout TMA
    cannot read)."""
    bq, bk = _check(q, k, v, window, bq, bk)
    if q.device.type != "cuda" or instance_dim(q.shape[3]) != q.shape[3]:
        raise ValueError("want CUDA tensors at an instance head dim")
    if kernel != CUDA_CORE_KERNEL and kernel != kernel_for(q, k, v):
        raise ValueError(f"{kernel} does not take these inputs")
    return _launch(q, k, v, torch.empty_like(q), kernel, causal, window, bq,
                   bk)


def _launch(q, k, v, out, kernel, causal, window, bq, bk, scale=None,
            staged=False):
    """One launch of ``kernel`` at an instance's head dim; ``scale``
    defaults to ``1/sqrt(D)``; ``staged`` counts it in ``COUNT.staged``."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if kernel in (WGMMA_KERNEL, TF32_KERNEL):
        _check_tma(kernel, q, k, v, out)
    lib = _library()
    code, dtype = _KERNEL_CODE[kernel], _DTYPE_CODE[q.dtype]
    smem = lib.flash_attention_smem_bytes(code, dtype, D, bq, bk)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"{kernel} does not take bq={bq}, bk={bk} at D={D} "
                         f"in {q.dtype}")
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in _strides(t)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            code, dtype, D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Hq, Hq // Hkv, Sq, Sk, bq, bk,
            int(bool(causal)), int(window), strides,
            1.0 / math.sqrt(D) if scale is None else scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} (10000 + n: TMA tensor map encoding "
                           f"failed with CUresult n)")
    COUNT.launches += 1
    COUNT.wgmma += kernel == WGMMA_KERNEL
    COUNT.tf32 += kernel == TF32_KERNEL
    COUNT.staged += staged
    return out


# ---------------------------------------------------------------------------
# the float32 tensor-core kernel's numerics, in plain torch
# ---------------------------------------------------------------------------
_LOG2E = 1.4426950408889634
SPLITS = ("tf32x3", "tf32", "bf16x3")


def _tf32(x):
    """x rounded to tf32 as ``cvt.rna.tf32.f32`` does: to 10 mantissa bits,
    to nearest, ties away from zero (the 13 low bits of the float32 zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, split: str):
    """a @ b of float32 operands as the kernel's tensor cores form it:
    ``tf32x3`` big.big + big.small + small.big with big = tf32(x), small =
    tf32(x - big); ``tf32`` one product of tf32(a) and tf32(b); ``bf16x3``
    as tf32x3 with bf16 hi and lo.  Every sum is f32."""
    if split == "tf32":
        return _tf32(a) @ _tf32(b)
    rnd = _tf32 if split == "tf32x3" else (
        lambda t: t.bfloat16().float())
    a_big, b_big = rnd(a), rnd(b)
    a_small, b_small = rnd(a - a_big), rnd(b - b_big)
    return a_big @ b_big + a_big @ b_small + a_small @ b_big


def piece_width(bk: int, D: int = 128) -> int:
    """Keys per softmax update of the tensor-core kernels for a KV tile of
    ``bk`` keys at instance head dim ``D``: bk at 32, 64 or 128; 128 where
    bk is a multiple of 128; else 64 (the last piece of a tile cut at its
    end).  At D = 256, in both dtypes, 32 at bk = 32, else 64: the bf16
    kernel's accumulator takes 128 registers a thread, and the f32
    kernel's shared memory holds one piece's partial scores per
    warpgroup beside q's 128 KB, so a piece is 64 keys at most."""
    if D == 256:
        return 32 if bk == 32 else 64
    return bk if bk in (32, 64) else 128 if bk % 128 == 0 else 64


def pieces(Sk: int, bk: int, D: int):
    """The ``[c0, c1)`` key ranges of the tensor-core kernels' softmax
    updates over ``Sk`` keys in tiles of ``bk`` (``min(bk, Sk)``) at head
    dim ``D``: pieces of :func:`piece_width` keys of the instance head
    dim, the last piece of a tile cut at its end."""
    bk = min(bk, Sk)
    width = piece_width(bk, instance_dim(D))
    return [(c0, min(c0 + width, t0 + bk)) for t0 in range(0, Sk, bk)
            for c0 in range(t0, t0 + bk, width)]


def _scores(q, k, split: str):
    """q.k^T as the kernel forms it: at instance head dim 256 each of the
    two warpgroups sums its own 128 columns of D, and the two partial
    sums are added."""
    if instance_dim(q.shape[-1]) != 256:
        return _product(q, k.transpose(2, 3), split)
    lo, hi = (_product(q[..., cols], k[..., cols].transpose(2, 3), split)
              for cols in (slice(0, 128), slice(128, None)))
    return lo + hi


def flash_tf32x3_ref(q, k, v, *, causal: bool = True, window: int = 0,
                     bq: int = 128, bk: int = 128, split: str = "tf32x3"):
    """``flash_fwd_tf32_kernel``'s function in plain torch, float32 in and
    out: q.k and p.v as :func:`_product` of ``split`` (``tf32x3`` the
    kernel's; ``tf32`` and ``bf16x3`` the two controls its gate must tell
    apart; q.k at head dim 256 as :func:`_scores` sums it), the online
    softmax in base 2 (scores times ``f32(1/sqrt(D)) * f32(log2 e)``,
    ``exp2``) once per piece of :func:`pieces`, the finite -1e30 mask,
    keys of a piece past its tile at -inf, l the f32 sum of f32 p, acc /
    max(l, 1e-30).  ``bq`` changes nothing: the kernel skips only tiles
    whose skipping is exact."""
    if split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}; got {split!r}")
    B, Hq, Sq, D = q.shape
    Sk, G = k.shape[2], Hq // k.shape[1]
    kq, vq = (t.repeat_interleave(G, dim=1).float() for t in (k, v))
    q = q.float()
    scale_log2 = (torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
                  * torch.tensor(_LOG2E, dtype=torch.float32)).item()
    qpos = torch.arange(Sq, device=q.device)[:, None]
    acc = torch.zeros(B, Hq, Sq, D, device=q.device)
    m = torch.full((B, Hq, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros(B, Hq, Sq, 1, device=q.device)
    for c0, c1 in pieces(Sk, bk, D):
        kpos = torch.arange(c0, c1, device=q.device)[None, :]
        x = _scores(q, kq[:, :, c0:c1], split) * scale_log2
        keep = torch.ones(Sq, c1 - c0, dtype=torch.bool, device=q.device)
        if causal:
            keep = kpos <= qpos
        if window:
            keep = keep & (kpos > qpos - window)
        x = torch.where(keep, x, torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _product(p, vq[:, :, c0:c1], split)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)
