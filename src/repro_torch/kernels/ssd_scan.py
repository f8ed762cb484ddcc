"""Mamba2 SSD chunk scan.

Port of the Pallas TPU kernel ``repro/kernels/ssd_scan.py:68``
(``ssd_scan``; body ``_kernel`` at ``:21``).  The kernel is hand-written
CUDA C++ for ``sm_90a`` in ``csrc/ssd_scan.cu``, built with ``nvcc`` at
first use and bound with ``ctypes``.

:func:`ssd_scan` takes the reference's layout: x ``(B,L,H,P)`` f32 or
bf16, dt ``(B,L,H)`` f32, A ``(H,)`` f32, Bm and Cm ``(B,L,N)`` in x's
dtype and shared by all heads, D ``(H,)`` f32 or bf16; it returns
``(y (B,L,H,P) in x's dtype, final_state (B,H,P,N) f32)``.  x, Bm and Cm
may be any strided views whose last dimension is contiguous, such as the
slices of the conv output that ``models.ssm.mamba_block`` makes; the
kernel reads them through their strides, so nothing is copied.

Where the Pallas kernel walks the chunks of one (b, h) in order, the CUDA
kernel takes the chunked decomposition of the Mamba2 paper (arXiv
2405.21060) in three launches: each chunk's cumulative decay and its own
state contribution; the state passed from chunk to chunk; each chunk's
output.  The first and third launches have three instances each, picked
together before the launch by one rule, :func:`instance_for`: on the
tensor cores ``chunk_state_wgmma_kernel`` and ``chunk_scan_wgmma_kernel``
for bfloat16 (every product with an f32 operand as two bf16 products,
``bf16(v)`` and ``bf16(v - bf16(v))``) and ``chunk_state_tf32_kernel`` and
``chunk_scan_tf32_kernel`` for float32 (every product as three tf32
products, big.big + big.small + small.big), and ``chunk_state_kernel`` and
``chunk_scan_kernel`` on CUDA cores for the shapes neither takes.
``csrc/ssd_scan.cu``'s header describes each.  A failed launch raises and
never falls back.  Its plain version is ``kernels.ref.ssd_ref``, the model
layer's chunked reference (``models.ssm.ssd_reference``).

On CPU tensors the wrapper runs the plain version at any P, N and chunk,
and counts that in ``COUNT.plain``; on CUDA tensors it launches the kernel
(``COUNT.launches``; ``COUNT.wgmma`` and ``COUNT.tf32`` count those whose
first and third launches ran on the bf16 and the tf32 tensor-core
instances) or raises.  It raises when autograd would need its gradient:
the reference cannot differentiate its kernel either, and the kernel has
no backward yet.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64        # P: one block's output tile is (64 rows, P)
MAX_STATE = 128          # N: one (64, N) tile of C and of B in shared memory
MAX_CHUNK = 1024         # Q: the chunk's cumulative decay in shared memory
# the tensor-core instances: P and N whose rows are a TMA swizzle width (32,
# 64 or 128 bytes; wider rows as 128-byte column blocks), whole 64-row tiles
# (float32 also a chunk of 32, half a tile), and TMA's 16-byte alignment
WGMMA_HEAD_DIMS = (16, 32, 64)
WGMMA_STATES = (16, 32, 64, 128)
_TMA_ALIGN = 16
#: the instances of launches 1 and 3, named as ``ssd_scan_launch`` numbers
#: them: CUDA cores, bf16 wgmma, float32 as 3xTF32 wgmma
INSTANCES = {"cuda_core": 0, "wgmma": 1, "tf32": 2}


@dataclasses.dataclass
class LaunchCount:
    launches: int = 0        # kernel launches, on CUDA tensors
    wgmma: int = 0           # of them, launches 1 and 3 as bf16 wgmma
    tf32: int = 0            # of them, launches 1 and 3 as 3xTF32 wgmma
    plain: int = 0           # plain-version calls, on CPU tensors

    def reset(self) -> None:
        self.launches = 0
        self.wgmma = 0
        self.tf32 = 0
        self.plain = 0


COUNT = LaunchCount()


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("ssd_scan")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ssd_scan_launch.argtypes = (
            [i, i] + [p] * 10 + [i] * 6 + [i64] * 10 + [i, p])
        lib.ssd_scan_launch.restype = i
        _lib = lib
    return _lib


def _check(x, dt, A, Bm, Cm, D, chunk: int) -> int:
    """Raise on what the kernel does not take; return the chunk length Q."""
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3 \
            or A.dim() != 1 or D.dim() != 1:
        raise ValueError("want x (B,L,H,P), dt (B,L,H), A (H,), Bm, Cm "
                         "(B,L,N), D (H,)")
    B_, L, H, Pd = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B_, L, H) or A.shape != (H,) or D.shape != (H,) \
            or Bm.shape != (B_, L, N) or Cm.shape != Bm.shape:
        raise ValueError(
            f"shapes do not fit: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, "
            f"D {tuple(D.shape)}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must share float32 or bfloat16; got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, "
                        f"{A.dtype}")
    if D.dtype not in _DTYPE_CODE:
        raise TypeError(f"D must be float32 or bfloat16; got {D.dtype}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive; got {chunk}")
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"L={L} is not a multiple of chunk {Q}")
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1 \
            or A.stride(0) != 1 or D.stride(0) != 1:
        raise ValueError("the last dimension of x, Bm, Cm, A and D must be "
                         "contiguous")
    devices = {t.device for t in (x, dt, A, Bm, Cm, D)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, D)):
        raise RuntimeError(
            "ssd_scan has no backward: call it under torch.no_grad() or "
            "with inputs that do not require grad (training runs "
            "models.ssm.ssd_reference)")
    return Q


def _strides(t):
    """t's strides but the last, a dimension of size 1 given its largest
    extent rounded up to 8 elements, so every stride is a valid TMA
    stride (it is never used to address)."""
    far = -(-max(st * n for st, n in zip(t.stride(), t.shape)) // 8) * 8
    return [st if n > 1 else far for st, n in zip(t.stride()[:-1],
                                                  t.shape[:-1])]


def instance_for(x, Bm, Cm, chunk: int) -> str:
    """The instance of launches 1 and 3 for these inputs, both together,
    decided from dtype, shape and alignment alone, before any launch:
    ``"wgmma"`` (``chunk_state_wgmma_kernel``, ``chunk_scan_wgmma_kernel``)
    for bfloat16 and ``"tf32"`` (``chunk_state_tf32_kernel``,
    ``chunk_scan_tf32_kernel``) for float32, where P is in
    ``WGMMA_HEAD_DIMS``, N in ``WGMMA_STATES``, the chunk ``Q = min(chunk,
    L)`` a multiple of 64 (float32: or 32) and the base addresses and the
    strides of x, Bm and Cm multiples of 16 bytes (TMA reads them); else
    ``"cuda_core"`` (``chunk_state_kernel``, ``chunk_scan_kernel``)."""
    Q = min(chunk, x.shape[1])
    tiles = Q % 64 == 0 or (Q == 32 and x.dtype == torch.float32)
    if (x.shape[3] in WGMMA_HEAD_DIMS and Bm.shape[-1] in WGMMA_STATES
            and tiles and all(
                t.data_ptr() % _TMA_ALIGN == 0
                and all(st * t.element_size() % _TMA_ALIGN == 0
                        for st in _strides(t))
                for t in (x, Bm, Cm))):
        return {torch.bfloat16: "wgmma", torch.float32: "tf32"}[x.dtype]
    return "cuda_core"


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """x: (B,L,H,P); dt: (B,L,H); A, D: (H,); Bm, Cm: (B,L,N)
    -> (y (B,L,H,P), final_state (B,H,P,N) f32)."""
    Q = _check(x, dt, A, Bm, Cm, D, chunk)
    if x.device.type == "cpu":
        COUNT.plain += 1
        return ssd_ref(x, dt, A, Bm, Cm, D, chunk)
    return _launch(x, dt, A, Bm, Cm, D, Q,
                   instance_for(x, Bm, Cm, chunk))[:2]


def _ssd_scan_instance(x, dt, A, Bm, Cm, D, *, chunk: int, instance: str):
    """:func:`ssd_scan` on the card with its first and third launches on
    the named instance (``INSTANCES``; a shape on CUDA cores that the rule
    sends to the tensor cores, to time the two side by side); raises where
    the named tensor-core instance does not take the inputs.  Returns y,
    the final state, the states entering each chunk (B, H, L/Q, P, N) f32,
    which hold every chunk's own state from the first launch, and the
    cumulative decay of each chunk (B, H, L/Q, Q) f32."""
    Q = _check(x, dt, A, Bm, Cm, D, chunk)
    if instance not in INSTANCES:
        raise ValueError(f"instance must be one of {sorted(INSTANCES)}; got "
                         f"{instance!r}")
    if instance != "cuda_core" and instance_for(x, Bm, Cm, chunk) != instance:
        raise ValueError(f"the {instance} instance does not take these "
                         "inputs")
    return _launch(x, dt, A, Bm, Cm, D, Q, instance)


def _launch(x, dt, A, Bm, Cm, D, Q: int, instance: str):
    B_, L, H, Pd = x.shape
    N = Bm.shape[-1]
    if Pd > MAX_HEAD_DIM or N > MAX_STATE or Q > MAX_CHUNK:
        raise ValueError(f"P={Pd}, N={N}, Q={Q} exceed the kernel's "
                         f"{MAX_HEAD_DIM}, {MAX_STATE}, {MAX_CHUNK}")
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    lib = _library()
    n = L // Q
    dev = x.device
    y = torch.empty((B_, L, H, Pd), dtype=x.dtype, device=dev)
    state = torch.empty((B_, H, Pd, N), dtype=torch.float32, device=dev)
    cum = torch.empty((B_, H, n, Q), dtype=torch.float32, device=dev)
    chunk_states = torch.empty((B_, H, n, Pd, N), dtype=torch.float32,
                               device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_launch(
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[D.dtype],
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
            cum.data_ptr(), chunk_states.data_ptr(),
            B_, L, H, Pd, N, Q, *_strides(x), *dt.stride(),
            *_strides(Bm), *_strides(Cm), INSTANCES[instance], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc} "
                           f"(10000 + n: TMA tensor map encoding failed with "
                           f"CUresult n)")
    COUNT.launches += 1
    COUNT.wgmma += instance == "wgmma"
    COUNT.tf32 += instance == "tf32"
    return y, state, chunk_states, cum
