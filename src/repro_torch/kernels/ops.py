"""Public entry points for the kernels (port of ``repro/kernels/ops.py``).

On CUDA tensors each launches its hand-written kernel; on CPU tensors it
runs the kernel's plain version (see each kernel module).  The reference's
``interpret`` switch has no counterpart: the device of the inputs decides.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.ssd_scan import ssd_scan


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = 128, bk: int = 128):
    """``ops.py:20``: q (B,Hq,Sq,D), k,v (B,Hkv,Sk,D) -> (B,Hq,Sq,D)."""
    return _flash(q, k, v, causal=causal, window=window, bq=bq, bk=bk)


def mha(q_bshd, k_bshd, v_bshd, *, causal: bool = True, window: int = 0):
    """``ops.py:28``: the (B,S,H,D)-layout wrapper.  The kernel reads the
    inputs through transposed views and writes a (B,S,H,D) output, so
    nothing is copied."""
    out = torch.empty(q_bshd.shape, dtype=q_bshd.dtype, device=q_bshd.device)
    _flash(q_bshd.transpose(1, 2), k_bshd.transpose(1, 2),
           v_bshd.transpose(1, 2), causal=causal, window=window,
           out=out.transpose(1, 2))
    return out


def ssd(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """``ops.py:38``: the SSD chunk scan -> (y, final_state)."""
    return ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)


def decode_attention(q, k, v, length, *, bk: Optional[int] = None):
    """``ops.py:44``: flash-decode; ``bk=None`` splits the KV sequence by the
    card's SM count, an int splits it into ``bk``-key blocks."""
    return _decode(q, k, v, length, bk=bk)


__all__ = ["decode_attention", "flash_attention", "mha", "ssd"]
