"""Public entry points for the kernels (port of ``repro/kernels/ops.py``).

On CUDA tensors each launches its hand-written kernel; on CPU tensors it
runs the kernel's plain version (see each kernel module).  The reference's
``interpret`` switch has no counterpart: the device of the inputs decides.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.ssd_scan import ssd_scan


def ssd(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """``ops.py:38``: the SSD chunk scan -> (y, final_state)."""
    return ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)


__all__ = ["decode_attention", "ssd"]
