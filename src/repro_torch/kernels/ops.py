"""Public entry points for the kernels (port of ``repro/kernels/ops.py``).

On CUDA tensors each launches its hand-written kernel; on CPU tensors it
runs the kernel's plain version (see each kernel module).  The reference's
``interpret`` switch has no counterpart: the device of the inputs decides.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention

__all__ = ["decode_attention"]
