"""Int8 gradient compression with error feedback (port of
``repro/optim/compress.py``).

Each leaf is quantized to int8 with one f32 scale (max |x| / 127) after
the error-feedback accumulator is added; the dequantized values feed the
optimizer and the residual is carried to the next step.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map


def init_error_feedback(grads: Any) -> Any:
    return tree_map(torch.zeros_like, grads)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads: Any, err: Any) -> Tuple[Any, Any]:
    """-> (dequantized grads to feed the optimizer, error feedback).  The
    error feedback is updated IN PLACE and returned."""
    def one(g, e):
        g32 = g.float() + e
        q, scale = _quantize(g32)
        deq = q.float() * scale
        e.copy_(g32 - deq)
        return deq.to(g.dtype)

    return tree_map(one, grads, err), err


def compression_ratio(grads: Any) -> float:
    bits_in = sum(x.numel() * x.element_size() * 8 for x in leaves(grads))
    bits_out = sum(x.numel() * 8 + 32 for x in leaves(grads))
    return bits_in / bits_out
