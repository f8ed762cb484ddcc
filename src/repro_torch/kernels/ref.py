"""Plain torch oracles for the kernels (port of ``repro/kernels/ref.py``):
for attention a dense softmax, f32 inside, output in q's dtype; for the
SSD scan the model layer's chunked reference.

Unlike the reference's ``decode_mha_ref`` (``ref.py:42``), which accepts
only a scalar ``length``, this one also takes per-sequence ``(B,)``
lengths.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, G: int) -> torch.Tensor:
    return torch.repeat_interleave(x, G, dim=1)


def mha_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,Hq,Sq,D); k,v: (B,Hkv,Sk,D) -> (B,Hq,Sq,D)."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    G = q.shape[1] // k.shape[1]
    kq, vq = _repeat_kv(k, G).float(), _repeat_kv(v, G).float()
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), kq) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m = kpos <= qpos
    if window:
        m = m & (kpos > qpos - window)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bhsd->bhqd", p, vq).to(q.dtype)


def decode_mha_ref(q, k, v, *, length=None):
    """q: (B,Hq,D); k,v: (B,Hkv,S,D); attends to positions < length
    (a scalar or a (B,) tensor)."""
    B, Hq, D = q.shape
    S = k.shape[2]
    G = Hq // k.shape[1]
    kq, vq = _repeat_kv(k, G).float(), _repeat_kv(v, G).float()
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kq) / math.sqrt(D)
    if length is not None:
        ln = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1)
        kpos = torch.arange(S, device=q.device)[None, None]
        s = torch.where(kpos < ln, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vq).to(q.dtype)


def ssd_ref(x, dt, A, Bm, Cm, D, chunk: int):
    """``ref.py:48``: delegates to the model layer's chunked SSD reference
    (``models.ssm.ssd_reference``, same math)."""
    from repro_torch.models.ssm import ssd_reference
    return ssd_reference(x, dt, A, Bm, Cm, D, chunk)
