"""Mixture-of-Experts FFN with grouped, gather-only dispatch (port of
``repro/models/moe.py``).

Tokens are processed in G groups (``_num_groups``).  Within a group the
top-k routing slots are ordered by expert with a stable argsort, and each
expert's (capacity C) buffer is built with gathers only, beside a validity
mask; slots past an expert's capacity are dropped.  Every shape is fixed
by (B, S) and the config: no ``nonzero``, no boolean indexing and no
``.item()``, so a step never waits on the host.

The orderings follow the reference exactly, since they decide which slots
are dropped: ``jax.lax.top_k`` keeps the lower expert on a tie (here the
first K of a stable descending sort; ``torch.topk`` promises no order on
ties), and both argsorts are stable.  The router runs in f32 on the
router weights as given (bf16-rounded by ``precast`` in a bf16 model);
the expert products run in the input dtype, and the gate-weighted combine
is an f32 sum over k, cast back once.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distrib.logical import NOSHARD, P, ShardCtx
from repro_torch.models.layers import activation


def moe_spec(cfg: ArchConfig) -> dict:
    """``moe.py:26``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": P((d, e), ("embed", "experts")),
        "wi": P((e, d, f), ("experts", "embed", "ffn")),
        "wg": P((e, d, f), ("experts", "embed", "ffn")),
        "wo": P((e, f, d), ("experts", "ffn", "embed")),
    }


def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    """``moe.py:36``: slots per expert and group, rounded up to a multiple
    of 128 with a floor of 8 (so C = 8 at decode, one token a group)."""
    c = int(cfg.capacity_factor * tokens_per_group * cfg.top_k
            / cfg.n_experts)
    return max(8, ((c + 127) // 128) * 128)


def _num_groups(batch: int) -> int:
    """``moe.py:42``: the largest divisor of ``batch`` up to 32, so up to
    32 sequences never share a group."""
    g = min(32, batch)
    while batch % g:
        g -= 1
    return g


def _route(p, xg: torch.Tensor, cfg: ArchConfig):
    """Routing of (G, Tg, D) tokens (``moe.py:62-80``) -> gate weights and
    ids (G, Tg, K), the slots' order by expert and its inverse (G, Tg*K),
    and each expert's segment [start, end) of the sorted slots (G, E)."""
    G = xg.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = xg.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                   # (G, Tg, E)
    gate_w, gate_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_ids = gate_w[..., :K], gate_ids[..., :K]  # lax.top_k ties
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_ids = gate_ids.reshape(G, -1)                      # (G, N)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    inv_order = torch.argsort(order, dim=-1, stable=True)   # slot -> sorted
    seg_start, seg_end = _segments(flat_ids, E)
    return gate_w, gate_ids, order, inv_order, seg_start, seg_end


def _segments(flat_ids: torch.Tensor, n_experts: int):
    """Each expert's segment [start, end) of a group's slots sorted by
    expert, from the slots' expert ids (G, N) -> two (G, E) int64.

    The reference searches the sorted ids (``moe.py:74-79``); counting
    each expert's slots and summing the counts gives the same integers
    from elementwise ops and a cumsum, which a mesh places (DTensor has
    no sharding rule for ``searchsorted``)."""
    experts = torch.arange(n_experts, device=flat_ids.device)
    counts = (flat_ids[:, :, None] == experts).sum(-2)      # (G, E)
    seg_end = torch.cumsum(counts, dim=-1)
    return seg_end - counts, seg_end


def _groups(x: torch.Tensor, cfg: ArchConfig):
    """(G, Tg, C) for an input of shape (B, S, D)."""
    B, S, _ = x.shape
    G = _num_groups(B)
    Tg = (B // G) * S
    return G, Tg, capacity(cfg, Tg)


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx
            ) -> torch.Tensor:
    """``moe.py:50``: x (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G, Tg, C = _groups(x, cfg)
    dt = x.dtype
    xg = ctx.constrain(ctx.fold_groups(x, G), "batch", None, "act_embed")
    gate_w, gate_ids, order, inv_order, seg_start, seg_end = _route(
        p, xg, cfg)

    # --- expert buffers via gather (moe.py:82-95) ---
    slot_pos = seg_start[:, :, None] + torch.arange(C, device=x.device)
    slot_valid = slot_pos < seg_end[:, :, None]             # (G, E, C)
    slot_pos = slot_pos.clamp_max(Tg * K - 1)
    slot_token = torch.gather(order, -1, slot_pos.reshape(G, E * C)) // K
    buf = torch.gather(xg, 1, slot_token[..., None].expand(G, E * C, D))
    buf = torch.where(slot_valid.reshape(G, E * C, 1), buf,
                      torch.zeros((), dtype=dt, device=x.device))
    buf = ctx.constrain(buf.reshape(G, E, C, D), "batch", "experts",
                        "expert_cap", "act_embed")

    # --- expert FFNs (moe.py:97-103): one batched product per weight,
    # expert-major, as the einsums "gecd,edf->gecf" and "gecf,efd->gecd"
    xe = buf.permute(1, 0, 2, 3).reshape(E, G * C, D)
    act = activation(cfg)
    h = act(xe @ p["wg"].to(dt)) * (xe @ p["wi"].to(dt))   # (E, G*C, F)
    out_buf = (h @ p["wo"].to(dt)).reshape(E, G, C, D).permute(1, 0, 2, 3)
    out_buf = ctx.constrain(out_buf, "batch", "experts", "expert_cap",
                            "act_embed")

    # --- combine back, gathers only (moe.py:107-121) ---
    sorted_pos = inv_order.reshape(G, Tg, K)
    c_of = sorted_pos - torch.gather(
        seg_start, -1, gate_ids.reshape(G, Tg * K)).reshape(G, Tg, K)
    valid = c_of < C
    lin = (gate_ids * C + c_of.clamp(0, C - 1)).reshape(G, Tg * K)
    y_slots = torch.gather(out_buf.reshape(G, E * C, D), 1,
                           lin[..., None].expand(G, Tg * K, D))
    y_slots = torch.where(valid[..., None], y_slots.reshape(G, Tg, K, D),
                          torch.zeros((), dtype=dt, device=x.device))
    y = torch.sum(y_slots.float() * gate_w[..., None], dim=2)  # (G, Tg, D)
    return ctx.unfold_groups(y.to(dt), B)


def dropped_slots(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The routing slots ``moe_ffn`` drops on ``x`` (B, S, D): those past
    their expert's capacity, summed over groups and experts (a 0-d int64
    tensor on x's device; no host sync)."""
    G, Tg, C = _groups(x, cfg)
    *_, seg_start, seg_end = _route(p, x.reshape(G, Tg, x.shape[-1]), cfg)
    return (seg_end - seg_start - C).clamp_min(0).sum()


def router_aux_loss(p, x: torch.Tensor, cfg: ArchConfig,
                    ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    """``moe.py:124``: Switch-style load balance, E * sum_e f_e * p_e,
    where f_e is the share of tokens whose top expert (``argmax``: the
    first on a tie) is e and p_e the mean router probability."""
    B, S, _ = x.shape
    # the (B, S, E) product, then its rows: the same values as flattening
    # x first, without folding a sharded sequence into the batch
    probs = torch.softmax(ctx.matmul(x.float(), p["router"].float()),
                          dim=-1).reshape(B * S, -1)
    top1 = torch.argmax(probs, dim=-1)
    f = torch.nn.functional.one_hot(top1, cfg.n_experts).float().mean(0)
    pbar = probs.mean(0)
    return cfg.n_experts * torch.sum(f * pbar)
