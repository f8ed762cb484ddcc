"""Plain reference of a dense or MoE decoder, in float32 with TF32 off.

It follows the layer equations the served model states (the
configuration's ``departures`` list where they leave the published
model): token embedding; per layer a pre-norm residual block of RMSNorm
(eps 1e-6, f32), causal grouped-query attention with half-split RoPE at
each token's own position, and an FFN, SwiGLU (``silu(x Wg) * (x Wi)``
then ``Wo``), a plain MLP (``gelu_tanh(x Wi)`` then ``Wo``) or a mixture
of SwiGLU experts; a final RMSNorm and an untied head.

The MoE router is a frozen copy of the semantics the served path must
have: f32 softmax over the router's logits, the top ``k`` taken as the
first ``k`` of a stable descending sort (the lower expert wins a tie),
gates renormalised (their sum clamped at 1e-9), each token's expert
outputs summed with its gates.  A served step puts at most
``tokens_per_group`` tokens in one routing group; where a group's slots
can never pass an expert's capacity nothing is dropped, and
``check_no_drop`` refuses a cell where they could.

It imports nothing of the program: it reads only the configuration file
and weights that the benchmark drew itself.  The same forward runs in
the precisions of ``Linear``: float32 judges; float8 (the control, the
lower precision a later change might be tempted by) and bf16 (the served
path's roundings) give readings.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

FP8_MAX = 448.0      # largest finite float8 e4m3fn


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 for the block's duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its amax maps to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def capacity(cfg: Dict, tokens_per_group: int) -> int:
    """Slots per expert and routing group (multiples of 128, floor 8)."""
    c = int(cfg["capacity_factor"] * tokens_per_group * cfg["top_k"]
            / cfg["n_experts"])
    return max(8, ((c + 127) // 128) * 128)


def groups_of(batch: int) -> int:
    """Routing groups of a decode step of ``batch`` slots: the largest
    divisor of ``batch`` up to 32."""
    g = min(32, batch)
    while batch % g:
        g -= 1
    return g


def check_no_drop(cfg: Dict, slots: int) -> None:
    """Refuse a served batch whose routing could drop a slot: then no
    token-by-token reference holds."""
    if cfg["family"] != "moe":
        return
    per_group = slots // groups_of(slots)
    if per_group * cfg["top_k"] > capacity(cfg, per_group):
        raise ValueError(f"{slots} slots put {per_group} tokens in a group: "
                         "routing may drop slots")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D), pos (T,): half-split rotary embedding."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos[:, None].float() * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Linear:
    """The products and roundings of one precision.  ``float32``: x @ W
    in float32.  ``fp8`` (the control): x and W rounded to float8 e4m3
    first (per token and per output channel scales), the product in
    float32.  ``bfloat16`` (a reading, never the judge): the served
    path's roundings, products in bf16 and every activation rounded to
    bf16 where the served model rounds it."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(precision)
        self.precision = precision

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "bfloat16":
            return w.to(torch.bfloat16)
        w = w.float()
        return fp8(w, dim=-2) if self.precision == "fp8" else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "bfloat16":
            return (x.to(torch.bfloat16) @ w).float()
        if self.precision == "fp8":
            x = fp8(x, dim=-1)
        return x @ w

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "bfloat16":
            return x.to(torch.bfloat16).float()
        return x


PRECISIONS = ("float32", "bfloat16", "fp8")


def attention(q, k, v, spans: Sequence[range]) -> torch.Tensor:
    """Causal GQA inside each sequence's span of the token axis:
    q (T, Hq, D), k and v (T, Hkv, D) -> (T, Hq, D)."""
    out = torch.empty_like(q)
    G = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    for sp in spans:
        qs = q[sp.start:sp.stop].transpose(0, 1)                  # H,T,D
        ks = k[sp.start:sp.stop].transpose(0, 1).repeat_interleave(G, 0)
        vs = v[sp.start:sp.stop].transpose(0, 1).repeat_interleave(G, 0)
        s = qs @ ks.transpose(1, 2) * scale
        T = s.shape[-1]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
        out[sp.start:sp.stop] = (torch.softmax(s, -1) @ vs).transpose(0, 1)
    return out


def route(hn: torch.Tensor, router: torch.Tensor, k: int):
    """-> gates (T, k) and expert ids (T, k) (the frozen semantics)."""
    probs = torch.softmax(hn @ router, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9), ids


def ffn(cfg: Dict, lin: Linear, W: Callable[[str], torch.Tensor],
        hn: torch.Tensor) -> torch.Tensor:
    """The block's FFN: the MLP, gated or plain, or each token's top-k
    experts."""
    act = torch.nn.functional.silu

    def gated(x, wi, wg, wo):
        h = lin.round(act(lin(x, lin.weight(wg)))) * lin(x, lin.weight(wi))
        return lin(lin.round(h), lin.weight(wo))

    def plain(x, wi, wo):
        h = torch.nn.functional.gelu(lin(x, lin.weight(wi)),
                                     approximate="tanh")
        return lin(lin.round(h), lin.weight(wo))

    if cfg["family"] == "dense":
        if cfg["activation"] == "gelu":
            return plain(hn, W("mlp.wi"), W("mlp.wo"))
        if cfg["activation"] != "swiglu":
            raise ValueError(f"activation {cfg['activation']!r}")
        return gated(hn, W("mlp.wi"), W("mlp.wg"), W("mlp.wo"))
    gates, ids = route(hn, W("moe.router").float(), cfg["top_k"])
    out = torch.zeros_like(hn)
    wi, wg, wo = W("moe.wi"), W("moe.wg"), W("moe.wo")
    for e in range(cfg["n_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        out.index_add_(0, tok, gated(hn[tok], wi[e], wg[e], wo[e])
                       * gates[tok, slot, None])
    return lin.round(out)


def forward_hidden(cfg: Dict, leaf: Callable[[str], torch.Tensor],
                   tokens: torch.Tensor, pos: torch.Tensor,
                   spans: Sequence[range], precision: str = "float32"):
    """Final-normed hidden states (T, D) of the sequences laid end to end
    in ``tokens``; ``leaf(name)`` gives a weight as drawn (any dtype),
    read one layer at a time."""
    lin = Linear(precision)
    H, Hkv, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    h = leaf("embed.tok")[tokens].float()
    T = h.shape[0]
    theta = cfg["rope_theta"]
    for i in range(cfg["n_layers"]):
        def W(name, i=i):
            return leaf("layers." + name)[i]
        hn = lin.round(rmsnorm(h, W("ln1.scale").float()))
        q = lin(hn, lin.weight(W("attn.wq"))).view(T, H, D)
        k = lin(hn, lin.weight(W("attn.wk"))).view(T, Hkv, D)
        v = lin(hn, lin.weight(W("attn.wv"))).view(T, Hkv, D)
        q, k = lin.round(rope(q, pos, theta)), lin.round(rope(k, pos, theta))
        o = lin.round(attention(q, k, v, spans).reshape(T, H * D))
        h = lin.round(h + lin(o, lin.weight(W("attn.wo"))))
        hn = lin.round(rmsnorm(h, W("ln2.scale").float()))
        h = lin.round(h + ffn(cfg, lin, W, hn))
    return lin.round(rmsnorm(h, leaf("ln_f.scale").float()))


def logit_gaps(cfg: Dict, leaf: Callable[[str], torch.Tensor],
               requests: List[Dict], device, also: Sequence[str] = (),
               chunk: int = 1024) -> Dict[str, np.ndarray]:
    """For each served token of ``requests`` ({"prompt", "output"} token
    lists), the gap by which the reference's logit of that token lies
    below the reference's best at its position (0 where the server gave
    the reference's own choice).  For each
    precision in ``also`` (``fp8``, the control; ``bfloat16``), the same
    gap for the token that forward puts first at each position, fed the
    same prompts and served tokens."""
    device = torch.device(device)
    seqs, outs, spans, at = [], [], [], []
    start = 0
    for r in requests:
        served = list(r["output"])
        seq = list(r["prompt"]) + served[:-1]
        seqs.extend(seq)
        spans.append(range(start, start + len(seq)))
        first = start + len(r["prompt"]) - 1
        at.extend(range(first, first + len(served)))
        outs.extend(served)
        start += len(seq)
    tokens = torch.tensor(seqs, dtype=torch.long, device=device)
    pos = torch.cat([torch.arange(len(sp), device=device) for sp in spans])
    at_t = torch.tensor(at, dtype=torch.long, device=device)
    out_t = torch.tensor(outs, dtype=torch.long, device=device)
    result: Dict[str, np.ndarray] = {}
    with torch.no_grad(), exact_f32():
        h = forward_hidden(cfg, leaf, tokens, pos, spans)[at_t]
        others = {p: forward_hidden(cfg, leaf, tokens, pos, spans, p)[at_t]
                  for p in also}
        w = leaf("embed.unembed").float()
        gaps = {p: [] for p in ("gaps",) + tuple(also)}
        for lo in range(0, len(at), chunk):
            ref = h[lo:lo + chunk] @ w
            best = ref.amax(-1)
            idx = out_t[lo:lo + chunk, None]
            gaps["gaps"].append((best - ref.gather(-1, idx)[:, 0]).cpu())
            for p, hp in others.items():
                lin = Linear(p)
                pick = lin(hp[lo:lo + chunk], lin.weight(w)).argmax(-1)
                gaps[p].append((best - ref.gather(-1, pick[:, None])[:, 0])
                               .cpu())
        for p, g in gaps.items():
            result[p] = torch.cat(g).numpy().astype(np.float64)
    return result


def row_gaps(rows: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's gap from the same row of ``ref``, relative to the
    latter's norm."""
    return (rows - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)


def replay(cfg: Dict, leaf: Callable[[str], torch.Tensor],
           cache_k: torch.Tensor, cache_v: torch.Tensor,
           slots: List[Dict], precision: str = "float32"):
    """Each checked slot's whole sequence again from the server's own K
    and V: the token at position p attends to the cache's rows below p
    and to its own K and V, which it computes, so every position is one
    served step taken again.  ``slots`` holds {"slot", "sequence" (the
    tokens it fed, positions 0..P), "pos" (the checked positions, the
    last of the sequence)}; ``cache_k``/``cache_v``: (L, B, S, Hkv, D).
    -> (logits at the checked positions (sum n, V) in the slots' order,
    per layer the K (after RoPE) and V rows it computed side by side,
    (T, 2 Hkv D) for the sequences laid end to end)."""
    lin = Linear(precision)
    H, Hkv, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    G = H // Hkv
    dev = cache_k.device
    spans, at, lo = [], [], 0
    for s in slots:
        n = len(s["sequence"])
        if list(s["pos"]) != list(range(n - len(s["pos"]), n)):
            raise ValueError("the checked positions end the sequence")
        spans.append(range(lo, lo + n))
        at.extend(range(lo + n - len(s["pos"]), lo + n))
        lo += n
    tok = torch.cat([torch.as_tensor(s["sequence"]) for s in slots]).to(dev)
    pos = torch.cat([torch.arange(len(sp)) for sp in spans]).to(dev)
    h = lin.round(leaf("embed.tok")[tok].float())
    scale = 1.0 / math.sqrt(D)
    rows = []
    for i in range(cfg["n_layers"]):
        def W(name, i=i):
            return leaf("layers." + name)[i]
        hn = lin.round(rmsnorm(h, W("ln1.scale").float()))
        q = lin(hn, lin.weight(W("attn.wq"))).view(-1, H, D)
        k = lin(hn, lin.weight(W("attn.wk"))).view(-1, Hkv, D)
        v = lin(hn, lin.weight(W("attn.wv"))).view(-1, Hkv, D)
        q = lin.round(rope(q, pos, cfg["rope_theta"])).view(-1, Hkv, G, D)
        k = lin.round(rope(k, pos, cfg["rope_theta"]))
        v = lin.round(v)
        rows.append(torch.cat([k, v], -1).reshape(len(tok), -1))
        o = torch.empty_like(q)
        for s, sp in zip(slots, spans):
            n = len(sp)
            kc = cache_k[i, s["slot"], :n].float()           # n, Hkv, D
            vc = cache_v[i, s["slot"], :n].float()
            qs = q[sp.start:sp.stop]
            sc = torch.einsum("nkgd,skd->nkgs", qs, kc) * scale
            below = torch.ones(n, n, dtype=torch.bool, device=dev).tril(-1)
            sc = sc.masked_fill(~below[:, None, None], float("-inf"))
            own = torch.einsum("nkgd,nkd->nkg", qs, k[sp.start:sp.stop])
            pr = torch.softmax(torch.cat([sc, own[..., None] * scale], -1),
                               -1)
            o[sp.start:sp.stop] = \
                torch.einsum("nkgs,skd->nkgd", pr[..., :-1], vc) + \
                pr[..., -1:] * v[sp.start:sp.stop, :, None]
        o = lin.round(o.reshape(-1, H * D))
        h = lin.round(h + lin(o, lin.weight(W("attn.wo"))))
        hn = lin.round(rmsnorm(h, W("ln2.scale").float()))
        h = lin.round(h + ffn(cfg, lin, W, hn))
    at_t = torch.tensor(at, dtype=torch.long, device=dev)
    h = lin.round(rmsnorm(h[at_t], leaf("ln_f.scale").float()))
    return lin(h, lin.weight(leaf("embed.unembed"))), rows


def step_gaps(cfg: Dict, leaf: Callable[[str], torch.Tensor],
              cache_k: torch.Tensor, cache_v: torch.Tensor,
              slots: List[Dict], also: Sequence[str] = ()
              ) -> Dict[str, np.ndarray]:
    """The step-wise check (``replay``).  ``gaps``: for each checked step
    of each slot (``slots`` also holds "picked", the token the server
    gave or, while it fed the prompt, the one its step put first), the
    gap below the reference's best logit of that step.  ``kv0``: for
    each slot, the largest relative gap of a layer-0 K and V row that
    the server wrote (every position; they depend on its tokens alone)
    from the reference's.  ``rows``: the relative gap of every K and V
    row the server wrote at layers 1 and up, at every position of every
    slot, from the row the reference computes there from the rows
    below it.  For each precision in ``also``, the same from that
    forward in the program's place: the gap of the token it puts first,
    and its rows against the reference's."""
    dev = cache_k.device
    picked = torch.cat([torch.as_tensor(s["picked"]) for s in slots]).to(dev)
    out: Dict[str, np.ndarray] = {}

    def written(i):
        return torch.cat([torch.cat([cache_k[i, s["slot"], :len(s["sequence"])],
                                     cache_v[i, s["slot"], :len(s["sequence"])]],
                                    -1).reshape(len(s["sequence"]), -1)
                          for s in slots]).float()

    def summary(rows, ref_rows, key):
        ends = np.cumsum([len(s["sequence"]) for s in slots])[:-1]
        first = row_gaps(rows[0], ref_rows[0]).cpu().numpy()
        out[key["kv0"]] = np.array([g.max() for g in np.split(first, ends)])
        out[key["rows"]] = torch.cat(
            [row_gaps(a, b) for a, b in zip(rows[1:], ref_rows[1:])]) \
            .cpu().numpy().astype(np.float64)

    with torch.no_grad(), exact_f32():
        ref, ref_rows = replay(cfg, leaf, cache_k, cache_v, slots)
        best = ref.amax(-1)
        out["gaps"] = (best - ref.gather(-1, picked[:, None])[:, 0]) \
            .cpu().numpy().astype(np.float64)
        summary([written(i) for i in range(cfg["n_layers"])], ref_rows,
                {"kv0": "kv0", "rows": "rows"})
        for p in also:
            lg, rows = replay(cfg, leaf, cache_k, cache_v, slots, p)
            pick = lg.argmax(-1)
            out[p] = (best - ref.gather(-1, pick[:, None])[:, 0]) \
                .cpu().numpy().astype(np.float64)
            summary(rows, ref_rows, {"kv0": "kv0_" + p, "rows": "rows_" + p})
            del lg, rows
    return out
