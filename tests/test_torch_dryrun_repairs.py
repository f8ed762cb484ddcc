"""The rewrites that let the port's dry-run place every reduced cell, each
held to the function it replaces:

* the MoE dispatch's segment starts from per-expert slot counts
  (``models.moe._segments``) equal ``searchsorted``'s on the sorted ids,
  the port's and the reference's (``src/repro/models/moe.py:74-79``),
  on random routings, routings that leave experts empty and routings
  that send every slot to one expert;
* the one-token cache write (``ShardCtx.write_rows``) on a (4, 2) mesh
  whose cache is sharded along its sequence (a masked select) or over
  batch and heads equals ``scatter_`` on plain tensors, at a scalar
  position and at per-slot positions;
* a head split (``ShardCtx.split_heads``) of a (4, 8, 40) product split
  over a 2-way axis into 5 heads, which no shard holds whole, and the
  merge back, equal the plain reshapes, gradients too; so do the
  causal conv's pad and the SSD's cumsum in their mesh forms
  (``ShardCtx.pad_front``, ``ShardCtx.cumsum``);
* the cross-entropy's gold logit (``layers.GoldLogit``): its loss and
  gradients equal ``torch.gather``'s bit for bit on plain tensors and
  the reference's at ``TOL``; on the mesh its gradient
  (``ShardCtx.gold_grad``) equals gather's bit for bit and keeps the
  logits' vocab split; and a small vocab-sharded train step traced on
  the fake process group holds no (B, chunk, V) f32 tensor replicated:
  its peak is below that tensor's bytes.

The mesh checks that compare values run on a real ``gloo`` group of 8
processes on this host (the fake group moves no data); the trace runs
in a process of its own on the fake group, as ``test_torch_dryrun.py``'s
do.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distrib.logical import NOSHARD as JNOSHARD
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch.distrib.logical import NOSHARD
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WORLD = 8


# ---------------------------------------------------------------------------
# segment starts
# ---------------------------------------------------------------------------
def _routings():
    rng = np.random.default_rng(0)
    G, N, E = 4, 64, 16
    return {
        "random": rng.integers(0, E, (G, N)),
        # experts 3..9 and 12 take no slot
        "empty_experts": rng.choice([0, 1, 2, 10, 11, 13, 14, 15], (G, N)),
        "one_expert": np.full((G, N), 7),
        "top2_ties": np.tile(np.arange(2), (G, N // 2)),
    }, E


@pytest.mark.parametrize("name", sorted(_routings()[0]))
def test_segments_equal_searchsorted(name):
    ids, E = _routings()
    ids = ids[name]
    flat = torch.from_numpy(ids)
    start, end = tmoe._segments(flat, E)
    assert start.dtype == end.dtype == torch.int64
    sorted_ids = torch.sort(flat, dim=-1, stable=True).values
    experts = torch.arange(E).expand(ids.shape[0], E).contiguous()
    assert torch.equal(start, torch.searchsorted(sorted_ids, experts))
    assert torch.equal(end, torch.searchsorted(sorted_ids, experts,
                                               right=True))
    # the reference's batched searchsorted on its own sorted ids
    jsorted = jnp.take_along_axis(
        jnp.asarray(ids), jnp.argsort(jnp.asarray(ids), axis=-1), axis=-1)
    jstart = jax.vmap(lambda r: jnp.searchsorted(r, jnp.arange(E),
                                                 side="left"))(jsorted)
    jend = jax.vmap(lambda r: jnp.searchsorted(r, jnp.arange(E),
                                               side="right"))(jsorted)
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    np.testing.assert_array_equal(end.numpy(), np.asarray(jend))


# ---------------------------------------------------------------------------
# the gold logit
# ---------------------------------------------------------------------------
def _gather_gold(logits, idx, shard):
    return torch.gather(logits, -1, idx)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().view(np.int32)


def test_gold_logit_gradient_is_gathers_bit_for_bit():
    """Upstream gradients of both signs, exact zeros of both signs and
    an infinity: with no mesh the Function's backward is gather's own
    (the elementwise form under a mesh is held in the gloo test)."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((3, 5, 11))
                              .astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 11, (3, 5, 1)))
    up = rng.standard_normal((3, 5, 1)).astype(np.float32)
    up[0, :3, 0] = [0.0, -0.0, np.inf]
    grads = []
    for gold in (tlayers.GoldLogit.apply, _gather_gold):
        x = logits.clone().requires_grad_(True)
        out = gold(x, idx, NOSHARD)
        out.backward(torch.from_numpy(up))
        grads.append((out, x.grad))
    assert np.array_equal(_bits(grads[0][0]), _bits(grads[1][0]))
    assert np.array_equal(_bits(grads[0][1]), _bits(grads[1][1]))


def _ce_setup(dt):
    jcfg = jconfigs.get_config("qwen1.5-4b").reduced()
    tcfg = tconfigs.get_config("qwen1.5-4b").reduced()
    rng = np.random.default_rng(2)
    B, S = 2, 32
    h = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    emb = {"tok": (0.02 * rng.standard_normal(
        (jcfg.vocab, jcfg.d_model))).astype(np.float32)}
    if not jcfg.tie_embeddings:
        emb["unembed"] = (0.02 * rng.standard_normal(
            (jcfg.d_model, jcfg.vocab))).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab, (B, S))
    labels[0, :5] = -1                       # ignored positions
    return jcfg, tcfg, h, emb, labels


def _torch_ce(tcfg, h, emb, labels, dt, chunk):
    th = torch.from_numpy(h).to(getattr(torch, dt)).requires_grad_(True)
    temb = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in emb.items()}
    loss = tlayers.chunked_cross_entropy(
        temb, tcfg, th, torch.from_numpy(labels), NOSHARD, chunk=chunk)
    loss.backward()
    # the gradients of the leaves the CE reads (an untied model's "tok"
    # has none)
    return loss, th.grad, {k: v.grad for k, v in temb.items()
                           if v.grad is not None}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_chunked_ce_with_gold_logit(dt, monkeypatch):
    """The loss and the gradients of h and the embedding: bit for bit
    those of the same CE with ``torch.gather``, and within ``TOL`` of
    ``jax.value_and_grad`` of the reference's CE."""
    jcfg, tcfg, h, emb, labels = _ce_setup(dt)
    loss, gh, gemb = _torch_ce(tcfg, h, emb, labels, dt, chunk=8)
    with monkeypatch.context() as m:
        m.setattr(tlayers.GoldLogit, "apply", _gather_gold)
        loss_g, gh_g, gemb_g = _torch_ce(tcfg, h, emb, labels, dt, chunk=8)
    assert torch.equal(loss, loss_g)
    assert torch.equal(gh, gh_g)
    assert gemb and gemb.keys() == gemb_g.keys()
    assert all(torch.equal(gemb[k], gemb_g[k]) for k in gemb)

    jdt = getattr(jnp, dt)

    def jloss(hh, ee):
        return jlayers.chunked_cross_entropy(
            ee, jcfg, hh.astype(jdt), jnp.asarray(labels), JNOSHARD,
            chunk=8)

    jl, (jgh, jgemb) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), {k: jnp.asarray(v) for k, v in emb.items()})
    tol = TOL[dt]
    np.testing.assert_allclose(loss.float().item(), float(jl), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(gh.float().numpy(), np.asarray(jgh),
                               rtol=tol, atol=tol)
    for k in gemb:
        np.testing.assert_allclose(gemb[k].numpy(), np.asarray(jgemb[k]),
                                   rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# ShardCtx.einsum and ShardCtx.matmul with no mesh, and the local plan
# ---------------------------------------------------------------------------
def _site_operands():
    """Each product site's equation with operands of the reduced
    qwen1.5-4b's and mamba2-130m's shapes (batch 2, a chunk of 16)."""
    q = tconfigs.get_config("qwen1.5-4b").reduced()
    m = tconfigs.get_config("mamba2-130m").reduced()
    B, C, S = 2, 16, 32
    K, G, D = q.n_kv_heads, q.n_heads // q.n_kv_heads, q.head_dim
    H, Pd, N = m.ssm_heads, m.ssm_head_dim, m.ssm_state
    return {
        "chunked_scores": ("bqkgd,bskd->bkgqs", [(B, C, K, G, D),
                                                 (B, S, K, D)]),
        "chunked_values": ("bkgqs,bskd->bqkgd", [(B, K, G, C, S),
                                                 (B, S, K, D)]),
        "decode_scores": ("bkgd,bskd->bkgs", [(B, K, G, D), (B, S, K, D)]),
        "decode_values": ("bkgs,bskd->bkgd", [(B, K, G, S), (B, S, K, D)]),
        "ssd_gram": ("bqn,bsn->bqs", [(B, C, N), (B, C, N)]),
        "ssd_diag": ("bhqs,bshp->bqhp", [(B, H, C, C), (B, C, H, Pd)]),
        "ssd_off": ("bqn,bhpn,bhq->bqhp", [(B, C, N), (B, H, Pd, N),
                                            (B, H, C)]),
        "ssd_state": ("bqn,bhq,bqhp->bhpn", [(B, C, N), (B, H, C),
                                              (B, C, H, Pd)]),
        "mamba_update": ("bh,bhp,bn->bhpn", [(B, H), (B, H, Pd), (B, N)]),
        "mamba_read": ("bhpn,bn->bhp", [(B, H, Pd, N), (B, N)]),
    }


@pytest.mark.parametrize("name", sorted(_site_operands()))
def test_noshard_einsum_is_torch_einsum(name):
    """With no mesh ``ShardCtx.einsum`` is ``torch.einsum``: the same
    bits, forward and gradients, at each site's equation."""
    eq, shapes = _site_operands()[name]
    rng = np.random.default_rng(3)
    fulls = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in shapes]
    outs = []
    for fn in (NOSHARD.einsum, torch.einsum):
        xs = [t.clone().requires_grad_(True) for t in fulls]
        out = fn(eq, *xs)
        out.backward(torch.ones_like(out))
        outs.append([out] + [x.grad for x in xs])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_noshard_matmul_is_matmul(dt):
    """With no mesh ``ShardCtx.matmul`` is ``x @ w`` bit for bit, forward
    and gradients, at the reduced qwen1.5-4b's projection shapes."""
    cfg = tconfigs.get_config("qwen1.5-4b").reduced()
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal((2, 32, cfg.d_model))
                          .astype(np.float32)).to(getattr(torch, dt))
    w0 = torch.from_numpy(rng.standard_normal((cfg.d_model, cfg.q_dim))
                          .astype(np.float32)).to(getattr(torch, dt))
    outs = []
    for fn in (NOSHARD.matmul, torch.matmul):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        out = fn(x, w)
        out.backward(torch.ones_like(out))
        outs.append((out, x.grad, w.grad))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


class _Mesh:
    """What ``_local_plan`` reads of a mesh: its dims and their sizes."""
    ndim = 2

    @staticmethod
    def size(axis):
        return (4, 2)[axis]


@pytest.mark.parametrize("eq,shapes,pls,out,grads", [
    # batch and heads split, the same in both: a local product
    ("bkgd,bskd->bkgs", [(8, 4, 2, 16), (8, 32, 4, 16)],
     [("S0", "S1"), ("S0", "S2")], ("S0", "S1"),
     [("S0", "S1"), ("S0", "S2")]),
    # a free dim of one operand split, the other whole on that axis: its
    # gradient is a pending sum
    ("bsd,df->bsf", [(8, 32, 16), (16, 8)], [("S0", "R"), ("R", "S1")],
     ("S0", "S2"), [("S0", "P"), ("P", "S1")]),
    # the contracted dim split in both: a pending-sum result
    ("bsf,fd->bsd", [(8, 32, 8), (8, 16)], [("S0", "S2"), ("R", "S0")],
     ("S0", "P"), [("S0", "S2"), ("P", "S0")]),
    # one operand a pending sum, the other whole: a pending sum
    ("bkgd,bskd->bkgs", [(8, 4, 2, 16), (8, 32, 4, 16)],
     [("S0", "P"), ("S0", "R")], ("S0", "P"), [("S0", "R"), ("S0", "P")]),
    # a plain tensor is whole; its gradient has no placements
    ("bqn,nm->bqm", [(8, 16, 4), (4, 6)], [("S0", "R"), None],
     ("S0", "R"), [("S0", "R"), None]),
    # two letters split over one axis, or a letter split in one operand
    # and whole in another that holds it: no local product
    ("bqn,bsn->bqs", [(8, 16, 4), (8, 16, 4)], [("S0", "S1"), ("S0", "S1")],
     None, None),
    ("bkgd,bskd->bkgs", [(8, 4, 2, 16), (8, 32, 4, 16)],
     [("S0", "S1"), ("S0", "R")], None, None),
    # heads that do not split evenly: no local product
    ("bkgd,bskd->bkgs", [(8, 5, 2, 16), (8, 32, 5, 16)],
     [("S0", "S1"), ("S0", "S2")], None, None),
])
def test_local_plan(eq, shapes, pls, out, grads):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.distrib.logical import _local_plan

    def placed(names):
        return None if names is None else tuple(
            Replicate() if n == "R" else Partial() if n == "P"
            else Shard(int(n[1:])) for n in names)

    plan = _local_plan(eq, [(s, placed(p)) for s, p in zip(shapes, pls)],
                       _Mesh)
    if out is None:
        assert plan is None
    else:
        assert plan == (placed(out), tuple(placed(g) for g in grads))


# ---------------------------------------------------------------------------
# on a mesh: 8 gloo processes
# ---------------------------------------------------------------------------
WORKER = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (
        DTensor, Replicate, Shard, distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distrib.logical import NOSHARD, ShardCtx, fsdp_tp_rules
    from repro_torch.models.layers import GoldLogit

    rank, world, port = map(int, sys.argv[1:4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    ctx = ShardCtx(mesh=mesh, rules=fsdp_tp_rules(False))
    g = torch.Generator().manual_seed(0)
    res = {}

    # the one-token cache write
    cache = torch.randn(4, 16, 4, 8, generator=g)
    new = torch.randn(4, 1, 4, 8, generator=g)
    layouts = {"seq": ((Shard(1), Shard(2)), (Replicate(), Shard(2))),
               "batch_heads": ((Shard(0), Shard(2)), (Shard(0), Shard(2)))}
    for pos_name, pos in (("scalar", torch.tensor(9)),
                          ("per_slot", torch.tensor([1, 5, 9, 15]))):
        ref = cache.clone()
        NOSHARD.write_rows(ref, new, pos)
        hand = cache.clone()
        hand[torch.arange(4), pos.expand(4)] = new[:, 0]
        res[f"scatter_{pos_name}"] = torch.equal(ref, hand)
        for lay, (c_pl, n_pl) in layouts.items():
            c = distribute_tensor(cache.clone(), mesh, c_pl)
            n = distribute_tensor(new, mesh, n_pl)
            p = distribute_tensor(pos, mesh, (Replicate(), Replicate()))
            with implicit_replication():
                ctx.write_rows(c, n, p)
            res[f"write_{lay}_{pos_name}"] = (
                torch.equal(c.full_tensor(), ref)
                and tuple(c.placements) == c_pl)

    # a head split that no shard holds whole: 5 heads of 8 over 2 ranks
    x_full = torch.randn(4, 8, 40, generator=g)
    w_full = torch.randn(4, 8, 5, 8, generator=g)
    x = distribute_tensor(x_full, mesh, (Replicate(), Shard(2)))
    x.requires_grad_(True)
    with implicit_replication():
        y = ctx.split_heads(x, 5)
        back = ctx.merge_heads(y)
        (y * w_full).sum().backward()
    res["split"] = torch.equal(y.full_tensor(), x_full.reshape(4, 8, 5, 8))
    res["split_replicated"] = all(isinstance(p, Replicate)
                                  for p in y.placements)
    res["merge_back"] = torch.equal(back.full_tensor(), x_full)
    res["split_grad"] = torch.equal(x.grad.full_tensor(),
                                    w_full.reshape(4, 8, 40))
    # heads DTensor split unevenly (5 over 2) merge whole
    o = distribute_tensor(w_full, mesh, (Replicate(), Shard(2)))
    res["merge_uneven"] = torch.equal(ctx.merge_heads(o).full_tensor(),
                                      w_full.reshape(4, 8, 40))

    # the gold logit's mask and gradient on vocab-sharded logits
    logits_full = torch.randn(8, 4, 32, generator=g)
    idx_full = torch.randint(0, 32, (8, 4, 1), generator=g)
    up_full = torch.randn(8, 4, 1, generator=g)
    logits = distribute_tensor(logits_full, mesh, (Shard(0), Shard(2)))
    logits.requires_grad_(True)
    idx = distribute_tensor(idx_full, mesh, (Shard(0), Replicate()))
    up = distribute_tensor(up_full, mesh, (Shard(0), Replicate()))
    up_full[0, :3, 0] = torch.tensor([0.0, -0.0, float("inf")])
    up = distribute_tensor(up_full, mesh, (Shard(0), Replicate()))
    grad = ctx.gold_grad(up, idx, logits)
    plain = torch.zeros_like(logits_full).scatter_add_(-1, idx_full, up_full)
    res["gold_grad_bits"] = (
        torch.equal(grad.full_tensor().view(torch.int32),
                    plain.view(torch.int32))
        and tuple(grad.placements) == tuple(logits.placements))
    GoldLogit.apply(logits, idx, ctx).backward(up)
    plain = logits_full.clone().requires_grad_(True)
    torch.gather(plain, -1, idx_full).backward(up_full)
    res["gold_grad"] = torch.equal(logits.grad.full_tensor(), plain.grad)
    res["gold_grad_placed"] = (tuple(logits.grad.placements)
                               == (Shard(0), Shard(2)))
    # the causal conv's pad and the SSD's cumsum under a mesh
    xs_full = torch.randn(4, 6, 16, generator=g)
    ws_full = torch.randn(4, 6, 16, generator=g)
    xs = distribute_tensor(xs_full, mesh, (Shard(0), Shard(1)))
    res["pad"] = torch.equal(
        ctx.pad_front(xs, 3).full_tensor(),
        torch.nn.functional.pad(xs_full, (0, 0, 3, 0)))
    xs.requires_grad_(True)
    with implicit_replication():
        cs = ctx.cumsum(xs)
        (cs * ws_full).sum().backward()
    plain_x = xs_full.clone().requires_grad_(True)
    (torch.cumsum(plain_x, -1) * ws_full).sum().backward()
    res["cumsum"] = (torch.equal(cs.full_tensor(), torch.cumsum(xs_full, -1))
                     and torch.equal(xs.grad.full_tensor(), plain_x.grad))

    # the products on the local shards: ShardCtx.einsum at every equation
    # of the model's sites and ShardCtx.matmul of a sequence-split
    # activation, forward and gradients, against the plain ops on the
    # whole tensors: bit for bit where only batch dims (in every operand)
    # are split, so each rank multiplies whole matrices of the plain
    # product, and no pending sum is left; else f32 2e-5 (a split row or
    # column dim gives the CPU's GEMM another blocking, a split
    # contracted dim a pending sum)
    from torch.distributed.tensor import Partial
    from repro_torch.distrib.logical import _local_plan

    def close(a, b, exact):
        if exact:
            return torch.equal(a, b)
        return torch.allclose(a, b, rtol=2e-5, atol=2e-5)

    def pending(t):
        return any(isinstance(q, Partial) for q in t.placements)

    def product(name, fn, plain, fulls, pls, batch_only):
        ins = [distribute_tensor(t, mesh, pl).requires_grad_(True)
               for t, pl in zip(fulls, pls)]
        with implicit_replication():
            out = fn(*ins)
            up = torch.randn(out.shape, generator=g)
            (out * up).sum().backward()
        refs = [t.clone().requires_grad_(True) for t in fulls]
        ref = plain(*refs)
        (ref * up).sum().backward()
        exact = batch_only and not pending(out)
        res[f"{name}_out"] = close(out.full_tensor(), ref, exact)
        res[f"{name}_grads"] = all(
            close(a.grad.full_tensor(), b.grad,
                  batch_only and not pending(a.grad))
            for a, b in zip(ins, refs))
        res[f"{name}_exact"] = exact
        return ins, out

    def batch_only(eq, pls):
        ins = eq.split("->")[0].split(",")
        split = {s[q.dim] for s, pl in zip(ins, pls) for q in pl
                 if isinstance(q, Shard)}
        return all(c in s for c in split for s in ins)

    S0, S1, S2, R = Shard(0), Shard(1), Shard(2), Replicate()
    B, Q, S, K, G, D, H, P, N = 4, 8, 16, 4, 2, 8, 4, 6, 8
    rnd = lambda *shape: torch.randn(*shape, generator=g)
    EINSUMS = {
        # attention: batch over "data", KV heads over "model"
        "chunked_scores": ("bqkgd,bskd->bkgqs", [rnd(B, Q, K, G, D),
                           rnd(B, S, K, D)], [(S0, S2), (S0, S2)]),
        "chunked_values": ("bkgqs,bskd->bqkgd", [rnd(B, K, G, Q, S),
                           rnd(B, S, K, D)], [(S0, S1), (S0, S2)]),
        "decode_scores": ("bkgd,bskd->bkgs", [rnd(B, K, G, D),
                          rnd(B, S, K, D)], [(S0, S1), (S0, S2)]),
        "decode_values": ("bkgs,bskd->bkgd", [rnd(B, K, G, S),
                          rnd(B, S, K, D)], [(S0, S1), (S0, S2)]),
        # the SSD's intra-chunk products: batch over "data", the chunk's
        # rows or the heads over "model"
        "ssd_gram": ("bqn,bsn->bqs", [rnd(B, Q, N), rnd(B, Q, N)],
                     [(S0, S1), (S0, R)]),
        "ssd_diag": ("bhqs,bshp->bqhp", [rnd(B, H, Q, Q), rnd(B, Q, H, P)],
                     [(S0, S1), (S0, S2)]),
        "ssd_off": ("bqn,bhpn,bhq->bqhp", [rnd(B, Q, N), rnd(B, H, P, N),
                    rnd(B, H, Q)], [(S0, R), (S0, S1), (S0, S1)]),
        "ssd_state": ("bqn,bhq,bqhp->bhpn", [rnd(B, Q, N), rnd(B, H, Q),
                      rnd(B, Q, H, P)], [(S0, R), (S0, S1), (S0, S2)]),
        # the Mamba decode's state update and read
        "mamba_update": ("bh,bhp,bn->bhpn", [rnd(B, H), rnd(B, H, P),
                         rnd(B, N)], [(S0, S1), (S0, S1), (S0, R)]),
        "mamba_read": ("bhpn,bn->bhp", [rnd(B, H, P, N), rnd(B, N)],
                       [(S0, S1), (S0, R)]),
        # a contracted dim split: the keys over "model", a pending sum
        "values_split_keys": ("bkgs,bskd->bkgd", [rnd(B, K, G, S),
                              rnd(B, S, K, D)], [(S0, Shard(3)), (S0, S1)]),
    }
    for name, (eq, fulls, pls) in EINSUMS.items():
        product(f"einsum_{name}",
                lambda *xs, eq=eq: ctx.einsum(eq, *xs),
                lambda *xs, eq=eq: torch.einsum(eq, *xs), fulls, pls,
                batch_only(eq, pls))
        res[f"einsum_{name}_local"] = _local_plan(
            eq, [(t.shape, pl) for t, pl in zip(fulls, pls)], mesh) is not None
    # a pending-sum operand against a whole one: a pending-sum result
    qf, kf = rnd(B, K, G, D), rnd(B, S, K, D)
    half = distribute_tensor(qf, mesh, (S0, R)).to_local() * 0.5
    qp = DTensor.from_local(half, mesh, (S0, Partial()), run_check=False)
    kr = distribute_tensor(kf, mesh, (S0, R))
    with implicit_replication():
        op = ctx.einsum("bkgd,bskd->bkgs", qp, kr)
    res["einsum_pending_operand"] = (
        tuple(op.placements) == (S0, Partial())
        and close(op.full_tensor(), torch.einsum("bkgd,bskd->bkgs", qf, kf),
                  False))
    # two letters split on one axis: no local product, DTensor's einsum
    cq, cs = rnd(B, Q, N), rnd(B, S, N)
    a = distribute_tensor(cq, mesh, (S0, S1))
    b = distribute_tensor(cs, mesh, (S0, S1))
    with implicit_replication():
        via = ctx.einsum("bqn,bsn->bqs", a, b)
        own = torch.einsum("bqn,bsn->bqs", a, b)
    res["einsum_falls_through"] = (
        _local_plan("bqn,bsn->bqs", [(cq.shape, a.placements),
                                     (cs.shape, b.placements)], mesh) is None
        and tuple(via.placements) == tuple(own.placements)
        and torch.equal(via.full_tensor(), own.full_tensor())
        and close(via.full_tensor(), torch.einsum("bqn,bsn->bqs", cq, cs),
                  False))

    # ShardCtx.matmul: (B, S, D) split over batch and sequence against a
    # weight split over F (gathered sequence), over D (the activation
    # moved onto D, a pending sum), whole (the sequence kept), and split
    # over D on the batch's axis and over F on the sequence's (the weight
    # gathered on the first, the sequence on the second)
    xf = rnd(B, S, D)
    for name, wpl in (("cols", (R, S1)), ("rows", (R, S0)),
                      ("whole", (R, R)), ("both", (S0, S1))):
        ins, out = product(f"matmul_{name}", ctx.matmul,
                           lambda x, w: x @ w, [xf, rnd(D, 6)],
                           [(S0, S1), wpl], False)
        res[f"matmul_{name}_placed"] = [repr(q) for q in out.placements]

    # the embedding lookup on a vocab-split table (the FSDP-gathered
    # table of fsdp_tp and fsdp_tp_nosp: vocab over "model"), tokens split
    # over batch (nosp) or over batch and sequence (fsdp_tp)
    table_full = torch.randn(32, 8, generator=g)
    tok_full = torch.randint(0, 32, (8, 8), generator=g)
    for name, tok_pl in (("nosp", (S0, R)), ("seq", (S0, S1))):
        table = distribute_tensor(table_full, mesh, (R, S0))
        table.requires_grad_(True)
        tok = distribute_tensor(tok_full, mesh, tok_pl)
        with implicit_replication():
            out = ctx.embed(table, tok, torch.float32)
            up = torch.randn(out.shape, generator=g)
            (out * up).sum().backward()
        plain = table_full.clone().requires_grad_(True)
        ref = torch.nn.functional.embedding(tok_full, plain)
        (ref * up).sum().backward()
        res[f"embed_{name}"] = torch.equal(out.full_tensor(), ref)
        res[f"embed_{name}_pending"] = (
            tuple(out.placements) == (tok_pl[0], Partial()))
        res[f"embed_{name}_grad"] = torch.allclose(
            table.grad.full_tensor(), plain.grad, rtol=1e-6, atol=1e-6)
        res[f"embed_{name}_grad_split"] = table.grad.placements[1] == S0

    # the tied table (S1, R: FSDP over D, vocab whole, as mamba2-130m's
    # at production width) read by the lookup through its FSDP gather and
    # by the logits product through ShardCtx.transpose: both gradients
    # meet in the table's own placement, where autograd sums them
    tied_full = torch.randn(16, 8, generator=g)
    h_full = torch.randn(8, 8, generator=g)
    tok2_full = torch.randint(0, 16, (8, 4), generator=g)
    tied = distribute_tensor(tied_full, mesh, (S1, R)).requires_grad_(True)
    h = distribute_tensor(h_full, mesh, (S0, R))
    tok2 = distribute_tensor(tok2_full, mesh, (S0, R))
    with implicit_replication():
        logits = h @ ctx.transpose(tied)
        rows = ctx.embed(tied.redistribute(mesh, (R, R)), tok2,
                         torch.float32)
        up_l = torch.randn(logits.shape, generator=g)
        up_r = torch.randn(rows.shape, generator=g)
        ((logits * up_l).sum() + (rows * up_r).sum()).backward()
    plain = tied_full.clone().requires_grad_(True)
    ((h_full @ plain.T * up_l).sum() + (torch.nn.functional.embedding(
        tok2_full, plain) * up_r).sum()).backward()
    res["tied_forward"] = torch.allclose(logits.full_tensor(),
                                         h_full @ tied_full.T, rtol=1e-6,
                                         atol=1e-6)
    res["tied_grad"] = torch.allclose(tied.grad.full_tensor(), plain.grad,
                                      rtol=1e-5, atol=1e-5)
    res["tied_grad_placed"] = tuple(tied.grad.placements) == (S1, R)

    # the MoE grouping of a sequence-split input, and its unfold: the
    # groups' view placed as DTensor places it (the sequence gathered),
    # gradients back to each side's own placement
    xm_full = torch.randn(8, 16, 4, generator=g)
    xm = distribute_tensor(xm_full, mesh, (S0, S1)).requires_grad_(True)
    resid = distribute_tensor(torch.randn(8, 16, 4, generator=g), mesh,
                              (S0, S1))
    with implicit_replication():
        grouped = ctx.fold_groups(xm, 4)
        res["fold"] = (torch.equal(grouped.full_tensor(),
                                   xm_full.reshape(4, 32, 4))
                       and tuple(grouped.placements) == (S0, R))
        back = ctx.unfold_groups(grouped * 2.0, 8)
        out = back + resid
        up = torch.randn(out.shape, generator=g)
        (out * up).sum().backward()
    res["unfold"] = torch.equal(back.full_tensor(), xm_full * 2.0)
    res["fold_grad"] = (torch.equal(xm.grad.full_tensor(), up * 2.0)
                        and tuple(xm.grad.placements) == (S0, S1))

    if rank == 0:
        print(json.dumps(res))
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    script = tmp_path_factory.mktemp("gloo") / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(WORLD)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return json.loads(outs[0].strip().splitlines()[-1])


@pytest.mark.parametrize("pos", ["scalar", "per_slot"])
@pytest.mark.parametrize("layout", ["seq", "batch_heads"])
def test_masked_write_equals_scatter(gloo, layout, pos):
    assert gloo[f"scatter_{pos}"]
    assert gloo[f"write_{layout}_{pos}"]


def test_head_split_on_shards_without_whole_heads(gloo):
    assert gloo["split"] and gloo["merge_back"] and gloo["split_grad"]
    # 5 heads do not split 2 ways: the model axis is replicated
    assert gloo["split_replicated"]
    assert gloo["merge_uneven"]


def test_conv_pad_and_cumsum_on_a_mesh(gloo):
    """The concatenation and the flip-free backward give F.pad's and
    torch.cumsum's values and gradient bit for bit."""
    assert gloo["pad"] and gloo["cumsum"]


#: the site equations whose split letters are batch dims of the product
#: (in every operand): each rank multiplies whole matrices, bit for bit
BATCH_SPLIT = ("chunked_scores", "chunked_values", "decode_scores",
               "decode_values", "ssd_diag")


@pytest.mark.parametrize("name", BATCH_SPLIT + (
    "ssd_gram", "ssd_off", "ssd_state", "mamba_update", "mamba_read",
    "values_split_keys"))
def test_einsum_on_local_shards(gloo, name):
    """``ShardCtx.einsum`` at each site's equation with batch over one
    axis and heads (or the chunk's rows) over the other is a local
    product and gives the plain einsum's values and gradients: bit for
    bit where only batch dims are split; a split row dim (another GEMM
    blocking on the CPU) or a split key dim (a pending sum) at 2e-5."""
    assert gloo[f"einsum_{name}_local"]
    assert gloo[f"einsum_{name}_out"] and gloo[f"einsum_{name}_grads"]
    assert gloo[f"einsum_{name}_exact"] == (name in BATCH_SPLIT)


def test_einsum_pending_operand_and_fall_through(gloo):
    """A pending-sum operand against whole ones is local (a pending-sum
    result); two letters split over one axis are not, and DTensor's own
    einsum plans it (2.13 places it), with its placements and values."""
    assert gloo["einsum_pending_operand"]
    assert gloo["einsum_falls_through"]


@pytest.mark.parametrize("name,placed", [
    ("cols", ["Shard(dim=0)", "Shard(dim=2)"]),
    ("rows", ["Shard(dim=0)", "Partial(sum)"]),
    ("whole", ["Shard(dim=0)", "Shard(dim=1)"]),
    ("both", ["Shard(dim=0)", "Shard(dim=2)"])])
def test_matmul_of_a_sequence_split_activation(gloo, name, placed):
    """``ShardCtx.matmul`` of (B, S, D) split over batch and sequence: the
    placements DTensor gives ``x @ w`` (F split, a pending sum over a
    split D, the sequence kept, the weight's D gathered where it shares
    the batch's axis), the plain product's values and gradients at 2e-5
    (rows or columns split, or a pending sum)."""
    assert gloo[f"matmul_{name}_placed"] == placed
    assert gloo[f"matmul_{name}_out"] and gloo[f"matmul_{name}_grads"]


def test_gold_logit_keeps_the_vocab_split(gloo):
    assert gloo["gold_grad_bits"] and gloo["gold_grad"]
    assert gloo["gold_grad_placed"]


# ---------------------------------------------------------------------------
# the traced peak of a vocab-sharded train step
# ---------------------------------------------------------------------------
PEAK = textwrap.dedent("""
    import dataclasses, json
    from repro_torch.analysis.roofline import trace_plan
    from repro_torch.configs import REGISTRY, get_shape
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_plan
    from repro_torch.models.blocks import ModelOpts
    V, B, S = 65536, 8, 128
    cfg = dataclasses.replace(REGISTRY["qwen1.5-4b"].reduced(), vocab=V)
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=S,
                                global_batch=B)
    cost = trace_plan(build_plan(cfg, shape, make_mesh(4, 2),
                                 strategy="fsdp_tp_nosp",
                                 opts=ModelOpts(attn_chunk=64, ce_chunk=S)))
    print(json.dumps({"peak": cost.peak_bytes, "args": cost.arg_bytes,
                      "replicated": B * S * V * 4}))
""")


def test_vocab_sharded_train_trace_holds_no_replicated_logits():
    """qwen1.5-4b reduced with a 65,536 vocab, batch 8 x 128 in one CE
    chunk, ``fsdp_tp_nosp`` on (4, 2): the logits split 2 ways over the
    vocab.  gather's backward made its (8, 128, 65536) f32 zeros
    replicated, 268 MB, above the whole step's peak now."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", PEAK], capture_output=True,
                          text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert 0 < r["args"] < r["peak"] < r["replicated"]


# ---------------------------------------------------------------------------
# the embedding lookup, the tied table's transpose and the MoE grouping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_noshard_embed_transpose_fold_are_the_plain_ops(dt):
    """With no mesh ``ShardCtx.embed`` is ``F.embedding`` of the cast
    table, ``ShardCtx.transpose`` is ``.T`` and ``fold_groups`` /
    ``unfold_groups`` are the reshapes: the same bits, forward and
    gradients."""
    rng = np.random.default_rng(5)
    table0 = torch.from_numpy(rng.standard_normal((32, 8))
                              .astype(np.float32))
    tok = torch.from_numpy(rng.integers(0, 32, (4, 6)))
    x0 = torch.from_numpy(rng.standard_normal((8, 6, 8)).astype(np.float32))
    dtype = getattr(torch, dt)
    outs = []
    for embed, transpose, fold, unfold in (
            (NOSHARD.embed, NOSHARD.transpose, NOSHARD.fold_groups,
             NOSHARD.unfold_groups),
            (lambda t, i, d: torch.nn.functional.embedding(i, t.to(d)),
             lambda w: w.T, lambda x, g: x.reshape(g, -1, x.shape[-1]),
             lambda y, b: y.reshape(b, -1, y.shape[-1]))):
        table = table0.clone().requires_grad_(True)
        x = x0.clone().requires_grad_(True)
        rows = embed(table, tok, dtype)
        logits = x.to(dtype) @ transpose(table.to(dtype))
        grouped = fold(x, 4)
        back = unfold(grouped * 3.0, 8)
        (rows.float().sum() + logits.float().square().sum()
         + back.square().sum()).backward()
        outs.append((rows, logits, grouped, back, table.grad, x.grad))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert outs[0][2].shape == (4, 12, 8)


@pytest.mark.parametrize("layout", ["nosp", "seq"])
def test_embed_reads_each_ranks_own_vocab(gloo, layout):
    """``ShardCtx.embed`` on a vocab-split table: ``F.embedding``'s rows bit
    for bit (each row the sum of its own and zeros), left a pending sum
    over the vocab's axis; the gradient (the local scatter-add) within
    1e-6 of ``F.embedding``'s and split as the table is."""
    assert gloo[f"embed_{layout}"]
    assert gloo[f"embed_{layout}_pending"]
    assert gloo[f"embed_{layout}_grad"]
    assert gloo[f"embed_{layout}_grad_split"]


def test_tied_table_gradients_meet_in_its_placement(gloo):
    """A tied table read by the lookup (through its gather) and by the
    logits product (``ShardCtx.transpose``): the forward and the summed
    gradient equal the plain ones, and the gradient lies as the table."""
    assert gloo["tied_forward"] and gloo["tied_grad"]
    assert gloo["tied_grad_placed"]


def test_moe_fold_of_a_split_sequence(gloo):
    """``ShardCtx.fold_groups`` of a sequence-split input: the plain
    reshape's values, placed with the sequence gathered;
    ``unfold_groups`` back and the gradient through both, bit for bit,
    in the input's own placement."""
    assert gloo["fold"] and gloo["unfold"] and gloo["fold_grad"]
