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
