"""The port's MoE family (phi3.5-moe-42b-a6.6b and llama4-scout-17b-a16e,
reduced) against the JAX reference, on the same numpy parameters and
inputs: the spec, ``moe_ffn`` (including slots dropped past capacity,
tied router probabilities and top-1 routing), ``router_aux_loss``,
``Model.forward``/``loss`` with the aux term, ``prefill``,
``decode_step`` with and without the flash-decode kernel, and serving.

Parameters come from the reference's ``Model.init``
(``test_torch_model._np_params``).  Tolerances: f32 2e-5, bf16 2e-2
(``tests/test_kernels.py:14``); bf16 hidden states after several layers
are held in norm (``test_torch_ssm._close_bf16_hidden``).  On the CPU the
decode kernel's wrapper runs its plain version and counts it in
``COUNT.plain``, never in ``COUNT.launches``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distrib.logical import NOSHARD as JNOSHARD
from repro.models import moe as jmoe
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import Model as JModel
from repro.runtime.serve import BatchedServer as JBatchedServer
from repro.runtime.serve import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.distrib.logical import NOSHARD
from repro_torch.interop import params_from_numpy, spec_tree
from repro_torch.kernels import decode_attention as da
from repro_torch.models import moe as tmoe
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model
from repro_torch.runtime.serve import BatchedServer, LockstepServer, Request

import test_torch_model as tm
from test_torch_model import TDT, TOL, _close, _f32, _np_params, _tokens
from test_torch_ssm import _close_bf16_hidden, _forward_pair

ARCH = "phi3.5-moe-42b-a6.6b"            # 16 experts, top-2 (reduced: 4)
TOP1_ARCH = "llama4-scout-17b-a16e"      # 16 experts, top-1 (reduced: 4)
MOE_ARCHS = [ARCH, TOP1_ARCH]
OPTS = dict(attn_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch=ARCH, **kw):
    return tm._cfgs(arch, **kw)


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_spec_tree_equals_reference(arch, reduced):
    jcfg, tcfg = jconfigs.REGISTRY[arch], tconfigs.REGISTRY[arch]
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    tspec = Model(tcfg).param_spec()
    assert spec_tree(tspec) == spec_tree(JModel(jcfg).param_spec())
    assert "moe" in tspec["layers"] and "mlp" not in tspec["layers"]


@pytest.mark.parametrize("tokens_per_group,expect", [
    (1, 8), (2, 8), (25, 128), (256, 128), (2048, 384), (4096, 640)])
def test_capacity_and_groups_equal_reference(tokens_per_group, expect):
    """phi3.5-moe at full width: C = 8 at decode (one token a group), the
    128-rounding above it; G = B up to 32."""
    jcfg, tcfg = jconfigs.REGISTRY[ARCH], tconfigs.REGISTRY[ARCH]
    assert tmoe.capacity(tcfg, tokens_per_group) == expect == \
        jmoe.capacity(jcfg, tokens_per_group)
    for batch in (1, 3, 8, 32, 48, 64, 100):
        assert tmoe._num_groups(batch) == jmoe._num_groups(batch)


# ---------------------------------------------------------------------------
# moe_ffn and router_aux_loss
# ---------------------------------------------------------------------------
def _moe_params(cfg, seed=0, router_scale=0.5):
    rng = np.random.default_rng(seed)
    p = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in jmoe.moe_spec(cfg).items()}
    p["router"] *= router_scale / 0.1
    return p


def _moe_pair(jcfg, tcfg, p, x, dt):
    ref = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x, getattr(jnp, dt)), jcfg, JNOSHARD)
    out = tmoe.moe_ffn(params_from_numpy(p),
                       torch.from_numpy(x).to(TDT[dt]), tcfg, NOSHARD)
    assert out.dtype == TDT[dt] and tuple(out.shape) == x.shape
    return out, ref


def _reference_drops(jcfg, p, x):
    """Slots the reference drops: per group and expert, the slots its
    ``lax.top_k`` routes there beyond the capacity (numpy count)."""
    B, S, D = x.shape
    G = jmoe._num_groups(B)
    Tg = (B // G) * S
    C = jmoe.capacity(jcfg, Tg)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(G, Tg, D))
                           @ jnp.asarray(p["router"]), axis=-1)
    _, ids = jax.lax.top_k(probs, jcfg.top_k)
    ids = np.asarray(ids).reshape(G, -1)
    return int(sum(np.maximum(np.bincount(row, minlength=jcfg.n_experts)
                              - C, 0).sum() for row in ids))


@pytest.mark.parametrize("B,S", [(2, 16), (8, 1), (3, 5), (64, 1)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(B, S, dt):
    """(8, 1) is a decode step (G = 8, one token a group, C = 8); (64, 1)
    gives G = 32, two tokens a group."""
    jcfg, tcfg = _cfgs()
    p = _moe_params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    out, ref = _moe_pair(jcfg, tcfg, p, x, dt)
    _close(out.float(), ref, dt)
    assert int(tmoe.dropped_slots(params_from_numpy(p),
                                  torch.from_numpy(x), tcfg)) == 0


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_ffn_drops_slots_past_capacity(dt):
    """capacity_factor 0.01: C = 8 (the floor) for 64 tokens a group, whose
    128 slots over 4 experts overflow it.  Which slots are kept follows
    the stable argsort: the port keeps and drops the same ones."""
    jcfg, tcfg = _cfgs(capacity_factor=0.01)
    assert jmoe.capacity(jcfg, 64) == 8
    p = _moe_params(jcfg, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)
    drops = _reference_drops(jcfg, p, x)
    assert drops >= 2 * (128 - 4 * 8), drops   # a group keeps <= E * C
    assert int(tmoe.dropped_slots(params_from_numpy(p),
                                  torch.from_numpy(x), tcfg)) == drops
    out, ref = _moe_pair(jcfg, tcfg, p, x, dt)
    assert np.all(np.asarray(ref, np.float32) == 0, axis=-1).any()
    _close(out.float(), ref, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_ffn_ties_go_to_the_lower_experts(dt):
    """A zero router: every probability is 1/E, and lax.top_k keeps
    experts 0..K-1.  ``torch.topk`` promises no order on ties."""
    jcfg, tcfg = _cfgs()
    p = _moe_params(jcfg)
    p["router"][:] = 0
    x = np.random.default_rng(5).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    out, ref = _moe_pair(jcfg, tcfg, p, x, dt)
    _close(out.float(), ref, dt)
    gate_w, gate_ids, *_ = tmoe._route(
        params_from_numpy(p), torch.from_numpy(x).reshape(2, 16, -1), tcfg)
    assert torch.equal(gate_ids, torch.arange(tcfg.top_k).expand(2, 16, -1))
    assert torch.allclose(gate_w, torch.full_like(gate_w, 1 / tcfg.top_k))


@pytest.mark.parametrize("B,S", [(2, 16), (8, 1)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_ffn_top1(B, S, dt):
    """llama4-scout routes each token to one expert, its gate weight 1."""
    jcfg, tcfg = _cfgs(TOP1_ARCH)
    assert tcfg.top_k == 1
    p = _moe_params(jcfg, seed=6)
    x = np.random.default_rng(7).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    out, ref = _moe_pair(jcfg, tcfg, p, x, dt)
    _close(out.float(), ref, dt)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_router_aux_loss_matches_reference(tie, dt):
    """With a zero router every token's argmax is expert 0 (the first on
    a tie): f = one-hot(0), p = 1/E, so the loss is exactly 1."""
    jcfg, tcfg = _cfgs()
    p = _moe_params(jcfg, seed=8)
    if tie:
        p["router"][:] = 0
    x = np.random.default_rng(9).standard_normal(
        (3, 5, jcfg.d_model)).astype(np.float32)
    ref = jmoe.router_aux_loss({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x, getattr(jnp, dt)), jcfg)
    out = tmoe.router_aux_loss(params_from_numpy(p),
                               torch.from_numpy(x).to(TDT[dt]), tcfg)
    assert out.dtype == torch.float32 and out.dim() == 0
    _close(out, ref, "float32")
    if tie:
        assert float(out) == pytest.approx(1.0, abs=1e-6)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------
# A token whose K-th and (K+1)-th router probabilities lie closer than
# this in some layer has no decided routing in bf16: one bf16 unit in the
# router's input (the reference's jitted bf16 sums differ from op-by-op
# ones, test_torch_ssm.py) can swap the experts, and the token's hidden
# state then follows other weights.  Reduced llama4-scout (top-1) has two
# such tokens of 32 at seed 0, with gaps of 1.1e-5 and 3.3e-4 in its last
# layer, and their states differ by 9-11 % there.  So in bf16 the hidden
# states are held on the tokens whose routing is decided in every layer,
# as chip_smoke.py holds only decisive greedy tokens; the float32 config
# holds every token at the f32 tolerance.
ROUTE_MARGIN = 1e-3


def _routing_margins(monkeypatch, tcfg, params, toks):
    """(B, S): each token's smallest gap, over the layers of the port's own
    forward, between its K-th and (K+1)-th router probability."""
    margins, moe_ffn = [], tmoe.moe_ffn

    def spy(p, x, cfg, ctx):
        probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
        top = probs.sort(dim=-1, descending=True).values
        margins.append(top[..., cfg.top_k - 1] - top[..., cfg.top_k])
        return moe_ffn(p, x, cfg, ctx)

    monkeypatch.setattr(tmoe, "moe_ffn", spy)
    Model(tcfg).forward(params, {"tokens": toks}, opts=ModelOpts(**OPTS))
    monkeypatch.undo()
    assert len(margins) == tcfg.n_layers
    return torch.stack(margins).amin(dim=0).numpy()


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_loss_match_reference(arch, dtype, monkeypatch):
    """(h, aux) of ``Model.forward``, and ``Model.loss`` = CE + 0.01 aux.
    The aux loss is f32 in both dtypes: held at the f32 tolerance in the
    float32 config, at bf16's where its inputs are bf16.  bf16 hidden
    states: on the tokens with decided routing (``ROUTE_MARGIN``), at
    least 3/4 of them."""
    (hj, lj), (ht, aux, lt), counts, tcfg = _forward_pair(
        arch, False, dtype=dtype, S=16)
    jcfg, _ = _cfgs(arch, dtype=dtype)
    toks = _tokens(jcfg, 2, 16, 2)
    _, auxj = jax.jit(lambda p, b: JModel(jcfg).forward(
        p, b, opts=JOpts(remat="none", **OPTS)))(
        _np_params(jcfg), {"tokens": jnp.asarray(toks)})
    assert counts == (0, 0) and aux.dtype == torch.float32
    assert float(aux) > 0
    _close(aux, auxj, dtype)
    if dtype == "bfloat16":
        sure = _routing_margins(monkeypatch, tcfg,
                                params_from_numpy(_np_params(jcfg)),
                                torch.from_numpy(toks)) >= ROUTE_MARGIN
        assert sure.mean() >= 0.75, sure.mean()
        _close_bf16_hidden(_f32(ht)[sure], np.asarray(hj, np.float32)[sure])
    else:
        _close(ht, hj, dtype)
    _close(lt, lj, dtype)


def test_loss_adds_the_weighted_aux_loss():
    _, tcfg = _cfgs(dtype="float32")
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    toks = torch.from_numpy(_tokens(tcfg, 2, 8))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    base = model.loss(params, batch, opts=ModelOpts(aux_loss_coef=0.0))
    _, aux = model.forward(params, batch)
    for coef in (0.01, 0.5):
        torch.testing.assert_close(
            model.loss(params, batch, opts=ModelOpts(aux_loss_coef=coef)),
            base + coef * aux)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_logits_and_cache(arch):
    jcfg, tcfg = _cfgs(arch)
    params = _np_params(jcfg)
    toks = _tokens(jcfg, 2, 16)
    jmodel = JModel(jcfg)
    jopts = JOpts(remat="none", **OPTS)
    lj, cj = jax.jit(lambda p, b: jmodel.prefill(p, b, opts=jopts))(
        params, {"tokens": jnp.asarray(toks)})
    lt, ct = Model(tcfg).prefill(params_from_numpy(params),
                                 {"tokens": torch.from_numpy(toks)},
                                 opts=ModelOpts(**OPTS))
    assert lt.dtype == torch.float32 and ct["k"].dtype == torch.bfloat16
    _close(lt, lj, "bfloat16")
    for key in ("k", "v"):
        assert tuple(ct[key].shape) == cj[key].shape
        _close(_f32(ct[key]), cj[key], "bfloat16")


@pytest.mark.parametrize("pos", [5, (2, 9, 0)])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_matches_reference(pos, use_kernel, arch):
    """Scalar and per-slot pos, kernel on and off; three slots, three
    routing groups.  On the CPU "on" reaches the kernel's plain version,
    once a layer, and no launch is counted."""
    jcfg, tcfg = _cfgs(arch)
    (lj, cj), (lt, ct), counts = tm._decode_pair(jcfg, tcfg, pos, use_kernel)
    assert counts == (0, tcfg.n_layers if use_kernel else 0)
    _close(lt, lj, "bfloat16")
    for key in ("k", "v"):
        _close(ct[key].numpy(), cj[key], "bfloat16")


@pytest.mark.parametrize("pos", [4, (1, 6, 11)])
def test_decode_step_float32_config(pos):
    jcfg, tcfg = _cfgs(dtype="float32")
    (lj, cj), (lt, ct), _ = tm._decode_pair(jcfg, tcfg, pos, True)
    _close(lt, lj, "float32")
    _close(ct["k"].numpy(), cj["k"], "float32")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_matches_prefill(use_kernel):
    """Decoding token by token (one token a group, C = 8) reproduces the
    prefill's last logits (16 tokens a group) where no slot is dropped."""
    _, tcfg = _cfgs(dtype="float32")
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    S = 12
    toks = torch.from_numpy(_tokens(tcfg, 1, S))
    cache = model.init_cache(1, S, torch.float32)
    opts = ModelOpts(use_kernel=use_kernel, **OPTS)
    for i in range(S):
        lg, cache = model.decode_step(
            params, {"token": toks[:, i:i + 1], "pos": i}, cache, opts=opts)
    full, pcache = model.prefill(params, {"tokens": toks},
                                 opts=ModelOpts(attn_chunk=4))
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(cache["k"].numpy(), pcache["k"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_init_draws_layer_by_layer_in_any_dtype():
    """A stacked leaf is drawn one layer at a time in every dtype: seeded,
    of the spec's scale, its layers distinct, and a bf16 draw equals the
    f32 draw rounded."""
    _, tcfg = _cfgs()
    model = Model(tcfg)
    a = model.init(torch.Generator("cpu").manual_seed(0), torch.bfloat16)
    b = model.init(torch.Generator("cpu").manual_seed(0), torch.bfloat16)
    f = model.init(torch.Generator("cpu").manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)

    def rounded(t):
        if isinstance(t, dict):
            return {k: rounded(v) for k, v in t.items()}
        return t.to(torch.bfloat16)
    torch.testing.assert_close(a, rounded(f), rtol=0, atol=0)
    wi = a["layers"]["moe"]["wi"]
    assert wi.dtype == torch.bfloat16 and wi.shape[0] == tcfg.n_layers
    assert not torch.equal(wi[0], wi[1])
    assert 0.015 < float(wi.float().std()) < 0.025
    assert torch.all(a["layers"]["ln2"]["scale"] == 1)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _reqs(n, base=3, gen=5, cls=Request):
    return [cls(rid=i, prompt=[1 + i, base, base + i % 3],
                max_new_tokens=gen) for i in range(n)]


@pytest.fixture(scope="module")
def moe_model():
    _, tcfg = _cfgs()
    model = Model(tcfg)
    return model, model.init(torch.Generator("cpu").manual_seed(0))


@pytest.mark.parametrize("B,n", [(3, 3), (4, 2)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_continuous_bit_identical_to_lockstep(moe_model, B, n, use_kernel):
    model, params = moe_model
    opts = ModelOpts(use_kernel=use_kernel, **OPTS)
    lock = LockstepServer(model, params, batch_size=B, max_seq=64,
                          opts=opts, device="cpu")
    cont = BatchedServer(model, params, batch_size=B, max_seq=64, opts=opts,
                         device="cpu")
    assert cont.use_kernel == use_kernel
    assert cont.run(_reqs(n)) == lock.run(_reqs(n))


def test_kernel_path_counts_every_layer_of_every_step(moe_model):
    model, params = moe_model
    ref = BatchedServer(model, params, batch_size=2, max_seq=64,
                        use_kernel=False, device="cpu")
    ker = BatchedServer(model, params, batch_size=2, max_seq=64,
                        use_kernel=True, device="cpu")
    assert ker.use_kernel
    da.COUNT.reset()
    out = ker.run(_reqs(4))
    assert da.COUNT.launches == 0
    assert da.COUNT.plain == ker.steps * model.cfg.n_layers
    assert out == ref.run(_reqs(4))


def test_slot_reuse_serves_like_solo(moe_model):
    model, params = moe_model
    mk = lambda: Request(rid=7, prompt=[11, 12], max_new_tokens=5)
    ref = BatchedServer(model, params, batch_size=1, max_seq=64,
                        device="cpu").run([mk()])
    srv = BatchedServer(model, params, batch_size=1, max_seq=64,
                        use_kernel=True, device="cpu")
    srv.run([Request(rid=0, prompt=[3, 4, 5], max_new_tokens=6)])
    assert srv.run([mk()]) == ref


@pytest.mark.parametrize("arch,use_kernel", [(ARCH, True), (ARCH, False),
                                             (TOP1_ARCH, True)])
def test_greedy_tokens_match_jax_server(arch, use_kernel):
    """Same numpy parameters, same requests, float32 config: the torch and
    JAX continuous servers emit the same greedy tokens, slot reuse
    included (5 requests on 2 slots)."""
    jcfg, tcfg = _cfgs(arch, dtype="float32")
    params = _np_params(jcfg)
    jsrv = JBatchedServer(JModel(jcfg), params, batch_size=2, max_seq=32,
                          opts=JOpts(remat="none", **OPTS),
                          use_kernel=use_kernel)
    tsrv = BatchedServer(Model(tcfg), params_from_numpy(params),
                         batch_size=2, max_seq=32, opts=ModelOpts(**OPTS),
                         use_kernel=use_kernel, device="cpu")
    assert tsrv.use_kernel == jsrv.use_kernel == use_kernel
    ref = jsrv.run(_reqs(5, gen=6, cls=JRequest))
    assert tsrv.run(_reqs(5, gen=6)) == ref


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_launcher_runs_moe_reduced_on_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <moe> --reduced
    --device cpu``: every request answered with its tokens."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--requests", "3", "--batch", "2",
         "--new-tokens", "4"],
        env=env, cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["arch"] == arch
    assert out["requests"] == 3 and out["generated_tokens"] == 12
