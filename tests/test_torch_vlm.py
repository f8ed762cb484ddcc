"""The port's vlm family (llama-3.2-vision-90b, reduced) against the JAX
reference, on the same numpy parameters and inputs: ``cross_attention``
and the cross-attention blocks, the grouped parameter tree (``self`` of
(g, k) dense blocks, ``cross`` of g cross blocks, the remainder dropped),
``Model.forward``/``loss``, ``prefill`` and its cache with the projected
image K/V, ``decode_step`` at scalar positions and its refusal of
per-slot ones, the lockstep server fallback and the gradient of the loss.

The reduced config has g = 2 groups of k = 1 self-attention layer and one
cross block; ``n_layers=5`` leaves a remainder of one layer, which the
reference drops and so does the port.  Inputs and tolerances as in
``test_torch_hybrid``, whose helpers these tests use.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distrib.logical import NOSHARD as JNOSHARD
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import Model as JModel
from repro.runtime.serve import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.distrib.logical import NOSHARD
from repro_torch.interop import params_from_numpy, spec_tree, tree_to_numpy
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model

import test_torch_hybrid as th
import test_torch_model as tm
from test_torch_model import TDT, _close, _f32, _j, _np_params, _t

ARCH = "llama-3.2-vision-90b"
OPTS = th.OPTS
LAYERS = [4, 5]              # g=2, k=1; and a dropped remainder of 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return tm._cfgs(ARCH, **kw)


def _cross_params(jcfg):
    """Group 0's cross block, as numpy."""
    return jax.tree.map(lambda a: a[0], _np_params(jcfg)["cross"])


# ---------------------------------------------------------------------------
# specs and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", ["full", "reduced", "reduced-5"])
def test_param_spec_tree_equals_reference(size):
    jcfg, tcfg = jconfigs.REGISTRY[ARCH], tconfigs.REGISTRY[ARCH]
    if size != "full":
        jcfg, tcfg = _cfgs(n_layers=5 if size == "reduced-5" else 4)
    assert spec_tree(Model(tcfg).param_spec()) == \
        spec_tree(JModel(jcfg).param_spec())


def test_full_size_groups():
    """llama-3.2-vision-90b: 10 groups of 9 self layers and 1 cross."""
    spec = Model(tconfigs.REGISTRY[ARCH]).param_spec()
    assert spec["self"]["mlp"]["wi"].shape == (10, 9, 8192, 28672)
    assert spec["cross"]["gate"]["scale"].shape == (10, 8192)
    assert "bq" not in spec["cross"]["xattn"]


@pytest.mark.parametrize("n_layers", LAYERS)
def test_interop_carries_every_leaf(n_layers):
    """The nested self/cross tree goes to torch and back unchanged."""
    jcfg, _ = _cfgs(n_layers=n_layers)
    params = _np_params(jcfg)
    jax.tree.map(np.testing.assert_array_equal,
                 tree_to_numpy(params_from_numpy(params)), params)


def test_precast_rounds_the_reference_leaves():
    """The stacked (g, d) gate scale rounds to bf16 before its tanh, as
    the (g, k, d) norm scales do; ln_f (d,) stays f32."""
    jcfg, _ = _cfgs()
    ours, theirs = th._precast_dtypes(jcfg)
    assert ours == theirs
    assert ours["cross"]["gate"]["scale"] == "bfloat16"
    assert ours["self"]["ln1"]["scale"] == "bfloat16"
    assert ours["ln_f"]["scale"] == "float32"


# ---------------------------------------------------------------------------
# cross-attention and its blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cross_attention(dt, chunk):
    """No mask, no RoPE: 16 queries against the 8 image tokens."""
    jcfg, tcfg = _cfgs(dtype=dt)
    p = _cross_params(jcfg)["xattn"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    img = rng.standard_normal((2, jcfg.n_image_tokens, jcfg.d_model)
                              ).astype(np.float32)
    out = tattn.cross_attention(
        {k: _t(v, dt) for k, v in p.items()}, _t(x, dt), _t(img, dt), tcfg,
        NOSHARD, chunk=chunk)
    ref = jattn.cross_attention(
        {k: _j(v, dt) for k, v in p.items()}, _j(x, dt), _j(img, dt), jcfg,
        JNOSHARD, chunk=chunk)
    assert out.dtype == TDT[dt]
    _close(out.float(), ref, dt)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cross_block(dt, cached):
    """h + tanh(gate) * cross-attention, the gate cast to the attention
    output's dtype; the cached block against the projected image K/V,
    one query at a time."""
    jcfg, tcfg = _cfgs(dtype=dt)
    p = _cross_params(jcfg)
    tp = jax.tree.map(lambda a: _t(a, dt), p)
    jp = jax.tree.map(lambda a: _j(a, dt), p)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    img = rng.standard_normal((2, jcfg.n_image_tokens, jcfg.d_model)
                              ).astype(np.float32)
    if cached:
        xk, xv = tattn.project_kv(tp["xattn"], _t(img, dt), tcfg)
        jxk, jxv = jattn.project_kv(jp["xattn"], _j(img, dt), jcfg)
        _close(xk.float(), jxk, dt)
        out = tblocks.cross_block_cached(tp, _t(h, dt), xk, xv, tcfg,
                                         NOSHARD)
        ref = jblocks.cross_block_cached(jp, _j(h, dt), jxk, jxv, jcfg,
                                         JNOSHARD)
    else:
        out = tblocks.cross_block(tp, _t(h, dt), _t(img, dt), tcfg, NOSHARD,
                                  ModelOpts(attn_chunk=2))
        ref = jblocks.cross_block(jp, _j(h, dt), _j(img, dt), jcfg, JNOSHARD,
                                  JOpts(attn_chunk=2))
    assert out.dtype == TDT[dt]
    _close(out.float(), ref, dt)


def test_cross_block_cached_keeps_the_hidden_dtype():
    """A bf16 h against a wider f32 image cache: the sum comes back in
    bf16 (the reference's scan carry raises a TypeError there)."""
    jcfg, tcfg = _cfgs()
    tp = jax.tree.map(lambda a: _t(a, "bfloat16"), _cross_params(jcfg))
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 1, tcfg.d_model, generator=g).bfloat16()
    kv = torch.randn(2, tcfg.n_image_tokens, tcfg.n_kv_heads, tcfg.head_dim,
                     generator=g)
    out = tblocks.cross_block_cached(tp, h, kv, kv, tcfg, NOSHARD)
    assert out.dtype == torch.bfloat16 and out.shape == h.shape


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_loss_match_reference(n_layers, dtype):
    """``use_kernel`` is on in both and runs no kernel: the vlm forward
    has none."""
    jcfg, tcfg = _cfgs(dtype=dtype, n_layers=n_layers)
    (hj, lj), (ht, aux, lt), counts = th._forward_pair(jcfg, tcfg, True)
    assert counts == (0, 0)
    th._hold_forward(dtype, hj, lj, ht, aux, lt)


def test_forward_reads_the_image():
    """Another image changes the hidden states (the gate is not zero)."""
    _, tcfg = _cfgs(dtype="float32")
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    batch = th._torch(th._batch(tcfg, S=8))
    h1 = model.forward(params, batch, opts=ModelOpts(**OPTS))[0]
    batch["image_embeds"] = batch["image_embeds"] + 1
    h2 = model.forward(params, batch, opts=ModelOpts(**OPTS))[0]
    assert not torch.allclose(h1, h2)


@pytest.mark.parametrize("n_layers", LAYERS)
def test_float32_grads_match_reference(n_layers):
    jcfg, tcfg = _cfgs(dtype="float32", n_layers=n_layers)
    grads = th._grads_pair(jcfg, tcfg, remat="full")
    assert np.linalg.norm(grads[("cross", "gate", "scale")]) > 0


def test_remat_modes_give_equal_grads():
    jcfg, tcfg = _cfgs()
    np_params, batch = _np_params(jcfg), th._batch(jcfg, S=16)
    runs = {m: th._value_and_grad(tcfg, np_params, batch, remat=m)
            for m in ("none", "full", "dots")}
    loss, grads = runs["none"]
    for mode in ("full", "dots"):
        assert runs[mode][0] == loss, mode
        for path, g in grads.items():
            np.testing.assert_array_equal(runs[mode][1][path], g,
                                          err_msg=f"{mode} {path}")


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_logits_and_cache(n_layers, dtype):
    """k/v of (g, k, B, S, Hkv, D), xk/xv of (g, B, n_img, Hkv, D)."""
    jcfg, tcfg = _cfgs(dtype=dtype, n_layers=n_layers)
    (lj, cj), (lt, ct) = th._prefill_pair(jcfg, tcfg)
    assert lt.dtype == torch.float32
    assert ct["k"].shape[:3] == (2, 1, 2)
    assert ct["xk"].shape == (2, 2, jcfg.n_image_tokens, jcfg.n_kv_heads,
                              jcfg.head_dim)
    _close(lt, lj, dtype)
    th._hold_cache(ct, cj, dtype)


@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_steps_match_reference(n_layers, dtype):
    """Three steps at scalar positions from one random cache in the
    compute dtype, image K/V included (a bf16 model on an f32 cache is the
    next test): the logits of each and every cache entry at the end.
    ``use_kernel`` is on in the port and runs no kernel."""
    jcfg, tcfg = _cfgs(dtype=dtype, n_layers=n_layers)
    da.COUNT.reset()
    pairs, cj, ct = th._decode_steps(jcfg, tcfg, [5, 6, 9],
                                     getattr(jnp, dtype))
    assert (da.COUNT.launches, da.COUNT.plain) == (0, 0)
    for lj, lt in pairs:
        _close(lt, lj, dtype)
    th._hold_cache(ct, cj, dtype)


def test_bf16_model_on_an_f32_cache():
    """The server's f32 cache under a bf16 model: the reference's layer
    scan raises (its carry would widen to f32 after a cross block); the
    port rounds the cross block's sum to bf16 and decodes.  Held against
    the reference on the same values in a bf16 cache, at the bf16
    tolerance: only the cache's dtype differs."""
    jcfg, tcfg = _cfgs()
    params = _np_params(jcfg)
    rng = np.random.default_rng(8)
    bf16 = {k: np.asarray(jnp.asarray(0.3 * rng.standard_normal(v.shape),
                                      jnp.bfloat16))
            for k, v in JModel(jcfg).init_cache(3, 16).items()}
    f32 = {k: v.astype(np.float32) for k, v in bf16.items()}
    token = tm._tokens(jcfg, 3, 1, 5).astype(np.int32)
    jb = {"token": jnp.asarray(token), "pos": jnp.asarray(6, jnp.int32)}
    jstep = jax.jit(lambda p, b, c: JModel(jcfg).decode_step(
        p, b, c, opts=JOpts(remat="none", **OPTS)))
    with pytest.raises(TypeError, match="carry"):
        jstep(params, jb, f32)
    lj, _ = jstep(params, jb, bf16)
    lt, ct = Model(tcfg).decode_step(
        params_from_numpy(params), {"token": torch.from_numpy(token),
                                    "pos": 6},
        params_from_numpy(f32), opts=ModelOpts(**OPTS))
    assert ct["k"].dtype == torch.float32
    _close(lt, lj, "bfloat16")


@pytest.mark.parametrize("pos", [(2, 9, 0), [4, 4, 4]])
def test_decode_refuses_per_slot_positions(pos):
    jcfg, tcfg = _cfgs(dtype="float32")
    params = _np_params(jcfg)
    token = np.ones((3, 1), np.int32)
    msg = "per-slot decode positions: vlm family serves via the lockstep"
    with pytest.raises(NotImplementedError, match=msg):
        JModel(jcfg).decode_step(
            params, {"token": jnp.asarray(token),
                     "pos": jnp.asarray(pos, jnp.int32)},
            JModel(jcfg).init_cache(3, 16, jnp.float32))
    model = Model(tcfg)
    with pytest.raises(NotImplementedError, match=msg):
        model.decode_step(
            params_from_numpy(params),
            {"token": torch.from_numpy(token),
             "pos": torch.tensor(pos, dtype=torch.int32)},
            model.init_cache(3, 16, torch.float32))


@pytest.mark.parametrize("n_layers", LAYERS)
def test_init_cache_shapes_and_dtypes(n_layers):
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    jc = JModel(jcfg).init_cache(3, 16, jnp.bfloat16)
    tc = Model(tcfg).init_cache(3, 16, torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in tc.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    assert not any(torch.any(v) for v in tc.values())


def test_decode_matches_prefill():
    """tests/test_models_smoke.py:49-55 and :92 for the vlm: the prefill's
    image K/V put in an empty f32 cache, decoding token by token
    reproduces the prefill's last logits and its K/V."""
    _, tcfg = _cfgs()
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    S = 12
    batch = th._torch(th._inputs(th._batch(tcfg, B=1, S=S)))
    full, pcache = model.prefill(params, batch, opts=ModelOpts(attn_chunk=4))
    cache = model.init_cache(1, S, torch.float32)
    cache["xk"].copy_(pcache["xk"])
    cache["xv"].copy_(pcache["xv"])
    toks = batch["tokens"]
    for i in range(S):
        lg, cache = model.decode_step(
            params, {"token": toks[:, i:i + 1], "pos": i}, cache)
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=0.05,
                               atol=0.05)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), _f32(pcache[key]),
                                   rtol=0.05, atol=0.05, err_msg=key)


# ---------------------------------------------------------------------------
# serving and the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", LAYERS)
def test_server_tokens_match_reference(n_layers):
    """float32 config, 5 requests on 2 slots: the lockstep fallback emits
    the reference's greedy tokens."""
    jcfg, tcfg = _cfgs(dtype="float32", n_layers=n_layers)
    jsrv, tsrv = th._servers(jcfg, tcfg)
    assert not (jsrv.continuous or tsrv.continuous or tsrv.use_kernel)
    ref = jsrv.run(th._reqs(5, gen=6, cls=JRequest))
    assert tsrv.run(th._reqs(5, gen=6)) == ref


def test_bf16_server_serves_where_the_reference_raises():
    """bf16 model, f32 cache: the reference's server raises in its first
    step; the port's serves every request."""
    jcfg, tcfg = _cfgs()
    jsrv, tsrv = th._servers(jcfg, tcfg)
    with pytest.raises(TypeError, match="carry"):
        jsrv.run(th._reqs(2, cls=JRequest))
    out = tsrv.run(th._reqs(3))
    assert sorted(out) == [0, 1, 2] and all(len(v) == 5 for v in out.values())


def test_server_refuses_streaming():
    jcfg, tcfg = _cfgs()
    _, tsrv = th._servers(jcfg, tcfg)
    for call in (lambda: tsrv.submit(th._reqs(1)[0]), tsrv.step,
                 tsrv.drain):
        with pytest.raises(RuntimeError, match="vlm serves via the lockstep "
                           "fallback; use run"):
            call()


def test_serve_launcher_runs_reduced_on_cpu():
    out = th._launch(serve_launcher, "--arch", ARCH, "--reduced",
                     "--device", "cpu", "--requests", "3", "--batch", "2",
                     "--new-tokens", "4")
    assert out["arch"] == ARCH
    assert out["requests"] == 3 and out["generated_tokens"] == 12


def test_train_launcher_runs_reduced_on_cpu(tmp_path):
    out = th._launch(train_launcher, "--arch", ARCH, "--reduced", "--device",
                     "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                     "--out", str(tmp_path))
    assert out["arch"] == ARCH and out["steps"] == 2
    assert np.isfinite([out["loss_first10"], out["loss_last10"]]).all()
