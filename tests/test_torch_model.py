"""The port's configs, layers, attention and dense model against the JAX
reference, on the same numpy parameters and inputs.

Parameters come from the reference's ``Model.init``; its biases are zero
and its norm scales one (and, for the ssm family, ``A_log`` and ``D`` one,
``dt_bias`` and ``conv_b`` zero), which would hide a wrong path, so those
leaves are overwritten with seeded random values first.  Tolerances:
f32 2e-5, bf16 2e-2 (``tests/test_kernels.py:14``), unless a test says
otherwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distrib.logical import NOSHARD as JNOSHARD
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch.distrib.logical import NOSHARD
from repro_torch.interop import params_from_numpy, spec_tree, tree_to_numpy
from repro_torch.kernels import decode_attention as da
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model, precast

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH = "qwen1.5-4b"
DENSE_ARCHS = [a for a in jconfigs.ARCH_IDS
               if jconfigs.REGISTRY[a].family == "dense"]


def _cfgs(arch=ARCH, **kw):
    """The same reduced config in both packages."""
    return (dataclasses.replace(jconfigs.REGISTRY[arch].reduced(), **kw),
            dataclasses.replace(tconfigs.REGISTRY[arch].reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _np_params(jcfg, seed=0):
    """Reference init -> numpy, with random biases and norm scales.
    Cached per config; callers only read the arrays."""
    params = jax.tree.map(np.asarray,
                          JModel(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def fill(tree, path=()):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                fill(leaf, path + (key,))
            elif key in ("bq", "bk", "bv", "dt_bias", "conv_b"):
                tree[key] = (0.1 * rng.standard_normal(leaf.shape)
                             ).astype(np.float32)
            elif key in ("scale", "D"):
                tree[key] = (1 + 0.2 * rng.standard_normal(leaf.shape)
                             ).astype(np.float32)
            elif key == "A_log":
                tree[key] = (0.5 * rng.standard_normal(leaf.shape)
                             ).astype(np.float32)
    fill(params)
    return params


def _close(out, ref, dt, tol=None):
    tol = TOL[dt] if tol is None else tol
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


def _t(a, dt="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(TDT[dt])


def _j(a, dt="float32"):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dt))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_reference(arch):
    j, t = jconfigs.REGISTRY[arch], tconfigs.REGISTRY[arch]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.n_params() == j.n_params()


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_param_spec_tree_equals_reference(arch):
    jcfg, tcfg = jconfigs.REGISTRY[arch], tconfigs.REGISTRY[arch]
    assert spec_tree(Model(tcfg).param_spec()) == \
        spec_tree(JModel(jcfg).param_spec())


def test_interop_carries_every_leaf():
    jcfg, tcfg = _cfgs()
    params = _np_params(jcfg)
    tp = params_from_numpy(params)
    back = tree_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    shapes = jax.tree.map(lambda p: p.shape, JModel(jcfg).param_spec(),
                          is_leaf=lambda x: hasattr(x, "axes"))
    assert jax.tree.map(lambda a: tuple(a.shape), back) == shapes


def test_init_is_seeded_and_follows_the_spec():
    _, tcfg = _cfgs()
    a = Model(tcfg).init(torch.Generator("cpu").manual_seed(0))
    b = Model(tcfg).init(torch.Generator("cpu").manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.all(a["layers"]["attn"]["bq"] == 0)
    assert torch.all(a["ln_f"]["scale"] == 1)
    assert 0.015 < float(a["embed"]["tok"].std()) < 0.025


def test_precast_rounds_the_reference_leaves():
    """ndim >= 2 leaves go to bf16: the stacked (L, d) norm scales and qkv
    biases do, ln_f.scale (d,) stays f32 (model.py:558)."""
    jcfg, _ = _cfgs()
    p = precast(params_from_numpy(_np_params(jcfg)), torch.bfloat16)
    assert p["layers"]["ln1"]["scale"].dtype == torch.bfloat16
    assert p["layers"]["attn"]["bq"].dtype == torch.bfloat16
    assert p["layers"]["mlp"]["wi"].dtype == torch.bfloat16
    assert p["ln_f"]["scale"].dtype == torch.float32
    assert precast(p, torch.bfloat16)["embed"]["tok"] is p["embed"]["tok"]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_rope_embed_logits(dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16), np.float32)
    scale = 1 + 0.2 * rng.standard_normal(16).astype(np.float32)
    _close(tlayers.rmsnorm({"scale": _t(scale)}, _t(x, dt)).float(),
           jlayers.rmsnorm({"scale": _j(scale)}, _j(x, dt)), dt)
    pos = np.array([[0, 1, 7, 30, 511]] * 2, np.int32)
    _close(tlayers.rope(_t(x, dt), torch.from_numpy(pos), 10_000.0).float(),
           jlayers.rope(_j(x, dt), jnp.asarray(pos), 10_000.0), dt)
    jcfg, tcfg = _cfgs()
    emb = _np_params(jcfg)["embed"]
    toks = rng.integers(0, jcfg.vocab, (2, 3))
    h_t = tlayers.embed(params_from_numpy(emb), torch.from_numpy(toks),
                        TDT[dt])
    h_j = jlayers.embed(jax.tree.map(jnp.asarray, emb), jnp.asarray(toks),
                        getattr(jnp, dt))
    _close(h_t.float(), h_j, dt)
    _close(tlayers.logits_last(params_from_numpy(emb), tcfg, h_t[:, -1]),
           jlayers.logits_last(jax.tree.map(jnp.asarray, emb), jcfg,
                               h_j[:, -1]), dt)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mlp(activation, dt):
    jcfg, tcfg = _cfgs(activation=activation)
    rng = np.random.default_rng(1)
    spec = jlayers.mlp_spec(jcfg)
    p = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in spec.items()}
    x = rng.standard_normal((2, 3, jcfg.d_model), np.float32)
    out = tlayers.mlp({k: _t(v) for k, v in p.items()}, _t(x, dt), tcfg,
                      NOSHARD)
    ref = jlayers.mlp({k: _j(v) for k, v in p.items()}, _j(x, dt), jcfg,
                      JNOSHARD)
    _close(out.float(), ref, dt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,is_global,chunk", [
    (True, 0, True, 8), (True, 4, False, 16), (True, 4, True, 32),
    (False, 0, True, 32)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_chunked_mha(causal, window, is_global, chunk, dt):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 32, 4, 16), np.float32)
    k = rng.standard_normal((2, 32, 2, 16), np.float32)
    v = rng.standard_normal((2, 32, 2, 16), np.float32)
    kw = dict(causal=causal, window=window, is_global=is_global, chunk=chunk)
    out = tattn.chunked_mha(_t(q, dt), _t(k, dt), _t(v, dt), NOSHARD, **kw)
    ref = jattn.chunked_mha(_j(q, dt), _j(k, dt), _j(v, dt), JNOSHARD, **kw)
    _close(out.float(), ref, dt)


@pytest.mark.parametrize("pos", [5, (3, 9, 0)])
@pytest.mark.parametrize("new_slot", [True, False])
@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("cache_dt", ["float32", "bfloat16"])
def test_decode_mha(pos, new_slot, window, cache_dt):
    """Scalar and per-slot pos; with and without the k_new/v_new slot; a
    bf16 query against an f32 or bf16 cache, as in the server."""
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, D = 3, 12, 4, 2, 16
    q = rng.standard_normal((B, 1, Hq, D), np.float32)
    kc = rng.standard_normal((B, S, Hkv, D), np.float32)
    vc = rng.standard_normal((B, S, Hkv, D), np.float32)
    kn = rng.standard_normal((B, 1, Hkv, D), np.float32)
    vn = rng.standard_normal((B, 1, Hkv, D), np.float32)
    tpos = torch.tensor(pos, dtype=torch.int32)
    jpos = jnp.asarray(pos, jnp.int32)
    tkw = dict(pos=tpos, window=window, is_global=False)
    jkw = dict(pos=jpos, window=window, is_global=False)
    if new_slot:
        tkw.update(k_new=_t(kn, "bfloat16"), v_new=_t(vn, "bfloat16"))
        jkw.update(k_new=_j(kn, "bfloat16"), v_new=_j(vn, "bfloat16"))
    out = tattn.decode_mha(_t(q, "bfloat16"), _t(kc, cache_dt),
                           _t(vc, cache_dt), NOSHARD, **tkw)
    ref = jattn.decode_mha(_j(q, "bfloat16"), _j(kc, cache_dt),
                           _j(vc, cache_dt), JNOSHARD, **jkw)
    assert out.dtype == TDT[cache_dt]
    _close(out.float(), ref, cache_dt)


# ---------------------------------------------------------------------------
# model: prefill and decode_step
# ---------------------------------------------------------------------------
OPTS = dict(attn_chunk=8)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


@pytest.mark.parametrize("n_kv_heads", [4, 2])
def test_prefill_logits_and_cache(n_kv_heads):
    jcfg, tcfg = _cfgs(n_kv_heads=n_kv_heads)
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
        assert ct[key].shape == cj[key].shape
        _close(_f32(ct[key]), cj[key], "bfloat16")


def _decode_pair(jcfg, tcfg, pos, use_kernel, dtype="bfloat16", seed=0):
    """One decode_step in both packages from the same random f32 cache."""
    params = _np_params(jcfg, seed)
    B, S = 3, 16
    rng = np.random.default_rng(seed + 7)
    shape = (jcfg.n_layers, B, S, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    token = _tokens(jcfg, B, 1, seed + 3).astype(np.int32)
    jmodel = JModel(jcfg)
    lj, cj = jax.jit(lambda p, b, c: jmodel.decode_step(
        p, b, c, opts=JOpts(remat="none", use_kernel=use_kernel, **OPTS)))(
        params,
        {"token": jnp.asarray(token), "pos": jnp.asarray(pos, jnp.int32)},
        cache)
    da.COUNT.reset()
    tcache = params_from_numpy(cache)
    lt, ct = Model(tcfg).decode_step(
        params_from_numpy(params),
        {"token": torch.from_numpy(token),
         "pos": torch.tensor(pos, dtype=torch.int32)},
        tcache, opts=ModelOpts(use_kernel=use_kernel, **OPTS))
    assert ct["k"] is tcache["k"]          # updated in place
    counts = (da.COUNT.launches, da.COUNT.plain)
    return (lj, cj), (lt, ct), counts


@pytest.mark.parametrize("pos", [5, (2, 9, 0)])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n_kv_heads", [4, 2])
def test_decode_step_matches_reference(pos, use_kernel, n_kv_heads):
    """Scalar and per-slot pos, kernel on and off, G = 1 and G = 2.  On the
    CPU "on" reaches the kernel's plain version: no launch is counted."""
    jcfg, tcfg = _cfgs(n_kv_heads=n_kv_heads)
    (lj, cj), (lt, ct), counts = _decode_pair(jcfg, tcfg, pos, use_kernel)
    assert counts == (0, tcfg.n_layers if use_kernel else 0)
    _close(lt, lj, "bfloat16")
    for key in ("k", "v"):
        # the cache is f32 holding bf16-rounded rows; compare at bf16 TOL
        _close(ct[key].numpy(), cj[key], "bfloat16")
        untouched = np.ones(ct[key].shape[2], bool)
        untouched[np.unique(pos)] = False
        np.testing.assert_array_equal(ct[key].numpy()[:, :, untouched],
                                      np.asarray(cj[key])[:, :, untouched])


@pytest.mark.parametrize("pos", [4, (1, 6, 11)])
def test_decode_step_float32_config(pos):
    """With dtype float32 there is no bf16 rounding to differ in: logits
    at the f32 tolerance."""
    jcfg, tcfg = _cfgs(n_kv_heads=2, dtype="float32")
    (lj, cj), (lt, ct), _ = _decode_pair(jcfg, tcfg, pos, True)
    _close(lt, lj, "float32")
    _close(ct["k"].numpy(), cj["k"], "float32")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_matches_prefill(use_kernel):
    """tests/test_models_smoke.py:92 in torch: decoding token by token from
    an empty cache reproduces the prefill's last logits."""
    _, tcfg = _cfgs()
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
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=0.05,
                               atol=0.05)
    np.testing.assert_allclose(cache["k"].numpy(), _f32(pcache["k"]),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("arch", ["zamba2-7b", "hubert-xlarge",
                                  "llama-3.2-vision-90b"])
def test_unported_families_raise(arch):
    """The hybrid, audio and vlm slice has come: the port takes every
    family, with the reference's parameter tree (their own files,
    tests/test_torch_hybrid.py, test_torch_audio.py and test_torch_vlm.py,
    hold the rest); an unknown family raises, as in the reference."""
    for cfg in (tconfigs.REGISTRY[arch], tconfigs.REGISTRY[arch].reduced()):
        jcfg = jconfigs.REGISTRY[arch]
        jcfg = jcfg if cfg.n_layers == jcfg.n_layers else jcfg.reduced()
        assert spec_tree(Model(cfg).param_spec()) == \
            spec_tree(JModel(jcfg).param_spec())
    bad = dataclasses.replace(tconfigs.REGISTRY[arch], family="retrieval")
    with pytest.raises(ValueError, match="retrieval"):
        Model(bad).param_spec()
