"""The port's hybrid family (zamba2-7b, reduced) against the JAX reference,
on the same numpy parameters and inputs: the grouped parameter tree
(``groups`` of (g, k) Mamba blocks, one unstacked ``shared`` attention
block, the ``rem`` stack), ``Model.forward``/``loss`` with and without
the ``ssd_scan`` kernel, ``prefill`` and its cache, ``decode_step`` at
scalar positions and its refusal of per-slot ones, the lockstep server
fallback and the gradient of the loss.

The reduced config has g = 2 groups of k = 2 Mamba layers and no
remainder; ``n_layers=5`` gives r = 1 and so a ``rem`` stack.  Parameters
come from the reference's ``Model.init`` with its constant leaves
randomised (``test_torch_model._np_params``); batches from numpy with a
seed.  Tolerances: ``TOL`` f32 2e-5, bf16 2e-2; f32 hidden states at 5x
(the scan's own tolerance, ``test_torch_ssm``); bf16 hidden states in
norm (``test_torch_ssm._close_bf16_hidden``).  With the kernel the
reference runs its Pallas ``ssd_scan`` in interpret mode on the CPU, and
the port's wrapper runs its plain version, counted in ``COUNT.plain``.

The helpers here serve ``test_torch_vlm`` and ``test_torch_audio`` too.
"""
import contextlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import Model as JModel
from repro.models.model import _precast as jprecast
from repro.runtime.serve import BatchedServer as JBatchedServer
from repro.runtime.serve import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy, spec_tree, tree_to_numpy
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model, precast
from repro_torch.runtime.serve import BatchedServer, Request

import test_torch_model as tm
from test_torch_model import TOL, _close, _f32, _np_params
from test_torch_ssm import _close_bf16_hidden
from test_torch_train import F32_LEAF, F32_LOSS, _ref_value_and_grad, \
    _value_and_grad

ARCH = "zamba2-7b"
OPTS = dict(attn_chunk=8, ce_chunk=8)
LAYERS = [4, 5]              # g=2, k=2, r=0; and r=1: the rem stack


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch=ARCH, **kw):
    if jconfigs.REGISTRY[arch].family == "hybrid":
        kw.setdefault("ssm_chunk", 8)     # several chunks of the scan
    return tm._cfgs(arch, **kw)


# ---------------------------------------------------------------------------
# helpers, shared by the vlm and audio tests
# ---------------------------------------------------------------------------
def _batch(cfg, B=2, S=32, seed=2):
    """Tokens and next-token labels (some ignored); audio has frames in
    place of tokens, vlm adds image embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    labels = toks[:, 1:].astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": labels}
    if cfg.family == "audio":
        batch = {"frames": (0.5 * rng.standard_normal((B, S, cfg.frame_dim))
                            ).astype(np.float32),
                 "labels": labels}
    elif cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _forward_pair(jcfg, tcfg, use_kernel=False, B=2, S=32):
    """forward and loss in both packages -> (hj, lj), (ht, aux, lt), the
    port's ssd_scan (launches, plain calls) in its forward."""
    params = _np_params(jcfg)
    batch = _batch(jcfg, B, S)
    jopts = JOpts(remat="none", use_kernel=use_kernel, **OPTS)
    jmodel = JModel(jcfg)
    hj, _ = jax.jit(lambda p, b: jmodel.forward(p, b, opts=jopts))(
        params, _jax(batch))
    lj = jax.jit(lambda p, b: jmodel.loss(p, b, opts=jopts))(
        params, _jax(batch))
    topts = ModelOpts(use_kernel=use_kernel, **OPTS)
    model, tp = Model(tcfg), params_from_numpy(params)
    ssd_mod.COUNT.reset()
    ht, aux = model.forward(tp, _torch(batch), opts=topts)
    counts = (ssd_mod.COUNT.launches, ssd_mod.COUNT.plain)
    lt = model.loss(tp, _torch(batch), opts=topts)
    return (hj, lj), (ht, aux, lt), counts


def _hold_forward(dtype, hj, lj, ht, aux, lt, f32_hidden=TOL["float32"]):
    assert ht.dtype == getattr(torch, dtype) and float(aux) == 0.0
    if dtype == "bfloat16":
        _close_bf16_hidden(ht, hj)
    else:
        _close(ht, hj, dtype, f32_hidden)
    _close(lt, lj, dtype)


def _prefill_pair(jcfg, tcfg, B=2, S=16):
    params = _np_params(jcfg)
    batch = _inputs(_batch(jcfg, B, S))
    jmodel = JModel(jcfg)
    jopts = JOpts(remat="none", **OPTS)
    lj, cj = jax.jit(lambda p, b: jmodel.prefill(p, b, opts=jopts))(
        params, _jax(batch))
    lt, ct = Model(tcfg).prefill(params_from_numpy(params), _torch(batch),
                                 opts=ModelOpts(**OPTS))
    return (lj, cj), (lt, ct)


def _hold_cache(ct, cj, dtype, same_dtypes=True):
    """Every entry at ``dtype``'s tolerance.  A decode step's entries keep
    the dtype they came in (updated in place), where the reference's
    conv history widens to f32 in a float32 model on a bf16 cache: there
    ``same_dtypes`` is False."""
    assert sorted(ct) == sorted(cj)
    for key in cj:
        assert tuple(ct[key].shape) == cj[key].shape, key
        if same_dtypes:
            assert str(ct[key].dtype)[6:] == str(cj[key].dtype), key
        _close(_f32(ct[key]), cj[key], dtype)


def _random_cache(jcfg, B, S, cache_dtype, seed=7):
    """The reference's ``init_cache`` filled with seeded values, as numpy
    arrays in each entry's dtype (ml_dtypes' bfloat16 for bf16)."""
    rng = np.random.default_rng(seed)
    return {k: np.asarray(jnp.asarray(0.3 * rng.standard_normal(v.shape),
                                      v.dtype))
            for k, v in JModel(jcfg).init_cache(B, S, cache_dtype).items()}


def _decode_steps(jcfg, tcfg, positions, cache_dtype=jnp.float32, B=3,
                  S=16, seed=0):
    """decode_step in both packages at each scalar position in turn, each
    step on the cache the last one left -> [(lj, lt)] and the final caches
    (the port's updated in place)."""
    params = _np_params(jcfg, seed)
    jcache = _random_cache(jcfg, B, S, cache_dtype)
    tcache = params_from_numpy(jcache)
    first = dict(tcache)
    jmodel, model = JModel(jcfg), Model(tcfg)
    jstep = jax.jit(lambda p, b, c: jmodel.decode_step(
        p, b, c, opts=JOpts(remat="none", **OPTS)))
    tparams = params_from_numpy(params)
    rng = np.random.default_rng(seed + 3)
    pairs = []
    for pos in positions:
        token = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        lj, jcache = jstep(params, {"token": jnp.asarray(token),
                                    "pos": jnp.asarray(pos, jnp.int32)},
                           jcache)
        lt, tcache = model.decode_step(
            tparams, {"token": torch.from_numpy(token), "pos": pos}, tcache,
            opts=ModelOpts(use_kernel=True, **OPTS))
        pairs.append((lj, lt))
    assert all(tcache[k] is first[k] for k in first)   # updated in place
    return pairs, jcache, tcache


def _reqs(n, base=3, gen=5, cls=Request):
    return [cls(rid=i, prompt=[1 + i, base, base + i % 3],
                max_new_tokens=gen) for i in range(n)]


def _servers(jcfg, tcfg, B=2, S=32):
    params = _np_params(jcfg)
    jsrv = JBatchedServer(JModel(jcfg), params, batch_size=B, max_seq=S,
                          opts=JOpts(remat="none", **OPTS))
    tsrv = BatchedServer(Model(tcfg), params_from_numpy(params),
                         batch_size=B, max_seq=S, opts=ModelOpts(**OPTS),
                         use_kernel=True, device="cpu")
    return jsrv, tsrv


def _grads_pair(jcfg, tcfg, **opts):
    """The f32 loss and every leaf of its gradient, both packages."""
    np_params = _np_params(jcfg)
    batch = _batch(jcfg, S=16)
    jloss, jgrads = _ref_value_and_grad(jcfg, np_params, batch)
    loss, grads = _value_and_grad(tcfg, np_params, batch, **opts)
    np.testing.assert_allclose(loss, jloss, rtol=F32_LOSS, atol=F32_LOSS)
    assert grads.keys() == jgrads.keys()
    for path, g in grads.items():
        ref = jgrads[path]
        err = np.linalg.norm(g - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= F32_LEAF, (path, err)
    return grads


def _launch(module, *argv):
    """``python -m <module> argv`` in this process -> its JSON."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = [module.__name__] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        sys.argv = old
    return json.loads(out.getvalue())


def _precast_dtypes(jcfg):
    """Every leaf's dtype after precast to bf16, port and reference."""
    params = _np_params(jcfg)
    ours = jax.tree.map(
        lambda t: str(t.dtype)[6:],
        precast(params_from_numpy(params), torch.bfloat16),
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    theirs = jax.tree.map(lambda a: str(a.dtype),
                          jprecast(jax.tree.map(jnp.asarray, params),
                                   jnp.bfloat16))
    return ours, theirs


# ---------------------------------------------------------------------------
# specs and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", ["full", "reduced", "reduced-5"])
def test_param_spec_tree_equals_reference(size):
    jcfg, tcfg = jconfigs.REGISTRY[ARCH], tconfigs.REGISTRY[ARCH]
    if size != "full":
        jcfg, tcfg = _cfgs(n_layers=5 if size == "reduced-5" else 4)
    spec = Model(tcfg).param_spec()
    assert spec_tree(spec) == spec_tree(JModel(jcfg).param_spec())
    assert ("rem" in spec) == (jcfg.n_layers % jcfg.shared_attn_every > 0)


def test_full_size_groups():
    """zamba2-7b: 81 Mamba layers in 13 groups of 6 and 3 in rem."""
    spec = Model(tconfigs.REGISTRY[ARCH]).param_spec()
    assert spec["groups"]["ln"]["scale"].shape == (13, 6, 3584)
    assert spec["rem"]["mixer"]["A_log"].shape == (3, 112)
    assert spec["shared"]["ln1"]["scale"].shape == (3584,)


def test_init_draws_every_layer_of_a_group():
    """init_params draws a (g, k) stack one layer at a time: seeded, and
    no two layers equal."""
    _, tcfg = _cfgs()
    a = Model(tcfg).init(torch.Generator("cpu").manual_seed(0))
    b = Model(tcfg).init(torch.Generator("cpu").manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    w = a["groups"]["mixer"]["in_proj"]
    flat = w.reshape(-1, *w.shape[2:])
    assert all(not torch.equal(flat[i], flat[j])
               for i in range(len(flat)) for j in range(i))
    assert torch.all(a["groups"]["mixer"]["A_log"] == 1)


@pytest.mark.parametrize("n_layers", LAYERS)
def test_interop_carries_every_leaf(n_layers):
    jcfg, _ = _cfgs(n_layers=n_layers)
    params = _np_params(jcfg)
    jax.tree.map(np.testing.assert_array_equal,
                 tree_to_numpy(params_from_numpy(params)), params)


def test_precast_rounds_the_reference_leaves():
    """By ndim, as the reference: the unstacked shared block's (d,) norm
    scales stay f32, the stacked (g, k, d) ones and the (g, k, H) A_log,
    D, dt_bias round to bf16, and so does the (r, H) rem stack's."""
    jcfg, _ = _cfgs(n_layers=5)
    ours, theirs = _precast_dtypes(jcfg)
    assert ours == theirs
    assert ours["shared"]["ln1"]["scale"] == "float32"
    assert ours["groups"]["ln"]["scale"] == "bfloat16"
    assert ours["groups"]["mixer"]["A_log"] == "bfloat16"
    assert ours["rem"]["mixer"]["D"] == "bfloat16"


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_loss_match_reference(use_kernel, n_layers, dtype):
    """With the kernel the port runs ssd_scan's plain version once per
    Mamba layer, the reference its Pallas kernel in interpret mode."""
    jcfg, tcfg = _cfgs(dtype=dtype, n_layers=n_layers)
    (hj, lj), (ht, aux, lt), counts = _forward_pair(jcfg, tcfg, use_kernel)
    assert counts == (0, n_layers if use_kernel else 0)
    _hold_forward(dtype, hj, lj, ht, aux, lt, 5 * TOL["float32"])


def test_remat_modes_give_equal_grads():
    """remat none, full and dots (each group recomputed as a whole, the
    rem layers one by one) give one loss and one gradient."""
    jcfg, tcfg = _cfgs(n_layers=5)
    np_params, batch = _np_params(jcfg), _batch(jcfg, S=16)
    runs = {m: _value_and_grad(tcfg, np_params, batch, remat=m)
            for m in ("none", "full", "dots")}
    loss, grads = runs["none"]
    for mode in ("full", "dots"):
        assert runs[mode][0] == loss, mode
        for path, g in grads.items():
            np.testing.assert_array_equal(runs[mode][1][path], g,
                                          err_msg=f"{mode} {path}")


def test_kernel_under_grad_raises():
    """ssd_scan has no backward: the kernel path refuses a loss whose
    parameters require grad, as the trainer keeps use_kernel off."""
    _, tcfg = _cfgs()
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    params["groups"]["mixer"]["in_proj"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(params, _torch(_batch(tcfg, S=16)),
                   opts=ModelOpts(use_kernel=True, **OPTS))


@pytest.mark.parametrize("n_layers", LAYERS)
def test_float32_grads_match_reference(n_layers):
    jcfg, tcfg = _cfgs(dtype="float32", n_layers=n_layers)
    grads = _grads_pair(jcfg, tcfg, remat="full")
    assert any(p[0] == "shared" for p in grads)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_logits_and_cache(n_layers, dtype):
    """ssm/conv of (g, k, ...), the shared block's k/v of (g, B, S, ...),
    rem_ssm/rem_conv of (r, ...) where r > 0."""
    jcfg, tcfg = _cfgs(dtype=dtype, n_layers=n_layers)
    (lj, cj), (lt, ct) = _prefill_pair(jcfg, tcfg)
    assert lt.dtype == torch.float32
    assert ct["ssm"].shape[:2] == (2, 2) and ct["k"].shape[0] == 2
    assert ("rem_ssm" in ct) == (n_layers == 5)
    _close(lt, lj, dtype)
    _hold_cache(ct, cj, "bfloat16" if dtype == "bfloat16" else "float32")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_steps_match_reference(cache_dtype, n_layers, dtype):
    """Three steps at scalar positions from one random cache: the logits
    of each and every cache entry at the end.  ``use_kernel`` is on in
    the port and changes nothing: the shared block runs decode_mha."""
    jcfg, tcfg = _cfgs(dtype=dtype, n_layers=n_layers)
    da.COUNT.reset()
    pairs, cj, ct = _decode_steps(jcfg, tcfg, [5, 6, 9],
                                  getattr(jnp, cache_dtype))
    assert (da.COUNT.launches, da.COUNT.plain) == (0, 0)
    tol = "float32" if dtype == cache_dtype == "float32" else "bfloat16"
    for lj, lt in pairs:
        _close(lt, lj, tol)
    _hold_cache(ct, cj, tol, same_dtypes=(dtype, cache_dtype) != (
        "float32", "bfloat16"))


@pytest.mark.parametrize("pos", [(2, 9, 0), [4, 4, 4]])
def test_decode_refuses_per_slot_positions(pos):
    """A (B,) pos raises, with the reference's message."""
    jcfg, tcfg = _cfgs()
    params = _np_params(jcfg)
    token = np.ones((3, 1), np.int32)
    msg = "per-slot decode positions: hybrid family serves via the lockstep"
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
    assert tc["ssm"][0, 0].data_ptr() != tc["ssm"][0, 1].data_ptr()


@pytest.mark.parametrize("n_layers", LAYERS)
def test_decode_matches_prefill(n_layers):
    """tests/test_models_smoke.py:92 for the hybrid: decoding token by
    token from an empty f32 cache reproduces the prefill's last logits,
    its states and the shared block's K/V."""
    _, tcfg = _cfgs(n_layers=n_layers, ssm_chunk=4)
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    S = 12
    toks = torch.from_numpy(tm._tokens(tcfg, 1, S))
    cache = model.init_cache(1, S, torch.float32)
    for i in range(S):
        lg, cache = model.decode_step(
            params, {"token": toks[:, i:i + 1], "pos": i}, cache)
    full, pcache = model.prefill(params, {"tokens": toks},
                                 opts=ModelOpts(attn_chunk=4))
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=0.05,
                               atol=0.05)
    for key in pcache:
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
    jsrv, tsrv = _servers(jcfg, tcfg)
    assert not (jsrv.continuous or tsrv.continuous or tsrv.use_kernel)
    ref = jsrv.run(_reqs(5, gen=6, cls=JRequest))
    assert tsrv.run(_reqs(5, gen=6)) == ref


def test_server_refuses_streaming():
    """submit, step and drain raise as the reference's do."""
    jcfg, tcfg = _cfgs()
    jsrv, tsrv = _servers(jcfg, tcfg)
    for srv, req in ((jsrv, _reqs(1, cls=JRequest)[0]),
                     (tsrv, _reqs(1)[0])):
        for call in (lambda: srv.submit(req), srv.step, srv.drain):
            with pytest.raises(RuntimeError, match="hybrid serves via the "
                               "lockstep fallback; use run"):
                call()


def test_serve_launcher_runs_reduced_on_cpu():
    out = _launch(serve_launcher, "--arch", ARCH, "--reduced", "--device",
                  "cpu", "--requests", "3", "--batch", "2",
                  "--new-tokens", "4")
    assert out["arch"] == ARCH
    assert out["requests"] == 3 and out["generated_tokens"] == 12


def test_train_launcher_runs_reduced_on_cpu(tmp_path):
    out = _launch(train_launcher, "--arch", ARCH, "--reduced", "--device",
                  "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                  "--out", str(tmp_path))
    assert out["arch"] == ARCH and out["steps"] == 2
    assert np.isfinite([out["loss_first10"], out["loss_last10"]]).all()
