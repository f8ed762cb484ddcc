"""The port's SSM family (mamba2-130m, reduced) against the JAX reference,
on the same numpy parameters and inputs: the conv, the segment sums and
the chunked scan, the cross-entropy, ``Model.forward``/``loss`` with and
without the ``ssd_scan`` kernel, ``prefill``, ``decode_step`` and serving.

Parameters come from the reference's ``Model.init`` with its constant
leaves randomised (``A_log``, ``D``, ``dt_bias``, ``conv_b``, the norm
scales; ``test_torch_model._np_params``).  Tolerances: f32 2e-5, bf16 2e-2
(``tests/test_kernels.py:14``), the scan's y at 5x, unless a test says
otherwise.  The reference runs its Pallas kernel in interpret mode on the
CPU, as ``kops.ssd`` does there; the port's wrapper runs its plain version
on CPU tensors and counts it in ``COUNT.plain``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distrib.logical import NOSHARD as JNOSHARD
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import Model as JModel
from repro.runtime.serve import BatchedServer as JBatchedServer
from repro.runtime.serve import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.distrib.logical import NOSHARD
from repro_torch.interop import params_from_numpy, spec_tree
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model
from repro_torch.runtime.serve import BatchedServer, LockstepServer, Request

import test_torch_model as tm
from test_torch_model import TDT, TOL, _close, _f32, _j, _np_params, _t, \
    _tokens

ARCH = "mamba2-130m"


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
# specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False])
def test_param_spec_tree_equals_reference(reduced):
    jcfg, tcfg = jconfigs.REGISTRY[ARCH], tconfigs.REGISTRY[ARCH]
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert spec_tree(Model(tcfg).param_spec()) == \
        spec_tree(JModel(jcfg).param_spec())


# ---------------------------------------------------------------------------
# the block's parts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_causal_conv(dt):
    """Taps accumulated one by one in the input dtype, as the reference."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 24), np.float32)
    w = 0.5 * rng.standard_normal((4, 24), np.float32)
    b = 0.1 * rng.standard_normal(24, np.float32)
    out = tssm._causal_conv(_t(x, dt), _t(w), _t(b))
    ref = jssm._causal_conv(_j(x, dt), _j(w), _j(b))
    assert out.dtype == TDT[dt]
    _close(out.float(), ref, dt)


def test_segsum_is_minus_inf_above_the_diagonal():
    a = -np.abs(np.random.default_rng(1).standard_normal((3, 2, 7))
                ).astype(np.float32)
    out = tssm._segsum(_t(a)).numpy()
    ref = np.asarray(jssm._segsum(_j(a)))
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    _close(out[fin], ref[fin], "float32")


def _scan_inputs(B, L, H, P, N, seed=4, dt="float32"):
    """Inputs in the manner of tests/test_kernels.py:45-51, from numpy."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, L, H, P), np.float32)
    dtv = 0.5 * np.log1p(np.exp(rng.standard_normal((B, L, H)))
                         ).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = 0.3 * rng.standard_normal((B, L, N), np.float32)
    Cm = 0.3 * rng.standard_normal((B, L, N), np.float32)
    D = 1 + 0.2 * rng.standard_normal(H).astype(np.float32)
    if dt == "bfloat16":     # round once, so both packages see the same bits
        x, Bm, Cm = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                     for a in (x, Bm, Cm))
    return x, dtv, A, Bm, Cm, D


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_reference_matches(with_init):
    x, dtv, A, Bm, Cm, D = _scan_inputs(2, 64, 3, 16, 8)
    init = (0.3 * np.random.default_rng(5).standard_normal((2, 3, 16, 8))
            ).astype(np.float32) if with_init else None
    y, s = tssm.ssd_reference(
        _t(x), _t(dtv), _t(A), _t(Bm), _t(Cm), _t(D), 16,
        init_state=None if init is None else _t(init))
    yj, sj = jssm.ssd_reference(
        _j(x), _j(dtv), _j(A), _j(Bm), _j(Cm), _j(D), 16,
        init_state=None if init is None else _j(init))
    _close(y, yj, "float32", 5 * TOL["float32"])
    _close(s, sj, "float32", 1e-4)


def test_ssd_reference_raises_on_a_ragged_chunk():
    x, dtv, A, Bm, Cm, D = _scan_inputs(1, 48, 2, 16, 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tssm.ssd_reference(_t(x), _t(dtv), _t(A), _t(Bm), _t(Cm), _t(D), 32)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_cross_entropy(dt, chunk):
    """Tied embeddings (mamba2-130m), some labels at -1."""
    jcfg, tcfg = _cfgs()
    assert tcfg.tie_embeddings
    emb = _np_params(jcfg)["embed"]
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, 9] = -1
    out = tlayers.chunked_cross_entropy(
        params_from_numpy(emb), tcfg, _t(h, dt), torch.from_numpy(labels),
        NOSHARD, chunk=chunk)
    ref = jlayers.chunked_cross_entropy(
        jax.tree.map(jnp.asarray, emb), jcfg, _j(h, dt), jnp.asarray(labels),
        JNOSHARD, chunk=chunk)
    assert out.dtype == torch.float32 and out.dim() == 0
    _close(out, ref, dt)


def test_chunked_cross_entropy_checks_the_chunk():
    _, tcfg = _cfgs()
    emb = params_from_numpy(_np_params(_cfgs()[0])["embed"])
    h = torch.zeros(1, 12, tcfg.d_model)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tlayers.chunked_cross_entropy(emb, tcfg, h,
                                      torch.zeros(1, 12, dtype=torch.long),
                                      NOSHARD, chunk=8)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------
def _batch(cfg, B, S, seed=2):
    toks = _tokens(cfg, B, S, seed)
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    return toks, labels


def _forward_pair(arch, use_kernel, dtype="bfloat16", B=2, S=32, **kw):
    jcfg, tcfg = _cfgs(arch, dtype=dtype, **kw)
    params = _np_params(jcfg)
    toks, labels = _batch(jcfg, B, S)
    jopts = JOpts(remat="none", use_kernel=use_kernel, attn_chunk=8,
                  ce_chunk=8)
    jmodel = JModel(jcfg)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    hj, _ = jax.jit(lambda p, b: jmodel.forward(p, b, opts=jopts))(params, jb)
    lj = jax.jit(lambda p, b: jmodel.loss(p, b, opts=jopts))(params, jb)
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels)}
    topts = ModelOpts(use_kernel=use_kernel, attn_chunk=8, ce_chunk=8)
    model, tp = Model(tcfg), params_from_numpy(params)
    ssd_mod.COUNT.reset()
    ht, aux = model.forward(tp, tb, opts=topts)
    counts = (ssd_mod.COUNT.launches, ssd_mod.COUNT.plain)
    lt = model.loss(tp, tb, opts=topts)
    return (hj, lj), (ht, aux, lt), counts, tcfg


# bf16 hidden states after 4 random layers (both reduced configs): one
# unit of bf16 in the last place flips where f32 sums are taken in another
# order and grows through the layers.  The reference's own jitted and
# op-by-op runs of these forwards differ by 0.055 at |h| <= 3.9 (1.13 % in
# norm) for mamba2-130m and by 0.031 at |h| <= 4.3 (0.51 %) for
# qwen1.5-4b.  So bf16 hidden states are held at 2e-2 in norm
# (||ht - hj|| / ||hj||) and elementwise at atol 0.1 (three bf16 units at
# |h| = 4), rtol 2e-2; the loss at the bf16 tolerance; the algorithm at f32
# tolerances in the float32 config.
BF16_HIDDEN_ATOL = 0.1


def _close_bf16_hidden(ht, hj):
    ht, hj = _f32(ht), np.asarray(hj, np.float32)
    rel = np.linalg.norm(ht - hj) / np.linalg.norm(hj)
    assert rel < TOL["bfloat16"], rel
    np.testing.assert_allclose(ht, hj, atol=BF16_HIDDEN_ATOL,
                               rtol=TOL["bfloat16"])


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("chunk", [256, 8])
def test_ssm_forward_and_loss_match_reference(use_kernel, chunk):
    """bf16 compute dtype; chunk 256 is one chunk of the 32 tokens, chunk
    8 carries the state across four.  With the kernel the port runs its
    plain version once per layer, the reference its Pallas kernel in
    interpret mode."""
    (hj, lj), (ht, aux, lt), counts, tcfg = _forward_pair(
        ARCH, use_kernel, ssm_chunk=chunk)
    assert counts == (0, tcfg.n_layers if use_kernel else 0)
    assert ht.dtype == torch.bfloat16 and float(aux) == 0.0
    _close_bf16_hidden(ht, hj)
    _close(lt, lj, "bfloat16")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ssm_forward_float32_config(use_kernel):
    """With dtype float32 no bf16 rounding can differ: hidden states at 5x
    the f32 tolerance (the scan's own tolerance), the loss at f32."""
    (hj, lj), (ht, _, lt), _, _ = _forward_pair(
        ARCH, use_kernel, dtype="float32", ssm_chunk=8)
    _close(ht, hj, "float32", 5 * TOL["float32"])
    _close(lt, lj, "float32")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_forward_and_loss_match_reference(dtype):
    (hj, lj), (ht, aux, lt), counts, _ = _forward_pair(
        "qwen1.5-4b", False, dtype=dtype, S=16)
    assert counts == (0, 0) and float(aux) == 0.0
    if dtype == "bfloat16":
        _close_bf16_hidden(ht, hj)
    else:
        _close(ht, hj, dtype)
    _close(lt, lj, dtype)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def test_prefill_logits_and_cache():
    jcfg, tcfg = _cfgs(ssm_chunk=8)
    params = _np_params(jcfg)
    toks = _tokens(jcfg, 2, 16)
    jmodel = JModel(jcfg)
    lj, cj = jax.jit(lambda p, b: jmodel.prefill(
        p, b, opts=JOpts(remat="none")))(params, {"tokens": jnp.asarray(toks)})
    lt, ct = Model(tcfg).prefill(params_from_numpy(params),
                                 {"tokens": torch.from_numpy(toks)})
    assert ct["ssm"].dtype == torch.float32
    assert ct["conv"].dtype == torch.bfloat16
    _close(lt, lj, "bfloat16")
    for key in ("ssm", "conv"):
        assert tuple(ct[key].shape) == cj[key].shape
        _close(_f32(ct[key]), cj[key], "bfloat16")


def _decode_pair(pos, dtype="bfloat16", seed=0):
    """One decode_step in both packages from the same random f32 cache."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    params = _np_params(jcfg, seed)
    B = 3
    rng = np.random.default_rng(seed + 7)
    jcache = JModel(jcfg).init_cache(B, 16, jnp.float32)
    cache = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in jcache.items()}
    token = _tokens(jcfg, B, 1, seed + 3).astype(np.int32)
    jmodel = JModel(jcfg)
    lj, cj = jax.jit(lambda p, b, c: jmodel.decode_step(
        p, b, c, opts=JOpts(remat="none")))(
        params,
        {"token": jnp.asarray(token), "pos": jnp.asarray(pos, jnp.int32)},
        cache)
    tcache = params_from_numpy(cache)
    lt, ct = Model(tcfg).decode_step(
        params_from_numpy(params),
        {"token": torch.from_numpy(token),
         "pos": torch.tensor(pos, dtype=torch.int32)}, tcache)
    assert ct["ssm"] is tcache["ssm"]          # updated in place
    return (lj, cj), (lt, ct)


@pytest.mark.parametrize("pos", [5, (2, 9, 0)])
def test_decode_step_matches_reference(pos):
    """Scalar and per-slot pos (unused by the recurrence).  The f32 cache
    promotes the conv and the state update to f32, as in the server."""
    (lj, cj), (lt, ct) = _decode_pair(pos)
    _close(lt, lj, "bfloat16")
    for key in ("ssm", "conv"):
        assert ct[key].dtype == torch.float32
        _close(ct[key].numpy(), cj[key], "bfloat16")


def test_decode_step_float32_config():
    (lj, cj), (lt, ct) = _decode_pair((4, 1, 7), dtype="float32")
    _close(lt, lj, "float32")
    for key in ("ssm", "conv"):
        _close(ct[key].numpy(), cj[key], "float32")


def test_init_cache_shapes_and_dtypes():
    jcfg, tcfg = _cfgs()
    jc = JModel(jcfg).init_cache(3, 16, jnp.float32)
    tc = Model(tcfg).init_cache(3, 16, torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert tc["ssm"].dtype == torch.float32
    assert tc["conv"].dtype == torch.bfloat16
    assert not torch.any(tc["ssm"]) and not torch.any(tc["conv"])
    assert tc["ssm"][0].data_ptr() != tc["ssm"][1].data_ptr()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_matches_prefill(use_kernel):
    """tests/test_models_smoke.py:92 for ssm: decoding token by token from
    an empty cache reproduces the prefill's last logits and its state.
    ``use_kernel`` changes nothing on the ssm decode path."""
    _, tcfg = _cfgs(ssm_chunk=4)
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    S = 12
    toks = torch.from_numpy(_tokens(tcfg, 1, S))
    cache = model.init_cache(1, S, torch.float32)
    ssd_mod.COUNT.reset()
    for i in range(S):
        lg, cache = model.decode_step(
            params, {"token": toks[:, i:i + 1], "pos": i}, cache,
            opts=ModelOpts(use_kernel=use_kernel))
    assert (ssd_mod.COUNT.launches, ssd_mod.COUNT.plain) == (0, 0)
    full, pcache = model.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=0.05,
                               atol=0.05)
    np.testing.assert_allclose(cache["ssm"].numpy(), pcache["ssm"].numpy(),
                               rtol=0.05, atol=0.05)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _reqs(n, base=3, gen=5, cls=Request):
    return [cls(rid=i, prompt=[1 + i, base, base + i % 3],
                max_new_tokens=gen) for i in range(n)]


@pytest.fixture(scope="module")
def ssm_model():
    _, tcfg = _cfgs()
    model = Model(tcfg)
    return model, model.init(torch.Generator("cpu").manual_seed(0))


@pytest.mark.parametrize("B,n", [(3, 3), (4, 2)])
def test_continuous_bit_identical_to_lockstep(ssm_model, B, n):
    model, params = ssm_model
    lock = LockstepServer(model, params, batch_size=B, max_seq=64,
                          device="cpu")
    cont = BatchedServer(model, params, batch_size=B, max_seq=64,
                         use_kernel=True, device="cpu")
    assert not cont.use_kernel                         # no ssm decode kernel
    assert cont.run(_reqs(n)) == lock.run(_reqs(n))


def test_slot_reuse_resets_recurrent_state(ssm_model):
    """tests/test_serve.py:145 in torch: a request served in a reused slot
    equals serving it alone."""
    model, params = ssm_model
    mk = lambda: Request(rid=7, prompt=[11, 12], max_new_tokens=5)
    ref = BatchedServer(model, params, batch_size=1, max_seq=64,
                        device="cpu").run([mk()])
    srv = BatchedServer(model, params, batch_size=1, max_seq=64,
                        device="cpu")
    srv.run([Request(rid=0, prompt=[3, 4, 5], max_new_tokens=6)])
    assert torch.any(srv.cache["ssm"] != 0)       # the first occupant's state
    assert srv.run([mk()]) == ref


def test_greedy_tokens_match_jax_server():
    """Same numpy parameters, same requests, float32 config: the torch and
    JAX continuous servers emit the same greedy tokens, slot reuse
    included (5 requests on 2 slots)."""
    jcfg, tcfg = _cfgs(dtype="float32")
    params = _np_params(jcfg)
    jsrv = JBatchedServer(JModel(jcfg), params, batch_size=2, max_seq=32,
                          opts=JOpts(remat="none"))
    tsrv = BatchedServer(Model(tcfg), params_from_numpy(params),
                         batch_size=2, max_seq=32, device="cpu")
    ref = jsrv.run(_reqs(5, gen=6, cls=JRequest))
    assert tsrv.run(_reqs(5, gen=6)) == ref


@pytest.mark.parametrize("arch", ["zamba2-7b", "llama-3.2-vision-90b",
                                  "hubert-xlarge"])
def test_unported_family_server_raises(arch):
    """The hybrid, vlm and audio slice has come: as the reference's
    (``serve.py:160-168``), the server takes hybrid and vlm through its
    lockstep fallback, whose ``run()`` serves and whose streaming calls
    raise; audio fails in ``init_cache``, as there."""
    _, tcfg = _cfgs(arch)
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    if tcfg.family == "audio":
        with pytest.raises(ValueError, match="no decode cache"):
            BatchedServer(model, params, batch_size=2, device="cpu")
        return
    srv = BatchedServer(model, params, batch_size=2, use_kernel=True,
                        device="cpu")
    assert not (srv.continuous or srv.use_kernel)
    with pytest.raises(RuntimeError, match="lockstep fallback"):
        srv.submit(_reqs(1)[0])
    out = srv.run(_reqs(3))
    assert sorted(out) == [0, 1, 2] and all(len(v) == 5 for v in out.values())


def test_moe_server_raises_until_its_slice():
    """The MoE slice has come: the port's server takes moe per slot, with
    the flash-decode kernel, as the reference does (``serve.py:147,163``),
    and serves every request."""
    _, tcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    srv = BatchedServer(model, params, batch_size=2, use_kernel=True,
                        device="cpu")
    assert "moe" in srv.SLOT_FAMILIES and srv.use_kernel
    out = srv.run(_reqs(3))
    assert sorted(out) == [0, 1, 2] and all(len(v) == 5 for v in out.values())
