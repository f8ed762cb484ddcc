"""gemma-7b, minitron-8b and llama4-scout-17b-a16e, reduced so that each
keeps the shape that sets it apart, against the JAX reference on the same
numpy parameters and inputs.

``ArchConfig.reduced()`` gives all three 4 heads of 16 (4 KV heads), so
``q_dim == d_model`` and G = 1 there.  Here:

* gemma-7b: 4 heads = 4 KV heads of 32, a q width of 128 against
  ``d_model`` 64 (``project_q`` and ``out_proj`` are not square), the
  tied head and GeGLU;
* minitron-8b: 8 heads over 2 KV heads (G = 4);
* llama4-scout-17b-a16e: 10 heads over 2 KV heads (G = 5), top-1 of 4
  experts.

For the two dense archs: ``Model.forward``'s hidden states and logits
and ``Model.loss``, ``prefill`` logits and cache, and ``decode_step`` at a
scalar and a per-slot ``pos`` with the decode kernel off and on (the
reference's Pallas kernel in interpret mode, the port's wrapper running
its plain version on CPU tensors, counted in ``COUNT.plain``).  For all
three: the port's ``BatchedServer`` emits the JAX ``BatchedServer``'s
greedy tokens in a float32 config, with and without the kernel.

Parameters come from the reference's ``Model.init``
(``test_torch_model._np_params``, biases and norm scales made random).
Tolerances: f32 2e-5, bf16 2e-2 (``tests/test_kernels.py:14``); bf16
hidden states after several layers are held in norm as in
``test_torch_ssm._close_bf16_hidden``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import Model as JModel
from repro.runtime.serve import BatchedServer as JBatchedServer
from repro.runtime.serve import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy, spec_tree
from repro_torch.kernels import decode_attention as da
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.layers import unembed_matrix
from repro_torch.models.model import Model
from repro_torch.runtime.serve import BatchedServer, Request

import test_torch_model as tm
from test_torch_model import TOL, _close, _f32, _np_params, _tokens
from test_torch_ssm import _batch, _close_bf16_hidden

# each arch's reduced config, widened back to the shape that sets it apart
SHAPES = {"gemma-7b": dict(head_dim=32),
          "minitron-8b": dict(n_heads=8, n_kv_heads=2),
          "llama4-scout-17b-a16e": dict(n_heads=10, n_kv_heads=2)}
ARCHS = list(SHAPES)
DENSE = ["gemma-7b", "minitron-8b"]
OPTS = dict(attn_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    """The arch's reduced config in both packages, with its shape."""
    return tm._cfgs(arch, **SHAPES[arch], **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_configs_keep_the_shape_that_sets_them_apart(arch):
    jcfg, tcfg = _cfgs(arch)
    full = tconfigs.REGISTRY[arch]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.family == full.family
    assert tcfg.activation == full.activation
    assert tcfg.tie_embeddings == full.tie_embeddings
    assert (tcfg.n_heads // tcfg.n_kv_heads, tcfg.top_k) == {
        "gemma-7b": (1, 0), "minitron-8b": (4, 0),
        "llama4-scout-17b-a16e": (5, 1)}[arch]
    assert tcfg.q_dim != tcfg.d_model      # as in every full config
    assert (full.q_dim != full.d_model) == (arch == "gemma-7b")
    assert spec_tree(Model(tcfg).param_spec()) == \
        spec_tree(JModel(jcfg).param_spec())


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------
def _forward_pair(arch, dtype, B=2, S=16):
    """(hidden, logits, loss) of the reference's jitted forward and loss
    and of the port's, on one batch."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    params = _np_params(jcfg)
    toks, labels = _batch(jcfg, B, S)
    jopts = JOpts(remat="none", ce_chunk=8, **OPTS)
    jmodel = JModel(jcfg)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    hj, _ = jax.jit(lambda p, b: jmodel.forward(p, b, opts=jopts))(params, jb)
    wj = np.asarray(params["embed"]["tok"]).T if jcfg.tie_embeddings \
        else np.asarray(params["embed"]["unembed"])
    hj = np.asarray(hj.astype(jnp.float32))
    lj = jax.jit(lambda p, b: jmodel.loss(p, b, opts=jopts))(params, jb)
    model, tp = Model(tcfg), params_from_numpy(params)
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels)}
    topts = ModelOpts(ce_chunk=8, **OPTS)
    ht, aux = model.forward(tp, tb, opts=topts)
    assert float(aux) == 0.0
    w = unembed_matrix(tp["embed"], tcfg, ht.dtype)
    logits_t = (ht @ w).float()
    # the reference's logits: its hidden states through its head, in the
    # compute dtype as ``chunked_cross_entropy`` takes them
    jdt = getattr(jnp, dtype)
    logits_j = np.asarray((jnp.asarray(hj, jdt) @ jnp.asarray(wj, jdt)
                           ).astype(jnp.float32))
    lt = model.loss(tp, tb, opts=topts)
    return (hj, logits_j, lj), (ht, logits_t, lt)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_match_reference(arch, dtype):
    """bf16 hidden states in norm (``_close_bf16_hidden``), the logits and
    the loss at the dtype's tolerance; in the float32 config all three at
    the f32 tolerance."""
    (hj, logits_j, lj), (ht, logits_t, lt) = _forward_pair(arch, dtype)
    if dtype == "bfloat16":
        assert ht.dtype == torch.bfloat16
        _close_bf16_hidden(ht, hj)
    else:
        _close(ht, hj, dtype)
    _close(logits_t, logits_j, dtype)
    _close(lt, lj, dtype)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_cache(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    params = _np_params(jcfg)
    toks = _tokens(jcfg, 2, 16)
    jmodel = JModel(jcfg)
    jopts = JOpts(remat="none", **OPTS)
    lj, cj = jax.jit(lambda p, b: jmodel.prefill(p, b, opts=jopts))(
        params, {"tokens": jnp.asarray(toks)})
    lt, ct = Model(tcfg).prefill(params_from_numpy(params),
                                 {"tokens": torch.from_numpy(toks)},
                                 opts=ModelOpts(**OPTS))
    assert lt.dtype == torch.float32
    assert ct["k"].dtype == getattr(torch, dtype)
    assert tuple(lt.shape) == (2, tcfg.vocab)
    _close(lt, lj, dtype)
    for key in ("k", "v"):
        assert tuple(ct[key].shape) == cj[key].shape == (
            tcfg.n_layers, 2, 16, tcfg.n_kv_heads, tcfg.head_dim)
        _close(_f32(ct[key]), cj[key], dtype)


@pytest.mark.parametrize("pos", [5, (2, 9, 0)])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(arch, use_kernel, pos):
    """bf16 compute on an f32 cache: the logits and the cache at the bf16
    tolerance, every row no step wrote bit-equal.  On the CPU "on" runs the
    wrapper's plain version once a layer, and no launch is counted."""
    jcfg, tcfg = _cfgs(arch)
    (lj, cj), (lt, ct), counts = tm._decode_pair(jcfg, tcfg, pos, use_kernel)
    assert counts == (0, tcfg.n_layers if use_kernel else 0)
    assert tuple(lt.shape) == (3, tcfg.vocab)
    _close(lt, lj, "bfloat16")
    for key in ("k", "v"):
        _close(ct[key].numpy(), cj[key], "bfloat16")
        untouched = np.ones(ct[key].shape[2], bool)
        untouched[np.unique(pos)] = False
        np.testing.assert_array_equal(ct[key].numpy()[:, :, untouched],
                                      np.asarray(cj[key])[:, :, untouched])


@pytest.mark.parametrize("pos", [4, (1, 6, 11)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_float32_config(arch, pos):
    """With the kernel, in a float32 config: the logits and the cache at
    the f32 tolerance, llama4-scout's G = 5 and top-1 router included."""
    jcfg, tcfg = _cfgs(arch, dtype="float32")
    (lj, cj), (lt, ct), counts = tm._decode_pair(jcfg, tcfg, pos, True)
    assert counts == (0, tcfg.n_layers)
    _close(lt, lj, "float32")
    for key in ("k", "v"):
        _close(ct[key].numpy(), cj[key], "float32")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _reqs(n, base=3, gen=6, cls=Request):
    return [cls(rid=i, prompt=[1 + i, base, base + i % 3],
                max_new_tokens=gen) for i in range(n)]


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_server(arch, use_kernel):
    """Same numpy parameters, same requests, float32 config: the port's
    and the reference's continuous servers emit the same greedy tokens,
    slot reuse included (5 requests on 2 slots); with the kernel the port
    runs its plain version once a layer a step."""
    jcfg, tcfg = _cfgs(arch, dtype="float32")
    params = _np_params(jcfg)
    jsrv = JBatchedServer(JModel(jcfg), params, batch_size=2, max_seq=32,
                          opts=JOpts(remat="none", **OPTS),
                          use_kernel=use_kernel)
    tsrv = BatchedServer(Model(tcfg), params_from_numpy(params),
                         batch_size=2, max_seq=32, opts=ModelOpts(**OPTS),
                         use_kernel=use_kernel, device="cpu")
    assert tsrv.use_kernel == jsrv.use_kernel == use_kernel
    ref = jsrv.run(_reqs(5, cls=JRequest))
    da.COUNT.reset()
    out = tsrv.run(_reqs(5))
    assert da.COUNT.launches == 0
    assert da.COUNT.plain == (tsrv.steps * tcfg.n_layers if use_kernel
                              else 0)
    assert sorted(out) == list(range(5))
    assert all(len(v) == 6 for v in out.values())
    assert out == ref
