"""The port's banded local:global path against the JAX reference, on the
same numpy inputs: ``banded_mha`` (``repro/models/attention.py:142``) and
``Model.forward``/``loss`` with ``banded_local=True`` on reduced
gemma3-27b, whose stack runs as superblocks of two local layers (banded)
and one global layer, then a local remainder (``model.py:185``).

The reduced config has window 8 and the tests take query chunks of 8, so
each band is 16 keys of 32 and the band really cuts the keys.
Tolerances: f32 2e-5, bf16 2e-2 (``tests/test_kernels.py:14``); bf16
hidden states through ``test_torch_ssm._close_bf16_hidden``; f32
gradients as ``test_torch_train`` holds them (the loss at 2e-5, every
leaf at 1e-4 relative in norm).  Within the port ``banded_mha`` is
``chunked_mha(window=w, is_global=False)`` without the masked-out keys,
held at 1e-6.
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
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch.distrib.logical import NOSHARD
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model
from repro_torch.tree import leaf_paths, leaves

from test_torch_model import TDT, TOL, _close, _np_params
from test_torch_ssm import _close_bf16_hidden
from test_torch_train import F32_LEAF, F32_LOSS, _batch

ARCH = "gemma3-27b"
OPTS = dict(attn_chunk=8, ce_chunk=8)
LAYERS = [4, 7]          # ratio 2: 1 superblock + 1 local; 2 + 1 local
SAME = 1e-6              # banded_mha vs chunked_mha, both the port's, f32

# (Sq, Sk, window, chunk, q_offset)
CASES = {
    "one_chunk": (16, 16, 4, 32, 0),           # chunk >= Sq: one block
    "band_is_sk": (16, 16, 8, 8, 0),           # round_up(16, 8) = Sk
    "bands": (32, 32, 4, 8, 0),                # band 16, clipped at 0
    # band 24: the first chunk's clips at 0, the last's at Sk - band (its
    # queries, at positions 32-39, run past the last key)
    "clipped_both_ends": (32, 32, 12, 8, 8),
    "q_offset": (16, 40, 8, 8, 24),            # Sk > Sq, the queries last
}
HEADS = {"G1": (2, 2), "G2": (4, 2)}           # (Hq, Hkv)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(case, heads, seed=0):
    Sq, Sk, *_ = CASES[case]
    Hq, Hkv = HEADS[heads]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, Sq, Hq, 16), np.float32),
            rng.standard_normal((2, Sk, Hkv, 16), np.float32),
            rng.standard_normal((2, Sk, Hkv, 16), np.float32))


# ---------------------------------------------------------------------------
# banded_mha
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("case", list(CASES))
def test_banded_mha_matches_reference(case, heads, dt):
    _, _, window, chunk, q_offset = CASES[case]
    q, k, v = _qkv(case, heads)
    oj = jattn.banded_mha(*(jnp.asarray(a, getattr(jnp, dt))
                            for a in (q, k, v)), JNOSHARD, window=window,
                          q_offset=q_offset, chunk=chunk)
    ot = tattn.banded_mha(*(torch.from_numpy(a).to(TDT[dt])
                            for a in (q, k, v)), NOSHARD, window=window,
                          q_offset=q_offset, chunk=chunk)
    assert ot.dtype == TDT[dt] and ot.shape == q.shape
    _close(ot.float(), oj, dt)


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("case", list(CASES))
def test_banded_mha_is_the_windowed_chunked_mha(case, heads):
    _, _, window, chunk, q_offset = CASES[case]
    q, k, v = map(torch.from_numpy, _qkv(case, heads, seed=1))
    banded = tattn.banded_mha(q, k, v, NOSHARD, window=window,
                              q_offset=q_offset, chunk=chunk)
    full = tattn.chunked_mha(q, k, v, NOSHARD, causal=True, is_global=False,
                             window=window, q_offset=q_offset, chunk=chunk)
    torch.testing.assert_close(banded, full, atol=SAME, rtol=SAME)


def test_banded_mha_refuses_a_ragged_chunk():
    q, k, v = (torch.zeros(1, 12, 2, 16) for _ in range(3))
    with pytest.raises(ValueError, match="multiple of chunk"):
        tattn.banded_mha(q, k, v, NOSHARD, window=4, chunk=8)


# ---------------------------------------------------------------------------
# Model.forward and loss on the banded path
# ---------------------------------------------------------------------------
def _cfgs(n_layers, dtype, arch=ARCH):
    kw = dict(n_layers=n_layers, dtype=dtype)
    return (dataclasses.replace(jconfigs.REGISTRY[arch].reduced(), **kw),
            dataclasses.replace(tconfigs.REGISTRY[arch].reduced(), **kw))


def _params(jcfg):
    return _np_params(dataclasses.replace(jcfg, dtype="float32"))


@functools.lru_cache(maxsize=None)
def _reference(n_layers, dtype):
    """The reference's banded hidden states and loss."""
    jcfg, _ = _cfgs(n_layers, dtype)
    jmodel, opts = JModel(jcfg), JOpts(banded_local=True, **OPTS)
    batch = jax.tree.map(jnp.asarray, _batch(jcfg))
    params = jax.tree.map(jnp.asarray, _params(jcfg))
    h, _ = jax.jit(lambda p, b: jmodel.forward(p, b, opts=opts))(
        params, batch)
    loss = jax.jit(lambda p, b: jmodel.loss(p, b, opts=opts))(params, batch)
    return np.asarray(h.astype(jnp.float32)), float(loss)


def _port(tcfg, np_params, batch, banded):
    model, params = Model(tcfg), params_from_numpy(np_params)
    opts = ModelOpts(banded_local=banded, **OPTS)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    h, aux = model.forward(params, tb, opts=opts)
    return h, aux, model.loss(params, tb, opts=opts).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_banded_forward_matches_reference_and_unbanded(n_layers, dtype):
    jcfg, tcfg = _cfgs(n_layers, dtype)
    np_params, batch = _params(jcfg), _batch(jcfg)
    hj, lj = _reference(n_layers, dtype)
    h, aux, loss = _port(tcfg, np_params, batch, banded=True)
    h_full, _, loss_full = _port(tcfg, np_params, batch, banded=False)
    assert h.dtype == TDT[dtype] and float(aux) == 0.0
    for ours in (h, h_full):
        if dtype == "bfloat16":
            _close_bf16_hidden(ours, hj)
        else:
            _close(ours, hj, dtype)
    for ours in (loss, loss_full):
        _close(ours, lj, dtype)
    if dtype == "float32":
        _close(h, h_full.numpy(), dtype)


@functools.lru_cache(maxsize=None)
def _reference_grads(n_layers):
    jcfg, _ = _cfgs(n_layers, "float32")
    opts = JOpts(remat="none", banded_local=True, **OPTS)
    batch = jax.tree.map(jnp.asarray, _batch(jcfg))
    loss, grads = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, batch, opts=opts))(
        jax.tree.map(jnp.asarray, _params(jcfg)))
    return float(loss), dict(leaf_paths(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_banded_grads_match_reference(n_layers, remat):
    jcfg, tcfg = _cfgs(n_layers, "float32")
    jloss, jgrads = _reference_grads(n_layers)
    params = params_from_numpy(_params(jcfg))
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = Model(tcfg).loss(
        params, {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()},
        opts=ModelOpts(remat=remat, banded_local=True, **OPTS))
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), jloss, rtol=F32_LOSS,
                               atol=F32_LOSS)
    paths = [p for p, _ in leaf_paths(params)]
    assert sorted(paths) == sorted(jgrads)
    for path, g in zip(paths, grads):
        ref = jgrads[path]
        err = np.linalg.norm(g.numpy() - ref) / max(np.linalg.norm(ref),
                                                    1e-30)
        assert err <= F32_LEAF, (path, err)


def test_banded_flag_without_a_window_changes_nothing():
    """qwen1.5-4b has no window: ``banded_local`` leaves its forward as
    it is, bit for bit."""
    jcfg, tcfg = _cfgs(2, "bfloat16", arch="qwen1.5-4b")
    assert not tcfg.sliding_window
    np_params, batch = _params(jcfg), _batch(jcfg)
    h, _, loss = _port(tcfg, np_params, batch, banded=True)
    h_full, _, loss_full = _port(tcfg, np_params, batch, banded=False)
    assert torch.equal(h, h_full) and loss == loss_full


@pytest.mark.parametrize("grad", [False, True])
def test_banded_forward_reads_views_of_the_stack(monkeypatch, grad):
    """Every layer the banded forward runs is layer i of the stacked
    leaves, a view in their storage, in stack order: superblocks of two
    banded local layers and one full global layer, then the banded
    remainder.  With grad on too (remat "full"), where the views are
    ``unbind``'s."""
    jcfg, tcfg = _cfgs(7, "float32")
    params = params_from_numpy(_params(jcfg))
    if grad:
        for p in leaves(params):
            p.requires_grad_(True)
    stack = dict(leaf_paths(params["layers"]))
    seen = []
    block = tblocks.dense_block

    def spy(p, h, *args, banded=False, is_global=True, **kw):
        seen.append((dict(leaf_paths(p)), banded, is_global))
        return block(p, h, *args, banded=banded, is_global=is_global, **kw)

    monkeypatch.setattr(tblocks, "dense_block", spy)
    tb = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    with torch.set_grad_enabled(grad):
        Model(tcfg).forward(params, tb, opts=ModelOpts(
            banded_local=True, remat="full", **OPTS))
    assert [(b, g) for _, b, g in seen] == \
        [(True, True), (True, True), (False, True)] * 2 + [(True, True)]
    for i, (layer, _, _) in enumerate(seen):
        assert layer.keys() == stack.keys()
        for path, leaf in layer.items():
            whole = stack[path]
            assert leaf.untyped_storage().data_ptr() == \
                whole.untyped_storage().data_ptr(), (i, path)
            assert leaf.data_ptr() == whole[i].data_ptr(), (i, path)
