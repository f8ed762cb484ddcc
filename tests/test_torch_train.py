"""The port's training loss and its gradient against the reference's
``jax.value_and_grad(model.loss)``, on the same numpy parameters
(``test_torch_model._np_params``: the reference's init with random biases
and norm scales) and batch, for reduced qwen1.5-4b (dense), phi3.5-moe
(moe, its router aux term included) and mamba2-130m (ssm), several chunks
of attention, cross-entropy and SSD scan each, and ignored labels.

Tolerances: a float32 config holds the loss at 2e-5 and every leaf of the
gradient at 1e-4 relative in norm; bfloat16 holds the loss at 2e-2 and
the whole gradient at 2e-2 relative in norm (``TOL`` of
``tests/test_kernels.py:14``): bf16 products and scatter-adds sum in
another order, so single small leaves move more than the whole.  ``remat``
none, full and dots give equal gradients (exact).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model, layer_slice, unstack
from repro_torch.tree import leaf_paths, leaves

from test_torch_model import _np_params

ARCHS = ["qwen1.5-4b", "phi3.5-moe-42b-a6.6b", "mamba2-130m"]
OPTS = dict(attn_chunk=8, ce_chunk=8)
B, S = 2, 32
F32_LOSS, F32_LEAF, BF16 = 2e-5, 1e-4, 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype):
    kw = dict(dtype=dtype)
    if arch == "mamba2-130m":
        kw["ssm_chunk"] = 8                   # four chunks of the scan
    return (dataclasses.replace(jconfigs.REGISTRY[arch].reduced(), **kw),
            dataclasses.replace(tconfigs.REGISTRY[arch].reduced(), **kw))


def _batch(cfg, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1                        # ignored positions
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": labels.astype(np.int32)}


def _params(jcfg):
    return _np_params(dataclasses.replace(jcfg, dtype="float32"))


def _ref_value_and_grad(jcfg, np_params, batch):
    opts = JOpts(remat="none", **OPTS)
    loss, grads = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, jax.tree.map(jnp.asarray, batch),
                                    opts=opts))(
        jax.tree.map(jnp.asarray, np_params))
    return float(loss), dict(leaf_paths(jax.tree.map(np.asarray, grads)))


def _value_and_grad(tcfg, np_params, batch, **opts):
    params = params_from_numpy(np_params)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = Model(tcfg).loss(params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()},
                            opts=ModelOpts(**{**OPTS, **opts}))
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    paths = [p for p, _ in leaf_paths(params)]
    assert all(g.dtype == torch.float32 for g in grads)   # f32 masters
    return loss.item(), {p: g.numpy() for p, g in zip(paths, grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    np_params, batch = _params(jcfg), _batch(jcfg)
    jloss, jgrads = _ref_value_and_grad(jcfg, np_params, batch)
    loss, grads = _value_and_grad(tcfg, np_params, batch, remat="full")
    np.testing.assert_allclose(loss, jloss, rtol=F32_LOSS, atol=F32_LOSS)
    assert grads.keys() == jgrads.keys()
    for path, g in grads.items():
        ref = jgrads[path]
        err = np.linalg.norm(g - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= F32_LEAF, (path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    np_params, batch = _params(jcfg), _batch(jcfg)
    jloss, jgrads = _ref_value_and_grad(jcfg, np_params, batch)
    loss, grads = _value_and_grad(tcfg, np_params, batch, remat="full")
    np.testing.assert_allclose(loss, jloss, rtol=BF16, atol=BF16)
    diff = np.sqrt(sum(np.sum((grads[p] - jgrads[p].astype(np.float32)) ** 2)
                       for p in grads))
    norm = np.sqrt(sum(np.sum(jgrads[p].astype(np.float32) ** 2)
                       for p in grads))
    assert diff / norm <= BF16, diff / norm


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_equal_grads(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    np_params, batch = _params(jcfg), _batch(jcfg)
    runs = {mode: _value_and_grad(tcfg, np_params, batch, remat=mode)
            for mode in ("none", "full", "dots")}
    base_loss, base = runs["none"]
    for mode in ("full", "dots"):
        loss, grads = runs[mode]
        assert loss == base_loss, mode
        for path in base:
            np.testing.assert_array_equal(grads[path], base[path],
                                          err_msg=f"{mode} {path}")


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = str(func.overloadpacket).split(".")[-1]
        self.n[key] = self.n.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(mode, arch="qwen1.5-4b"):
    """The operators the backward runs: recomputed forward ops included."""
    jcfg, tcfg = _cfgs(arch, "float32")
    params = params_from_numpy(_params(jcfg))
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    loss = Model(tcfg).loss(params, batch,
                            opts=ModelOpts(remat=mode, **OPTS))
    with _CountOps() as ops:
        torch.autograd.grad(loss, flat)
    return ops.n


def test_dots_policy_saves_products_and_recomputes_the_rest():
    """"full" recomputes each layer's forward in the backward, products
    included; "dots" keeps the products (aten.mm, bmm, addmm) and
    recomputes the rest, as ``checkpoint_dots`` does; "none" recomputes
    nothing but the chunk bodies of attention and the cross-entropy."""
    n = {mode: _backward_ops(mode) for mode in ("none", "full", "dots")}
    mm = {m: sum(c.get(k, 0) for k in ("mm", "bmm", "addmm"))
          for m, c in n.items()}
    assert mm["dots"] < mm["full"]
    assert mm["none"] < mm["full"]
    soft = {m: c.get("_softmax", 0) for m, c in n.items()}
    assert soft["full"] > soft["none"] and soft["dots"] > soft["none"]
    rsqrt = {m: c.get("rsqrt", 0) for m, c in n.items()}   # the rmsnorms
    assert rsqrt["none"] == 0 < rsqrt["dots"] == rsqrt["full"]


def test_remat_is_inert_without_grad(monkeypatch):
    """No checkpoint is taken under ``no_grad``, nor by the prefill and
    decode paths whatever the grad mode: their kernels, launch counts and
    numbers stay as they were."""
    def refuse(*a, **k):
        raise AssertionError("checkpoint taken")
    monkeypatch.setattr(tlayers, "checkpoint", refuse)
    jcfg, tcfg = _cfgs("qwen1.5-4b", "float32")
    params = params_from_numpy(_params(jcfg))
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    model = Model(tcfg)
    with torch.no_grad():
        model.loss(params, batch, opts=ModelOpts(remat="full", **OPTS))
    logits, cache = model.prefill(params, batch, opts=ModelOpts(**OPTS))
    assert not logits.requires_grad
    model.decode_step(params, {"token": batch["tokens"][:, :1],
                               "pos": torch.tensor(S - 1)},
                      {k: torch.cat([v, v[:, :, :1]], dim=2)
                       for k, v in cache.items()})
    with pytest.raises(AssertionError, match="checkpoint taken"):
        model.loss(params, batch, opts=ModelOpts(remat="full", **OPTS))


def test_remat_rejects_unknown_mode():
    """An unknown mode is not rejected: it means "full", as the
    reference's ``remat_wrap`` reads it (its dry-run's ``--remat`` takes
    any string): the same backward, the same gradients."""
    assert _backward_ops("some") == _backward_ops("full")
    jcfg, tcfg = _cfgs("qwen1.5-4b", "float32")
    np_params, batch = _params(jcfg), _batch(jcfg)
    some = _value_and_grad(tcfg, np_params, batch, remat="some")
    full = _value_and_grad(tcfg, np_params, batch, remat="full")
    assert some[0] == full[0]
    assert some[1].keys() == full[1].keys()
    for path in some[1]:
        np.testing.assert_array_equal(some[1][path], full[1][path])


def test_unstack_equals_layer_slices():
    jcfg, _ = _cfgs("phi3.5-moe-42b-a6.6b", "float32")
    params = params_from_numpy(_params(jcfg))
    layers = unstack(params["layers"], jcfg.n_layers)
    assert len(layers) == jcfg.n_layers
    for i, layer in enumerate(layers):
        want = dict(leaf_paths(layer_slice(params["layers"], i)))
        got = dict(leaf_paths(layer))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)


def test_ssm_kernel_loss_raises_under_autograd():
    """``use_kernel=True`` runs ``ssd_scan``, which has no backward: with
    parameters that require grad the loss raises the wrapper's message;
    training runs ``ssd_reference``."""
    jcfg, tcfg = _cfgs("mamba2-130m", "float32")
    params = params_from_numpy(_params(jcfg))
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    with pytest.raises(RuntimeError, match="ssd_scan has no backward"):
        Model(tcfg).loss(params, batch,
                         opts=ModelOpts(use_kernel=True, **OPTS))
