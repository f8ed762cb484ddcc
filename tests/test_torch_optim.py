"""The port's optimizer (``repro_torch.optim``) against the reference's
(``repro.optim``) on the same numpy trees: ``adamw_update`` with and
without clipping, from a fresh state and from a state several steps in;
``cosine_schedule`` at step 0, inside the warm-up, mid-decay and past
``total``; int8 ``compress_grads`` (codes equal exactly, error feedback
and dequantized values equal) and ``compression_ratio``.

Tolerances: AdamW's params, ``m`` and ``v`` 1e-6 relative with an atol of
1e-7 (XLA may contract a product and a sum into one fma where the port
rounds twice); the grad norm 1e-6 relative (the leaf sums are reduced in
another order); the schedule and the learning rate 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.optim import compress as jcompress
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm)
from repro_torch.optim import compress as tcompress
from repro_torch.tree import leaf_paths, leaves, tree_map, unflatten

RTOL, ATOL = 1e-6, 1e-7


def _tree(rng, scale=1.0):
    """A nested tree of f32 numpy leaves, 0-d to 3-d, keys out of order."""
    return {"w": {"b": scale * rng.standard_normal((3, 5)).astype(np.float32),
                  "a": scale * rng.standard_normal((7,)).astype(np.float32)},
            "emb": scale * rng.standard_normal((4, 2, 6)).astype(np.float32),
            "c": np.float32(scale * rng.standard_normal())}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                    tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _pairs(ported, ref):
    """(port leaf, reference leaf) as numpy, by path."""
    flat_ref = dict(leaf_paths(jax.tree.map(np.asarray, ref)))
    return [(leaf.detach().numpy(), flat_ref[path])
            for path, leaf in leaf_paths(ported)]


def test_tree_order_is_the_reference_order():
    tree = _tree(np.random.default_rng(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert [path for path, _ in leaf_paths(tree)] == [
        tuple(k.key for k in path) for path, _ in flat]
    assert unflatten(tree, list(range(4))) == {
        "c": 0, "emb": 1, "w": {"a": 2, "b": 3}}


def test_global_norm_matches_reference():
    from repro.optim.adamw import global_norm as jglobal_norm
    tree = _tree(np.random.default_rng(1), scale=3.0)
    got = global_norm(_torch(tree)).item()
    np.testing.assert_allclose(got, float(jglobal_norm(_jax(tree))),
                               rtol=RTOL)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("warm_steps", [0, 5])
def test_adamw_update_matches_reference(clip_norm, warm_steps):
    """One update from a state ``warm_steps`` steps in (random m, v >= 0),
    with the clip active (the grads' norm is ~10) or not."""
    rng = np.random.default_rng(2 + warm_steps)
    params, grads = _tree(rng), _tree(rng, scale=3.0)
    m0, v0 = _tree(rng, 0.1), tree_map(np.abs, _tree(rng, 0.01))
    cfg = dict(lr=1e-3, clip_norm=clip_norm, weight_decay=0.1)
    jstate = jadamw_init(_jax(params))
    if warm_steps:
        jstate = {"m": _jax(m0), "v": _jax(v0),
                  "count": jnp.asarray(warm_steps, jnp.int32)}
    jp, js, jm = jadamw_update(_jax(grads), jstate, _jax(params),
                               JAdamWConfig(**cfg), lr_scale=0.5)

    tp = _torch(params)
    ts = adamw_init(tp)
    assert ts["count"].dtype == torch.int32
    assert all(m.dtype == p.dtype and not m.any()
               for m, p in zip(leaves(ts["m"]), leaves(tp)))
    if warm_steps:
        ts = {"m": _torch(m0), "v": _torch(v0),
              "count": torch.tensor(warm_steps, dtype=torch.int32)}
    ident = [id(x) for x in leaves(tp)]
    tm = adamw_update(_torch(grads), ts, tp, AdamWConfig(**cfg),
                      lr_scale=torch.tensor(0.5))
    assert [id(x) for x in leaves(tp)] == ident          # in place
    assert int(ts["count"]) == int(js["count"]) == warm_steps + 1
    for got, ref in _pairs(tp, jp) + _pairs(ts["m"], js["m"]) + \
            _pairs(ts["v"], js["v"]):
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=RTOL)
    np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-7)
    assert tm["grad_norm"].dtype == tm["lr"].dtype == torch.float32


def test_adamw_update_leaves_grads_untouched():
    rng = np.random.default_rng(3)
    params, grads = _torch(_tree(rng)), _torch(_tree(rng, scale=3.0))
    before = [g.clone() for g in leaves(grads)]
    adamw_update(grads, adamw_init(params), params, AdamWConfig())
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(grads)))


@pytest.mark.parametrize("step", [0, 7, 20, 5_010, 10_000, 12_345],
                         ids=["zero", "warmup", "warmup_end", "mid_decay",
                              "total", "past_total"])
def test_cosine_schedule_matches_reference(step):
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32), warmup=20,
                          total=10_000)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(jcosine(
        jnp.asarray(step, jnp.int32), warmup=20, total=10_000)), rtol=1e-7,
        atol=1e-7)
    if step == 0:
        assert got.item() == 0.0


def test_quantize_codes_equal_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    x[:8] = [0.5, -0.5, 1.5, 2.5, -2.5, 0, 127, -127]  # ties, both ends
    q, s = tcompress._quantize(torch.from_numpy(x))
    jq, js = jcompress._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert s.item() == float(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    zq, zs = tcompress._quantize(torch.zeros(5))
    assert not zq.any() and zs.item() == np.float32(1e-12) / np.float32(127)


def test_compress_grads_with_error_feedback_matches_reference():
    """Three steps of compression with the error carried: the
    dequantized grads and the error feedback equal the reference's."""
    rng = np.random.default_rng(5)
    like = _tree(rng)
    terr = tcompress.init_error_feedback(_torch(like))
    jerr = jcompress.init_error_feedback(_jax(like))
    for step in range(3):
        grads = _tree(rng, scale=10.0 ** -step)
        tdeq, terr2 = tcompress.compress_grads(_torch(grads), terr)
        assert terr2 is terr                             # in place
        jdeq, jerr = jcompress.compress_grads(_jax(grads), jerr)
        for got, ref in _pairs(tdeq, jdeq) + _pairs(terr, jerr):
            np.testing.assert_array_equal(got, ref)


def test_compression_ratio_matches_reference():
    tree = _tree(np.random.default_rng(6))
    tree["half"] = np.zeros((8, 8), np.float16)
    ratio = tcompress.compression_ratio(
        tree_map(lambda a: torch.from_numpy(np.array(a)), tree))
    assert ratio == jcompress.compression_ratio(_jax(tree))
