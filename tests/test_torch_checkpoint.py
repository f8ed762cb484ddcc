"""The port's checkpoints (``repro_torch.checkpoint``) and the reference's
(``repro.checkpoint``) are one format: a round trip in the port, pruning
and ``latest_step``; a checkpoint the port saves restores in the reference
and one the reference saves restores in the port, with equal names,
shapes, dtypes and values (exact); the whole training state of a
``TrainLoop`` crosses both ways; a bfloat16 leaf is refused."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import REGISTRY as JREGISTRY
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import build_model as jbuild_model
from repro.runtime.train_loop import TrainLoop as JTrainLoop
from repro.runtime.train_loop import TrainLoopConfig as JLoopConfig
from repro_torch import checkpoint as tckpt
from repro_torch.configs import REGISTRY
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model import build_model
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
from repro_torch.tree import leaf_paths, tree_map


def _np_tree():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "layers": {"b": rng.standard_normal((2, 5)).astype(
                           np.float32)}},
            "opt": {"count": np.array(7, np.int32),
                    "m": {"w": np.zeros((3, 4), np.float32)}}}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    return m["step"], m["leaves"]


def _assert_same(got, want):
    """Two nested trees of arrays/tensors: same paths, dtypes, values."""
    g = {p: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                       else v) for p, v in leaf_paths(got)}
    w = {p: np.asarray(v) for p, v in leaf_paths(
        jax.tree.map(np.asarray, want))}
    assert g.keys() == w.keys()
    for p in g:
        assert g[p].dtype == w[p].dtype, p
        np.testing.assert_array_equal(g[p], w[p])


def test_round_trip_and_latest_step(tmp_path):
    tree = tree_map(torch.from_numpy, _np_tree())
    path = tckpt.save_checkpoint(str(tmp_path), 5, tree)
    assert os.path.basename(path) == "step_00000005"
    assert tckpt.latest_step(str(tmp_path)) == 5
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)
    back = tckpt.restore_checkpoint(str(tmp_path), 5, like)
    _assert_same(back, _np_tree())
    assert back["opt"]["count"].dtype == torch.int32
    assert sorted(os.listdir(path)) == sorted(
        ["manifest.json", "opt_count.npy", "opt_m_w.npy",
         "params_layers_b.npy", "params_w.npy"])


def test_prune_and_incomplete_steps(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(str(tmp_path), s, tree)
    tckpt.prune_checkpoints(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    os.makedirs(tmp_path / "step_00000009.tmp")        # a crash mid-write
    os.makedirs(tmp_path / "step_00000008")            # no manifest yet
    assert tckpt.latest_step(str(tmp_path)) == 5
    assert tckpt.latest_step(str(tmp_path / "absent")) is None


def test_restore_refuses_missing_or_misshapen_leaves(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="missing leaves"):
        tckpt.restore_checkpoint(str(tmp_path), 1, {"b": torch.zeros(2)})
    with pytest.raises(ValueError, match="shaped"):
        tckpt.restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)})


def test_bf16_leaf_raises(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        tckpt.save_checkpoint(str(tmp_path), 1, {
            "a": torch.zeros(2), "b": torch.zeros(2, dtype=torch.bfloat16)})
    assert tckpt.latest_step(str(tmp_path)) is None


def test_port_saves_reference_restores(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    tckpt.save_checkpoint(str(ours), 3, tree_map(torch.from_numpy,
                                                 _np_tree()))
    jckpt.save_checkpoint(str(theirs), 3, jax.tree.map(jnp.asarray,
                                                       _np_tree()))
    step, leaves = _manifest(ours / "step_00000003")
    assert (step, leaves) == _manifest(theirs / "step_00000003")
    assert jckpt.latest_step(str(ours)) == 3
    like = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, _np_tree()))
    _assert_same(jckpt.restore_checkpoint(str(ours), 3, like), _np_tree())


def test_reference_saves_port_restores(tmp_path):
    jckpt.save_checkpoint(str(tmp_path), 2, jax.tree.map(jnp.asarray,
                                                         _np_tree()))
    assert tckpt.latest_step(str(tmp_path)) == 2
    like = tree_map(lambda a: torch.empty(a.shape, device="meta"),
                    _np_tree())
    _assert_same(tckpt.restore_checkpoint(str(tmp_path), 2, like),
                 _np_tree())


def _loops(tmp_path):
    cfg = REGISTRY["qwen1.5-4b"].reduced()
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=16, global_batch=2)
    port = TrainLoop(build_model(cfg), data,
                     TrainLoopConfig(out_dir=str(tmp_path / "port")),
                     device="cpu")
    jcfg = JREGISTRY["qwen1.5-4b"].reduced()
    ref = JTrainLoop(jbuild_model(jcfg), JData(vocab=cfg.vocab, seq_len=16,
                                               global_batch=2),
                     JLoopConfig(out_dir=str(tmp_path / "ref")),
                     opts=JOpts(remat="none"))
    return port, ref


def test_training_state_crosses_both_ways(tmp_path):
    """The reference's whole TrainLoop state (params, AdamW m/v/count,
    error feedback) restores into the port's ``state_like``, and the
    port's state restores into the reference's ``eval_shape``."""
    port, ref = _loops(tmp_path)
    jstate = ref.init_state(jax.random.PRNGKey(0))
    jckpt.save_checkpoint(str(tmp_path / "j"), 0, jstate)
    got = tckpt.restore_checkpoint(str(tmp_path / "j"), 0,
                                   port.state_like())
    _assert_same(got, jstate)

    tstate = port.init_state(torch.Generator().manual_seed(0))
    tckpt.save_checkpoint(str(tmp_path / "t"), 0, tstate)
    like = jax.eval_shape(lambda: ref.init_state(jax.random.PRNGKey(0)))
    back = jckpt.restore_checkpoint(str(tmp_path / "t"), 0, like)
    _assert_same(tstate, back)
