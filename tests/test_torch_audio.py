"""The port's audio family (hubert-xlarge, reduced) against the JAX
reference, on the same numpy parameters and inputs: the parameter tree
with ``frame_proj``, the frame embedding (``Model._embed_in``), the
bidirectional encoder's ``forward``/``loss``, ``prefill`` (the whole
encoder pass, logits per frame, an empty cache), the refusals of
``init_cache``, ``decode_step``, the server and the serving launcher,
and the gradient of the loss.

Inputs and tolerances as in ``test_torch_hybrid``, whose helpers these
tests use.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import Model as JModel
from repro.runtime.serve import BatchedServer as JBatchedServer
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_numpy, spec_tree, tree_to_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model
from repro_torch.runtime.serve import BatchedServer

import test_torch_hybrid as th
import test_torch_model as tm
from test_torch_model import _close, _np_params

ARCH = "hubert-xlarge"
OPTS = th.OPTS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return tm._cfgs(ARCH, **kw)


@pytest.mark.parametrize("reduced", [True, False])
def test_param_spec_tree_equals_reference(reduced):
    jcfg, tcfg = jconfigs.REGISTRY[ARCH], tconfigs.REGISTRY[ARCH]
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    spec = Model(tcfg).param_spec()
    assert spec_tree(spec) == spec_tree(JModel(jcfg).param_spec())
    assert spec["frame_proj"].shape == (jcfg.frame_dim, jcfg.d_model)


def test_interop_carries_every_leaf():
    """frame_proj and the encoder stack go to torch and back unchanged."""
    jcfg, _ = _cfgs()
    params = _np_params(jcfg)
    jax.tree.map(np.testing.assert_array_equal,
                 tree_to_numpy(params_from_numpy(params)), params)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embed_in_projects_frames(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    params = _np_params(jcfg)
    batch = th._batch(jcfg)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JModel(jcfg)._embed_in(jax.tree.map(jnp.asarray, params),
                                 th._jax(batch), jdt)
    out = Model(tcfg)._embed_in(params_from_numpy(params), th._torch(batch),
                                tdt)
    assert out.dtype == tdt
    _close(out.float(), ref, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_and_loss_match_reference(dtype):
    """Bidirectional attention over 32 frames; ``use_kernel`` runs no
    kernel here."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    assert not tcfg.causal
    (hj, lj), (ht, aux, lt), counts = th._forward_pair(jcfg, tcfg, True)
    assert counts == (0, 0)
    th._hold_forward(dtype, hj, lj, ht, aux, lt)


def test_forward_is_bidirectional():
    """Changing the last frame moves the first frame's hidden state."""
    _, tcfg = _cfgs(dtype="float32")
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    batch = th._torch(th._batch(tcfg, S=8))
    h1 = model.forward(params, batch, opts=ModelOpts(**OPTS))[0]
    batch["frames"][:, -1] += 1
    h2 = model.forward(params, batch, opts=ModelOpts(**OPTS))[0]
    assert not torch.allclose(h1[:, 0], h2[:, 0])


def test_float32_grads_match_reference():
    jcfg, tcfg = _cfgs(dtype="float32")
    grads = th._grads_pair(jcfg, tcfg, remat="full")
    assert np.linalg.norm(grads[("frame_proj",)]) > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_is_the_encoder_pass(dtype):
    """Per-frame logits (B, S, V) f32 and an empty cache."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    (lj, cj), (lt, ct) = th._prefill_pair(jcfg, tcfg)
    assert cj == {} and ct == {}
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape == (
        2, 16, jcfg.vocab)
    _close(lt, lj, dtype)


def test_init_cache_and_decode_raise_as_the_reference():
    jcfg, tcfg = _cfgs()
    for model in (JModel(jcfg), Model(tcfg)):
        with pytest.raises(ValueError, match="audio has no decode cache"):
            model.init_cache(2, 16)
    params = _np_params(jcfg)
    token = np.ones((2, 1), np.int32)
    with pytest.raises(ValueError, match="audio has no decode step"):
        JModel(jcfg).decode_step(params, {"token": jnp.asarray(token),
                                          "pos": jnp.asarray(0)}, {})
    with pytest.raises(ValueError, match="audio has no decode step"):
        Model(tcfg).decode_step(params_from_numpy(params),
                                {"token": torch.from_numpy(token),
                                 "pos": 0}, {})


def test_server_fails_where_the_reference_fails():
    """No per-slot path, so the lockstep fallback, whose init_cache
    raises."""
    jcfg, tcfg = _cfgs()
    params = _np_params(jcfg)
    with pytest.raises(ValueError, match="audio has no decode cache"):
        JBatchedServer(JModel(jcfg), params, batch_size=2,
                       opts=JOpts(remat="none"))
    with pytest.raises(ValueError, match="audio has no decode cache"):
        BatchedServer(Model(tcfg), params_from_numpy(params), batch_size=2,
                      device="cpu")


def test_serve_launcher_refuses_an_encoder():
    with pytest.raises(SystemExit, match="encoder-only; no decode path"):
        th._launch(serve_launcher, "--arch", ARCH, "--reduced", "--device",
                   "cpu")


def test_train_launcher_runs_reduced_on_cpu(tmp_path):
    out = th._launch(train_launcher, "--arch", ARCH, "--reduced", "--device",
                     "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                     "--out", str(tmp_path))
    assert out["arch"] == ARCH and out["steps"] == 2
    assert np.isfinite([out["loss_first10"], out["loss_last10"]]).all()
