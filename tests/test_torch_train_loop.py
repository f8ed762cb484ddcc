"""The port's training loop (``repro_torch.runtime.train_loop``) against
the reference's, on reduced qwen1.5-4b in a float32 config.

``SyntheticLMData`` batches are bit-equal to the reference's.  Both loops
start from the reference's init state, which ``repro.checkpoint`` saves as
step 0 into the port's directory, where the port's ``run`` resumes from
it; then 8 steps match the reference's losses, grad norms and learning
rates (``metrics.jsonl``) and its final params.  A run crashed at step 6
resumes from its step-4 checkpoint to the uninterrupted run's state
exactly; a reference run of 4 steps resumed by the port to 8 matches the
reference's run of 8; int8 gradient compression matches the reference's;
the launcher at ``--reduced --device cpu`` prints the reference's JSON.

Tolerances: losses, grad norms and learning rates 1e-5 relative; params
after 8 steps 1e-5 relative in norm over the whole tree, and each element
within twice the sum of the learning rates.  The second is the most AdamW
can move an element whose gradient is rounding noise: the key bias's is
zero in exact arithmetic (the softmax ignores a constant added to a row),
and AdamW's early steps move it by about lr whatever its sign, so the
sign of the noise, which differs between the two packages, decides it.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import REGISTRY as JREGISTRY
from repro.data.pipeline import SyntheticLMData as JData
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import build_model as jbuild_model
from repro.runtime.fault import StragglerDetector as JStragglerDetector
from repro.runtime.train_loop import TrainLoop as JTrainLoop
from repro.runtime.train_loop import TrainLoopConfig as JLoopConfig
from repro_torch.configs import REGISTRY
from repro_torch.data.pipeline import SyntheticLMData, make_batch_iterator
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import build_model
from repro_torch.runtime.fault import (
    FailureInjector, SimulatedCrash, StragglerDetector)
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
from repro_torch.tree import leaf_paths

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-4b"
STEPS, SEQ, BATCH = 8, 32, 2
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(registry):
    return dataclasses.replace(registry[ARCH].reduced(), dtype="float32")


def _loop_cfg(out, steps, compress):
    return dict(steps=steps, ckpt_every=4, out_dir=str(out), log_every=1,
                compress_grads=compress)


def _ref_loop(out, steps=STEPS, compress=False):
    cfg = _cfg(JREGISTRY)
    return JTrainLoop(
        jbuild_model(cfg), JData(vocab=cfg.vocab, seq_len=SEQ,
                                 global_batch=BATCH),
        JLoopConfig(**_loop_cfg(out, steps, compress)),
        opts=JOpts(attn_chunk=16, ce_chunk=16, remat="none"))


def _loop(out, steps=STEPS, compress=False, fail=None, remat="none"):
    cfg = _cfg(REGISTRY)
    return TrainLoop(
        build_model(cfg), SyntheticLMData(vocab=cfg.vocab, seq_len=SEQ,
                                          global_batch=BATCH),
        TrainLoopConfig(**_loop_cfg(out, steps, compress)),
        opts=ModelOpts(attn_chunk=16, ce_chunk=16, remat=remat),
        failure=fail, device="cpu")


def _seed_from_reference(out):
    """The reference's init state (PRNGKey(0), as its ``run`` draws it),
    saved by ``repro.checkpoint`` as step 0 into ``out``'s checkpoints."""
    state = _ref_loop(out).init_state(jax.random.PRNGKey(0))
    jckpt.save_checkpoint(os.path.join(out, "ckpt"), 0, state)


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _params(state):
    return {p: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for p, v in leaf_paths(state["params"])}


def _close_params(got, want, records):
    """The whole tree within RTOL in norm; each element within twice the
    sum of the run's learning rates, the most that opposite signs of a
    gradient made of rounding noise can move it apart."""
    a, b = _params(got), _params(want)
    assert a.keys() == b.keys()
    diff = np.sqrt(sum(np.sum((a[p] - b[p]) ** 2) for p in a))
    norm = np.sqrt(sum(np.sum(b[p] ** 2) for p in a))
    assert diff / norm <= RTOL, diff / norm
    atol = 2 * sum(r["lr"] for r in records)
    for p in a:
        np.testing.assert_allclose(a[p], b[p], rtol=0, atol=atol,
                                   err_msg=str(p))


def _close_records(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=1e-12,
                                       err_msg=f"step {g['step']} {k}")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref8")
    result = _ref_loop(out).run()
    return result, _records(out)


# ---------------------------------------------------------------------------
# data and fault primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family,kw", [
    ("dense", {}), ("audio", dict(frame_dim=6)),
    ("vlm", dict(n_image_tokens=3, d_model=5))])
def test_synthetic_batches_bit_equal_reference(family, kw):
    args = dict(vocab=97, seq_len=24, global_batch=4, seed=3, family=family,
                **kw)
    ours, theirs = SyntheticLMData(**args), JData(**args)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        for host in range(2):
            sa, sb = ours.host_shard(a, host, 2), theirs.host_shard(b, host, 2)
            assert all(np.array_equal(sa[k], sb[k]) for k in sa)


def test_batch_iterator_moves_batches_to_the_device():
    data = SyntheticLMData(vocab=50, seq_len=8, global_batch=2)
    it = make_batch_iterator(data, start_step=5, device="cpu")
    for step in (5, 6):
        batch = next(it)
        want = data.batch_at(step)
        assert all(isinstance(v, torch.Tensor) for v in batch.values())
        assert all(np.array_equal(batch[k].numpy(), want[k]) for k in want)


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(0)
    ours, theirs = StragglerDetector(6), JStragglerDetector(6)
    for step in range(12):
        t = rng.uniform(1.0, 1.2, 6)
        if step >= 4:
            t[2] *= 3.0                                # a slow host
        assert ours.observe(t) == theirs.observe(t)
    assert ours.healthy_hosts() == theirs.healthy_hosts() == [0, 1, 3, 4, 5]
    assert FailureInjector((6,)).check(6) == "crash"
    assert FailureInjector((6,)).check(5) is None


# ---------------------------------------------------------------------------
# the loop against the reference
# ---------------------------------------------------------------------------
def test_train_loop_matches_reference(tmp_path, reference_run):
    ref, ref_records = reference_run
    _seed_from_reference(tmp_path)
    result = _loop(tmp_path).run()
    assert result["final_step"] == STEPS and len(result["losses"]) == STEPS
    np.testing.assert_allclose(result["losses"], ref["losses"], rtol=RTOL)
    _close_records(_records(tmp_path), ref_records)
    assert _records(tmp_path)[0]["lr"] == 0.0            # count 0: warm-up
    _close_params(result["state"], ref["state"], ref_records)
    assert result["state"]["opt"]["count"].item() == STEPS
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "step_00000000", "step_00000004", "step_00000008"]


def test_crash_and_exact_resume(tmp_path):
    """Bit-equal on the CPU: the data is a function of the step and the
    resumed state is the checkpoint's."""
    full = _loop(tmp_path / "full").run()
    crash = _loop(tmp_path / "crash", fail=FailureInjector((6,)))
    with pytest.raises(SimulatedCrash):
        crash.run()
    resumed = _loop(tmp_path / "crash").run()
    assert resumed["losses"] == full["losses"][4:]
    for (pa, a), (pb, b) in zip(leaf_paths(full["state"]),
                                leaf_paths(resumed["state"])):
        assert pa == pb and torch.equal(a, b), pa


def test_port_resumes_a_reference_run(tmp_path, reference_run):
    """The reference trains to step 4 and checkpoints; the port resumes
    in the same directory to step 8, matching the reference's run of 8."""
    ref, ref_records = reference_run
    _ref_loop(tmp_path, steps=4).run()
    result = _loop(tmp_path).run()
    np.testing.assert_allclose(result["losses"], ref["losses"][4:],
                               rtol=RTOL)
    _close_records(_records(tmp_path)[4:], ref_records[4:])
    _close_params(result["state"], ref["state"], ref_records)


def test_compressed_training_matches_reference(tmp_path):
    ref = _ref_loop(tmp_path / "ref", compress=True).run()
    _seed_from_reference(tmp_path / "port")
    result = _loop(tmp_path / "port", compress=True).run()
    np.testing.assert_allclose(result["losses"], ref["losses"], rtol=RTOL)
    records = _records(tmp_path / "ref")
    _close_records(_records(tmp_path / "port"), records)
    _close_params(result["state"], ref["state"], records)
    assert any(e.any() for _, e in leaf_paths(result["state"]["err"]))


def test_remat_leaves_the_loop_unchanged(tmp_path):
    a = _loop(tmp_path / "none", steps=2).run()
    b = _loop(tmp_path / "full", steps=2, remat="full").run()
    assert a["losses"] == b["losses"]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
        leaf_paths(a["state"]), leaf_paths(b["state"])))


def test_loop_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = _cfg(REGISTRY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoop(build_model(cfg), SyntheticLMData(vocab=cfg.vocab,
                                                    seq_len=SEQ,
                                                    global_batch=BATCH),
                  TrainLoopConfig(out_dir=str(tmp_path)))


def _launch(module, out, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", module, "--arch", ARCH, "--reduced",
         "--steps", "3", "--batch", "2", "--seq", "16", "--out", str(out),
         *extra], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)


def test_launcher_prints_the_reference_json(tmp_path):
    ours = _launch("repro_torch.launch.train", tmp_path / "port",
                   "--device", "cpu")
    theirs = _launch("repro.launch.train", tmp_path / "ref")
    assert ours.returncode == 0, ours.stderr
    assert theirs.returncode == 0, theirs.stderr
    a, b = json.loads(ours.stdout), json.loads(theirs.stdout)
    assert a.keys() == b.keys()
    assert (a["arch"], a["steps"]) == (b["arch"], b["steps"])
    assert np.isfinite([a["loss_first10"], a["loss_last10"]]).all()
    assert sorted(os.listdir(tmp_path / "port" / "ckpt")) == [
        "step_00000003"]
