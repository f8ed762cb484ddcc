"""The port's twins of the examples that import jax:
``examples/torch_train_e2e.py`` trains on the CPU, its loss falls and a
second run resumes from the first's checkpoint; ``examples/
torch_serve_batched.py``, handed the JAX example's parameters on a
float32 reduced mamba2-130m, serves the tokens the JAX example's
``BatchedServer`` serves (float32, so no bf16 near-tie flips an argmax:
exact equality).  ``examples/torch_autotune_mesh.py`` runs in
``tests/test_torch_dryrun.py``, beside the other fake-group runs."""
import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import build_model as jbuild
from repro.runtime.serve import BatchedServer as JBatchedServer
from repro.runtime.serve import Request as JRequest
from repro_torch.interop import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRAIN_ARGS = ["--device", "cpu", "--dmodel", "64", "--layers", "2",
              "--batch", "4", "--seq", "32", "--vocab", "256"]


def test_train_twin_learns_and_resumes(tmp_path):
    ex = _example("torch_train_e2e")
    out = str(tmp_path / "run")
    args = TRAIN_ARGS + ["--out", out]
    first = ex.main(args + ["--steps", "150"])
    losses = first["losses"]
    assert len(losses) == 150 and all(np.isfinite(losses))
    # the example's own verdict: the last ten steps' mean below the first
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
    assert ckpts, "no checkpoint written"
    # a second run to 160 steps resumes at 150 and trains 10 more
    second = ex.main(args + ["--steps", "160"])
    assert len(second["losses"]) == 10
    assert np.mean(second["losses"]) < np.mean(losses[:10])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps[-1] == 159 and 149 in steps


def test_train_twin_defaults_to_the_card():
    ex = _example("torch_train_e2e")
    args = ex.parse_args([])
    assert args.device == "cuda" and args.out == "runs/torch_train_e2e"


def test_serve_twin_matches_the_jax_example():
    ex = _example("torch_serve_batched")
    args = ex.parse_args(["--device", "cpu"])
    jcfg = dataclasses.replace(jget_config(args.arch).reduced(),
                               dtype="float32")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)

    # the JAX example's flow (examples/serve_batched.py:29-42)
    rng = np.random.default_rng(0)
    jreqs = [JRequest(rid=i, prompt=rng.integers(
        0, jcfg.vocab, rng.integers(3, 10)).tolist(),
        max_new_tokens=args.new_tokens) for i in range(args.requests)]
    jserver = JBatchedServer(jmodel, jparams, batch_size=args.batch,
                             max_seq=128,
                             opts=JOpts(attn_chunk=64, remat="none"))
    want = jserver.run(jreqs)

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(args.arch).reduced(),
                              dtype="float32")
    server, reqs = ex.build(args, cfg=cfg,
                            params=params_from_numpy(np_params))
    assert [r.prompt for r in reqs] == [r.prompt for r in jreqs]
    got = ex.run(server, reqs)
    assert got == want
    assert sum(len(v) for v in got.values()) == \
        args.requests * args.new_tokens


def test_serve_twin_defaults_to_the_card():
    ex = _example("torch_serve_batched")
    assert ex.parse_args([]).device == "cuda"
