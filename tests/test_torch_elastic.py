"""Elastic restart of the port's training loop on real process groups:
``TrainLoop.run(shardings=ShardCtx(mesh, rules))`` with the state, each
batch and the step as DTensors over gloo ranks, checkpoints saved whole by
rank 0 and restored under another mesh's placements.

On reduced qwen1.5-4b in a float32 config (``test_torch_train_loop``'s
setting, whose helpers these tests use):

* a run on a (2, 2) ("data", "model") mesh of 4 ranks under
  ``fsdp_tp_rules``, crashed at step 6 by ``FailureInjector``, resumed by
  a group of 2 ranks on a (1, 2) mesh from its step-4 checkpoint to step
  8, ends where the port's uninterrupted run with no mesh ends: losses,
  grad norms and learning rates at 1e-5 relative, the params as
  ``_close_params`` holds them, AdamW's moments at 1e-5 relative in norm;
* the sharded run's checkpoint has the unsharded run's leaves, and the
  reference's ``restore_checkpoint`` reads it;
* a reference run's step-4 checkpoint, resumed by the port on the (2, 2)
  mesh, matches the reference's run of 8;
* a tree the reference saved is restored under ``Shard(0)`` and under no
  placements (``tests/test_resilience.py``'s elastic restore);
* ``make_mesh`` over a real group of another size raises, and int8
  gradient compression of a sharded leaf scales by the whole leaf's max.

The workers are gloo processes, 4 and then 2, started by one
module-scoped fixture.  Sharded and unsharded runs differ in the order of
their sums (each reduce-scatter and all-reduce), not in what they compute.
"""
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_torch_train_loop as tl
from repro import checkpoint as jckpt
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import REGISTRY
from repro_torch.data.pipeline import (
    SyntheticLMData, make_batch_iterator, place_batch)
from repro_torch.distrib.logical import _local_plan, abstract_params, place
from repro_torch.models.model import build_model
from repro_torch.tree import leaf_paths

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CRASH_AT = 6

WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import REGISTRY
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.distrib.logical import ShardCtx, fsdp_tp_rules, place
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models.blocks import ModelOpts
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import global_norm
    from repro_torch.optim.compress import compress_grads
    from repro_torch.runtime.fault import FailureInjector, SimulatedCrash
    from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
    from repro_torch.tree import leaves, tree_map

    torch.set_num_threads(1)
    rank, world, port = map(int, sys.argv[1:4])
    job = json.loads(sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    res = {}

    def loop(out, fail=None):
        # test_torch_train_loop._loop's loop, from the job's settings
        cfg = dataclasses.replace(REGISTRY[job["arch"]].reduced(),
                                  dtype="float32")
        return TrainLoop(
            build_model(cfg), SyntheticLMData(**job["data"]),
            TrainLoopConfig(out_dir=out, **job["loop"]),
            opts=ModelOpts(**job["opts"]), failure=fail, device="cpu")

    def placed_as_wanted(loop, state, ctx):
        return all(leaves(tree_map(
            lambda x, pl: isinstance(x, DTensor) and x.device_mesh is ctx.mesh
            and tuple(x.placements) == pl, state,
            loop.state_shardings(ctx))))

    if world == 4:
        ctx = ShardCtx(make_mesh(2, 2), fsdp_tp_rules(False))
        loop = loop(job["elastic"], fail=FailureInjector((job["crash"],)))
        try:
            loop.run(shardings=ctx)
            res["crashed"] = False
        except SimulatedCrash:
            res["crashed"] = True
        loop = loop.__class__(loop.model, loop.data, TrainLoopConfig(
            out_dir=job["ref"], **job["loop"]), opts=loop.opts, device="cpu")
        out = loop.run(shardings=ctx)
        res["ref_losses"] = out["losses"]
        res["ref_placed"] = placed_as_wanted(loop, out["state"], ctx)
    else:
        try:
            make_mesh(2, 2)
            res["wrong_size"] = None
        except ValueError as e:
            res["wrong_size"] = str(e)
        try:
            make_production_mesh()
            res["production"] = None
        except RuntimeError as e:
            res["production"] = str(e)
        ctx = ShardCtx(make_mesh(1, 2), fsdp_tp_rules(False))
        loop = loop(job["elastic"])
        out = loop.run(shardings=ctx)
        res["elastic_losses"] = out["losses"]
        res["elastic_placed"] = placed_as_wanted(loop, out["state"], ctx)

        # the reference's saved tree, one leaf split over 2 ranks, one whole
        mesh = make_mesh(2, 1)
        like = {"w": torch.empty(4, 4, device="meta"),
                "b": torch.empty(3, device="meta")}
        back = restore_checkpoint(job["tree"], 1, like, shardings={
            "w": (Shard(0), Replicate()), "b": None}, mesh=mesh)
        w = torch.arange(16, dtype=torch.float32).reshape(4, 4)
        res["tree_w_placed"] = (isinstance(back["w"], DTensor) and tuple(
            back["w"].placements) == (Shard(0), Replicate()))
        res["tree_w_local"] = torch.equal(back["w"].to_local(),
                                          w[2 * rank:2 * rank + 2])
        res["tree_w_full"] = torch.equal(back["w"].full_tensor(), w)
        res["tree_b_whole"] = (not isinstance(back["b"], DTensor)
                               and torch.equal(back["b"],
                                               torch.tensor([1., 2., 3.])))

        # int8 compression and the global norm of a sharded leaf
        g = torch.randn(8, 6, generator=torch.Generator().manual_seed(0))
        g[7, 5] = 10.0                     # the leaf's max, on rank 1
        e = torch.randn(8, 6, generator=torch.Generator().manual_seed(1))
        sh = (Shard(0), Replicate())
        with implicit_replication():
            deq, err = compress_grads({"w": place(g, sh, mesh)},
                                      {"w": place(e * 0.01, sh, mesh)})
            norm = global_norm({"w": place(g, sh, mesh)}).full_tensor()
        pdeq, perr = compress_grads({"w": g}, {"w": e * 0.01})
        res["compress_exact"] = (torch.equal(deq["w"].full_tensor(),
                                             pdeq["w"])
                                 and torch.equal(err["w"].full_tensor(),
                                                 perr["w"]))
        res["norm"] = [float(norm), float(global_norm({"w": g}))]
    print(json.dumps(res))
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group(script, world, job):
    """Every rank's JSON, from ``world`` gloo processes of ``script``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), port,
         json.dumps(job)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run of 8 and the port's with no mesh, in this
    process; then 4 gloo ranks (the crashed elastic run, the reference's
    step 4 resumed) and 2 (the elastic resume, the restores and the
    checks of the group)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("elastic")
    try:
        ref = tl._ref_loop(base / "ref8").run()
        plain = tl._loop(base / "plain").run()
    finally:
        torch.set_num_threads(n)
    # the reference's step-4 checkpoint alone, for the port to resume
    shutil.copytree(base / "ref8" / "ckpt" / "step_00000004",
                    base / "ref4" / "ckpt" / "step_00000004")
    tree = {"w": jax.numpy.arange(16, dtype=jax.numpy.float32).reshape(4, 4),
            "b": jax.numpy.array([1.0, 2.0, 3.0])}
    jckpt.save_checkpoint(str(base / "tree"), 1, tree)

    script = base / "worker.py"
    script.write_text(WORKER)
    loop = tl._loop(base / "plain")
    settings = dataclasses.asdict(loop.cfg)
    del settings["out_dir"]
    job = {"elastic": str(base / "elastic"), "ref": str(base / "ref4"),
           "tree": str(base / "tree"), "crash": CRASH_AT, "arch": tl.ARCH,
           "data": dataclasses.asdict(loop.data), "loop": settings,
           "opts": dataclasses.asdict(loop.opts)}
    four = _group(script, 4, job)
    two = _group(script, 2, job)
    return dict(base=base, ref=ref, plain=plain, four=four, two=two)


def _state(out_dir, step):
    """A checkpoint's state as plain tensors, through the port's restore."""
    loop = tl._loop(out_dir)
    return restore_checkpoint(os.path.join(out_dir, "ckpt"), step,
                              loop.state_like())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.sum((a - b) ** 2)) / np.sqrt(np.sum(b ** 2))


def _tree_rel(got, want):
    """||got - want|| / ||want|| over every leaf of two trees."""
    a = {p: x.detach().double().numpy() for p, x in leaf_paths(got)}
    b = {p: x.detach().double().numpy() for p, x in leaf_paths(want)}
    assert a.keys() == b.keys()
    return _rel(np.concatenate([a[p].ravel() for p in a]),
                np.concatenate([b[p].ravel() for p in a]))


# ---------------------------------------------------------------------------
# (a) 4 ranks on (2, 2), crashed, resumed by 2 ranks on (1, 2)
# ---------------------------------------------------------------------------
def test_elastic_run_matches_the_unsharded_run(runs):
    plain, base = runs["plain"], runs["base"]
    assert all(r["crashed"] for r in runs["four"])
    losses = [r["elastic_losses"] for r in runs["two"]]
    assert losses[0] == losses[1]                   # every rank's the same
    assert len(losses[0]) == tl.STEPS - 4
    np.testing.assert_allclose(losses[0], plain["losses"][4:], rtol=tl.RTOL)
    # rank 0 alone logged: steps 0-5 of the crashed run, 4-7 of the resume
    records = tl._records(base / "elastic")
    want = tl._records(base / "plain")
    assert [r["step"] for r in records] == list(range(CRASH_AT)) + [4, 5, 6, 7]
    tl._close_records(records[:CRASH_AT], want[:CRASH_AT])
    tl._close_records(records[CRASH_AT:], want[4:])

    state = _state(base / "elastic", tl.STEPS)
    tl._close_params(state, plain["state"], want)
    for k in ("m", "v"):
        rel = _tree_rel(state["opt"][k], plain["state"]["opt"][k])
        assert rel <= tl.RTOL, (k, rel)
    assert state["opt"]["count"].item() == tl.STEPS
    assert not any(e.any() for _, e in leaf_paths(state["err"]))


def test_elastic_state_lies_under_the_meshs_placements(runs):
    assert all(r["elastic_placed"] for r in runs["two"])
    assert all(r["ref_placed"] for r in runs["four"])


# ---------------------------------------------------------------------------
# (b) the sharded run's checkpoint is the unsharded run's format
# ---------------------------------------------------------------------------
def _manifest(out_dir, step):
    with open(os.path.join(out_dir, "ckpt", f"step_{step:08d}",
                           "manifest.json")) as f:
        return sorted((m["name"], tuple(m["shape"]), m["dtype"])
                      for m in json.load(f)["leaves"])


def test_sharded_checkpoint_has_the_unsharded_format(runs):
    base = runs["base"]
    assert sorted(os.listdir(base / "elastic" / "ckpt")) == [
        "step_00000004", "step_00000008"]
    assert _manifest(base / "elastic", 4) == _manifest(base / "plain", 4)


def test_reference_restores_the_sharded_checkpoint(runs):
    base = runs["base"]
    like = jax.eval_shape(lambda: tl._ref_loop(base / "like").init_state(
        jax.random.PRNGKey(0)))
    got = _to_torch(jckpt.restore_checkpoint(
        str(base / "elastic" / "ckpt"), 4, like))
    want = _state(base / "plain", 4)
    assert [(p, x.shape, x.dtype) for p, x in leaf_paths(got)] == \
        [(p, x.shape, x.dtype) for p, x in leaf_paths(want)]
    assert _tree_rel(got["params"], want["params"]) <= tl.RTOL


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------------------
# (c) the reference's run resumed on the (2, 2) mesh
# ---------------------------------------------------------------------------
def test_sharded_port_resumes_a_reference_run(runs):
    ref, base = runs["ref"], runs["base"]
    ref_records = tl._records(base / "ref8")
    losses = [r["ref_losses"] for r in runs["four"]]
    assert all(x == losses[0] for x in losses)
    np.testing.assert_allclose(losses[0], ref["losses"][4:], rtol=tl.RTOL)
    tl._close_records(tl._records(base / "ref4"), ref_records[4:])
    tl._close_params(_state(base / "ref4", tl.STEPS), ref["state"],
                     ref_records)


# ---------------------------------------------------------------------------
# (d) a reference tree restored under placements; (e) the group's checks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("check", ["tree_w_placed", "tree_w_local",
                                   "tree_w_full", "tree_b_whole"])
def test_restore_places_a_reference_tree(runs, check):
    assert all(r[check] for r in runs["two"])


def test_make_mesh_refuses_a_group_of_another_size(runs):
    for r in runs["two"]:
        assert "needs 4 ranks" in r["wrong_size"]
        assert "has 2" in r["wrong_size"]
        assert "process group exists" in r["production"]


def test_compression_scales_by_the_whole_leaf(runs):
    """Bit for bit the plain leaf's: the scale is the max over every
    shard; the global norm sums every shard."""
    for r in runs["two"]:
        assert r["compress_exact"]
        np.testing.assert_allclose(*r["norm"], rtol=1e-6)


# ---------------------------------------------------------------------------
# with no mesh (in this process)
# ---------------------------------------------------------------------------
def test_model_abstract_params():
    model = build_model(tl._cfg(REGISTRY))
    got = model.abstract_params()
    want = abstract_params(model.param_spec())
    assert [(p, x.shape, x.dtype, x.device.type) for p, x in leaf_paths(got)] \
        == [(p, x.shape, x.dtype, "meta") for p, x in leaf_paths(want)]
    assert all(x.dtype == torch.bfloat16 for _, x in leaf_paths(
        model.abstract_params(torch.bfloat16)))


def test_placements_need_a_mesh(tmp_path):
    from repro_torch.checkpoint import save_checkpoint
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2, 2)})
    like = {"w": torch.empty(2, 2, device="meta")}
    with pytest.raises(ValueError, match="need the mesh"):
        restore_checkpoint(str(tmp_path), 1, like, shardings={"w": None})
    batch = {"tokens": np.zeros((2, 3), np.int32)}
    with pytest.raises(ValueError, match="need the mesh"):
        place_batch(batch, "cpu", {"tokens": None})
    x = torch.ones(3)
    assert place(x, None, None) is x


def test_batches_without_placements_are_plain():
    data = SyntheticLMData(vocab=50, seq_len=8, global_batch=2)
    a = next(make_batch_iterator(data, 3, "cpu"))
    b = next(make_batch_iterator(data, 3, "cpu", shardings={}, mesh=object()))
    want = data.batch_at(3)
    for k in want:
        assert type(a[k]) is torch.Tensor and type(b[k]) is torch.Tensor
        assert np.array_equal(a[k].numpy(), want[k])
        assert np.array_equal(b[k].numpy(), want[k])


class _Mesh:
    """What ``_local_plan`` reads of a mesh: its dims and their sizes."""
    ndim = 2

    def __init__(self, *sizes):
        self.sizes = sizes

    def size(self, axis):
        return self.sizes[axis]


def _placed(names):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Replicate() if n == "R" else Partial() if n == "P"
                 else Shard(int(n[1:])) for n in names)


@pytest.mark.parametrize("sizes,pls,out,grads", [
    # torch 2.11 on (1, 1): probabilities whole, values split over batch
    # and heads; every product is local, each gradient placed as its
    # operand
    ((1, 1), [("R", "R"), ("S0", "S2")], ("R", "R"),
     [("R", "R"), ("S0", "S2")]),
    # one axis of one rank beside a split one: that axis whole, the other
    # split as the letter it splits
    ((1, 2), [("R", "S1"), ("S0", "S2")], ("R", "S2"),
     [("R", "S1"), ("S0", "S2")]),
    # a pending sum on an axis of one rank is the whole sum
    ((1, 2), [("P", "S1"), ("S0", "S2")], ("R", "S2"),
     [("R", "S1"), ("S0", "S2")]),
])
def test_local_plan_on_axes_of_one_rank(sizes, pls, out, grads):
    plan = _local_plan("bkgqs,bskd->bqkgd",
                       [((2, 4, 1, 16, 32), _placed(pls[0])),
                        ((2, 32, 4, 16), _placed(pls[1]))], _Mesh(*sizes))
    assert plan == (_placed(out), tuple(_placed(g) for g in grads))


def test_local_plan_unchanged_on_axes_of_more_ranks():
    """On (2, 2) the whole probabilities beside split values are no local
    product, as before."""
    assert _local_plan("bkgqs,bskd->bqkgd",
                       [((2, 4, 1, 16, 32), _placed(("R", "R"))),
                        ((2, 32, 4, 16), _placed(("S0", "S2")))],
                       _Mesh(2, 2)) is None
