"""The port's dry-run (``repro_torch.launch.{mesh,steps,dryrun}``,
``repro_torch.analysis.roofline``, ``repro_torch.tuner``) on the fake
process group.  The group is process-wide, so every run that makes a
mesh is a subprocess of its own, as the reference's mini dry-run is
(``tests/test_distribution.py``); one subprocess serves this module's
checks:

* the reduced qwen1.5-4b train cell (seq 128, batch 8) traces on a
  (4, 2) mesh under every strategy of its sharding domain;
* on a 1 x 1 mesh the per-chip FLOPs equal a ``FlopCounterMode`` count of
  the plain step (exactly: the same products of the same shapes), and
  ``fsdp_dp`` on (4, 2), which splits all of that work over the batch,
  gives exactly 1/8 of them;
* hand-counted collectives: a (8, 16) f32 tensor split over 4 ranks and
  gathered moves 8 * 16 * 4 = 512 bytes per chip; moved from rows to
  columns it is the same all-gather on a CPU mesh (then a chunk);
* ``compile_cost`` evaluates through the engine and ``eval_dryrun`` reads
  the JSON of ``python -m repro_torch.launch.dryrun``;
* the group is made on the first mesh request, and the process that
  made it is refused CUDA.

``examples/torch_autotune_mesh.py`` runs at a small budget in a second
subprocess."""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
STRATEGIES = ("fsdp_tp", "fsdp_tp_nosp", "fsdp_dp", "ddp_tp")

SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis.roofline import (
        roofline_from_trace, trace_plan)
    from repro_torch.configs import REGISTRY, get_shape
    from repro_torch.core.objectives import bind_objective, eval_dryrun
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.distrib.logical import NOSHARD
    from repro_torch.exp import experiment_engine
    from repro_torch.launch.mesh import (
        fake_group_active, make_mesh, mesh_chip_count)
    from repro_torch.launch.steps import (
        LoweringPlan, build_plan, make_train_step)
    from repro_torch.models.blocks import ModelOpts
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.tuner.strategies import sharding_domain

    out_dir = sys.argv[1]
    full = REGISTRY["qwen1.5-4b"]
    cfg = full.reduced()
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=128,
                                global_batch=8)
    opts = ModelOpts(attn_chunk=64, ce_chunk=64)
    res = {"group_before": fake_group_active()}

    mesh = make_mesh(4, 2)
    res["chips"] = mesh_chip_count(mesh)
    res["domain"] = list(sharding_domain(full, get_shape("train_4k"))
                         .provider_names)
    res["cells"] = {}
    for strategy in res["domain"]:
        plan = build_plan(cfg, shape, mesh, strategy=strategy, opts=opts)
        r = roofline_from_trace(plan, cfg=cfg, shape=shape,
                                mesh_name="test", chips=8)
        res["cells"][strategy] = r.to_dict()

    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMData(cfg.vocab, 128, 8).batch_at(0).items()}
    with FlopCounterMode(display=False) as fc:
        make_train_step(model, NOSHARD, opts)(params, adamw_init(params),
                                              batch)
    res["plain_flops"] = fc.get_total_flops()
    res["one_chip_flops"] = trace_plan(build_plan(
        cfg, shape, make_mesh(1, 1), strategy="fsdp_tp", opts=opts)).flops

    x = torch.empty((8, 16), device="meta")
    spec = (Shard(0), Replicate())
    gather = trace_plan(LoweringPlan(
        lambda t: t.redistribute(mesh, (Replicate(), Replicate())),
        (x,), (spec,), mesh))
    a2a = trace_plan(LoweringPlan(
        lambda t: t.redistribute(mesh, (Shard(1), Replicate())),
        (x,), (spec,), mesh))
    res["gather"] = [gather.coll, gather.arg_bytes, gather.peak_bytes]
    res["a2a"] = [a2a.coll, a2a.arg_bytes, a2a.peak_bytes]

    binding = bind_objective("compile_cost", arch="mamba2-130m",
                             shape="long_500k")
    with experiment_engine(binding) as engine:
        res["engine"] = engine.run([binding.unit("fsdp_tp", {})])[0]
    res["dryrun"] = eval_dryrun(
        {"arch": "mamba2-130m", "shape": "long_500k", "mesh": "pod",
         "provider": "tp_serve", "config": {}},
        {"out_dir": out_dir, "src_path": sys.argv[2]})
    res["group_after"] = fake_group_active()
    from repro_torch.device import resolve_device
    try:
        resolve_device("cuda")
    except RuntimeError as exc:
        res["cuda_refused"] = str(exc)
    print(json.dumps(res))
""")


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    proc = _run(["-c", SCRIPT, str(out), str(SRC)], timeout=900)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_group_is_made_on_demand(run):
    assert run["group_before"] is False and run["group_after"] is True
    assert run["chips"] == 8
    # a process that made a mesh is refused the card
    assert "fake process group" in run["cuda_refused"]


def test_domain_is_the_four_train_strategies(run):
    assert tuple(run["domain"]) == STRATEGIES


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_reduced_cell_traces_under_every_strategy(run, strategy):
    r = run["cells"][strategy]
    assert r["chips"] == 8 and r["mesh"] == "test"
    assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0
    # each chip holds a shard of the masters and AdamW state
    assert 0 < r["peak_memory_per_chip"] == r["peak_memory_adjusted"]
    # every strategy moves data between chips: at least FSDP's or DDP's
    # gradient traffic
    assert r["coll_bytes_per_chip"] > 0
    assert r["coll_bytes_per_chip"] == sum(r["coll_breakdown"].values())
    assert set(r["coll_breakdown"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert r["t_step"] == max(r["t_compute"], r["t_memory"],
                              r["t_collective"])
    assert r["bottleneck"] in ("compute", "memory", "collective")


def test_one_chip_flops_equal_the_plain_step(run):
    assert run["plain_flops"] > 0
    assert run["one_chip_flops"] == run["plain_flops"]


def test_fsdp_dp_splits_the_flops_eight_ways(run):
    assert run["cells"]["fsdp_dp"]["flops_per_chip"] * 8 == \
        run["plain_flops"]
    # model parallelism splits no more than data parallelism does
    assert run["cells"]["fsdp_tp"]["flops_per_chip"] >= \
        run["cells"]["fsdp_dp"]["flops_per_chip"]


def test_hand_counted_collectives(run):
    coll, arg, peak = run["gather"]
    assert coll["all-gather"] == 8 * 16 * 4
    assert sum(coll.values()) == coll["all-gather"]
    assert arg == 2 * 16 * 4                 # rank 0's shard
    assert peak == arg + 8 * 16 * 4          # shard + the gathered copy
    # rows to columns: on a CPU mesh DTensor gathers the whole tensor and
    # keeps its chunk (NCCL would run one all-to-all), and the trace
    # counts the all-gather it runs
    coll, arg, peak = run["a2a"]
    assert coll["all-gather"] == 8 * 16 * 4
    assert sum(coll.values()) == coll["all-gather"]
    assert arg == 2 * 16 * 4


def test_compile_cost_and_dryrun_objectives(run):
    engine = run["engine"]
    assert engine["value"] == engine["report"]["t_step"] > 0
    assert engine["report"]["chips"] == 256
    rep = run["dryrun"]["report"]
    assert run["dryrun"]["value"] == rep["t_step"] > 0
    for key in ("arch", "shape", "mesh", "chips", "flops_per_chip",
                "bytes_per_chip", "coll_bytes_per_chip", "coll_breakdown",
                "peak_memory_per_chip", "peak_memory_adjusted",
                "model_flops", "t_compute", "t_memory", "t_collective",
                "bottleneck", "t_step", "useful_flops_fraction",
                "roofline_fraction", "strategy", "lower_s", "compile_s",
                "n_params", "n_active_params"):
        assert key in rep, key
    assert rep["strategy"] == "tp_serve" and rep["compile_s"] == 0.0
    assert rep["lower_s"] > 0


def test_autotune_twin_completes_at_a_small_budget():
    proc = _run([str(ROOT / "examples" / "torch_autotune_mesh.py"),
                 "--budget", "3", "--driver", "random"], timeout=600)
    assert "best strategy:" in proc.stdout
    assert "(3 traces spent)" in proc.stdout


def test_sweep_twin_differs_only_in_the_import_root_and_paths():
    """``scripts/torch_run_dryrun_sweep.py`` is the reference's sweep with
    ``repro.`` read as ``repro_torch.`` and its own result and store
    paths (a store shared with the reference would replay its cells)."""
    body = re.compile(r'^#![^\n]*\n"""[\s\S]*?"""\n')
    port = (ROOT / "scripts" / "torch_run_dryrun_sweep.py").read_text()
    ref = (ROOT / "scripts" / "run_dryrun_sweep.py").read_text()
    assert "repro." not in port.replace("repro_torch.", "")
    port = body.sub("", port).replace("repro_torch.", "repro.")
    port = port.replace('"torch_dryrun"', '"dryrun"').replace(
        '"torch_dryrun.jsonl"', '"dryrun.jsonl"')
    assert port == body.sub("", ref)
