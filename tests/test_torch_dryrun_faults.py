"""Which dry-run cells DTensor can trace, and where the rest stop.

Every arch's reduced config, at each shape the registry runs it at (seq
128, batch 8, or the shape's own batch where it is smaller), is traced
on a (4, 2) mesh of the fake process group under every strategy of its
sharding domain.  A cell either traces, with a finite roofline, or fails
loudly: DTensor raises with the operation it cannot place named, and
nothing catches or replicates around it in the port.  ``FAULTS`` is the
list of cells that fail on the torch these tests run on (2.13), with
the operation each names (none do); ``ROADMAP.md`` (Queue 3) holds the
same list, and a cell that starts or stops failing fails here.  The
meshes live in three subprocesses, each with a fake process group of
its own.

While a cell traces, a dispatch mode on the stack (``Folds``) sees each
operation on DTensors before DTensor places it and records every view
that flattens a split dim into the dim before it: the view torch 2.11's
DTensor refuses ("Attempted to flatten multiple dimensions, with
dimension ... being sharded").  ``FOLDS`` lists the cells that still
make one, and a cell that starts or stops folding fails here, so 2.11's
commonest stop is held on the torch these tests run on.

Run as a script, it lists every cell on the torch it runs on, one line
each: the trace's counts (FLOPs, bytes, collective bytes by kind, peak
per chip), its folds and its seconds, or the operation that stops it;
two trees' listings can be diffed.  ``PYTHONPATH`` is kept for the
subprocesses, behind ``src``, so a directory laid over torch's own
(another release's ``torch/distributed``) reaches them too:

    PYTHONPATH=src python tests/test_torch_dryrun_faults.py [processes]
"""
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch.configs import REGISTRY, get_shape, shapes_for
from repro_torch.tuner.strategies import sharding_domain

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SEQ, BATCH = 128, 8
PROCESSES = 3

#: (arch, shape) -> the operation DTensor cannot place, at every strategy
#: of the cell's domain.  Empty on 2.13: every cell traces since the MoE
#: dispatch's segment starts come from slot counts (``moe._segments``)
#: and the one-token cache write on a sharded cache is a masked select
#: (``ShardCtx.write_rows``); the torch before it stops on more
#: (ROADMAP.md, Queue 3)
FAULTS = {}

#: (arch, shape, strategy) of the cells whose trace still folds a split
#: dim into the one before it in a view (the op the ``Folds`` guard
#: records, which torch 2.11's DTensor refuses), each with that op.
#: ``ShardCtx.einsum`` and ``ShardCtx.matmul`` take every other product
#: on the local shards.  In these, 2.13's DTensor leaves the query a
#: pending sum (it gathers the projection's weight rather than settle its
#: input's sum), and a pending sum against a head-split key is no local
#: product, so the scores' einsum is DTensor's, which folds batch and
#: heads; 2.11 settles that sum in the projection and takes the local
#: product, and these cells trace there (ROADMAP.md, Queue 3)
FOLDS = dict.fromkeys((
    ("gemma-7b", "decode_32k", "fsdp_tp"),
    ("gemma-7b", "decode_32k", "fsdp_tp_nosp"),
    ("gemma-7b", "decode_32k", "tp_serve"),
    ("gemma3-27b", "decode_32k", "fsdp_tp"),
    ("gemma3-27b", "decode_32k", "fsdp_tp_nosp"),
    ("gemma3-27b", "decode_32k", "tp_serve"),
    ("llama-3.2-vision-90b", "train_4k", "fsdp_tp_nosp"),
    ("llama-3.2-vision-90b", "prefill_32k", "fsdp_tp_nosp"),
    ("llama-3.2-vision-90b", "prefill_32k", "tp_serve"),
    ("llama-3.2-vision-90b", "decode_32k", "fsdp_tp"),
    ("llama-3.2-vision-90b", "decode_32k", "fsdp_tp_nosp"),
    ("llama-3.2-vision-90b", "decode_32k", "tp_serve"),
    ("minitron-8b", "decode_32k", "fsdp_tp"),
    ("minitron-8b", "decode_32k", "fsdp_tp_nosp"),
    ("minitron-8b", "decode_32k", "tp_serve"),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "fsdp_tp"),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "fsdp_tp_nosp"),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "tp_serve"),
), "aten._unsafe_view.default")


def _cells():
    out = []
    for arch in sorted(REGISTRY):
        cfg = REGISTRY[arch]
        for shape, reason in shapes_for(cfg):
            if shape.name not in SHAPES or reason is not None:
                continue
            for strategy in sharding_domain(cfg, shape).provider_names:
                out.append((arch, shape.name, strategy))
    return out


CELLS = _cells()

SCRIPT = """
import dataclasses, json, math, sys, time
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._ops._view_ops import Flatten, view_groups
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.analysis.roofline import roofline_from_trace
from repro_torch.configs import REGISTRY, get_shape
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_plan
from repro_torch.models.blocks import ModelOpts

VIEWS = {"view", "_unsafe_view", "reshape"}


def _flattens(cmd):
    if isinstance(cmd, Flatten):
        yield cmd
    for inp in cmd.inputs():
        yield from _flattens(inp)


class Folds(TorchDispatchMode):
    # on the stack while a cell traces, so it sees each DTensor-level op
    # before DTensor does: a view that flattens input dims (i, j, ...)
    # with a dim after i sharded is the fold torch 2.11 refuses
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        x = args[0] if args else None
        if (func._overloadpacket.__name__ in VIEWS
                and isinstance(x, DTensor)):
            # recorded before DTensor places the view, which 2.11 refuses
            shape = torch.empty(x.shape, device="meta").reshape(
                args[1]).shape
            split = {getattr(pl, "dim", None) for pl in x.placements}
            for flat in (f for cmd in view_groups(x.shape, shape)
                         for f in _flattens(cmd)):
                if any(d.input_dim in split for d in flat.input_dims[1:]):
                    self.seen.add(f"{func} {tuple(x.shape)} -> "
                                  f"{tuple(shape)} {x.placements}")
        return func(*args, **(kwargs or {}))


seq, batch = int(sys.argv[2]), int(sys.argv[3])
mesh = make_mesh(4, 2)
opts = ModelOpts(attn_chunk=64, ce_chunk=64)
res = {}
for arch, shape_name, strategy in json.loads(sys.argv[1]):
    full = get_shape(shape_name)
    shape = dataclasses.replace(full, seq_len=seq,
                                global_batch=min(full.global_batch, batch))
    cfg = REGISTRY[arch].reduced()
    key = f"{arch}|{shape_name}|{strategy}"
    folds = Folds()
    t0 = time.time()
    try:
        plan = build_plan(cfg, shape, mesh, strategy=strategy, opts=opts)
        with folds:
            r = roofline_from_trace(plan, cfg=cfg, shape=shape,
                                    mesh_name="reduced", chips=8)
    except Exception as exc:        # recorded: the test names the op
        res[key] = {"error": type(exc).__name__ + ": "
                    + " ".join(str(exc).split()),
                    "folds": sorted(folds.seen)}
        continue
    res[key] = {"t_step": r.t_step, "flops": r.flops_per_chip,
                "bytes": r.bytes_per_chip, "coll": r.coll_breakdown,
                "peak": r.peak_memory_per_chip, "trace_s": time.time() - t0,
                "folds": sorted(folds.seen)}
print(json.dumps(res))
"""


#: production cells at full width with their depth cut, on the (16, 16)
#: mesh, each with the folds its trace still records on 2.13: the MoE
#: grouping of a sequence-split input, (B, S, D) -> (G, Tg, D), reaches a
#: fold only there (a reduced cell's groups hold whole rows), and
#: ``ShardCtx.fold_groups`` gathers the sequence first, as DTensor places
#: the view.  What remains is the router product's backward, whose
#: gradient 2.13 leaves split along the group's tokens (2.11 traces the
#: cell: ROADMAP.md, Queue 3)
DEPTH_CELLS = {("phi3.5-moe-42b-a6.6b", "train_4k", "fsdp_tp", 2): (
    "aten.view.default (32, 32768, 16) -> (1048576, 16)",)}

DEPTH_SCRIPT = SCRIPT.split("seq, batch = ")[0] + """
from repro_torch.launch.mesh import make_production_mesh, mesh_chip_count
mesh = make_production_mesh(multi_pod=False)
res = {}
for arch, shape_name, strategy, layers in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(REGISTRY[arch], n_layers=layers)
    shape = get_shape(shape_name)
    plan = build_plan(cfg, shape, mesh, strategy=strategy)
    folds = Folds()
    t0 = time.time()
    with folds:
        r = roofline_from_trace(plan, cfg=cfg, shape=shape, mesh_name="pod",
                                chips=mesh_chip_count(mesh))
    res[f"{arch}|{shape_name}|{strategy}|{layers}"] = {
        "t_step": r.t_step, "flops": r.flops_per_chip,
        "trace_s": time.time() - t0, "folds": sorted(folds.seen)}
print(json.dumps(res))
"""


def trace_cells(processes: int = PROCESSES) -> dict:
    """Every cell of ``CELLS``, traced in ``processes`` subprocesses at
    once -> {"arch|shape|strategy": the roofline's numbers or the error}."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), *filter(None, [os.environ.get("PYTHONPATH")])]))
    archs = sorted({c[0] for c in CELLS})
    procs = []
    for i in range(processes):
        mine = [c for c in CELLS if archs.index(c[0]) % processes == i]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SCRIPT, json.dumps(mine), str(SEQ),
             str(BATCH)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=ROOT))
    res = {}
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-4000:]
            res.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return res


@pytest.fixture(scope="module")
def traced():
    return trace_cells()


def test_every_cell_is_listed():
    # the four shapes of every arch that runs them, each strategy of its
    # domain; the faults name cells that exist
    assert len(CELLS) == len(set(CELLS)) > 0
    assert {c[:2] for c in CELLS} >= set(FAULTS)
    assert set(CELLS) >= set(FOLDS)
    assert all(get_shape(s).name == s for s in SHAPES)


@pytest.mark.parametrize("cell", CELLS, ids="|".join)
def test_reduced_cell_traces_or_names_its_fault(traced, cell):
    r = traced["|".join(cell)]
    op = FAULTS.get(cell[:2])
    if op is None:
        assert "error" not in r, r.get("error")
        assert math.isfinite(r["t_step"]) and r["t_step"] > 0
        assert r["flops"] > 0 and r["peak"] > 0
    else:
        assert "error" in r, f"{cell} traces: take it out of FAULTS"
        assert op in r["error"], r["error"]


@pytest.mark.parametrize("cell", sorted(DEPTH_CELLS),
                         ids=lambda c: "|".join(map(str, c)))
def test_depth_cut_cell_folds_no_split_dim(cell):
    """A production cell at full width and cut depth traces, finite, and
    folds no split dim into the one before it but those listed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), *filter(None, [os.environ.get("PYTHONPATH")])]))
    proc = subprocess.run(
        [sys.executable, "-c", DEPTH_SCRIPT, json.dumps([cell])],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])[
        "|".join(map(str, cell))]
    assert math.isfinite(r["t_step"]) and r["t_step"] > 0 and r["flops"] > 0
    assert all(f.startswith(DEPTH_CELLS[cell]) for f in r["folds"]), \
        r["folds"]


@pytest.mark.parametrize("cell", CELLS, ids="|".join)
def test_reduced_cell_folds_no_split_dim(traced, cell):
    """The trace's views on DTensors, as the ``Folds`` mode saw them: none
    flattens a split dim into the one before it, but in ``FOLDS``."""
    folds = traced["|".join(cell)]["folds"]
    op = FOLDS.get(cell)
    if op is None:
        assert not folds, folds
    else:
        assert folds, f"{cell} folds no split dim: take it out of FOLDS"
        assert all(f.startswith(op) for f in folds), folds


if __name__ == "__main__":
    import torch
    t0 = time.time()
    res = trace_cells(int(sys.argv[1]) if len(sys.argv) > 1 else PROCESSES)
    print(f"torch {torch.__version__}: {len(CELLS)} cells", flush=True)
    for cell in CELLS:
        r = res["|".join(cell)]
        folds = f"folds {len(r['folds'])}"
        if "error" in r:
            ops = sorted(set(re.findall(
                r"aten\.[A-Za-z_0-9]+\.[A-Za-z_0-9]+", r["error"])))
            print("FAIL", *cell, folds, " ".join(ops) or "-",
                  r["error"][-240:])
        else:
            coll = " ".join(f"{k} {v}" for k, v in sorted(r["coll"].items()))
            print("OK", *cell, folds, f"flops {r['flops']!r}",
                  f"bytes {r['bytes']!r}", coll, f"peak {r['peak']!r}",
                  f"t_step {r['t_step']!r}", f"trace {r['trace_s']:.2f} s")
    print(f"{sum('error' not in r for r in res.values())} of {len(CELLS)} "
          f"trace, {sum(bool(r['folds']) for r in res.values())} fold; "
          f"listed in {time.time() - t0:.1f} s")
