#!/usr/bin/env python
"""Drive the port's dry-run sweep through the experiment engine (the twin
of ``scripts/run_dryrun_sweep.py``): every (arch x shape x mesh) cell is
one work unit, ``python -m repro_torch.launch.dryrun`` in a subprocess of
its own (each holds its own fake process group, ``repro_torch.launch.mesh``).

Per-cell JSON lands in results/torch_dryrun/<arch>.<shape>.<mesh>.json;
completed cells are also recorded in the engine store
results/expstore/torch_dryrun.jsonl, so an interrupted sweep resumes
where it stopped and failures are retried on the next invocation.  A
cell whose step DTensor cannot place fails with the op named in its
``.err`` file.  ``--workers N`` runs N cells at once.  Host code only:

    PYTHONPATH=src python scripts/torch_run_dryrun_sweep.py \\
        --only mamba2-130m.long_500k.pod
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ARCH_IDS, REGISTRY, shapes_for   # noqa: E402
from repro_torch.exp import (                                    # noqa: E402
    WorkUnit, add_engine_args, engine_from_args, open_store)
from repro_torch.exp.runners import dryrun_runner                # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
OUT = os.path.join(ROOT, "results", "torch_dryrun")
STORE = os.path.join(ROOT, "results", "expstore", "torch_dryrun.jsonl")


# cheapest-first ordering (by params × layers as a compile-cost proxy)
def cost_proxy(arch):
    c = REGISTRY[arch]
    return c.n_params() * c.n_layers


def cells(meshes):
    for arch in sorted(ARCH_IDS, key=cost_proxy):
        cfg = REGISTRY[arch]
        for shape, reason in shapes_for(cfg):
            for mesh in meshes:
                yield arch, shape.name, mesh, reason


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="pod,multipod")
    ap.add_argument("--only", default=None, help="substring filter")
    # --timeout reaches the runner's subprocess kill through the engine's
    # timeout config (injected into the runner context as unit_timeout_s)
    add_engine_args(ap, timeout=3600)
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)

    units = []
    for arch, shape, mesh, reason in cells(args.meshes.split(",")):
        tag = f"{arch}.{shape}.{mesh}"
        if args.only and args.only not in tag:
            continue
        params = {"arch": arch, "shape": shape, "mesh": mesh}
        if reason is not None:
            params["skip_reason"] = reason
        units.append(WorkUnit.make("dryrun", **params))

    engine = engine_from_args(
        args, runner=dryrun_runner,
        local_context={"out_dir": OUT,
                       "src_path": os.path.join(ROOT, "src")},
        store=open_store(args.store_dir or STORE), verbose=True)
    t0 = time.time()
    with engine:
        results = engine.run(units)
    # re-materialize per-cell JSONs that downstream consumers (hillclimb,
    # render_experiments) read, for cells replayed from the store after
    # results/dryrun/ was cleaned
    for unit, res in zip(units, results):
        if res is None:
            continue
        p = unit.as_dict()
        path = os.path.join(OUT, f"{p['arch']}.{p['shape']}.{p['mesh']}.json")
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump(res, f, indent=2)
    s = engine.stats
    print(f"sweep done in {time.time() - t0:.0f}s: {s.total} cells, "
          f"{s.cached} cached, {s.computed} run, {s.failed} failed",
          flush=True)
    for e in s.errors:
        print(f"  FAILED {e}", file=sys.stderr)
    if s.failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
