"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake
DTensors and score it with the H100 roofline (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 512 placeholder XLA
devices; here ``repro_torch.launch.mesh`` lays the production mesh on a
fake process group of 512 ranks, and the step runs once on DTensors
whose local shards are fake tensors (``repro_torch.analysis.roofline``).
``lower_s`` is that trace's time.  Nothing is compiled: ``compile_s`` is
0.0, kept so that readers of the reference's JSON find every key.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
        --shape train_4k [--multi-pod] [--strategy fsdp_tp] [--out out.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.analysis.roofline import roofline_from_trace
from repro_torch.configs import get_config, get_shape, shapes_for
from repro_torch.launch.mesh import make_production_mesh, mesh_chip_count
from repro_torch.launch.steps import build_plan, default_attn_chunk
from repro_torch.models.blocks import ModelOpts


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             strategy: str = "fsdp_tp", opts: ModelOpts = None,
             verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = "multipod" if multi_pod else "pod"
    for s, reason in shapes_for(cfg):
        if s.name == shape_name and reason is not None:
            return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "skipped": reason}

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chip_count(mesh)
    plan = build_plan(cfg, shape, mesh, strategy=strategy, opts=opts)

    t0 = time.time()
    report = roofline_from_trace(plan, cfg=cfg, shape=shape,
                                 mesh_name=mesh_name, chips=chips)
    t_trace = time.time() - t0
    result = report.to_dict()
    result.update({
        "strategy": strategy,
        "lower_s": round(t_trace, 2),
        "compile_s": 0.0,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
    })
    if verbose:
        # diagnostics go to stderr: stdout belongs to --out/JSON piping
        err = sys.stderr
        print(f"== {arch} × {shape_name} × "
              f"{'multipod(2,16,16)' if multi_pod else 'pod(16,16)'} "
              f"[{strategy}] traced in {t_trace:.2f}s ==", file=err)
        print("coll_breakdown:", result["coll_breakdown"], file=err)
        print(json.dumps(
            {k: result[k] for k in
             ("t_compute", "t_memory", "t_collective", "bottleneck",
              "roofline_fraction", "useful_flops_fraction",
              "peak_memory_per_chip")}, indent=2), file=err)
    return result


def opts_from_cli(args) -> "ModelOpts | None":
    """ModelOpts for the explicitly-set CLI flags, or ``None`` when every
    flag is at its default (``build_plan`` then applies its own per-arch
    defaulting).  The ``--attn-chunk 0`` sentinel resolves to the same
    per-arch default even when another flag forces an opts object."""
    if not (args.attn_chunk or args.ce_chunk != 1024
            or args.remat != "full" or args.banded_local):
        return None
    attn = args.attn_chunk or default_attn_chunk(get_config(args.arch))
    return ModelOpts(attn_chunk=attn, ce_chunk=args.ce_chunk,
                     remat=args.remat, banded_local=args.banded_local)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="fsdp_tp")
    ap.add_argument("--attn-chunk", type=int, default=0,
                    help="0 = per-arch default")
    ap.add_argument("--ce-chunk", type=int, default=1024)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--banded-local", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    result = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                      strategy=args.strategy, opts=opts_from_cli(args))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    if "skipped" in result:
        print(f"SKIPPED: {result['skipped']}", file=sys.stderr)
        sys.exit(0)


if __name__ == "__main__":
    main()
