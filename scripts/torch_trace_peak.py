#!/usr/bin/env python
"""List what a dry-run cell holds at its traced peak: the largest storages
live, per chip, when ``repro_torch.analysis.roofline.trace_plan``'s count
of live bytes reaches its most.

    PYTHONPATH=src python scripts/torch_trace_peak.py --arch gemma-7b \\
        --shape train_4k [--strategy fsdp_tp] [--top 8]

The production mesh (16, 16) of the fake process group, as
``python -m repro_torch.launch.dryrun`` traces it (a train cell takes
minutes).  Each line: the storage's bytes, and the shape and dtype of the
tensor that first held it (a view may hold more than its shape).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.steps import build_plan  # noqa: E402


def watch_peak(top: int):
    """Make ``roofline.cost_mode`` record the storages live at its peak
    -> the dict it fills ({"peak": bytes, "live": [(bytes, shape,
    dtype)]})."""
    seen = {"peak": 0, "live": []}
    make = roofline.cost_mode

    def cost_mode():
        mode = make()
        cls = type(mode)
        live = {}
        alloc, free = cls._alloc, cls._free

        def _alloc(self, t):
            before = self.live
            alloc(self, t)
            if self.live == before:
                return
            st = t.untyped_storage()
            live[id(st)] = (st.nbytes(), tuple(t.shape), str(t.dtype))
            if self.live > seen["peak"]:
                seen["peak"] = self.live
                seen["live"] = sorted(live.values(), reverse=True)[:top]

        def _free(self, key, n):
            free(self, key, n)
            live.pop(key, None)

        cls._alloc, cls._free = _alloc, _free
        return mode

    roofline.cost_mode = cost_mode
    return seen


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--strategy", default="fsdp_tp")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    seen = watch_peak(args.top)
    plan = build_plan(get_config(args.arch), get_shape(args.shape),
                      make_production_mesh(), strategy=args.strategy)
    cost = roofline.trace_plan(plan)
    print(f"{args.arch} x {args.shape} [{args.strategy}] on (16, 16): peak "
          f"{cost.peak_bytes:.0f} B per chip ({cost.arg_bytes:.0f} B of "
          f"arguments); the largest storages live at the peak:")
    for nbytes, shape, dtype in seen["live"]:
        print(f"  {nbytes:>14d} B  {shape} {dtype}")


if __name__ == "__main__":
    main()
