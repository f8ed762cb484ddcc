"""Readings for a cell's limits: the check's numbers on many seeds in one
process, the program's beside the control's (the reference's forward
with its linear layers in float8) on the same served tokens.

    python3 bench/tools/readings.py --workload <cell> --seeds 1,2,3
        --seconds 30 [--also fp8,bfloat16] [--out readings.jsonl]

Each seed is a whole run of the cell (set-up, window, check); one line of
JSON a seed goes to standard output and, with --out, to a file.  The
benchmark's own runs never run the control.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE),
                os.path.join(os.path.dirname(os.path.dirname(HERE)), "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--also", default="fp8",
                   help="reference precisions read beside the program")
    p.add_argument("--layers", type=int, default=None,
                   help="a diagnostic: the configuration cut to this depth")
    p.add_argument("--dtype", default=None,
                   help="a diagnostic: the configuration served in this dtype")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from harness.cell import load_cell, log, run_cell
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    cell = load_cell(args.workload, False)
    if args.layers:
        cell.config["n_layers"] = args.layers
    if args.dtype:
        cell.config["dtype"] = args.dtype
    also = tuple(a for a in args.also.split(",") if a)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, device="cuda",
                       t_start=t0, also=also)
        line = {"workload": args.workload, "seed": seed,
                "layers": cell.config["n_layers"],
                "dtype": cell.config["dtype"],
                "correct": out["correct"], "metrics": out["metrics"],
                "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                "readings": out["readings"], "checks": out["checks"],
                "run_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
