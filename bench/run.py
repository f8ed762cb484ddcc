"""The port's serving benchmark: one cell of BENCHMARK.json, one run.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Runs from the root of a checkout on a machine with an NVIDIA card; it
exits non-zero and prints no result without one.  The last line of
standard output is the result as one JSON object; the numbers the check
compared, each beside its limit, are the last lines of standard error.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from harness.cell import ForbiddenModules, load_cell, log, run_cell
    import torch
    t_import = time.perf_counter()
    cell = load_cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards; "
            f"{torch.cuda.device_count()} found")
        return 2
    early = {"import": t_import - T0,
             "driver": time.perf_counter() - t_import}
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       device="cuda", t_start=T0, early=early)
    except ForbiddenModules as exc:
        log(str(exc))
        return 3
    # the reference ran after the run's last look: look again before the
    # result is printed
    from harness import guard
    found = guard.forbidden_loaded()
    if found:
        log(str(ForbiddenModules(found)))
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
