"""One run of one cell: the manifest's entry, its configuration and mix
files, the server, the window, the metrics and the check.

Everything that belongs to a configuration, a mix or a metric is a file
found by its name: ``bench/configs/<config>.json`` (its ``reference``
names ``bench/reference/<name>.py``), ``bench/traffic/<traffic>.json``,
``bench/metrics/<metric>.py`` (a ``read(run)`` that returns a number or
None) and ``bench/limits/<cell>.json``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

from harness import check, guard
from harness import weights as W
from harness.loop import ClosedLoop, Record
from harness.traffic import Traffic

BENCH = check.BENCH
ROOT = os.path.dirname(BENCH)
TRACE_STEPS = 32       # served steps under the profiler in a --trace 1 run
MIN_TOKENS = 100       # served tokens the check must compare at least


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    metrics: Dict[str, Dict]         # this run's metrics by name


def applies(metric: Dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, trace: bool) -> Cell:
    manifest = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT, conf["file"])
    mix = load_json(BENCH, "traffic", f"{entry['traffic']}.json")
    metrics = {m["name"]: m for m in
               manifest["per_layer" if trace else "end_to_end"]
               if applies(m, name)}
    return Cell(name, int(entry["chips"]), config, mix, metrics)


def reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: str
    cfg: Dict
    mix: Dict
    rec: Record
    setup_s: float
    device_kind: str


def arch_config(cfg: Dict):
    """The program's configuration object from the file's keys."""
    from repro_torch.configs.base import ArchConfig
    keys = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in cfg.items() if k in keys})


def build_server(cfg: Dict, mix: Dict, seed: int, device,
                 mark=lambda part: None):
    import torch
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve import BatchedServer, Request
    torch.empty(0, device=device)            # the CUDA context
    mark("context")
    params = W.nest(W.draw(cfg, seed, device))
    mark("weights")
    server = BatchedServer(
        Model(arch_config(cfg)), params, batch_size=int(mix["slots"]),
        max_seq=int(mix["max_seq"]), use_kernel=True, device=device)
    if cfg["kv_cache_dtype"] != str(server.cache["k"].dtype)[6:]:
        raise RuntimeError(f"the server's cache is {server.cache['k'].dtype}"
                           f", the configuration states "
                           f"{cfg['kv_cache_dtype']}")
    if not server.use_kernel:
        raise RuntimeError("the server refused the decode kernel")
    del params
    return server, Request


def launch_counts(server) -> Dict[str, int]:
    from repro_torch.kernels import decode_attention
    return {"replays": server.step_graph.replays,
            "launches": decode_attention.COUNT.launches,
            "plain": decode_attention.COUNT.plain}


def path_shortfall(before: Dict, after: Dict, steps: int, layers: int,
                   on_card: bool) -> Dict[str, int]:
    """Window steps that were no replay of the step graph, and layers of
    window steps that did not run the decode kernel (its plain version on
    the CPU)."""
    replays = after["replays"] - before["replays"]
    key = "launches" if on_card else "plain"
    calls = after[key] - before[key]
    return {"steps_not_replayed": (steps - replays) if on_card else 0,
            "layers_without_kernel": abs(layers * steps - calls)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             also=(), limits: Optional[Dict] = None,
             early: Optional[Dict[str, float]] = None) -> Dict:
    """Set up, serve the window, read the metrics, check the served
    tokens -> the result's fields (and ``readings`` with the check's
    numbers).  ``also`` names reference precisions to read beside the
    program (``fp8`` is the control); ``limits`` stands in for the
    cell's limit file; ``early`` holds the seconds of set-up's parts
    before the call (importing torch, starting the driver)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, mix = cell.config, cell.mix
    on_card = torch.device(device).type == "cuda"
    check.load_reference(cfg["reference"]).check_no_drop(cfg, mix["slots"])
    parts = dict(early or {})
    parts["start"] = time.perf_counter() - t_start - sum(parts.values())

    def mark(part: str) -> None:
        if on_card:
            torch.cuda.synchronize()
        parts[part] = time.perf_counter() - t_start - sum(parts.values())

    server, Request = build_server(cfg, mix, seed, device, mark)
    mark("server")
    loop = ClosedLoop(server, Traffic(mix, seed, cfg["vocab"]), Request)
    loop.capture()
    mark("capture")
    loop.start()
    for _ in range(int(mix["warmup_steps"])):
        loop.step()
    mark("warmup")
    found = guard.forbidden_loaded()
    if found:
        raise ForbiddenModules(found)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log("set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()))
    before = launch_counts(server)
    rec = loop.window(seconds, TRACE_STEPS if trace else 0)
    after = launch_counts(server)
    gc.unfreeze()
    steps = len(rec.step_end)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    run = Run(cell.name, cfg, mix, rec, setup_s, kind)
    metrics = {}
    for name, m in cell.metrics.items():
        value = reader(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    shortfall = path_shortfall(before, after, steps, cfg["n_layers"], on_card)
    stepwise = cfg.get("check", "served") == "step"
    if stepwise:
        probed = check.probe_steps(loop, int(mix["check_steps"]))
        cache = dict(server.cache)
    else:
        chosen = check.sample(loop.served, int(mix["check_requests"]), seed)
    del loop, server
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    if stepwise:
        got = check.compare_steps(cfg, seed, probed, cache, device, also)
        del cache
    else:
        got = check.compare(cfg, seed, chosen, device, also=also)
    shortfall["tokens_short"] = max(0, MIN_TOKENS - got["tokens"])
    if limits is None:
        limits = check.load_limits(cell.name)
    checks = check.judge(got["program"], limits, shortfall)
    out = {"correct": bool(checks) and all(c["ok"] for c in checks.values()),
           "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": kind, "count": cell.chips,
                      "memory_peak_bytes": int(peak)}}
    if trace and rec.trace is not None:
        from harness import trace as T
        out["device"]["busy_s"] = T.busy_us(rec.trace) / 1e6
        out["device"]["window_s"] = rec.trace.wall_s
        out["breakdown"] = T.breakdown(rec.trace)
    out["readings"] = dict(got, steps=steps, window_s=rec.window_s,
                           setup_s=setup_s, setup_parts=parts,
                           check_s=time.perf_counter() - t_check)
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


class ForbiddenModules(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__("forbidden modules loaded: " + ", ".join(found))
        self.found = found
