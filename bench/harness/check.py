"""Whether what the timed path served is right, against the plain
reference in float32 with weights drawn again from the seed, once the
window has closed and the program is gone.  A configuration's ``check``
says how:

* ``served`` (the default): a sample of requests drawn from the seed
  (the one with the most tokens and others at random, finished or still
  running at the close) goes through the reference whole, prompt and
  served tokens; each served token's gap below the reference's best
  logit at its position is taken.
* ``step``: where rounding sets a sequence off the reference's path (an
  MoE's routing near-ties), the window's timed path serves
  ``check_steps`` more steps, and the reference takes each of them again
  for every slot from the server's own K and V; the gap of each token
  the step picked is taken.  Each checked slot's whole history is taken
  again the same way, position by position from the rows below it, and
  the K and V rows the server wrote at every layer are held to the rows
  the reference computes there: layer 0's, which depend on the slot's
  tokens alone, each, and the later layers' by their median gap.

The numbers are compared with the cell's limits
(``bench/limits/<cell>.json``).
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

import numpy as np

from harness import weights as W
from harness.traffic import derive

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_reference(name: str):
    path = os.path.join(BENCH, "reference", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_limits(cell: str) -> Dict:
    path = os.path.join(BENCH, "limits", f"{cell}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def sample(requests: List, k: int, seed: int) -> List[Dict]:
    """The request with the most served tokens and ``k - 1`` others drawn
    from the seed, of those with at least one served token."""
    got = [r for r in requests if r.output]
    if not got:
        return []
    got.sort(key=lambda r: r.rid)
    longest = max(got, key=lambda r: (len(r.prompt) + len(r.output), -r.rid))
    rest = [r for r in got if r is not longest]
    rng = np.random.default_rng(derive(seed, "sample"))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    chosen = [longest] + [rest[i] for i in sorted(pick)]
    return [{"rid": r.rid, "prompt": list(r.prompt),
             "output": list(r.output)} for r in chosen]


def readings(gaps: np.ndarray) -> Dict[str, float]:
    """Numbers of one set of gaps: the widest, its 99th percentile, the
    mean, and the share of tokens that were not the reference's best."""
    if gaps.size == 0:
        return {}
    return {"max_logit_gap": float(gaps.max()),
            "p99_logit_gap": float(np.percentile(gaps, 99)),
            "mean_logit_gap": float(gaps.mean()),
            "not_best_share": float((gaps > 0).mean())}


def compare(cfg: Dict, seed: int, chosen: List[Dict], device,
            also=()) -> Dict:
    """The reference's readings of the chosen requests, and of the
    reference's own forward in each precision of ``also`` ("fp8" is the
    control), weights drawn again from the seed on ``device``."""
    drawn = W.draw(cfg, seed, device)
    ref = load_reference(cfg["reference"])
    out = ref.logit_gaps(cfg, drawn.__getitem__, chosen, device, also=also)
    del drawn
    res = {"tokens": int(out["gaps"].size), "program": readings(out["gaps"])}
    for p in also:
        res["control" if p == "fp8" else p] = readings(out[p])
    return res


def probe_steps(loop, n: int) -> List[Dict]:
    """``n`` more served steps after the window, through the same loop
    and step graph, for the step-wise check.  For each slot whose request
    holds it through all of them: its positions, the tokens fed, the
    tokens it picked (the served token, or while it fed the prompt the
    one its step put first) and the tokens it has fed so far."""
    server = loop.server
    held = {i: r for i, r in enumerate(server.active) if r is not None}
    steps = {i: {"slot": i, "pos": [], "token": [], "picked": []}
             for i in held}
    for _ in range(n):
        held = {i: r for i, r in held.items() if server.active[i] is r}
        pos = {i: server.steps - r.started for i, r in held.items()}
        loop.step()
        first = server.step_graph.logits.argmax(-1).cpu().tolist()
        for i, r in held.items():
            seq = list(r.prompt) + list(r.output)
            p, P = pos[i], len(r.prompt)
            st = steps[i]
            st["pos"].append(p)
            st["token"].append(seq[p])
            st["picked"].append(seq[p + 1] if p >= P - 1 else first[i])
    out = []
    for i, r in held.items():
        if server.active[i] is r:
            st = steps[i]
            st["sequence"] = (list(r.prompt) + list(r.output))[
                :st["pos"][-1] + 1]
            out.append(st)
    return out


def compare_steps(cfg: Dict, seed: int, slots: List[Dict], cache, device,
                  also=()) -> Dict:
    """The step-wise check's readings from the server's K and V
    (``cache``), weights drawn again from the seed on ``device``."""
    if not slots:
        return {"tokens": 0, "program": {}}
    drawn = W.draw(cfg, seed, device)
    ref = load_reference(cfg["reference"])
    out = ref.step_gaps(cfg, drawn.__getitem__, cache["k"], cache["v"],
                        slots, also=also)
    del drawn
    res = {"tokens": int(out["gaps"].size),
           "program": dict(readings(out["gaps"]),
                           **row_readings(out["kv0"], out["rows"]))}
    for p in also:
        res["control" if p == "fp8" else p] = dict(
            readings(out[p]), **row_readings(out["kv0_" + p],
                                             out["rows_" + p]))
    return res


def row_readings(kv0: np.ndarray, rows: np.ndarray) -> Dict[str, float]:
    """Numbers of the K and V rows: layer 0's widest gap, and the median
    gap of the rows of every later layer."""
    if rows.size == 0:
        return {}
    return {"kv0_error": float(kv0.max(initial=0.0)),
            "kv_rows_median": float(np.median(rows))}


def judge(found: Dict[str, float], limits: Dict, extra: Dict) -> Dict:
    """Each compared number beside its limit -> {name: {value, limit,
    ok}}; ``extra`` holds exact counts that must be 0."""
    out = {}
    if not limits.get("limits"):
        out["limit_file_missing"] = {"value": 1, "limit": 0, "ok": False}
    for name, lim in limits.get("limits", {}).items():
        v = found.get(name)
        out[name] = {"value": v, "limit": lim["limit"],
                     "ok": v is not None and v <= lim["limit"]}
    for name, v in extra.items():
        out[name] = {"value": v, "limit": 0, "ok": v == 0}
    return out
