"""A whole run of a cell at a tiny size on the CPU: sound runs are
correct, the control and each fault of the timed path are not, nothing
of JAX is loaded, and without a card the benchmark fails and prints no
result."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from harness import guard
from harness.cell import BENCH, ROOT, Cell, run_cell

# Limits of this size, from its readings on seeds 1000-1005 (bf16 on the
# CPU).  minitron-8b, served tokens: widest gap 0.027 and mean 0.00015
# at most; the float8 control 0.25 and 0.009 at least.  phi3.5-moe-16L,
# step-wise: mean gap 0.0032, layer-0 row gap 0.0044 and the later
# layers' median row gap 0.0068 at most; the control 0.025, 0.048 and
# 0.081 at least.
TINY_LIMITS = {
    "minitron-8b": {"limits": {"max_logit_gap": {"limit": 0.15},
                               "mean_logit_gap": {"limit": 0.005}}},
    "phi3.5-moe-16L": {"limits": {"mean_logit_gap": {"limit": 0.008},
                                  "kv0_error": {"limit": 0.015},
                                  "kv_rows_median": {"limit": 0.03}}},
}
SEEDS = (1000, 1001, 1002)


def run(name, seed, also=()):
    return run_cell(Cell("t", 1, tiny.config(name), tiny.mix(), {}), seed,
                    2.0, False, device="cpu", also=also,
                    limits=TINY_LIMITS[name])


@pytest.mark.parametrize("name", tiny.CONFIGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct_and_control_is_not(name, seed):
    out = run(name, seed, also=("fp8",))
    limits = TINY_LIMITS[name]["limits"]
    assert out["correct"], out["checks"]
    assert all(out["readings"]["control"][k] > v["limit"]
               for k, v in limits.items())
    assert list(out)[-1] == "checks"


def keep_state(monkeypatch):
    from repro_torch.distrib import logical
    monkeypatch.setattr(logical.ShardCtx, "write_rows",
                        lambda self, cache, new, pos: None)


def rows_above_layer0(monkeypatch, shift):
    """K and V rows of layers 1 and up never written (``shift`` None) or
    written ``shift`` positions on; layer 0 untouched."""
    from repro_torch.distrib import logical
    write = logical.ShardCtx.write_rows
    calls = [0]

    def broken(self, cache, new, pos):
        layer = (calls[0] // 2) % tiny.config("minitron-8b")["n_layers"]
        calls[0] += 1          # K then V, layer by layer, every step
        if layer == 0:
            return write(self, cache, new, pos)
        if shift is not None:
            at = torch.as_tensor(pos) + shift
            write(self, cache, new, at.clamp(max=cache.shape[1] - 1))
    monkeypatch.setattr(logical.ShardCtx, "write_rows", broken)


def skip_rows_above_layer0(monkeypatch):
    rows_above_layer0(monkeypatch, None)


def shift_rows_above_layer0(monkeypatch):
    rows_above_layer0(monkeypatch, 1)


def alter_token(monkeypatch):
    """One slot's token altered on each step, a different slot each
    time."""
    from repro_torch.runtime import graph
    step = graph.StepGraph.step
    calls = [0]

    def altered(self, token, pos):
        out = step(self, token, pos)
        i = calls[0] % len(out)
        calls[0] += 1
        out[i] = (out[i] + 1) % self.model.cfg.vocab
        return out
    monkeypatch.setattr(graph.StepGraph, "step", altered)


def drop_half(monkeypatch):
    from repro_torch.runtime import graph
    step = graph.StepGraph.step

    def half(self, token, pos):
        out = step(self, token, pos)
        out[len(out) // 2:] = 0
        return out
    monkeypatch.setattr(graph.StepGraph, "step", half)


@pytest.mark.parametrize("name", tiny.CONFIGS)
@pytest.mark.parametrize("fault", [keep_state, alter_token, drop_half,
                                   skip_rows_above_layer0,
                                   shift_rows_above_layer0])
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run(name, SEEDS[0])
    assert not out["correct"]


@pytest.mark.parametrize("fault", [skip_rows_above_layer0,
                                   shift_rows_above_layer0])
def test_the_history_check_alone_sees_rows_above_layer0(fault, monkeypatch):
    """The step-wise check's own-row steps cannot see a fault in the
    history of layers 1 and up; the rows' median gap does."""
    fault(monkeypatch)
    out = run("phi3.5-moe-16L", SEEDS[0])
    rows, kv0 = out["checks"]["kv_rows_median"], out["checks"]["kv0_error"]
    assert rows["value"] > rows["limit"]
    assert kv0["value"] <= kv0["limit"]


def test_forbidden_names_compare_whole():
    names = ["repro_torch", "repro_torch.runtime", "reprox", "jax.numpy",
             "repro", "repro.models", "flax", "jaxlib.xla", "jaxtyping"]
    assert guard.forbidden_loaded(names) == [
        "flax", "jax.numpy", "jaxlib.xla", "repro", "repro.models"]


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import tiny\n"
        "from harness import guard\n"
        "from harness.cell import Cell, run_cell\n"
        "run_cell(Cell('t', 1, tiny.config('phi3.5-moe-16L'), tiny.mix(), "
        "{}), 3, 0.5, False, device='cpu', limits={})\n"
        "assert 'repro_torch.runtime.serve' in sys.modules\n"
        "print(guard.forbidden_loaded())\n"
    ) % (os.path.join(BENCH, "tests"), BENCH, os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_jax_loaded_by_the_check_stops_the_result(monkeypatch, capsys):
    """What the reference loads after the window counts too: a module of
    JAX in the process once the check is done means no result."""
    import importlib.util
    import types
    from harness import cell as C
    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def checked_then_loaded(*a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"checks": {}, "correct": True}
    monkeypatch.setattr(C, "run_cell", checked_then_loaded)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = mod.main(["--workload", "minitron-8b.chat", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def bench_cmd(root):
    return [sys.executable, os.path.join(root, "bench", "run.py"),
            "--workload", "minitron-8b.chat", "--seed", str(2**31 + 5),
            "--seconds", "1", "--trace", "0"]


def no_result(proc):
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_without_a_card_it_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(bench_cmd(ROOT), capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    no_result(proc)


def test_without_the_program_it_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(bench_cmd(str(tmp_path)), capture_output=True,
                          text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    no_result(proc)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    proc = subprocess.run(bench_cmd(ROOT), capture_output=True, text=True,
                          cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "gpu"
    assert {"output_tok_s", "itl_p95_ms", "setup_s"} <= set(out["metrics"])
    assert np.isfinite(out["metrics"]["output_tok_s"]["value"])
