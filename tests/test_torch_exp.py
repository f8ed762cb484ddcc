"""Parity of the port's experiment engine (``repro_torch.exp``) with the
reference's (``repro.exp``): store fingerprints across backends and
packages, stores that each package writes and the other replays, the
kernel ladder's device-bearing keys, the worker command, the fork guard,
a multi-fidelity search of the kernel ladder on the CPU, and the CLI.
Everything compared across packages is held to exact equality."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.core.fidelity as jax_fidelity
import repro.core.objectives as jax_objectives
import repro.core.registry as jax_registry
import repro.exp as jax_exp
import repro.exp.runners as jax_runners
from repro_torch.core import fidelity, objectives, registry
from repro_torch.exp import executors
import repro_torch.exp as exp
import repro_torch.exp.runners as runners
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.bench import kernel_domain
from repro_torch.multicloud import build_dataset

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD, TARGET = "xgboost@santander", "cost"
COUNTS = {"flash_attention": fa.COUNT, "decode_attention": da.COUNT,
          "ssd_scan": ssd.COUNT}


def _units(objs):
    """Offline, proxy and market units over every candidate of the table,
    minted by the package whose ``objectives`` module is given."""
    cands = build_dataset(0).domain.all_candidates()
    out = []
    for name, extra in (("offline", {}), ("offline_proxy", {}),
                        ("market", {"schedule": "outage:aws:0:4"})):
        binding = objs.bind_objective(name, workload=WORKLOAD,
                                      target=TARGET, dataset_seed=0, **extra)
        for prov, cfg in cands[::3]:
            out.append(binding.unit(prov, cfg, **(
                {"tick": 2} if name == "market" else {})))
    return out


def _run(pkg_exp, pkg_runners, units, store=None, **kw):
    engine = pkg_exp.ExperimentEngine(
        pkg_runners.search_runner, context={"dataset_seed": 0},
        store=store, **kw)
    with engine:
        results = engine.run(units)
    return engine, results


def test_units_are_minted_alike():
    mine = _units(objectives)
    theirs = _units(jax_objectives)
    assert [(u.kind, u.params) for u in mine] == [
        (u.kind, u.params) for u in theirs]
    assert [exp.unit_key(u.kind, u.as_dict(), {"dataset_seed": 0})
            for u in mine] == [
        jax_exp.unit_key(u.kind, u.as_dict(), {"dataset_seed": 0})
        for u in theirs]


@pytest.mark.parametrize("backend", ["serial", "thread", "process"])
def test_store_fingerprint_equals_reference(backend):
    units = _units(objectives)
    engine, results = _run(exp, runners, units, executor=backend,
                           workers=1 if backend == "serial" else 2)
    ref_engine, ref_results = _run(jax_exp, jax_runners,
                                   _units(jax_objectives),
                                   executor="serial")
    assert engine.stats.computed == len(set(units)) > 0
    assert results == ref_results
    assert any(r.get("failed") for r in results)     # the market outage
    assert engine.store.fingerprint() == ref_engine.store.fingerprint()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_store_replays_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "units.jsonl")
    pkgs = {"ref": (jax_exp, jax_runners, _units(jax_objectives)),
            "port": (exp, runners, _units(objectives))}
    reader = "port" if writer == "ref" else "ref"
    w_exp, w_runners, w_units = pkgs[writer]
    cold, cold_results = _run(w_exp, w_runners, w_units,
                              store=w_exp.ResultStore(path))
    r_exp, r_runners, r_units = pkgs[reader]
    warm, warm_results = _run(r_exp, r_runners, r_units,
                              store=r_exp.ResultStore(path))
    assert cold.stats.computed == len(set(w_units))
    assert warm.stats.computed == 0
    assert warm.stats.cached == len(set(r_units))
    assert warm_results == cold_results
    assert warm.store.fingerprint() == cold.store.fingerprint()


def test_a_search_replays_in_the_other_package(tmp_path):
    """A drive through the reference's engine leaves a store in which the
    port's drive of the same search computes nothing."""
    path = str(tmp_path / "units.jsonl")
    hists = []
    for pkg_fid, pkg_exp, pkg_runners, pkg_registry in (
            (jax_fidelity, jax_exp, jax_runners, jax_registry),
            (fidelity, exp, runners, registry)):
        ds = build_dataset(0)
        drv = pkg_registry.get_method("mf_sh").make_driver(
            ds.domain, 33, 0, target=TARGET)
        ladder = pkg_fid.bind_ladder("offline", workload=WORKLOAD,
                                     target=TARGET, dataset_seed=0)
        engine = pkg_exp.ExperimentEngine(
            pkg_runners.search_runner, context={"dataset_seed": 0},
            store=pkg_exp.ResultStore(path))
        hists.append(pkg_runners.drive_units(engine, [(drv, ladder)])[0])
        computed = engine.stats.computed
    assert computed == 0
    assert (hists[0].points, hists[0].values) == (hists[1].points,
                                                  hists[1].values)


def _kernel_keys(fid, device=None):
    kw = {} if device is None else {"device": device}
    ladder = fid.bind_ladder("kernel", preset="tiny", reps=2, **kw)
    cands = kernel_domain("tiny").all_candidates()
    units = [ladder.rung_unit(r, p, c) for r in range(2) for p, c in cands]
    return [exp.unit_key(u.kind, u.as_dict(), {}) for u in units]


def test_kernel_ladder_keys_carry_the_device():
    ref = _kernel_keys(jax_fidelity)
    default, cuda = _kernel_keys(fidelity), _kernel_keys(fidelity, "cuda")
    cpu = _kernel_keys(fidelity, "cpu")
    assert default == cuda                  # the default is the card
    assert len(set(ref + cuda + cpu)) == 3 * len(ref) == 90
    unit = fidelity.bind_ladder("kernel", preset="tiny").rung_unit(
        1, "ssd_scan", {"chunk": 64})
    assert unit.as_dict()["device"] == "cuda"
    # the offline ladder's keys are the reference's
    cands = build_dataset(0).domain.all_candidates()[:5]
    for r in range(2):
        mine = fidelity.bind_ladder("offline", workload=WORKLOAD,
                                    target=TARGET, dataset_seed=0)
        theirs = jax_fidelity.bind_ladder("offline", workload=WORKLOAD,
                                          target=TARGET, dataset_seed=0)
        for p, c in cands:
            assert (mine.rung_unit(r, p, c).params
                    == theirs.rung_unit(r, p, c).params)


def test_worker_commands_name_the_port():
    ssh = executors.SSHTransport("gpu1")
    assert "-m repro_torch.exp worker" in ssh.remote_command
    proc = executors.LocalSubprocessTransport(heartbeat_s=0).spawn()
    try:
        assert proc.args[1:4] == ["-m", "repro_torch.exp", "worker"]
    finally:
        proc.kill()
        proc.wait()


def test_one_unit_round_trips_through_a_worker():
    units = _units(objectives)[:3]
    engine, results = _run(exp, runners, units, executor="remote",
                           workers=1)
    ref_engine, ref_results = _run(exp, runners, units, executor="serial")
    assert engine.stats.computed == 3 and results == ref_results
    assert engine.store.fingerprint() == ref_engine.store.fingerprint()


def test_fork_after_cuda_is_refused(monkeypatch):
    forked = executors.ProcessExecutor(workers=1)      # before CUDA
    try:
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        with pytest.raises(RuntimeError, match="initialised CUDA"):
            executors.ProcessExecutor(workers=1)
        with pytest.raises(RuntimeError, match="initialised CUDA"):
            forked.submit(len, [])
        monkeypatch.setenv("REPRO_EXP_MP", "fork")
        with pytest.raises(RuntimeError, match="initialised CUDA"):
            _run(exp, runners, _units(objectives)[:2], executor="process",
                 workers=2)
    finally:
        forked.shutdown()
    spawned = executors.ProcessExecutor(workers=1, mp_context="spawn")
    spawned.shutdown()


def test_mf_sh_searches_the_kernel_ladder_on_the_cpu():
    """The port's own engine drives ``mf_sh`` over the kernel ladder; on
    CPU tensors every wrapper runs its plain version and counts it."""
    ladder = fidelity.bind_ladder("kernel", preset="tiny", reps=1,
                                  device="cpu")
    domain = ladder.make_domain()
    drv = registry.get_method("mf_sh").make_driver(domain, 9, 0,
                                                   target="time")
    before = {n: (c.launches, c.plain) for n, c in COUNTS.items()}
    engine = exp.ExperimentEngine(runners.search_runner, executor="serial")
    hist = runners.drive_units(engine, [(drv, ladder)])[0]
    assert drv.done and len(hist.values) == drv.spend[1] >= 1
    assert drv.spend[0] == len(domain.all_candidates()) == 15
    prov, cfg, value, _h = drv.result()
    assert value == min(hist.values) > 0
    assert engine.stats.failed == 0
    for name, c in COUNTS.items():
        assert c.launches == before[name][0], name
    assert sum(c.plain - before[n][1] for n, c in COUNTS.items()) > 0
    top = [r["result"] for r in engine.store.records()
           if r["params"].get("objective") == "kernel_time"]
    assert len(top) == drv.spend[1]
    assert all(r["maxerr"] < 2e-2 for r in top)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.exp", *args],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


@pytest.mark.parametrize("what", ["methods", "objectives"])
def test_cli_lists_the_registries(what):
    lines = _cli(what)
    names = [line.split()[0] for line in lines]
    if what == "methods":
        assert tuple(names) == registry.method_names()
    else:
        assert tuple(names) == objectives.objective_names()
        assert all("repro_torch." in line for line in lines)
        kernel = [line for line in lines if line.startswith("kernel_time")]
        assert "device='cuda'" in kernel[0]


def test_cli_stat_reads_a_store(tmp_path):
    path = tmp_path / "units.jsonl"
    engine, _results = _run(exp, runners, _units(objectives)[:4],
                            store=exp.ResultStore(str(path)))
    lines = _cli("stat", str(path))
    assert lines[0] == f"{path}: 4 records"
    assert lines[1].split() == ["eval:", "4"]
    assert lines[-1] == f"fingerprint: {engine.store.fingerprint()}"
