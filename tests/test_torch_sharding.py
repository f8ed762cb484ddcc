"""The port's sharding layer held against the reference, on the CPU and
without a process group: ``logical_to_spec`` for every parameter of every
registry arch on mesh shapes (16, 16) and (2, 16, 16) under every
strategy's rules, ``make_rules`` for every strategy and shape kind,
``input_specs``/``abstract_params``/``cache_axes`` shapes and dtypes,
``opts_from_config``, the ``sharding`` ladder's registration,
``eval_sharding_analytic`` under the port's ``HW`` and the autotune CLI
on the offline objective.  The rules and specs are plain data in both
packages: exact equality throughout."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

import repro.analysis.roofline as jroofline
from repro.configs import REGISTRY as JREGISTRY
from repro.configs import ALL_SHAPES as JSHAPES
from repro.distrib import logical as jlogical
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.models.blocks import ModelOpts as JOpts
from repro.tuner import objective as jobjective
from repro_torch.analysis import roofline
from repro_torch.configs import ALL_SHAPES, REGISTRY
from repro_torch.core import objectives
from repro_torch.distrib import logical
from repro_torch.launch import steps
from repro_torch.models import model as tmodel
from repro_torch.models.blocks import ModelOpts
from repro_torch.tuner import objective as tobjective

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(REGISTRY)
SHAPES = [s.name for s in ALL_SHAPES]


class FakeMesh:
    """A mesh as the rules see it: axis name -> size."""

    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"pod": FakeMesh({"data": 16, "model": 16}),
          "multipod": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _shape(name, pkg_shapes):
    return next(s for s in pkg_shapes if s.name == name)


# -- the three cases of tests/test_distribution.py:21-57 -------------------
def test_logical_to_spec_divisibility_guard():
    rules = logical.fsdp_tp_rules(multi_pod=False)
    mesh = MESHES["pod"]
    spec = logical.logical_to_spec(("vocab", "embed"), rules, (504, 1280),
                                   mesh)
    assert spec[0] is None              # 504 % 16 != 0 -> replicated
    assert spec[1] == "data"
    spec2 = logical.logical_to_spec(("vocab", "embed"), rules,
                                    (32000, 3584), mesh)
    assert spec2[0] == "model"


def test_kv_head_fallback_to_head_dim():
    rules = logical.fsdp_tp_rules(multi_pod=False)
    spec = logical.logical_to_spec(
        ("layers", "batch", "kv_seq", "kv_heads", "kv_hd"), rules,
        (32, 128, 4096, 8, 128), MESHES["pod"])
    assert spec[3] is None
    assert spec[4] == "model"


def test_axis_used_only_once():
    rules = logical.AxisRules({"a": "model", "b": "model"})
    spec = logical.logical_to_spec(("a", "b"), rules, (8, 8),
                                   FakeMesh({"model": 4}))
    assert spec[0] == "model" and len(spec) == 1   # trailing None trimmed


# -- every parameter of every arch -----------------------------------------
def _leaves(spec, prefix=()):
    if hasattr(spec, "axes"):
        yield prefix, spec
        return
    for k in sorted(spec):
        yield from _leaves(spec[k], prefix + (k,))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    fake = MESHES[mesh]
    tspec = tmodel.build_model(REGISTRY[arch]).param_spec()
    jspec = jmodel.build_model(JREGISTRY[arch]).param_spec()
    tleaves, jleaves = list(_leaves(tspec)), list(_leaves(jspec))
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    shape = _shape("train_4k", ALL_SHAPES)
    jshape = _shape("train_4k", JSHAPES)
    n = 0
    for strategy in steps.STRATEGIES:
        trules = steps.make_rules(REGISTRY[arch], shape, fake, strategy)
        jrules = jsteps.make_rules(JREGISTRY[arch], jshape, fake, strategy)
        for (path, tp), (_, jp) in zip(tleaves, jleaves):
            assert (tp.shape, tp.axes) == (jp.shape, jp.axes), path
            got = logical.logical_to_spec(tp.axes, trules, tp.shape, fake)
            want = jlogical.logical_to_spec(jp.axes, jrules, jp.shape, fake)
            assert got == tuple(want), (strategy, path)
            n += 1
    assert logical.count_params(tspec) == jlogical.count_params(jspec)
    assert n == len(tleaves) * len(steps.STRATEGIES)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("strategy", steps.STRATEGIES)
def test_make_rules_equal_reference(strategy, shape, mesh):
    for arch in ("qwen1.5-4b", "mamba2-130m"):
        got = steps.make_rules(REGISTRY[arch], _shape(shape, ALL_SHAPES),
                               MESHES[mesh], strategy)
        want = jsteps.make_rules(JREGISTRY[arch], _shape(shape, JSHAPES),
                                 MESHES[mesh], strategy)
        assert got.rules == want.rules


# -- abstract inputs, parameters and caches --------------------------------
_DT = {jnp.int32: torch.int32, jnp.float32: torch.float32,
       jnp.bfloat16: torch.bfloat16}


def _dtype(jdt):
    return _DT[jnp.dtype(jdt).type]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, shape):
    cfg, jcfg = REGISTRY[arch], JREGISTRY[arch]
    got = steps.input_specs(cfg, _shape(shape, ALL_SHAPES))
    want = jsteps.input_specs(jcfg, _shape(shape, JSHAPES))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert v.dtype == _dtype(want[k].dtype), k
    assert steps.batch_axes(cfg, _shape(shape, ALL_SHAPES)) == \
        jsteps.batch_axes(jcfg, _shape(shape, JSHAPES))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_caches_equal_reference(arch):
    cfg, jcfg = REGISTRY[arch], JREGISTRY[arch]
    tm, jm = tmodel.build_model(cfg), jmodel.build_model(jcfg)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = dict(_leaves_of(logical.abstract_params(tm.param_spec(), dt)))
        want = dict(_leaves_of(jlogical.abstract_params(jm.param_spec(),
                                                        jdt)))
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert (tuple(v.shape), v.dtype) == (
                tuple(want[k].shape), _dtype(want[k].dtype)), k
    if cfg.is_encoder_only:
        return
    shape = _shape("decode_32k", ALL_SHAPES)
    got = steps.abstract_cache(tm, shape)
    want = jsteps.abstract_cache(jm, _shape("decode_32k", JSHAPES))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert (tuple(v.shape), v.dtype) == (
            tuple(want[k].shape), _dtype(want[k].dtype)), k
    assert tmodel.cache_axes(cfg) == jmodel.cache_axes(jcfg)


def _leaves_of(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_of(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# -- the tuner --------------------------------------------------------------
CONFIGS = [{}, {"remat": "dots"}, {"attn_chunk": 256, "ce_chunk": 2048},
           {"remat": "none", "attn_chunk": 1024, "banded_local": True},
           {"ce_chunk": "512", "attn_chunk": 512.0}]


@pytest.mark.parametrize("config", CONFIGS, ids=str)
def test_opts_from_config_equal_reference(config):
    got = tobjective.opts_from_config(config)
    want = jobjective.opts_from_config(config)
    assert isinstance(got, ModelOpts)
    for f in ("attn_chunk", "ce_chunk", "remat", "banded_local",
              "use_kernel", "aux_loss_coef"):
        assert getattr(got, f) == getattr(want, f), f
    base = ModelOpts(attn_chunk=64)
    assert tobjective.opts_from_config(config, base).attn_chunk == \
        jobjective.opts_from_config(config, JOpts(attn_chunk=64)).attn_chunk


def test_opts_from_config_rejects_unknown_keys():
    for mod in (tobjective, jobjective):
        with pytest.raises(ValueError, match="unknown config key"):
            mod.opts_from_config({"remat": "full", "chunk": 3})
    assert tobjective.CONFIG_KEYS == jobjective.CONFIG_KEYS


SHARDING = ("hlo_cost", "compile_cost", "dryrun")


@pytest.mark.parametrize("name", SHARDING)
def test_sharding_ladder_registration(name):
    from repro.core import objectives as jobjectives
    mine, theirs = objectives.get_objective(name), \
        jobjectives.get_objective(name)
    assert mine.evaluate == theirs.evaluate.replace("repro.",
                                                    "repro_torch.", 1)
    assert (mine.family, mine.rung, mine.cost_class, mine.tags,
            mine.params, dict(mine.defaults)) == (
        theirs.family, theirs.rung, theirs.cost_class, theirs.tags,
        theirs.params, dict(theirs.defaults))
    assert mine.resolve().__module__.startswith("repro_torch.")
    for arch, shape in (("qwen1.5-4b", "train_4k"),
                        ("mamba2-130m", "decode_32k")):
        params = {"arch": arch, "shape": shape}
        got = mine.domain_factory(params)
        want = theirs.domain_factory(params)
        assert got.provider_names == want.provider_names
        assert [c for c in got.all_candidates()] == \
            [c for c in want.all_candidates()]


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("arch,shape", [
    ("qwen1.5-4b", "train_4k"), ("gemma3-27b", "train_4k"),
    ("mamba2-130m", "decode_32k"), ("phi3.5-moe-42b-a6.6b", "prefill_32k")])
def test_hlo_cost_equals_reference_under_the_same_hw(monkeypatch, arch,
                                                      shape, mesh):
    """The reference's rung 0 run with ``repro.analysis.roofline.HW`` set
    to the port's H100 values (a test-side patch only)."""
    for k, v in roofline.HW.items():
        monkeypatch.setitem(jroofline.HW, k, v)
    domain = objectives.get_objective("hlo_cost").domain_factory(
        {"arch": arch, "shape": shape})
    for provider, config in domain.all_candidates()[::5]:
        params = {"arch": arch, "shape": shape, "mesh": mesh,
                  "provider": provider, "config": dict(config)}
        got = tobjective.eval_sharding_analytic(params, {})
        want = jobjective.eval_sharding_analytic(params, {})
        assert got == want


def test_hw_is_the_h100():
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                           "ici_bw": 450e9, "hbm_bytes": 80e9}
    assert tobjective.CompileCostObjective.__dataclass_fields__[
        "hbm_budget"].default == 80e9


def test_model_flops_estimate_equals_reference():
    for arch in ARCHS:
        for s in ALL_SHAPES:
            assert roofline.model_flops_estimate(REGISTRY[arch], s) == \
                jroofline.model_flops_estimate(JREGISTRY[arch],
                                               _shape(s.name, JSHAPES))


def _cli(root, tmp_path):
    store = tmp_path / f"{root}.jsonl"
    cmd = [sys.executable, "-m", f"{root}.tuner.autotune",
           "--objective", "offline", "--workload", "kmeans@buzz",
           "--target", "cost", "--budget", "11", "--driver", "cb_rbfopt",
           "--seed", "3", "--store", str(store)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc


def test_autotune_cli_prints_the_reference_json(tmp_path):
    port = _cli("repro_torch", tmp_path)
    ref = _cli("repro", tmp_path)
    assert json.loads(port.stdout) == json.loads(ref.stdout)
    assert port.stdout == ref.stdout
    assert "[exp] autotune:" in port.stderr
    # a warm store replays every evaluation
    warm = _cli("repro_torch", tmp_path)
    assert warm.stdout == port.stdout and "computed=0" in warm.stderr
