"""The port's kernel search domain (``repro_torch.kernels.bench``) against
the reference's (``repro.kernels.bench``).

The domain, the encoders and the analytic rung are held bit for bit; the
measured rung runs on the CPU here (each wrapper's plain version), and each
candidate's routing through the port's ``ops`` is held against the Pallas
kernels in interpret mode on the same inputs.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bench as jax_bench
from repro.kernels import ops as jax_ops
from repro_torch.kernels import bench
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd_mod

PRESETS = ("tiny", "small")
#: attention is f32 (tests/test_kernels.py:14); the ssd rung's maxerr
#: bound of tests/test_fidelity.py:347
MAXERR = {"flash_attention": 2e-5, "decode_attention": 2e-5,
          "ssd_scan": 2e-2}


def _params(provider, preset, config, **kw):
    return dict(provider=provider, preset=preset,
                config=tuple(sorted(config.items())), **kw)


def _candidates(preset):
    return bench.kernel_domain(preset).all_candidates()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("preset", PRESETS)
def test_kernel_domain_equals_the_reference(preset):
    mine, ref = bench.kernel_domain(preset), jax_bench.kernel_domain(preset)
    assert mine.provider_names == ref.provider_names == (
        "flash_attention", "decode_attention", "ssd_scan")
    for p in mine.provider_names:
        assert [(s.name, s.values) for s in mine.provider(p).params] == \
            [(s.name, s.values) for s in ref.provider(p).params]
    assert mine.size() == ref.size() == 15
    assert mine.all_candidates() == ref.all_candidates()
    flat_m, flat_r = mine.flat_encoder(), ref.flat_encoder()
    for point in mine.all_candidates():
        np.testing.assert_array_equal(flat_m.encode(point),
                                      flat_r.encode(point))
        prov, config = point
        np.testing.assert_array_equal(
            mine.inner_encoder(prov).encode(config),
            ref.inner_encoder(prov).encode(config))
    np.testing.assert_array_equal(
        flat_m.encode_many(mine.all_candidates()),
        flat_r.encode_many(ref.all_candidates()))


def test_presets_and_blocks_equal_the_reference():
    assert bench.PRESETS == jax_bench.PRESETS
    assert bench._BLOCKS == jax_bench._BLOCKS
    with pytest.raises(KeyError, match="unknown kernel preset"):
        bench.kernel_domain("huge")


@pytest.mark.parametrize("preset", PRESETS)
def test_analytic_rung_is_bit_equal(preset):
    for provider, config in _candidates(preset):
        assert bench.grid_steps(provider, preset, config) == \
            jax_bench.grid_steps(provider, preset, config)
        assert bench._work_elems(provider, preset) == \
            jax_bench._work_elems(provider, preset)
        p = _params(provider, preset, config)
        mine = bench.eval_kernel_analytic(p, {})
        assert mine == jax_bench.eval_kernel_analytic(p, {})
        assert type(mine["value"]) is float and mine["value"] > 0


def test_inputs_are_seeded_float32_and_ssd_D_is_ones():
    for preset in PRESETS:
        for provider in ("flash_attention", "decode_attention", "ssd_scan"):
            a = bench._inputs(provider, preset, "cpu")
            bench._inputs.cache_clear()
            b = bench._inputs(provider, preset, "cpu")
            assert all(x.dtype == torch.float32 for x in a)
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    B, Hq, Hkv, S, D = bench.PRESETS["small"]["flash_attention"]
    q, k, v = bench._inputs("flash_attention", "small")
    assert q.shape == (B, Hq, S, D) and k.shape == v.shape == (B, Hkv, S, D)
    x, dt, A, Bm, Cm, Dv = bench._inputs("ssd_scan", "small")
    assert torch.equal(Dv, torch.ones(2)) and (dt > 0).all() and (A < 0).all()


def _jax_candidate(provider, preset, config, args):
    """The reference's kernel for one candidate, in interpret mode, on the
    port's inputs."""
    a = [jnp.asarray(t.numpy()) for t in args]
    if provider == "flash_attention":
        return jax_ops.flash_attention(*a, causal=True, bq=config["bq"],
                                       bk=config["bk"], interpret=True)
    if provider == "decode_attention":
        length = bench.PRESETS[preset][provider][5]
        return jax_ops.decode_attention(*a, length, bk=config["bk"],
                                        interpret=True)
    return jax_ops.ssd(*a, chunk=config["chunk"], interpret=True)[0]


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("provider", ["decode_attention", "ssd_scan"])
def test_candidates_route_like_the_reference(preset, provider):
    """Each decode and ssd candidate through the port's ``ops`` with its
    block size, against the reference's kernel at the same config (every
    flash (bq, bk) is held in tests/test_torch_flash.py)."""
    for prov, config in _candidates(preset):
        if prov != provider:
            continue
        fn, args = bench._kernel_fn(provider, preset, config, "cpu")
        ref = _jax_candidate(provider, preset, config, args)
        np.testing.assert_allclose(fn(*args).numpy(), np.asarray(ref),
                                   atol=MAXERR[provider],
                                   rtol=MAXERR[provider])


@pytest.mark.parametrize("provider", ["flash_attention", "decode_attention",
                                      "ssd_scan"])
def test_time_rung_measures_and_validates_on_cpu(provider):
    """tests/test_fidelity.py:343, per provider, on the CPU: the value is
    the kernel's time, the ratio is consistent, maxerr is in tolerance,
    and every call went to the plain version."""
    counts = {"flash_attention": fa.COUNT, "decode_attention": da.COUNT,
              "ssd_scan": ssd_mod.COUNT}[provider]
    counts.reset()
    for prov, config in _candidates("tiny"):
        if prov != provider:
            continue
        r = bench.eval_kernel_time(
            _params(prov, "tiny", config, reps=2, device="cpu"), {})
        assert set(r) == {"value", "kernel_us", "ref_us", "ratio", "maxerr"}
        assert r["value"] == r["kernel_us"] > 0 and r["ref_us"] > 0
        assert r["ratio"] == pytest.approx(r["kernel_us"] / r["ref_us"])
        assert 0 <= r["maxerr"] < MAXERR[provider]
    n_cand = sum(p == provider for p, _ in _candidates("tiny"))
    assert counts.launches == 0
    assert counts.plain == n_cand * (1 + 2 + 1)     # warm-up, reps, maxerr


def test_time_rung_defaults_to_the_card():
    """No ``device`` param means cuda: without a card it raises, it never
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the cuda test covers this path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.eval_kernel_time(
            _params("ssd_scan", "tiny", {"chunk": 128}, reps=1), {})


def test_time_rung_runs_without_autograd(monkeypatch):
    from repro_torch.kernels import ops
    seen = []
    real = ops.ssd_scan
    monkeypatch.setattr(ops, "ssd_scan", lambda *a, **kw: seen.append(
        torch.is_grad_enabled()) or real(*a, **kw))
    bench.eval_kernel_time(_params("ssd_scan", "tiny", {"chunk": 64},
                                   reps=1, device="cpu"), {})
    assert seen and not any(seen)


def test_time_fn_uses_perf_counter_and_synced_warmup(monkeypatch):
    """tests/test_fidelity.py:352: the timer is never ``time.time``, and
    the warm-up is synchronised before the first timed rep; each rep is
    timed on its own."""
    events = []
    clock = iter(range(100))

    def perf_counter():
        events.append("tick")
        return float(next(clock))

    def wall_time():
        raise AssertionError("time.time() used in the timing harness")

    monkeypatch.setattr(bench, "time", types.SimpleNamespace(
        perf_counter=perf_counter, time=wall_time))
    monkeypatch.setattr(bench, "_sync", lambda device: events.append("sync"))
    out = bench.time_fn(lambda x: events.append("call"), torch.zeros(1),
                        reps=3)
    assert events == ["call", "sync"] + ["tick", "call", "sync", "tick"] * 3
    assert out == 1.0 * 1e6                     # every scripted rep: 1 s


def test_time_fn_reports_median_not_mean(monkeypatch):
    """tests/test_fidelity.py:381."""
    ticks = iter([0.0, 10.0, 100.0, 120.0, 200.0, 1000200.0])
    monkeypatch.setattr(bench, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks)))
    # durations 10 s, 20 s, 1e6 s: the outlier must not skew the result
    assert bench.time_fn(lambda: 0, reps=3) == 20.0 * 1e6

    ticks = iter([0.0, 1.0, 10.0, 12.0, 20.0, 23.0, 30.0, 130.0])
    monkeypatch.setattr(bench, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks)))
    # even rep count: mean of the middle pair (2 s, 3 s)
    assert bench.time_fn(lambda: 0, reps=4) == 2.5 * 1e6


@pytest.mark.cuda
def test_time_rung_on_card_launches_only_kernels():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device; the domain runs on the card in "
                    "chip_smoke.py")
    counts = (fa.COUNT, da.COUNT, ssd_mod.COUNT)
    for c in counts:
        c.reset()
    for provider, config in _candidates("tiny"):
        r = bench.eval_kernel_time(_params(provider, "tiny", config, reps=3),
                                   {})
        assert r["value"] == r["kernel_us"] > 0
        assert r["maxerr"] < MAXERR[provider]
    assert [c.launches for c in counts] == [9 * 5, 3 * 5, 3 * 5]
    assert [c.plain for c in counts] == [0, 0, 0]
