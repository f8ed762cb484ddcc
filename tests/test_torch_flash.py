"""The port's flash attention against the Pallas kernel and the oracle.

On the CPU ``ops.flash_attention`` runs its plain version
(``kernels.ref.mha_ref``); it is held here against
``repro.kernels.flash_attention`` in interpret mode (as
``tests/test_kernels.py`` runs it) on the same numpy inputs.  The CUDA
kernel itself is held against the plain version by the ``cuda`` test,
which skips without a card, and by ``chip_smoke.py``.
"""
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.bench import PRESETS, _BLOCKS
from repro_torch.kernels.ref import mha_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CSRC = Path(fa.__file__).parent / "csrc" / "flash_attention.cu"


def _inputs(B, Hq, Hkv, Sq, D, dt, seed=0, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    q = rng.standard_normal((B, Hq, Sq, D), np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D), np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D), np.float32)
    if dt == "bfloat16":     # round once, so both packages see the same bits
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    return q, k, v


def _torch(a, dt="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TORCH_DT[dt])


def _jax(a, dt="float32"):
    return jnp.asarray(a, getattr(jnp, dt))


def _close(out, ref, dt):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SWEEP = [   # tests/test_kernels.py:17-25
    (2, 4, 4, 256, 64, True, 0, "float32"),
    (1, 8, 2, 256, 64, True, 0, "float32"),
    (1, 8, 2, 256, 64, True, 0, "bfloat16"),
    (2, 4, 2, 512, 128, True, 128, "float32"),
    (1, 4, 1, 256, 64, True, 0, "float32"),      # MQA
    (1, 4, 4, 256, 64, False, 0, "float32"),     # bidirectional
    (1, 2, 2, 384, 64, True, 0, "float32"),      # non-pow2 seq
]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window,dt", SWEEP)
def test_flash_matches_pallas_interpret(B, Hq, Hkv, S, D, causal, window,
                                        dt):
    q, k, v = _inputs(B, Hq, Hkv, S, D, dt)
    ref = jax_flash(_jax(q, dt), _jax(k, dt), _jax(v, dt), causal=causal,
                    window=window, bq=128, bk=128, interpret=True)
    fa.COUNT.reset()
    out = ops.flash_attention(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                              causal=causal, window=window, bq=128, bk=128)
    assert out.dtype == TORCH_DT[dt] and out.shape == (B, Hq, S, D)
    assert (fa.COUNT.launches, fa.COUNT.plain) == (0, 1)
    _close(out.float(), ref, dt)


def _preset_blocks():
    for preset in ("tiny", "small"):
        for bq in _BLOCKS[preset]["flash"]:
            for bk in _BLOCKS[preset]["flash"]:
                yield preset, bq, bk


@pytest.mark.parametrize("preset,bq,bk", list(_preset_blocks()))
def test_every_domain_block_matches_pallas(preset, bq, bk):
    """Every (bq, bk) of both presets of the kernel search domain, at the
    preset's shape, causal as the domain runs it."""
    B, Hq, Hkv, S, D = PRESETS[preset]["flash_attention"]
    q, k, v = _inputs(B, Hq, Hkv, S, D, "float32", seed=bq + bk)
    ref = jax_flash(_jax(q), _jax(k), _jax(v), causal=True, bq=bq, bk=bk,
                    interpret=True)
    out = ops.flash_attention(_torch(q), _torch(k), _torch(v), causal=True,
                              bq=bq, bk=bk)
    _close(out, ref, "float32")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 48)])
def test_mha_matches_reference_mha(causal, window):
    """``ops.mha`` on (B,S,H,D) tensors with GQA (G = 3) and a window,
    against the reference ``ops.mha``; the output is a contiguous
    (B,S,H,D) tensor."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 128, 6, 32), np.float32)
    k = rng.standard_normal((2, 128, 2, 32), np.float32)
    v = rng.standard_normal((2, 128, 2, 32), np.float32)
    ref = jax_ops.mha(_jax(q), _jax(k), _jax(v), causal=causal,
                      window=window, interpret=True)
    out = ops.mha(_torch(q), _torch(k), _torch(v), causal=causal,
                  window=window)
    assert out.shape == (2, 128, 6, 32) and out.is_contiguous()
    _close(out, ref, "float32")


def test_strided_views_are_taken_as_they_are():
    """q, k, v as transposed views of (B,S,H,D) tensors, and an ``out``
    view, give what contiguous tensors give."""
    q, k, v = (_torch(a).transpose(1, 2).contiguous().transpose(1, 2)
               for a in _inputs(1, 4, 2, 64, 32, "float32"))
    assert not q.is_contiguous()
    a = ops.flash_attention(q, k, v, window=16, bq=32, bk=16)
    b = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            window=16, bq=32, bk=16)
    out = torch.empty(1, 64, 4, 32).transpose(1, 2)
    c = fa.flash_attention(q, k, v, window=16, bq=32, bk=16, out=out)
    assert c is out and torch.equal(a, b) and torch.equal(a, c)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_attention_is_convex_combination(seed):
    """tests/test_kernels.py:97: max |o| <= max |v| (softmax weights sum
    to 1), against the port."""
    q, k, v = (_torch(a) for a in _inputs(1, 2, 2, 128, 32, "float32",
                                          seed=seed))
    o = ops.flash_attention(q, k, v, causal=True, bq=128, bk=128)
    assert float(o.abs().max()) <= float(v.abs().max()) + 1e-4


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_window_equals_causal_when_window_covers_seq(seed):
    """tests/test_kernels.py:111, against the port."""
    q, k, v = (_torch(a) for a in _inputs(1, 2, 2, 128, 32, "float32",
                                          seed=seed))
    a = ops.flash_attention(q, k, v, causal=True, window=0)
    b = ops.flash_attention(q, k, v, causal=True, window=128)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_row_with_every_key_masked_is_mean_of_v(causal):
    """Sq > Sk with a window: query rows q >= Sk + window - 1 keep no key.
    The finite -1e30 makes p = 1 for every key, so such a row is the mean
    of v over all Sk, in the reference and in the port (an -inf mask
    would give NaN)."""
    Sq, Sk, window = 256, 64, 32
    q, k, v = _inputs(1, 4, 2, Sq, 32, "float32", seed=7, Sk=Sk)
    ref = jax_flash(_jax(q), _jax(k), _jax(v), causal=causal, window=window,
                    bq=64, bk=32, interpret=True)
    out = ops.flash_attention(_torch(q), _torch(k), _torch(v), causal=causal,
                              window=window, bq=64, bk=32)
    _close(out, ref, "float32")
    dead = Sk + window - 1
    mean = np.repeat(v.mean(axis=2), 2, axis=1)[:, :, None]   # G = 2
    np.testing.assert_allclose(out[:, :, dead:].numpy(),
                               np.broadcast_to(mean, out[:, :, dead:].shape),
                               atol=2e-6)
    assert not np.allclose(out[:, :, dead - 1].numpy(), mean[:, :, 0])


def test_kernel_source_keeps_the_reference_numerics():
    """Masked scores are the finite -1e30, the output divides by
    max(l, 1e-30), p stays f32 for p.v, and the plain version is
    ``mha_ref``."""
    src = CSRC.read_text()
    assert "constexpr float kNegInf = -1e30f;" in src
    assert "l = fmaxf(l_s[row], 1e-30f)" in src and "acc[r][c] / l" in src
    assert "fmaf(pv[r], vv[c], acc[r][c])" in src
    assert "pallas_call at :93" in src
    assert "mha_ref(q, k, v, causal=causal, window=window)" in \
        inspect.getsource(fa.flash_attention)


@pytest.mark.parametrize("bad,exc", [
    ("Sq % bq", ValueError), ("Sk % bk", ValueError), ("dtype", TypeError),
    ("Hq % Hkv", ValueError), ("head_dim", ValueError),
    ("stride", ValueError), ("window", ValueError), ("shape", ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    q, k, v = torch.zeros(1, 4, 96, 64), torch.zeros(1, 2, 96, 64), \
        torch.zeros(1, 2, 96, 64)
    kw = dict(bq=32, bk=32)
    if bad == "Sq % bq":
        kw["bq"] = 64
    elif bad == "Sk % bk":
        k, v, kw["bk"] = k[:, :, :80], v[:, :, :80], 64
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "Hq % Hkv":
        q = torch.zeros(1, 3, 96, 64)
    elif bad == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif bad == "stride":
        k = torch.zeros(1, 2, 64, 96).transpose(2, 3)
    elif bad == "window":
        kw["window"] = -1
    else:
        v = torch.zeros(1, 2, 95, 64)
    with pytest.raises(exc):
        ops.flash_attention(q, k, v, **kw)


def test_blocks_are_cut_to_the_sequence():
    """bq = min(bq, Sq), bk = min(bk, Sk), as in the reference: S = 96 runs
    with the default 128 blocks."""
    q, k, v = (_torch(a) for a in _inputs(1, 2, 1, 96, 32, "float32"))
    ref = jax_flash(*(_jax(a.numpy()) for a in (q, k, v)), interpret=True)
    _close(ops.flash_attention(q, k, v), ref, "float32")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrapper_raises_under_autograd(device):
    """No backward: with grad enabled and an input that requires it, the
    wrapper raises before it looks at the device; under no_grad it runs."""
    q, k, v = (_torch(a).to(device) for a in
               _inputs(1, 2, 1, 64, 32, "float32"))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    if device == "cpu":
        with torch.no_grad():
            ops.flash_attention(q, k, v)


def test_cpu_counts_plain_and_never_launches():
    q, k, v = (_torch(a) for a in _inputs(1, 2, 1, 64, 32, "float32"))
    fa.COUNT.reset()
    ops.flash_attention(q, k, v, bq=32, bk=32)
    ops.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert (fa.COUNT.launches, fa.COUNT.plain) == (0, 2)
    a = fa.flash_attention(q, k, v, causal=False, window=8)
    np.testing.assert_array_equal(
        a.numpy(), mha_ref(q, k, v, causal=False, window=8).numpy())
    assert fa.COUNT.plain == 3


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,bq,bk,dt", [
    (2, 4, 4, 256, 256, 64, True, 0, 128, 128, "float32"),
    (1, 8, 2, 256, 256, 64, True, 0, 128, 128, "bfloat16"),
    (2, 4, 2, 512, 512, 128, True, 128, 128, 128, "float32"),
    (1, 4, 4, 256, 256, 64, False, 0, 32, 256, "float32"),
    (1, 2, 1, 128, 128, 32, True, 0, 32, 32, "float32"),
    (1, 4, 2, 256, 64, 32, True, 32, 64, 32, "float32"),
    (1, 4, 2, 512, 512, 128, True, 0, 256, 256, "bfloat16"),
])
def test_kernel_matches_plain_on_card(B, Hq, Hkv, Sq, Sk, D, causal, window,
                                      bq, bk, dt):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device; compared against its plain version by "
                    "chip_smoke.py")
    q, k, v = (_torch(a, dt).cuda()
               for a in _inputs(B, Hq, Hkv, Sq, D, dt, Sk=Sk))
    fa.COUNT.reset()
    out = ops.flash_attention(q, k, v, causal=causal, window=window, bq=bq,
                              bk=bk)
    torch.cuda.synchronize()
    assert fa.COUNT.launches == 1 and fa.COUNT.plain == 0
    _close(out.float().cpu(),
           mha_ref(q, k, v, causal=causal, window=window).float().cpu(), dt)
