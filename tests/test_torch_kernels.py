"""The port's flash-decode against the Pallas kernel and the oracles.

On the CPU the wrapper runs its plain version; it is held here against
``repro.kernels.decode_attention`` in interpret mode (as
``tests/test_kernels.py`` runs it) on the same numpy inputs.  The CUDA
kernel itself is held against the plain version by the ``cuda`` tests,
which skip without a card, and by ``chip_smoke.py``.
"""
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.ref import decode_mha_ref as jax_decode_ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_mha_ref, mha_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CSRC = Path(da.__file__).parent / "csrc" / "decode_attention.cu"


def _inputs(B, Hq, Hkv, S, D, dt, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D), np.float32)
    k = rng.standard_normal((B, Hkv, S, D), np.float32)
    v = rng.standard_normal((B, Hkv, S, D), np.float32)
    if dt == "bfloat16":     # round once, so both packages see the same bits
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    return q, k, v


def _torch(a, dt):
    return torch.from_numpy(a).to(TORCH_DT[dt])


def _jax(a, dt):
    return jnp.asarray(a, getattr(jnp, dt))


def _close(out, ref, dt):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the three shapes of tests/test_kernels.py:78-82, then (B,) lengths and 0
@pytest.mark.parametrize("B,Hq,Hkv,S,D,length,dt", [
    (2, 8, 2, 1024, 64, 1000, "float32"),
    (1, 4, 4, 2048, 128, 1024, "bfloat16"),
    (1, 16, 2, 1024, 64, 17, "float32"),
    (3, 8, 2, 512, 64, (5, 512, 130), "float32"),
    (3, 4, 4, 512, 16, (1, 0, 300), "bfloat16"),
    (2, 4, 2, 512, 64, 0, "float32"),
])
def test_plain_matches_pallas_interpret(B, Hq, Hkv, S, D, length, dt):
    q, k, v = _inputs(B, Hq, Hkv, S, D, dt)
    ln = np.broadcast_to(np.asarray(length, np.int32), (B,)).copy()
    ref = jax_decode(_jax(q, dt), _jax(k, dt), _jax(v, dt), jnp.asarray(ln),
                     bk=512, interpret=True)
    da.COUNT.reset()
    out = ops.decode_attention(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                               torch.from_numpy(ln))
    assert out.dtype == TORCH_DT[dt] and out.shape == (B, Hq, D)
    assert (da.COUNT.launches, da.COUNT.plain) == (0, 1)
    _close(out.float(), ref, dt)


def test_plain_matches_reference_oracle_scalar_length():
    q, k, v = _inputs(2, 8, 2, 256, 64, "float32")
    ref = jax_decode_ref(_jax(q, "float32"), _jax(k, "float32"),
                         _jax(v, "float32"), length=100)
    out = da.decode_attention_plain(_torch(q, "float32"), _torch(k, "float32"),
                                    _torch(v, "float32"), 100)
    _close(out, ref, "float32")
    _close(decode_mha_ref(_torch(q, "float32"), _torch(k, "float32"),
                          _torch(v, "float32"), length=100), ref, "float32")


def test_torch_oracle_takes_per_slot_lengths():
    """The reference oracle raises on a (B,) length (ref.py:42); the port's
    accepts it and agrees with the Pallas kernel."""
    q, k, v = _inputs(3, 4, 2, 512, 64, "float32")
    ln = np.array([7, 512, 200], np.int32)
    with pytest.raises(Exception, match="Incompatible shapes"):
        jax_decode_ref(_jax(q, "float32"), _jax(k, "float32"),
                       _jax(v, "float32"), length=jnp.asarray(ln))
    ref = jax_decode(_jax(q, "float32"), _jax(k, "float32"),
                     _jax(v, "float32"), jnp.asarray(ln), interpret=True)
    out = decode_mha_ref(_torch(q, "float32"), _torch(k, "float32"),
                         _torch(v, "float32"), length=torch.from_numpy(ln))
    _close(out, ref, "float32")


def test_neg_inf_is_finite_and_length_zero_is_mean_of_v():
    """(a) NEG_INF is the finite -1e30; (b) length 0 gives the mean of v
    over all S, as the reference does (an -inf mask would give NaN)."""
    assert da.NEG_INF == -1e30 and np.isfinite(da.NEG_INF)
    assert "kNegInf = -1e30f" in CSRC.read_text()
    q, k, v = _inputs(2, 4, 2, 96, 16, "float32")
    out = da.decode_attention_plain(_torch(q, "float32"), _torch(k, "float32"),
                                    _torch(v, "float32"), 0)
    mean = v.mean(axis=2)                                  # (B, Hkv, D)
    want = np.repeat(mean, 2, axis=1)                      # G = 2
    np.testing.assert_allclose(out.numpy(), want, atol=2e-6)


def test_output_divides_by_guarded_sum():
    """(c) acc / max(l, 1e-30), in the plain version and in both CUDA
    kernels (split and combine)."""
    assert "clamp_min(1e-30)" in inspect.getsource(da.decode_attention_plain)
    src = CSRC.read_text()
    assert "acc_s[i] / fmaxf(l_s[g], 1e-30f)" in src
    assert "O / fmaxf(L, 1e-30f)" in src


@pytest.mark.parametrize("S,length", [(300, 257), (77, 77), (130, 0)])
def test_ragged_sequence_length(S, length):
    """(d) S need not be a multiple of a block size (the Pallas wrapper
    asserts S % bk == 0); held against the dense oracle."""
    q, k, v = _inputs(2, 8, 2, S, 64, "float32")
    args = [_torch(a, "float32") for a in (q, k, v)]
    out = ops.decode_attention(*args, length)
    _close(out, decode_mha_ref(*args, length=length), "float32")


def test_strided_cache_view_is_taken_as_is():
    """The model passes its (B,S,Hkv,D) cache as a transposed view."""
    rng = np.random.default_rng(0)
    cache_k = torch.from_numpy(rng.standard_normal((2, 64, 4, 16), np.float32))
    cache_v = torch.from_numpy(rng.standard_normal((2, 64, 4, 16), np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 8, 16), np.float32))
    ln = torch.tensor([9, 64], dtype=torch.int32)
    a = ops.decode_attention(q, cache_k.transpose(1, 2),
                             cache_v.transpose(1, 2), ln)
    b = ops.decode_attention(q, cache_k.transpose(1, 2).contiguous(),
                             cache_v.transpose(1, 2).contiguous(), ln)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad,exc", [
    ("dtype", TypeError), ("head_dim", ValueError), ("stride", ValueError),
    ("shape", ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    q = torch.zeros(2, 4, 64)
    k = torch.zeros(2, 2, 32, 64)
    v = torch.zeros(2, 2, 32, 64)
    if bad == "dtype":
        q = q.half()
    elif bad == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif bad == "stride":
        k = torch.zeros(2, 2, 64, 32).transpose(2, 3)
    else:
        q = torch.zeros(2, 3, 64)
    with pytest.raises(exc):
        ops.decode_attention(q, k, v, 4)


def test_mha_ref_matches_reference_oracle():
    from repro.kernels.ref import mha_ref as jax_mha_ref
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 4, 64, 16), np.float32)
    k = rng.standard_normal((1, 2, 64, 16), np.float32)
    v = rng.standard_normal((1, 2, 64, 16), np.float32)
    for causal, window in ((True, 0), (True, 8), (False, 0)):
        ref = jax_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, window=window)
        out = mha_ref(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), causal=causal, window=window)
        _close(out, ref, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,length,dt", [
    (2, 8, 2, 1024, 64, 1000, "float32"),
    (1, 4, 4, 2048, 128, 1024, "bfloat16"),
    (1, 16, 2, 1024, 64, 17, "float32"),
    (3, 8, 2, 300, 16, (0, 5, 300), "float32"),
    (8, 20, 20, 512, 128, (40, 90, 17, 64, 8, 96, 33, 71), "float32"),
])
def test_kernel_matches_plain_on_card(B, Hq, Hkv, S, D, length, dt):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device; compared against its plain version by "
                    "chip_smoke.py")
    q, k, v = (_torch(a, dt).cuda() for a in _inputs(B, Hq, Hkv, S, D, dt))
    ln = torch.tensor(np.broadcast_to(length, (B,)), dtype=torch.int32,
                      device="cuda")
    da.COUNT.reset()
    out = ops.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert da.COUNT.launches == 1 and da.COUNT.plain == 0
    _close(out.float().cpu(), da.decode_attention_plain(q, k, v, ln).cpu(), dt)
