"""The port's flash-decode and SSD scan against the Pallas kernels and the
oracles.

On the CPU each wrapper runs its plain version; it is held here against
``repro.kernels.decode_attention`` and ``repro.kernels.ssd_scan`` in
interpret mode (as ``tests/test_kernels.py`` runs them) on the same numpy
inputs.  The CUDA kernels themselves are held against the plain versions
by the ``cuda`` tests, which skip without a card, and by ``chip_smoke.py``.
"""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.ref import decode_mha_ref as jax_decode_ref
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import decode_mha_ref, mha_ref, ssd_ref

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
    # hubert-xlarge's and zamba2-7b's head dims, instances on the card
    (2, 8, 2, 512, 80, 300, "float32"),
    (2, 8, 2, 512, 80, (1, 512), "bfloat16"),
    (2, 8, 2, 512, 112, 300, "float32"),
    (2, 8, 2, 512, 112, (1, 512), "bfloat16"),
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
    """(c) acc / max(l, 1e-30), in the plain version, the partition's
    emulation and the CUDA kernel.  In the kernel the output's one store
    divides by the guarded sum (``write_out``), and both paths that write
    the output call it: a single working range, and the last block's
    combine of the ranges."""
    assert "clamp_min(1e-30)" in inspect.getsource(da.decode_attention_plain)
    assert "clamp_min(1e-30)" in inspect.getsource(da.decode_split_ref)
    src = CSRC.read_text()
    stores = re.findall(r"\bstore\((?!float\*|__nv_bfloat16\*)[^;]*;", src)
    assert stores == ["store(o, acc / fmaxf(l, 1e-30f));"]
    assert src.count("write_out(out + ") == 2


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
        # on CPU tensors any D runs the plain version; the kernel has no
        # D = 48 instance, so it is refused where the kernel would run,
        # here a meta tensor
        q, k, v = (t[..., :48].to("meta") for t in (q, k, v))
    elif bad == "stride":
        k = torch.zeros(2, 2, 64, 32).transpose(2, 3)
    else:
        q = torch.zeros(2, 3, 64)
    with pytest.raises(exc, match="head dim" if bad == "head_dim" else None):
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
    # G = 8 (llama-3.2-vision's), and lengths at and near S
    (2, 16, 2, 1000, 128, (999, 1000), "float32"),
    (3, 64, 8, 4096, 128, (4095, 4096, 1), "bfloat16"),
    (2, 40, 8, 700, 112, (699, 700), "float32"),
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


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [None, 256, 128, 64, 32])
def test_kernel_at_head_dim_32_and_every_bk_on_card(bk):
    """D = 32 (the domain's tiny preset) with the SM split and with the
    reference's bk, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device; compared against its plain version by "
                    "chip_smoke.py")
    q, k, v = (_torch(a, "float32").cuda()
               for a in _inputs(2, 4, 2, 256, 32, "float32"))
    ln = torch.tensor([200, 0], dtype=torch.int32, device="cuda")
    da.COUNT.reset()
    out = ops.decode_attention(q, k, v, ln, bk=bk)
    torch.cuda.synchronize()
    assert da.COUNT.launches == 1 and da.COUNT.plain == 0
    _close(out.cpu(), da.decode_attention_plain(q, k, v, ln).cpu(), "float32")


def _domain_decode_cases():
    """Every bk of both presets of the kernel search domain
    (``repro_torch.kernels.bench``), at the preset's shape and length."""
    from repro_torch.kernels.bench import PRESETS, _BLOCKS
    for preset in ("tiny", "small"):
        for bk in _BLOCKS[preset]["decode"]:
            yield (*PRESETS[preset]["decode_attention"], bk)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,length,bk", list(_domain_decode_cases()))
def test_block_size_matches_pallas_interpret(B, Hq, Hkv, S, D, length, bk):
    """The reference's ``bk``, D = 32 included (the tiny preset)."""
    q, k, v = _inputs(B, Hq, Hkv, S, D, "float32", seed=bk)
    ref = jax_decode(_jax(q, "float32"), _jax(k, "float32"),
                     _jax(v, "float32"), length, bk=bk, interpret=True)
    da.COUNT.reset()
    out = ops.decode_attention(_torch(q, "float32"), _torch(k, "float32"),
                               _torch(v, "float32"), length, bk=bk)
    assert (da.COUNT.launches, da.COUNT.plain) == (0, 1)
    _close(out, ref, "float32")


@pytest.mark.parametrize("bk,exc", [(96, ValueError), (0, ValueError),
                                    (4096, None), (None, None)])
def test_block_size_is_checked_as_the_reference_asserts(bk, exc):
    """bk = min(bk, S) must divide S; None is the split by SM count."""
    q, k, v = (_torch(a, "float32") for a in
               _inputs(1, 4, 2, 256, 32, "float32"))
    if exc is not None:
        with pytest.raises(exc):
            ops.decode_attention(q, k, v, 100, bk=bk)
        return
    _close(ops.decode_attention(q, k, v, 100, bk=bk),
           decode_mha_ref(q, k, v, length=100), "float32")


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------
SSD_SRC = Path(ssd_mod.__file__).parent / "csrc" / "ssd_scan.cu"
SSD_SWEEP = [   # tests/test_kernels.py:39-43
    (2, 256, 3, 64, 32, 64, "float32"),
    (1, 512, 2, 64, 64, 128, "float32"),
    (2, 256, 4, 32, 16, 128, "bfloat16"),
    (1, 128, 1, 16, 8, 32, "float32"),
]


def _ssd_inputs(B, L, H, P, N, dt, seed=1, a_scale=0.3, d_dt="float32"):
    """As tests/test_kernels.py:45-51, from numpy; D random, not ones."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, L, H, P), np.float32)
    dtv = 0.5 * np.log1p(np.exp(rng.standard_normal((B, L, H)))
                         ).astype(np.float32)
    A = -np.exp(a_scale * rng.standard_normal(H)).astype(np.float32)
    Bm = 0.3 * rng.standard_normal((B, L, N), np.float32)
    Cm = 0.3 * rng.standard_normal((B, L, N), np.float32)
    D = 1 + 0.2 * rng.standard_normal(H).astype(np.float32)
    if dt == "bfloat16":     # round once, so both packages see the same bits
        x, Bm, Cm = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                     for a in (x, Bm, Cm))
    if d_dt == "bfloat16":
        D = np.asarray(jnp.asarray(D, jnp.bfloat16), np.float32)
    return x, dtv, A, Bm, Cm, D


def _ssd_pair(B, L, H, P, N, chunk, dt, d_dt="float32", **kw):
    x, dtv, A, Bm, Cm, D = _ssd_inputs(B, L, H, P, N, dt, d_dt=d_dt, **kw)
    yj, sj = jax_ssd_scan(_jax(x, dt), jnp.asarray(dtv), jnp.asarray(A),
                          _jax(Bm, dt), _jax(Cm, dt), _jax(D, d_dt),
                          chunk=chunk, interpret=True)
    ssd_mod.COUNT.reset()
    yt, st = ops.ssd(_torch(x, dt), torch.from_numpy(dtv), torch.from_numpy(A),
                     _torch(Bm, dt), _torch(Cm, dt), _torch(D, d_dt),
                     chunk=chunk)
    assert (ssd_mod.COUNT.launches, ssd_mod.COUNT.plain) == (0, 1)
    assert yt.dtype == TORCH_DT[dt] and st.dtype == torch.float32
    assert yt.shape == (B, L, H, P) and st.shape == (B, H, P, N)
    return (yj, sj), (yt, st)


@pytest.mark.parametrize("B,L,H,P,N,chunk,dt", SSD_SWEEP + [
    (1, 128, 2, 80, 16, 64, "float32"),      # P above the CUDA kernel's 64
    (1, 128, 2, 16, 160, 64, "float32")])    # N above its 128
def test_ssd_plain_matches_pallas_interpret(B, L, H, P, N, chunk, dt):
    """y at 5 x TOL, state at 1e-4, as tests/test_kernels.py:53-57; on CPU
    tensors at any P and N, as the Pallas kernel."""
    (yj, sj), (yt, st) = _ssd_pair(B, L, H, P, N, chunk, dt)
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               atol=5 * TOL[dt], rtol=5 * TOL[dt])
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_ssd_plain_takes_bf16_D(dt):
    """The model's precast turns the stacked (L, H) D into bf16, so D
    reaches the kernel in bf16 while x may be either."""
    (yj, sj), (yt, st) = _ssd_pair(2, 128, 2, 16, 8, 32, dt,
                                   d_dt="bfloat16")
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               atol=5 * TOL[dt], rtol=5 * TOL[dt])
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4,
                               rtol=1e-4)


def test_ssd_plain_is_finite_where_the_upper_triangle_overflows():
    """A = -e (A_log = 1, as the model's init) and large steps: cum falls
    to about -500 across a 256-chunk, so exp(cum_q - cum_s) above the
    diagonal is inf.  Selecting (not masking by a product) keeps y finite
    and equal to the reference."""
    x, dtv, A, Bm, Cm, D = _ssd_inputs(1, 256, 2, 16, 8, "float32")
    A[:] = -np.e
    dtv = dtv + 0.5
    args_j = [jnp.asarray(a) for a in (x, dtv, A, Bm, Cm, D)]
    yj, sj = jax_ssd_scan(*args_j, chunk=256, interpret=True)
    ssd_mod.COUNT.reset()
    yt, st = ops.ssd(*(torch.from_numpy(a) for a in (x, dtv, A, Bm, Cm, D)),
                     chunk=256)
    cum = np.cumsum(dtv[0, :, 0] * A[0])
    assert cum[0] - cum[-1] > 400        # exp overflows f32 above 88.7
    assert torch.isfinite(yt).all() and torch.isfinite(st).all()
    tol = 5 * TOL["float32"]
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=tol, rtol=tol)


def test_ssd_chunk_invariance():
    """tests/test_kernels.py:60: chunk 64 and 256 give the same y."""
    args = [torch.from_numpy(a)
            for a in _ssd_inputs(1, 256, 2, 32, 16, "float32", seed=2)]
    y64, s64 = ops.ssd(*args, chunk=64)
    y256, s256 = ops.ssd(*args, chunk=256)
    np.testing.assert_allclose(y64.numpy(), y256.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(s64.numpy(), s256.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_ssd_ref_matches_reference_oracle():
    x, dtv, A, Bm, Cm, D = _ssd_inputs(2, 128, 3, 16, 8, "float32", seed=3)
    yj, sj = jax_ssd_ref(*(jnp.asarray(a) for a in (x, dtv, A, Bm, Cm, D)),
                         chunk=32)
    yt, st = ssd_ref(*(torch.from_numpy(a) for a in (x, dtv, A, Bm, Cm, D)),
                     chunk=32)
    tol = 5 * TOL["float32"]
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=tol, rtol=tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4,
                               rtol=1e-4)


def _model_views(B, L, H, P, N, dt, seed=4):
    """x, Bm, Cm as the strided slices ``mamba_block`` makes of its conv
    output (B, L, H*P + 2N), and the other inputs."""
    rng = np.random.default_rng(seed)
    conv = torch.from_numpy(
        0.4 * rng.standard_normal((B, L, H * P + 2 * N), np.float32)
    ).to(TORCH_DT[dt])
    di = H * P
    x = conv[..., :di].reshape(B, L, H, P)
    Bm, Cm = conv[..., di:di + N], conv[..., di + N:]
    dtv = torch.from_numpy(0.5 * np.log1p(np.exp(rng.standard_normal(
        (B, L, H)))).astype(np.float32))
    A = torch.from_numpy(-np.exp(0.3 * rng.standard_normal(H)
                                 ).astype(np.float32))
    D = torch.from_numpy(1 + 0.2 * rng.standard_normal(H).astype(np.float32))
    return x, dtv, A, Bm, Cm, D


def test_ssd_takes_the_model_strided_views_as_they_are():
    x, dtv, A, Bm, Cm, D = _model_views(2, 64, 3, 16, 8, "float32")
    assert not x.is_contiguous() and Bm.stride(1) == 3 * 16 + 16
    a = ops.ssd(x, dtv, A, Bm, Cm, D, chunk=16)
    b = ops.ssd(x.contiguous(), dtv, A, Bm.contiguous(), Cm.contiguous(), D,
                chunk=16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("bad,exc", [
    ("x dtype", TypeError), ("dt dtype", TypeError), ("shape", ValueError),
    ("ragged L", ValueError), ("stride", ValueError),
    ("head dim", ValueError), ("state", ValueError)])
def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    x, dtv, A, Bm, Cm, D = (torch.from_numpy(a) for a in
                            _ssd_inputs(1, 64, 2, 16, 8, "float32"))
    chunk = 16
    if bad == "x dtype":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif bad == "dt dtype":
        dtv = dtv.to(torch.bfloat16)
    elif bad == "shape":
        Cm = Cm[:, :32]
    elif bad == "ragged L":
        chunk = 24
    elif bad == "stride":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "head dim":
        # CPU tensors run the plain version at any P and N; the kernel's
        # limits hold where it would run, here on meta tensors
        x, dtv, A, Bm, Cm, D = (t.to("meta") for t in (
            torch.zeros(1, 64, 2, 80), dtv, A, Bm, Cm, D))
    else:
        x, dtv, A, Bm, Cm, D = (t.to("meta") for t in (
            x, dtv, A, torch.zeros(1, 64, 136), torch.zeros(1, 64, 136), D))
    with pytest.raises(exc, match="exceed" if bad in ("head dim", "state")
                       else None):
        ops.ssd(x, dtv, A, Bm, Cm, D, chunk=chunk)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_ssd_wrapper_raises_under_autograd(device):
    """No backward yet: with grad enabled and an input that requires it,
    the wrapper raises before it looks at the device; under no_grad it
    runs."""
    x, dtv, A, Bm, Cm, D = (torch.from_numpy(a).to(device) for a in
                            _ssd_inputs(1, 32, 2, 16, 8, "float32"))
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd(x, dtv, A, Bm, Cm, D, chunk=16)
    if device == "cpu":
        with torch.no_grad():
            ops.ssd(x, dtv, A, Bm, Cm, D, chunk=16)


def test_ssd_kernel_selects_the_upper_triangle():
    """The CUDA source selects exp(cum_q - cum_s) where s <= q (a ternary),
    never multiplies by a 0/1 mask."""
    src = SSD_SRC.read_text()
    assert "keep ? g[i][j] * expf(cum_s[q] - cum_s[s]) : 0.f" in src
    assert "? g[e] * expf(cum_q[i] - cum_s[key]) * dt_s[key]" in src
    assert "pallas_call at :80" in src


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N,chunk,dt", SSD_SWEEP + [
    (8, 512, 24, 64, 128, 256, "bfloat16")])
def test_ssd_kernel_matches_plain_on_card(B, L, H, P, N, chunk, dt):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device; compared against its plain version by "
                    "chip_smoke.py")
    x, dtv, A, Bm, Cm, D = _model_views(B, L, H, P, N, dt)
    args = [t.cuda() for t in (x, dtv, A, Bm, Cm, D)]
    ssd_mod.COUNT.reset()
    y, s = ops.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.COUNT.launches == 1 and ssd_mod.COUNT.plain == 0
    inst = ssd_mod.instance_for(args[0], args[3], args[4], chunk)
    assert (ssd_mod.COUNT.wgmma, ssd_mod.COUNT.tf32) == (inst == "wgmma",
                                                         inst == "tf32")
    yp, sp = ssd_ref(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), yp.float(), atol=5 * TOL[dt],
                               rtol=5 * TOL[dt])
    torch.testing.assert_close(s, sp, atol=1e-4, rtol=1e-4)


def test_library_path_covers_headers(tmp_path, monkeypatch):
    """The built library's name hashes the source, every ``csrc/*.cuh`` and
    the flags: an edited header, a new one or new flags give a new path, so
    a stale library is never loaded; an unchanged tree gives the same."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "g.cuh").write_text("// another header\n")
    assert build.library_path("k") not in (first, second)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("k") not in (first, second)
