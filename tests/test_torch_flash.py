"""The port's flash attention against the Pallas kernel and the oracle.

On the CPU ``ops.flash_attention`` runs its plain version
(``kernels.ref.mha_ref``); it is held here against
``repro.kernels.flash_attention`` in interpret mode (as
``tests/test_kernels.py`` runs it) on the same numpy inputs, and the
bfloat16 tensor-core kernel's numerics (bf16(p) + bf16(p - bf16(p)) for
p.v) are emulated here and held against both.  The CUDA kernels
themselves are held against the plain version by the ``cuda`` test,
which skips without a card, and by ``chip_smoke.py``.
"""
import inspect
import re
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
# head dims outside the instances (on the card 48, 80 and 112 are
# zero-padded to one, 256 has its own): hubert-xlarge, zamba2-7b, gemma-7b
HEAD_DIM_SWEEP = [(1, 4, 2, 128, D, True, 0, dt) for D in (48, 80, 112, 256)
                  for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window,dt",
                         SWEEP + HEAD_DIM_SWEEP)
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
    """The kernels keep the reference's numerics: masked scores are the
    finite -1e30 and the output divides by max(l, 1e-30).  The bfloat16
    kernel adds p.v as p_hi.V + p_lo.V into one f32 accumulator, with
    p_hi = bf16(p) and p_lo = bf16(p - p_hi).  The float32 tensor-core
    kernel forms q.k and p.v each as three tf32 products into one f32
    accumulator (big.big + big.small + small.big, big = tf32(x) by
    cvt.rna, small = tf32(x - big)), p.v per piece in an accumulator of
    its own that an f32 FMA adds to acc; at D = 256 its two consumer
    warpgroups each own 128 columns of D and add their partial scores.
    The CUDA-core kernel (what TMA cannot read) keeps p f32, unchanged.  The
    caller names the kernel and the C side only checks it; the instance
    rule ``kernel_for`` picks it from dtype, head dim and alignment.  The
    bfloat16 kernel has a D = 256 instance (p.v as m64n256k16 with p from
    registers); the CUDA-core kernel keeps its bfloat16 instance at
    D = 256 alone, for layouts TMA cannot read; the plain version is
    ``mha_ref``."""
    src = CSRC.read_text()
    hopper = (CSRC.parent / "hopper.cuh").read_text()
    assert "constexpr float kNegInf = -1e30f;" in src
    assert "pallas_call at :93" in src
    # both tensor-core kernels (the float32 one's D = 256 body too): the
    # guarded divide of the accumulator
    assert src.count("const float li = fmaxf(l[i], 1e-30f);") == 3
    assert "acc[cb * 4 + 2 * i] / li" in src
    # bfloat16: the hi + lo split, two wgmmas into acc
    assert "const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);" in src
    assert ("__floats2bfloat162_rn(x0 - __low2float(h),\n"
            "                                                 x1 - "
            "__high2float(h));") in src
    assert re.search(r"Wgmma<D>::rs_tb\(acc, p_hi\[j\]\[ks\], vd\);\s*"
                     r"Wgmma<D>::rs_tb\(acc, p_lo\[j\]\[ks\], vd\);", src)
    # float32 on the tensor cores: big = tf32(x), small = tf32(x - big),
    # three products into one accumulator for q.k and for p.v
    assert 'asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));' in hopper
    assert "small = tf32_rna(x - __uint_as_float(big));" in hopper
    assert re.search(
        r"WgmmaTf32<N>::ss\(s\[j\], kmajor\(qb_addr \+ qo\), "
        r"kmajor\(kb_addr \+ ko\),\s*kk > 0\);\s*"
        r"WgmmaTf32<N>::ss\(s\[j\], kmajor\(qb_addr \+ qo\), "
        r"kmajor\(ks_addr \+ ko\),\s*1\);\s*"
        r"WgmmaTf32<N>::ss\(s\[j\], kmajor\(qs_addr \+ qo\), "
        r"kmajor\(kb_addr \+ ko\),\s*1\);", src)
    assert re.search(
        r"WgmmaTf32<D>::rs\(pv, big\[0\], [^;]*kmajor\(vb_addr \+ vo\), "
        r"j > 0 \|\| ks > 0\);\s*WgmmaTf32<D>::rs\(pv, big\[0\], [^;]*"
        r"kmajor\(vsm_addr \+ vo\), 1\);\s*WgmmaTf32<D>::rs\(pv, sml\[0\], "
        r"[^;]*kmajor\(vb_addr \+ vo\), 1\);", src)
    # each piece's p.v in an accumulator of its own, folded in by an FMA
    assert "acc[e] = fmaf(acc[e], alpha[(e / 2) % 2], pv[e]);" in src
    # float32 at D = 256: the same three products over each warpgroup's
    # 128 columns of D, the two partial scores added in both warpgroups,
    # each V column block's p.v in its own accumulator, then the FMA
    assert re.search(
        r"WgmmaTf32<BKC>::ss\(s, kmajor\(qb_u \+ qo\), "
        r"kmajor\(kb_addr \+ ko\),\s*u > 0 \|\| kk > 0\);\s*"
        r"WgmmaTf32<BKC>::ss\(s, kmajor\(qb_u \+ qo\), "
        r"kmajor\(ks_addr \+ ko\),\s*1\);\s*"
        r"WgmmaTf32<BKC>::ss\(s, kmajor\(qs_u \+ qo\), "
        r"kmajor\(kb_addr \+ ko\),\s*1\);", src)
    assert "const float4 y = x_other[j * NT + ct];" in src
    assert "s[4 * j] += y.x;" in src
    assert re.search(
        r"WgmmaTf32<64>::rs\(pv, big\[0\], [^;]*"
        r"kmajor\(vb_addr \+ vo\), v % VH > 0 \|\| ks > 0\);\s*"
        r"WgmmaTf32<64>::rs\(pv, big\[0\], [^;]*kmajor\(vsm_addr \+ vo\), "
        r"1\);\s*WgmmaTf32<64>::rs\(pv, sml\[0\], [^;]*"
        r"kmajor\(vb_addr \+ vo\), 1\);", src)
    for pair in (0, 1):
        assert (f"acc[{pair}][e] = fmaf(acc[{pair}][e], alpha[(e / 2) % 2], "
                "pv[e]);") in src
    # the CUDA-core kernel as it was
    assert "l = fmaxf(l_s[row], 1e-30f)" in src and "acc[r][c] / l" in src
    assert "fmaf(pv[r], vv[c], acc[r][c])" in src
    # the kernel named by the caller
    assert "if (kernel == 2)\n    return tf::run(" in src
    assert "if (kernel == 1)\n    return wg::run(" in src
    assert "if (dtype == 0)\n    return dispatch<float>(" in src
    assert "  return launch_d<__nv_bfloat16, 256>(" in src
    assert "dispatch<__nv_bfloat16>" not in src
    # bfloat16 at D = 256 on the tensor cores: its instances, its wgmma
    assert "return (D == 32 || D == 64 || D == 128 || D == 256) && bq >= 1" \
        in src
    assert re.search(r"default:\s*return dispatch_bk<256>\(", src)
    assert "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16" in hopper
    assert "rs_tb(float (&d)[128]," in hopper
    assert "mha_ref(q, k, v, causal=causal, window=window)" in \
        inspect.getsource(fa.flash_attention)
    assert "kernel_for(q, k, v, out)" in inspect.getsource(fa.flash_attention)


def _split_p_flash(q, k, v, *, causal, window, bq, bk, split=True,
                   width=None):
    """The bfloat16 kernel's numerics, emulated in float32 on the CPU:
    q.k of bf16 values with f32 sums, the reference's online softmax per
    (bq, bk) tile with the finite -1e30 mask (``width``: once per piece of
    that many keys of each tile instead, the last piece cut at the tile's
    end, as ``fa.piece_width`` gives the kernel's), and p.v as
    bf16(p).v + bf16(p - bf16(p)).v into an f32 accumulator
    (``split=False``: bf16(p) alone).  Returns the output before its
    rounding to bf16."""
    B, Hq, Sq, D = q.shape
    Sk, G = k.shape[2], Hq // k.shape[1]
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    out = torch.empty(B, Hq, Sq, D)
    for q0 in range(0, Sq, bq):
        qpos = torch.arange(q0, q0 + bq)[:, None]
        acc = torch.zeros(B, Hq, bq, D)
        m = torch.full((B, Hq, bq, 1), -1e30)
        l = torch.zeros(B, Hq, bq, 1)
        pieces = [(c0, min(c0 + (width or bk), t0 + bk))
                  for t0 in range(0, Sk, bk)
                  for c0 in range(t0, t0 + bk, width or bk)]
        for k0, k1 in pieces:
            kpos = torch.arange(k0, k1)[None, :]
            s = q[:, :, q0:q0 + bq] @ k[:, :, k0:k1].transpose(2, 3)
            s = s * (1.0 / np.sqrt(D))
            keep = torch.ones(bq, k1 - k0, dtype=torch.bool)
            if causal:
                keep = kpos <= qpos
            if window:
                keep = keep & (kpos > qpos - window)
            s = torch.where(keep, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            p_hi = p.bfloat16().float()
            vt = v[:, :, k0:k1]
            acc = acc * alpha + p_hi @ vt
            if split:
                acc = acc + (p - p_hi).bfloat16().float() @ vt
            m = m_new
        out[:, :, q0:q0 + bq] = acc / torch.clamp(l, min=1e-30)
    return out


def _exact(q, k, v, *, causal, window):
    """mha_ref's function in float64."""
    q, k, v = (torch.from_numpy(a).double() for a in (q, k, v))
    return mha_ref(q, k, v, causal=causal, window=window)


SPLIT_BOUND = 1e-5   # f32 output vs float64; the split keeps ~16 bits of p
SPLIT_DIFF_SHARE = 0.02   # bf16 outputs that differ from mha_ref's, at most


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (256, 256, True, 0), (256, 256, True, 48), (256, 256, False, 0),
    (256, 64, True, 32)])
def test_split_p_numerics_contract(Sq, Sk, causal, window):
    """The design's numerics contract, on bf16 inputs: before rounding,
    the split-p output is within SPLIT_BOUND of the exact function (bf16
    p alone, SDPA's choice, is not: it misses by over ten times that);
    rounded to bf16 it agrees with ``mha_ref`` and with the Pallas kernel
    in interpret mode at the bf16 tolerance, and at most SPLIT_DIFF_SHARE
    of its outputs differ from ``mha_ref``'s, a limit bf16 p alone
    exceeds (``chip_smoke.py`` holds the kernel to the same share)."""
    q, k, v = _inputs(1, 4, 2, Sq, 64, "bfloat16", seed=Sq + Sk + window,
                      Sk=Sk)
    kw = dict(causal=causal, window=window)
    exact = _exact(q, k, v, **kw)
    split = _split_p_flash(q, k, v, bq=64, bk=32, **kw)
    err = (split.double() - exact).abs().max().item()
    assert err < SPLIT_BOUND
    hi_only = _split_p_flash(q, k, v, bq=64, bk=32, split=False, **kw)
    assert (hi_only.double() - exact).abs().max().item() > 10 * SPLIT_BOUND
    out = split.bfloat16()
    plain = mha_ref(_torch(q, "bfloat16"), _torch(k, "bfloat16"),
                    _torch(v, "bfloat16"), **kw).float()
    _close(out.float(), plain, "bfloat16")
    assert (out.float() != plain).float().mean().item() <= SPLIT_DIFF_SHARE
    assert (hi_only.bfloat16().float() != plain).float().mean().item() > \
        SPLIT_DIFF_SHARE
    ref = jax_flash(_jax(q, "bfloat16"), _jax(k, "bfloat16"),
                    _jax(v, "bfloat16"), bq=64, bk=32, interpret=True, **kw)
    _close(out.float(), ref, "bfloat16")


@pytest.mark.parametrize("Sq,Sk,causal,window,bq,bk", [
    (256, 256, True, 0, 128, 128), (256, 256, True, 48, 64, 64),
    (128, 200, False, 0, 64, 100), (256, 64, True, 32, 128, 32)])
def test_split_p_numerics_at_head_dim_256(Sq, Sk, causal, window, bq, bk):
    """The bfloat16 kernel at D = 256 updates the softmax once per piece
    of ``fa.piece_width(bk, 256)`` keys (64 at most; bk = 100 is a 64-key
    piece and a 36-key one): that split-p output, before rounding, is
    within SPLIT_BOUND of the exact function, and bf16 p alone misses by
    over ten times that; rounded to bf16 it agrees with ``mha_ref`` at
    the bf16 tolerance and in all but SPLIT_DIFF_SHARE of its outputs."""
    q, k, v = _inputs(1, 2, 1, Sq, 256, "bfloat16", seed=Sq + Sk + bk,
                      Sk=Sk)
    kw = dict(causal=causal, window=window)
    width = fa.piece_width(bk, 256)
    assert width == (32 if bk == 32 else 64)
    exact = _exact(q, k, v, **kw)
    split = _split_p_flash(q, k, v, bq=bq, bk=bk, width=width, **kw)
    assert (split.double() - exact).abs().max().item() < SPLIT_BOUND
    hi_only = _split_p_flash(q, k, v, bq=bq, bk=bk, width=width,
                             split=False, **kw)
    assert (hi_only.double() - exact).abs().max().item() > 10 * SPLIT_BOUND
    plain = mha_ref(_torch(q, "bfloat16"), _torch(k, "bfloat16"),
                    _torch(v, "bfloat16"), **kw).float()
    out = split.bfloat16().float()
    _close(out, plain, "bfloat16")
    assert (out != plain).float().mean().item() <= SPLIT_DIFF_SHARE
    if Sq > Sk:     # rows Sk + window - 1 .. keep no key: the mean of v
        dead = Sk + window - 1
        mean = np.repeat(v.mean(axis=2), 2, axis=1)[:, :, None]
        np.testing.assert_allclose(
            split[:, :, dead:].numpy(),
            np.broadcast_to(mean, split[:, :, dead:].shape), atol=1e-5)


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
        # any D up to 256 runs (padded to an instance; on CPU tensors any
        # D runs the plain version): one above the largest instance is
        # refused where the kernel would run, here a meta tensor
        q, k, v = (torch.zeros(t.shape[:3] + (300,), device="meta")
                   for t in (q, k, v))
    elif bad == "stride":
        k = torch.zeros(1, 2, 64, 96).transpose(2, 3)
    elif bad == "window":
        kw["window"] = -1
    else:
        v = torch.zeros(1, 2, 95, 64)
    with pytest.raises(exc, match="head dim" if bad == "head_dim" else None):
        ops.flash_attention(q, k, v, **kw)


def test_instance_dim_is_the_next_instance():
    """Padding goes to the smallest instance that holds D; zero columns
    change no score (q.k sums over them add 0) and no kept output column."""
    assert [fa.instance_dim(D) for D in (16, 32, 48, 64, 80, 112, 128, 200,
                                          256)] == \
        [32, 32, 64, 64, 128, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="head dim"):
        fa.instance_dim(257)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 64, 80,
                                                    "float32", seed=5))
    padded = mha_ref(*(fa._pad(t, 128) for t in (q, k, v)))
    # mha_ref scales by 1/sqrt(128) on the padded inputs; the kernel is
    # handed 1/sqrt(80), which equals scaling q by sqrt(128/80) first
    scaled = mha_ref(fa._pad(q * (128 / 80) ** 0.5, 128), fa._pad(k, 128),
                     fa._pad(v, 128))
    assert torch.equal(padded[..., 80:], torch.zeros_like(padded[..., 80:]))
    torch.testing.assert_close(scaled[..., :80], mha_ref(q, k, v),
                               atol=1e-6, rtol=1e-6)


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


@pytest.mark.parametrize("bad", ["k address", "q address", "k stride",
                                 "v stride", "out stride"])
def test_wgmma_check_rejects_what_tma_does_not_take(bad):
    """The bfloat16 kernel takes 16-byte aligned base addresses and strides
    (TMA); anything else raises before a launch of it, on any device, and
    the wrapper stages that tensor instead (nothing falls back to the
    float32 kernel)."""
    bf = torch.bfloat16
    q, k, v = (torch.zeros(1, 4, 64, 64, dtype=bf) for _ in range(3))
    out = torch.empty_like(q)
    if bad == "k address":
        k = torch.zeros(1 * 4 * 64 * 64 + 4, dtype=bf)[4:].view(1, 4, 64, 64)
    elif bad == "q address":
        q = torch.zeros(1, 4, 64, 72, dtype=bf)[..., 1:65]
    elif bad == "k stride":
        k = torch.zeros(1, 4, 64, 68, dtype=bf)[..., :64]
    elif bad == "v stride":
        # a (B,S,H,D) view whose rows are 260 elements (520 bytes) apart
        v = torch.zeros(1, 64, 260, dtype=bf).as_strided(
            (1, 4, 64, 64), (64 * 260, 64, 260, 1))
    else:
        out = torch.zeros(1, 4, 64, 66, dtype=bf)[..., :64]
    with pytest.raises(ValueError):
        fa._check_tma(fa.WGMMA_KERNEL, q, k, v, out)
    assert fa.kernel_for(q, k, v, out) == fa.WGMMA_KERNEL
    assert fa.staged_for(q, k, v, out) == (bad.split()[0],)


def test_wgmma_check_takes_mha_views_and_ignores_size_one_strides():
    """``mha``'s (B,S,H,D) views pass; a dimension of size 1 may have any
    stride, and is handed to TMA with the tensor's largest extent."""
    bf = torch.bfloat16
    q = torch.zeros(2, 64, 4, 32, dtype=bf).transpose(1, 2)
    fa._check_tma(fa.WGMMA_KERNEL, q, q, q, q)
    odd = torch.zeros(4 * 64 * 64, dtype=bf).as_strided(
        (1, 4, 64, 64), (3, 64 * 64, 64, 1))
    fa._check_tma(fa.WGMMA_KERNEL, odd, odd, odd, odd)
    assert fa.staged_for(odd, odd, odd, odd) == ()
    assert fa._strides(odd) == [4 * 64 * 64, 64 * 64, 64]
    assert fa._strides(q) == list(q.stride()[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,bq,bk,dt", [
    (2, 4, 4, 256, 256, 64, True, 0, 128, 128, "float32"),
    (1, 8, 2, 256, 256, 64, True, 0, 128, 128, "bfloat16"),
    (2, 4, 2, 512, 512, 128, True, 128, 128, 128, "float32"),
    (1, 4, 4, 256, 256, 64, False, 0, 32, 256, "float32"),
    (1, 2, 1, 128, 128, 32, True, 0, 32, 32, "float32"),
    (1, 4, 2, 256, 64, 32, True, 32, 64, 32, "float32"),
    # float32 on the tensor cores at D = 32, 64, 128: a q tile of one and
    # of two warpgroups, two 128-key pieces of a 256-key tile, bk = 48
    (1, 2, 1, 128, 128, 32, True, 0, 128, 64, "float32"),
    (1, 4, 2, 256, 256, 64, True, 0, 256, 256, "float32"),
    (1, 4, 2, 384, 384, 128, True, 64, 64, 48, "float32"),
    (1, 2, 2, 384, 384, 128, False, 0, 96, 128, "float32"),
    (1, 4, 2, 512, 512, 128, True, 0, 256, 256, "bfloat16"),
    (1, 2, 1, 128, 128, 32, True, 0, 32, 32, "bfloat16"),
    (1, 4, 2, 256, 64, 32, True, 32, 64, 32, "bfloat16"),
    (1, 4, 4, 256, 256, 64, False, 0, 32, 256, "bfloat16"),
    (1, 4, 2, 256, 256, 64, True, 48, 128, 64, "bfloat16"),
    (1, 2, 2, 384, 384, 64, True, 0, 96, 128, "bfloat16"),
    # bk = min(bk, Sk) of any size: padded pieces, pieces of a wide tile
    (1, 2, 1, 48, 48, 64, True, 0, 128, 128, "bfloat16"),
    (1, 2, 1, 16, 16, 32, True, 0, 128, 128, "bfloat16"),
    (1, 2, 2, 200, 100, 64, True, 40, 40, 100, "bfloat16"),
    (1, 2, 1, 1024, 1024, 128, True, 0, 128, 512, "bfloat16"),
    # a q tile of many passes: q is loaded per pass
    (1, 2, 1, 2048, 2048, 128, True, 0, 1024, 128, "bfloat16"),
    # bfloat16 at D = 256: a 32-key piece, 64-key pieces of wider tiles,
    # a piece padded past its tile, a window, GQA and q tiles of one
    # warpgroup, two and two passes
    (1, 2, 1, 256, 256, 256, True, 0, 64, 32, "bfloat16"),
    (1, 4, 2, 512, 512, 256, True, 0, 128, 128, "bfloat16"),
    (1, 2, 2, 512, 500, 256, True, 0, 256, 100, "bfloat16"),
    (1, 4, 1, 512, 512, 256, True, 100, 128, 256, "bfloat16"),
    (1, 2, 2, 256, 64, 256, False, 32, 64, 64, "bfloat16"),
    # float32 at D = 256 on the tensor cores: the same sweep
    (1, 2, 1, 256, 256, 256, True, 0, 64, 32, "float32"),
    (1, 4, 2, 512, 512, 256, True, 0, 128, 128, "float32"),
    (1, 2, 2, 512, 500, 256, True, 0, 256, 100, "float32"),
    (1, 4, 1, 512, 512, 256, True, 100, 128, 256, "float32"),
    (1, 2, 2, 256, 64, 256, False, 32, 64, 64, "float32"),
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
    assert fa.COUNT.wgmma == (dt == "bfloat16")
    assert fa.COUNT.tf32 == (dt == "float32")
    _close(out.float().cpu(),
           mha_ref(q, k, v, causal=causal, window=window).float().cpu(), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 256])
def test_float32_cuda_core_kernel_on_card(D):
    """float32 that TMA cannot read (k's rows D + 1 floats apart), at
    D = 64 and at D = 256, runs the CUDA-core kernel, and matches the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device; compared against its plain version by "
                    "chip_smoke.py")
    q, k, v = (_torch(a).cuda() for a in _inputs(1, 4, 2, 256, D, "float32"))
    wide = torch.zeros(1, 2, 256, D + 1, device="cuda")
    wide[..., :D] = k
    k = wide[..., :D]
    fa.COUNT.reset()
    out = ops.flash_attention(q, k, v, causal=True, bq=64, bk=32)
    torch.cuda.synchronize()
    assert (fa.COUNT.launches, fa.COUNT.tf32, fa.COUNT.wgmma) == (1, 0, 0)
    _close(out.cpu(), mha_ref(q, k, v, causal=True).cpu(), "float32")
