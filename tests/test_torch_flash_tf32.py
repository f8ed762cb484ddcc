"""The float32 tensor-core flash kernel's numerics and its instance rule.

``flash_fwd_tf32_kernel`` forms each f32 product of q.k and p.v as three
tf32 products (big.big + big.small + small.big, big = tf32(x), small =
tf32(x - big)).  Its emulation in plain torch,
``kernels.flash_attention.flash_tf32x3_ref``, is held here against the
Pallas kernel in interpret mode and the JAX oracle at the f32 tolerance,
on the same numpy inputs (at head dim 256 too, where q.k is the sum of
two 128-column halves), and to the 3xTF32 gate of ``chip_smoke.py``:
within GATE of f32 ``mha_ref``, which both controls (one tf32 product;
bf16 hi + lo) miss.  The kernel itself is held to the same gate on the
card by ``chip_smoke.py``.  The instance rule is tested on CPU and
``meta`` tensors: no card, and no ``nvcc``, is assumed.
"""
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import mha_ref as jax_mha_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.bench import PRESETS, _BLOCKS
from repro_torch.kernels.ref import mha_ref

import jax.numpy as jnp

TOL = 2e-5       # f32, tests/test_kernels.py:14 and the kernel search's gate
GATE = 8e-6      # chip_smoke.TF32_GATE: max abs error against f32 mha_ref
CONTROLS = ("tf32", "bf16x3")


def _inputs(B, Hq, Hkv, Sq, D, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.standard_normal((B, Hq, Sq, D), np.float32),
            rng.standard_normal((B, Hkv, Sk, D), np.float32),
            rng.standard_normal((B, Hkv, Sk, D), np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a, jnp.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _preset_blocks():
    for preset in ("tiny", "small"):
        for bq in _BLOCKS[preset]["flash"]:
            for bk in _BLOCKS[preset]["flash"]:
                yield preset, bq, bk


PRESET_BLOCKS = list(_preset_blocks())


@pytest.mark.parametrize("preset,bq,bk", PRESET_BLOCKS)
def test_emulation_matches_pallas_at_every_domain_block(preset, bq, bk):
    """Every (bq, bk) of both presets of the kernel search domain, causal
    as the domain runs it: the emulation agrees with the Pallas kernel in
    interpret mode and with the JAX oracle at the f32 tolerance."""
    B, Hq, Hkv, S, D = PRESETS[preset]["flash_attention"]
    q, k, v = _inputs(B, Hq, Hkv, S, D, seed=bq + 3 * bk)
    out = fa.flash_tf32x3_ref(_t(q), _t(k), _t(v), causal=True, bq=bq, bk=bk)
    pallas = jax_flash(_j(q), _j(k), _j(v), causal=True, bq=bq, bk=bk,
                       interpret=True)
    oracle = jax_mha_ref(_j(q), _j(k), _j(v), causal=True)
    for ref in (pallas, oracle):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,bq,bk", [
    (1, 8, 2, 256, 256, 64, True, 0, 128, 128),     # GQA, G = 4
    (1, 4, 1, 256, 256, 64, True, 0, 64, 32),       # MQA
    (2, 4, 2, 512, 512, 128, True, 128, 128, 128),  # window, D = 128
    (1, 4, 4, 256, 256, 64, False, 0, 32, 256),     # bidirectional, 2 pieces
    (1, 2, 2, 384, 384, 64, True, 48, 96, 48),      # bk in 64-key pieces
    (1, 4, 2, 256, 64, 32, True, 32, 64, 32),       # Sq > Sk: rows keep no key
    (1, 4, 2, 256, 64, 32, False, 32, 64, 32),
    # head dim 256: q.k as the sum of two 128-column halves, 64-key pieces
    (1, 4, 2, 256, 256, 256, True, 0, 128, 128),    # causal, GQA
    (1, 2, 1, 256, 256, 256, True, 100, 64, 64),    # window, MQA
    (1, 4, 2, 256, 256, 256, False, 0, 64, 32),     # bidirectional, bk = 32
    (1, 2, 1, 256, 256, 256, True, 0, 256, 256),    # 64-key pieces of 256
    (1, 4, 2, 256, 64, 256, True, 32, 64, 32),      # Sq > Sk: rows keep no key
    (1, 2, 1, 256, 64, 256, False, 32, 128, 64),
    (1, 2, 1, 256, 256, 200, True, 0, 128, 128),    # padded to 256
])
def test_emulation_matches_pallas(B, Hq, Hkv, Sq, Sk, D, causal, window, bq,
                                  bk):
    q, k, v = _inputs(B, Hq, Hkv, Sq, D, seed=Sq + Sk + window, Sk=Sk)
    kw = dict(causal=causal, window=window)
    out = fa.flash_tf32x3_ref(_t(q), _t(k), _t(v), bq=bq, bk=bk, **kw)
    pallas = jax_flash(_j(q), _j(k), _j(v), bq=bq, bk=bk, interpret=True,
                       **kw)
    oracle = jax_mha_ref(_j(q), _j(k), _j(v), **kw)
    for ref in (pallas, oracle):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)
    if Sq > Sk:     # rows Sk + window - 1 .. keep no key: the mean of v
        dead = Sk + window - 1
        mean = np.repeat(v.mean(axis=2), Hq // Hkv, axis=1)[:, :, None]
        np.testing.assert_allclose(
            out[:, :, dead:].numpy(),
            np.broadcast_to(mean, out[:, :, dead:].shape), atol=2e-6)


@pytest.mark.parametrize("Hq,Hkv,S,D,causal,window,bq,bk", [
    (2, 1, 256, 256, True, 0, 128, 128),
    (4, 2, 256, 256, True, 0, 64, 32),
    (2, 1, 512, 256, True, 100, 128, 64),
    (2, 2, 256, 256, False, 0, 256, 256),
    (2, 1, 256, 200, True, 0, 128, 128),
])
def test_gate_at_head_dim_256(Hq, Hkv, S, D, causal, window, bq, bk):
    """The 3xTF32 gate at head dim 256 (the instance of D = 200 too): the
    kernel's numerics, q.k summed as two 128-column halves, are within
    GATE of f32 ``mha_ref``; one tf32 product and bf16 hi + lo miss it."""
    q, k, v = (_t(a) for a in _inputs(1, Hq, Hkv, S, D, seed=S + D + bk))
    kw = dict(causal=causal, window=window, bq=bq, bk=bk)
    ref = mha_ref(q, k, v, causal=causal, window=window)

    def err(split):
        out = fa.flash_tf32x3_ref(q, k, v, split=split, **kw)
        return (out - ref).abs().max().item()
    assert err("tf32x3") <= GATE
    for control in CONTROLS:
        assert err(control) > GATE, control


@pytest.mark.parametrize("preset,bq,bk", PRESET_BLOCKS)
def test_gate_passes_the_split_and_fails_both_controls(preset, bq, bk):
    """The 3xTF32 gate of ``chip_smoke.py`` at every block of both
    presets: the kernel's numerics are within GATE of f32 ``mha_ref``;
    one tf32 product (about 1e-3 off) and bf16 hi + lo (about 1.5e-5)
    miss it."""
    B, Hq, Hkv, S, D = PRESETS[preset]["flash_attention"]
    q, k, v = (_t(a) for a in _inputs(B, Hq, Hkv, S, D, seed=7 * bq + bk))
    ref = mha_ref(q, k, v, causal=True)

    def err(split):
        out = fa.flash_tf32x3_ref(q, k, v, causal=True, bq=bq, bk=bk,
                                  split=split)
        return (out - ref).abs().max().item()
    assert err("tf32x3") <= GATE
    for control in CONTROLS:
        assert err(control) > GATE, control


def test_tf32_rounding_is_cvt_rna():
    """``_tf32`` rounds as ``cvt.rna.tf32.f32``: to 10 mantissa bits, to
    nearest with ties away from zero, carrying into the exponent; small =
    tf32(x - big) leaves x - big - small below 2^-22 of x."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2),
                      1 + ulp / 2 - 2.0 ** -23, 2 - ulp / 4, 0.0, -3.0],
                     dtype=torch.float32)
    want = [1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 2.0, 0.0, -3.0]
    assert fa._tf32(x).tolist() == want
    r = _t(np.random.default_rng(0).standard_normal(4096, np.float32))
    big = fa._tf32(r)
    assert torch.equal(fa._tf32(big), big)
    rest = (r.double() - big.double() - fa._tf32(r - big).double()).abs()
    assert (rest <= r.double().abs() * 2.0 ** -22).all()


def test_piece_width_follows_bk():
    """One softmax update per bk tile at bk = 32, 64, 128; 128-key pieces
    of a multiple of 128; 64-key pieces of any other bk."""
    assert [fa.piece_width(bk) for bk in (32, 64, 128, 256, 512, 16, 48,
                                          96, 100)] == \
        [32, 64, 128, 128, 128, 64, 64, 64, 64]


def test_piece_width_at_head_dim_256():
    """At D = 256 (both tensor-core kernels, bfloat16 and float32) a piece
    is 64 keys at most: one 32-key piece at bk = 32, 64-key pieces of
    every other bk; the head dims below keep the rule above."""
    bks = (32, 64, 128, 256, 512, 16, 48, 96, 100)
    assert [fa.piece_width(bk, 256) for bk in bks] == \
        [32, 64, 64, 64, 64, 64, 64, 64, 64]
    assert [fa.piece_width(bk, D) for D in (32, 64) for bk in bks] == \
        2 * [fa.piece_width(bk) for bk in bks]


@pytest.mark.parametrize("Sk,bk,D,want", [
    (256, 128, 256, [(c, c + 64) for c in range(0, 256, 64)]),
    (256, 32, 256, [(c, c + 32) for c in range(0, 256, 32)]),
    (200, 100, 256, [(0, 64), (64, 100), (100, 164), (164, 200)]),
    (512, 512, 200, [(c, c + 64) for c in range(0, 512, 64)]),  # D -> 256
    (256, 256, 128, [(0, 128), (128, 256)]),
    (256, 512, 64, [(0, 128), (128, 256)]),       # bk = min(bk, Sk)
    (96, 48, 32, [(0, 48), (48, 96)]),
])
def test_pieces_follow_the_instance_head_dim(Sk, bk, D, want):
    """The emulation's softmax updates are the float32 kernel's pieces:
    64 keys at most at instance head dim 256, the last piece of a tile
    cut at its end."""
    assert fa.pieces(Sk, bk, D) == want


def test_scores_at_head_dim_256_sum_two_halves():
    """At instance head dim 256 q.k is the sum of the two warpgroups'
    128-column parts, each three tf32 products; below 256 one product."""
    q, k, _ = (_t(a) for a in _inputs(1, 2, 1, 64, 256, seed=5))
    halves = (fa._product(q[..., :128], k[..., :128].transpose(2, 3),
                          "tf32x3")
              + fa._product(q[..., 128:], k[..., 128:].transpose(2, 3),
                            "tf32x3"))
    assert torch.equal(fa._scores(q, k, "tf32x3"), halves)
    q, k = q[..., :128].contiguous(), k[..., :128].contiguous()
    assert torch.equal(fa._scores(q, k, "tf32x3"),
                       fa._product(q, k.transpose(2, 3), "tf32x3"))


def test_emulation_rejects_an_unknown_split():
    q = torch.zeros(1, 1, 32, 32)
    with pytest.raises(ValueError, match="split"):
        fa.flash_tf32x3_ref(q, q, q, split="fp16")


def _aligned(dt, D, device):
    return tuple(torch.zeros(1, 4, 64, D, dtype=dt, device=device)
                 for _ in range(3))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dt,D,layout,kernel", [
    (torch.float32, 32, "contiguous", fa.TF32_KERNEL),
    (torch.float32, 64, "contiguous", fa.TF32_KERNEL),
    (torch.float32, 128, "contiguous", fa.TF32_KERNEL),
    (torch.float32, 128, "mha view", fa.TF32_KERNEL),
    (torch.float32, 80, "contiguous", fa.TF32_KERNEL),    # padded to 128
    (torch.float32, 80, "k rows 65 apart", fa.TF32_KERNEL),   # padded: new
    (torch.float32, 64, "k rows 65 apart", fa.TF32_KERNEL),
    (torch.float32, 64, "out rows 66 apart", fa.TF32_KERNEL),
    (torch.float32, 256, "contiguous", fa.TF32_KERNEL),
    (torch.float32, 200, "contiguous", fa.TF32_KERNEL),       # padded to 256
    (torch.float32, 256, "mha view", fa.TF32_KERNEL),
    (torch.float32, 256, "k rows 65 apart", fa.TF32_KERNEL),
    (torch.float32, 256, "out rows 66 apart", fa.TF32_KERNEL),
    (torch.float32, 200, "k rows 65 apart", fa.TF32_KERNEL),  # padded: new
    (torch.bfloat16, 64, "contiguous", fa.WGMMA_KERNEL),
    (torch.bfloat16, 64, "k rows 65 apart", fa.WGMMA_KERNEL),
    (torch.bfloat16, 256, "contiguous", fa.WGMMA_KERNEL),
    (torch.bfloat16, 256, "mha view", fa.WGMMA_KERNEL),
    (torch.bfloat16, 256, "k rows 65 apart", fa.WGMMA_KERNEL),
    (torch.bfloat16, 256, "out rows 66 apart", fa.WGMMA_KERNEL),
    (torch.bfloat16, 200, "contiguous", fa.WGMMA_KERNEL),     # padded to 256
    (torch.bfloat16, 200, "k rows 65 apart", fa.WGMMA_KERNEL),  # padded: new
])
def test_instance_rule(device, dt, D, layout, kernel):
    """dtype, head dim and alignment name the kernel, before any launch:
    at every head dim, the tf32 (float32) or wgmma (bfloat16) kernel,
    on the tensors as they are where TMA can read q, k, v and out (or the
    head dim is padded into new tensors), else on staged copies of what
    it cannot read, so no call is refused and none runs on CUDA cores.
    (``k rows 65 apart`` is k with D + 1 elements a row.)"""
    q, k, v = _aligned(dt, D, device)
    out = None
    if layout == "mha view":
        q, k, v = (torch.zeros(1, 64, 4, D, dtype=dt, device=device)
                   .transpose(1, 2) for _ in range(3))
        out = torch.empty(1, 64, 4, D, dtype=dt,
                          device=device).transpose(1, 2)
    elif layout == "k rows 65 apart":
        k = torch.zeros(1, 4, 64, D + 1, dtype=dt, device=device)[..., :D]
    elif layout == "out rows 66 apart":
        out = torch.zeros(1, 4, 64, D + 2, dtype=dt, device=device)[..., :D]
    assert fa.kernel_for(q, k, v, out) == kernel
    staged = () if fa.instance_dim(D) != D else {
        "k rows 65 apart": ("k",), "out rows 66 apart": ("out",)}.get(
            layout, ())
    assert fa.staged_for(q, k, v, out) == staged


def test_instance_rule_reads_base_addresses():
    """A float32 view that starts 4 bytes into its storage cannot be read
    by TMA: the tf32 kernel runs it on a staged copy."""
    q, k, v = _aligned(torch.float32, 64, "cpu")
    shifted = torch.zeros(4 * 64 * 64 + 1)[1:].view(1, 4, 64, 64)
    assert shifted.data_ptr() % 16
    assert fa.kernel_for(shifted, k, v) == fa.TF32_KERNEL
    assert fa.staged_for(shifted, k, v) == ("q",)
    assert fa.kernel_for(q, k, v) == fa.TF32_KERNEL
    assert fa.staged_for(q, k, v) == ()


def test_cpu_tensors_count_plain_only():
    """On the CPU the wrapper runs the plain version whatever kernel the
    rule would name on the card, and counts no launch."""
    q, k, v = (_t(a) for a in _inputs(1, 4, 2, 64, 64, seed=3))
    assert fa.kernel_for(q, k, v) == fa.TF32_KERNEL
    fa.COUNT.reset()
    out = ops.flash_attention(q, k, v, bq=32, bk=32)
    ops.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert (fa.COUNT.launches, fa.COUNT.tf32, fa.COUNT.wgmma,
            fa.COUNT.plain) == (0, 0, 0, 2)
    assert torch.equal(out, mha_ref(q, k, v))
    fa.COUNT.reset()
    assert (fa.COUNT.tf32, fa.COUNT.plain) == (0, 0)


def test_instance_entry_refuses_what_its_kernel_does_not_take():
    """``_flash_attention_instance`` (``chip_smoke.py`` times the two
    float32 kernels with it) launches only on the card, at an instance
    head dim, through a kernel the rule allows for the inputs."""
    q, k, v = _aligned(torch.float32, 64, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._flash_attention_instance(q, k, v, kernel=fa.CUDA_CORE_KERNEL)
    q, k, v = _aligned(torch.float32, 80, "meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._flash_attention_instance(q, k, v, kernel=fa.TF32_KERNEL)


@pytest.mark.cuda
@pytest.mark.parametrize("D,bq,bk", [(32, 32, 32), (64, 128, 256),
                                     (128, 128, 128), (128, 64, 48),
                                     (256, 128, 128), (256, 64, 32),
                                     (256, 256, 64), (200, 128, 128)])
def test_kernel_matches_its_emulation_on_card(D, bq, bk):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device; chip_smoke.py holds the kernel to the "
                    "3xTF32 gate on the card")
    q, k, v = (_t(a).cuda() for a in _inputs(1, 4, 2, 768, D, seed=D))
    fa.COUNT.reset()
    out = ops.flash_attention(q, k, v, causal=True, bq=bq, bk=bk)
    torch.cuda.synchronize()
    assert (fa.COUNT.launches, fa.COUNT.tf32) == (1, 1)
    emu = fa.flash_tf32x3_ref(q, k, v, causal=True, bq=bq, bk=bk)
    assert (out - emu).abs().max().item() <= 1e-6
    assert (out - mha_ref(q, k, v)).abs().max().item() <= GATE
