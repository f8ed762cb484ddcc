"""Flash attention on layouts TMA cannot read: the staged route.

The tensor-core kernels read q, k and v by TMA, which needs 16-byte
aligned base addresses and strides (out too, which they store in pairs).
Where one of them is not, the wrapper copies that tensor's values into a
new contiguous one and launches the same kernel (``COUNT.staged``), so
the output is the kernel's on those values, bit for bit.  The instance
rule names the kernel and the tensors it stages, on CPU and ``meta``
tensors, for every instance head dim in both dtypes; the staged copies
are TMA-aligned and hold the same values; the plain versions
(``mha_ref`` through the wrapper, and ``flash_tf32x3_ref`` for float32)
are held to the Pallas kernel in interpret mode on such views, at the
tolerance of ``tests/test_kernels.py``.  The launches themselves run only
on the card: ``chip_smoke.py`` holds each to ``mha_ref``, to its dtype's
gate and to the kernel on contiguous copies, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # tests/test_kernels.py:14
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LAYOUTS = ("contiguous", "mha view", "q base", "k rows", "v rows",
           "out rows", "out base")


def _view(t, layout_part):
    """``t``'s values in a layout TMA cannot read: ``base`` starts one
    element past the storage's start, ``rows`` keeps rows D + 1 elements
    apart."""
    if layout_part == "base":
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
    else:
        view = torch.zeros(*t.shape[:3], t.shape[3] + 1, dtype=t.dtype,
                           device=t.device)[..., :t.shape[3]]
    if t.device.type != "meta":
        view.copy_(t)
    return view


def _tensors(dt, D, device, layout):
    q, k, v = (torch.zeros(1, 4, 64, D, dtype=dt, device=device)
               for _ in range(3))
    out = None
    if layout == "mha view":
        q, k, v = (torch.zeros(1, 64, 4, D, dtype=dt, device=device)
                   .transpose(1, 2) for _ in range(3))
        out = torch.empty(1, 64, 4, D, dtype=dt, device=device).transpose(1, 2)
    elif layout != "contiguous":
        name, part = layout.split()
        if name == "out":
            out = _view(torch.zeros_like(q), part)
        else:
            tensors = {"q": q, "k": k, "v": v}
            tensors[name] = _view(tensors[name], part)
            q, k, v = tensors["q"], tensors["k"], tensors["v"]
    return q, k, v, out


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_instance_rule_stages_what_tma_cannot_read(device, dt, D, layout):
    """Every instance head dim in both dtypes runs the dtype's tensor-core
    kernel, never the CUDA-core one; the rule stages exactly the tensor
    TMA cannot read, which the kernel itself would refuse."""
    q, k, v, out = _tensors(DTYPES[dt], D, device, layout)
    kernel = fa.TF32_KERNEL if dt == "float32" else fa.WGMMA_KERNEL
    assert fa.kernel_for(q, k, v, out) == kernel
    aligned = layout in ("contiguous", "mha view")
    assert fa.staged_for(q, k, v, out) == (() if aligned
                                           else (layout.split()[0],))
    if not aligned:
        with pytest.raises(ValueError, match="multiples of 16 bytes"):
            fa._check_tma(kernel, q, k, v, q if out is None else out)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_padded_head_dims_stage_nothing(dt):
    """A head dim below an instance is padded into new contiguous tensors,
    which TMA can read, whatever the layout it came in."""
    q, k, v, out = _tensors(DTYPES[dt], 80, "cpu", "k rows")
    assert fa.kernel_for(q, k, v, out) == (
        fa.TF32_KERNEL if dt == "float32" else fa.WGMMA_KERNEL)
    assert fa.staged_for(q, k, v, out) == ()


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_staged_copies_are_tma_aligned_with_the_same_values(dt, D):
    """A staged copy of a view TMA cannot read is a new contiguous tensor
    that it can, holding the same values bit for bit."""
    rng = np.random.default_rng(D)
    t = torch.from_numpy(rng.standard_normal((1, 4, 64, D), np.float32)
                         ).to(DTYPES[dt])
    for part in ("base", "rows"):
        view = _view(t, part)
        assert not fa._tma_aligned(view)
        copy = fa._copy(view)
        assert copy.is_contiguous() and fa._tma_aligned(copy)
        assert copy.data_ptr() != view.data_ptr()
        assert torch.equal(copy, t)


def _inputs(B, Hq, Hkv, S, D, dt, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, H, S, D), np.float32)
              for H in (Hq, Hkv, Hkv)]
    if dt == "bfloat16":     # round once, so both packages see the same bits
        arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                  for a in arrays]
    return arrays


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("D,causal,window,bq,bk", [
    (64, True, 0, 64, 32), (128, True, 48, 128, 64), (32, False, 0, 32, 32),
    (256, True, 0, 64, 64)])
def test_plain_versions_on_views_tma_cannot_read(dt, D, causal, window, bq,
                                                 bk):
    """q one element past its storage's start and k and v rows D + 1
    elements apart, on the CPU: the wrapper's plain version (``mha_ref``,
    counted as plain, no launch), and for float32 the tf32 kernel's
    emulation, agree with the Pallas kernel in interpret mode at the
    dtype's tolerance."""
    q, k, v = _inputs(1, 4, 2, 128, D, dt, seed=D + bq)
    tq, tk, tv = (torch.from_numpy(a).to(DTYPES[dt]) for a in (q, k, v))
    qv, kv, vv = _view(tq, "base"), _view(tk, "rows"), _view(tv, "rows")
    assert fa.staged_for(qv, kv, vv) == ("q", "k", "v")
    jdt = getattr(jnp, dt)
    ref = np.asarray(jax_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                               jnp.asarray(v, jdt), causal=causal,
                               window=window, bq=bq, bk=bk, interpret=True),
                     np.float32)
    fa.COUNT.reset()
    out = fa.flash_attention(qv, kv, vv, causal=causal, window=window, bq=bq,
                             bk=bk)
    assert (fa.COUNT.launches, fa.COUNT.staged, fa.COUNT.plain) == (0, 0, 1)
    assert out.dtype == DTYPES[dt] and out.shape == tq.shape
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dt],
                               rtol=TOL[dt])
    if dt == "float32":
        emu = fa.flash_tf32x3_ref(qv, kv, vv, causal=causal, window=window,
                                  bq=bq, bk=bk)
        np.testing.assert_allclose(emu.numpy(), ref, atol=TOL[dt],
                                   rtol=TOL[dt])
