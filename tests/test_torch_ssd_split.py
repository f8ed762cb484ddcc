"""The numerics of ``ssd_scan``'s tensor-core instance, on the CPU.

``chunk_scan_wgmma_kernel`` (``kernels/csrc/ssd_scan.cu``) computes the
third launch of the scan with bf16 wgmma and f32 sums: C.B^T of exact bf16
values, and W = (C.B^T) o L o dt and the carried state, the two operands
that are f32, each split into ``bf16(v)`` and ``bf16(v - bf16(v))``.
``chip_smoke.py`` emulates that (``ssd_split_ref``) and holds the kernel
to a gate on the share of bf16 outputs that differ from ``ssd_ref``
(``ssd_split_gate``), which a control keeping W and the state in bf16
alone must fail.  Here the emulation is held against ``ssd_ref`` and the
Pallas kernel in interpret mode, and the gate is shown to tell the two
apart, on the same numpy inputs at a CPU size.  The rule that picks the
instance is held at the shapes it must send each way.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import ssd_ref

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(ssd_mod.__file__).parent / "csrc" / "ssd_scan.cu"
TOL_BF16 = 2e-2            # tests/test_kernels.py:14


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _model_inputs(dt_scale, B=1, L=1024, H=4, P=64, N=128, seed=50):
    """As ``chip_smoke.ssd_main_inputs`` makes them, from numpy at a CPU
    size: x, Bm, Cm the bf16 strided slices of one conv output, steps
    softplus(randn) * dt_scale, A = -exp(0.3 randn), bf16 D."""
    rng = np.random.default_rng(seed)
    di = H * P
    conv = _bf16(0.4 * rng.standard_normal((B, L, di + 2 * N), np.float32))
    x = conv[..., :di].reshape(B, L, H, P)
    Bm, Cm = conv[..., di:di + N], conv[..., di + N:]
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, L, H), np.float32))) * dt_scale
    A = torch.from_numpy(-np.exp(0.3 * rng.standard_normal(H)
                                 ).astype(np.float32))
    D = _bf16(1 + 0.2 * rng.standard_normal(H).astype(np.float32))
    return x, dt, A, Bm, Cm, D


INPUTS = {"model steps": 1.0, "slow decay": 0.05}   # dt_scale
CHUNK = 256


@pytest.fixture(scope="module", params=list(INPUTS))
def case(request):
    args = _model_inputs(INPUTS[request.param])
    ref = ssd_ref(*args, CHUNK)[0]
    return request.param, args, ref


def test_split_emulation_matches_ssd_ref_and_pallas(case):
    """The emulation is the same function at the bf16 tolerance the kernel
    is held to (5 x 2e-2), against the plain version and against the
    Pallas kernel in interpret mode."""
    _, args, ref = case
    split = cs.ssd_split_ref(*args, CHUNK)
    assert split.dtype == torch.bfloat16 and split.shape == ref.shape
    torch.testing.assert_close(split.float(), ref.float(),
                               atol=5 * TOL_BF16, rtol=5 * TOL_BF16)
    x, dt, A, Bm, Cm, D = (jnp.asarray(t.float().numpy()) for t in args)
    bf = jnp.bfloat16
    yj, _ = jax_ssd_scan(x.astype(bf), dt, A, Bm.astype(bf), Cm.astype(bf),
                         D.astype(bf), chunk=CHUNK, interpret=True)
    np.testing.assert_allclose(split.float().numpy(),
                               np.asarray(yj, np.float32),
                               atol=5 * TOL_BF16, rtol=5 * TOL_BF16)


def test_gate_passes_the_split_and_fails_bf16_alone(case):
    """W and the state as hi + lo leave a fraction of a percent of the bf16
    outputs rounded otherwise than ``ssd_ref``'s; in bf16 alone, several
    percent or more: the gate's limit lies between, at both inputs (with
    slow decay the carried state reaches deep into each chunk)."""
    _, args, ref = case
    share, ok = cs.ssd_split_gate(cs.ssd_split_ref(*args, CHUNK), ref)
    c_share, c_ok = cs.ssd_split_gate(
        cs.ssd_split_ref(*args, CHUNK, split=False), ref)
    assert ok and share < cs.SSD_SPLIT_SHARE / 2
    assert not c_ok and c_share > 5 * cs.SSD_SPLIT_SHARE


def _views(B, L, H, P, N, dtype=torch.bfloat16):
    conv = torch.zeros(B, L, H * P + 2 * N, dtype=dtype)
    di = H * P
    return (conv[..., :di].reshape(B, L, H, P), conv[..., di:di + N],
            conv[..., di + N:])


@pytest.mark.parametrize("name,shape,chunk,want", [
    ("mamba2-130m", (8, 512, 24, 64, 128), 256, True),
    ("zamba2-7b widths", (2, 512, 4, 64, 64), 256, True),
    ("test_kernels 3", (2, 256, 4, 32, 16), 128, True),
    ("Q = 128", (2, 512, 3, 64, 128), 128, True),
    ("Q < 64", (2, 96, 3, 16, 24), 32, False),
    ("N = 24", (2, 256, 3, 16, 24), 64, False),
    ("P = 48", (1, 256, 2, 48, 64), 128, False),
    ("Q = 100", (1, 200, 2, 64, 128), 100, False),
])
def test_instance_rule(name, shape, chunk, want):
    """The model's shape (strided bf16 views of the conv output) goes to
    the tensor cores; shapes the instance has no tile for go to CUDA
    cores."""
    x, Bm, Cm = _views(*shape)
    assert ssd_mod.uses_tensor_cores(x, Bm, Cm, chunk) is want


@pytest.mark.parametrize("bad", ["float32", "x address", "row stride"])
def test_instance_rule_needs_bf16_and_tma_alignment(bad):
    x, Bm, Cm = _views(2, 512, 4, 64, 128)
    assert ssd_mod.uses_tensor_cores(x, Bm, Cm, 256)
    if bad == "float32":
        x, Bm, Cm = _views(2, 512, 4, 64, 128, torch.float32)
    elif bad == "x address":        # one element in: 2 bytes off 16
        flat = torch.zeros(2 * 512 * 4 * 64 + 1, dtype=torch.bfloat16)
        x = flat[1:].reshape(2, 512, 4, 64)
    else:                           # a row of 1796 bf16 = 3592 bytes
        conv = torch.zeros(2, 512, 4 * 64 + 2 * 128 + 4,
                           dtype=torch.bfloat16)
        Bm = conv[..., 256:384]
    assert not ssd_mod.uses_tensor_cores(x, Bm, Cm, 256)


def test_wgmma_source_splits_w_and_the_state():
    """The tensor-core kernel selects W above the diagonal (never a 0/1
    product), splits W and the state into hi and lo, and adds each pair
    as two wgmmas into one f32 accumulator."""
    src = SRC.read_text()
    assert re.search(r"w\[cc\] = key <= q\s*\?\s*g\[e\] \* expf\(cum_q\[i\] "
                     r"- cum_s\[key\]\) \* dt_s\[key\]\s*:\s*0\.f;", src)
    assert re.search(r"Wgmma<P>::rs_tb\(acc, w_hi\[ks\], xd\);\s*"
                     r"Wgmma<P>::rs_tb\(acc, w_lo\[ks\], xd\);", src)
    assert "split2(v.x, v.y, hi.x, lo.x);" in src
    assert re.search(r"make_desc\(hi_addr \+ so,[^;]*\);\s*"
                     r"Wgmma<P>::ss\(acc, c_desc\(kk\),\s*"
                     r"hopper::make_desc\(lo_addr \+ so", src)
    assert "__floats2bfloat162_rn(x0 - __low2float(h)," in src
