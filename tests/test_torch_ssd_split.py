"""The numerics of ``ssd_scan``'s tensor-core instances, on the CPU.

``chunk_scan_wgmma_kernel`` (``kernels/csrc/ssd_scan.cu``) computes the
third launch of the scan with bf16 wgmma and f32 sums: C.B^T of exact bf16
values, and W = (C.B^T) o L o dt and the carried state, the two operands
that are f32, each split into ``bf16(v)`` and ``bf16(v - bf16(v))``.
``chunk_state_wgmma_kernel`` computes the first, each chunk's own state
(x o w)^T . Bm, w = dt exp(cum[Q-1] - cum), splitting the f32 x o w the
same way.  ``chip_smoke.py`` emulates both (``ssd_split_ref``) and holds
the kernel to two gates: the share of bf16 outputs that differ from
``ssd_ref`` (``ssd_split_gate``), which a control keeping W and the state
in bf16 alone must fail, and the error of the state leaving each chunk,
relative in norm at the worst chunk (``ssd_state_gate``, against
``ssd_ref_states``), which a control keeping x o w in bf16 alone must
fail at every chunk.  Here the emulation is held against ``ssd_ref`` and the Pallas
kernel in interpret mode, and the gates are shown to tell each pair
apart, on the same numpy inputs at a CPU size.  The rule that picks the
instances (``ssd_scan.instance_for``) is held at the shapes it must send
each way.
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
    """(name, inputs, ssd_ref's (y, final state, states leaving each
    chunk), Pallas interpret's (y, final state))."""
    args = _model_inputs(INPUTS[request.param])
    ref = (*ssd_ref(*args, CHUNK), cs.ssd_ref_states(*args, CHUNK))
    x, dt, A, Bm, Cm, D = (jnp.asarray(t.float().numpy()) for t in args)
    bf = jnp.bfloat16
    yj, sj = jax_ssd_scan(x.astype(bf), dt, A, Bm.astype(bf), Cm.astype(bf),
                          D.astype(bf), chunk=CHUNK, interpret=True)
    return (request.param, args, ref,
            (np.asarray(yj, np.float32), np.asarray(sj, np.float32)))


def test_split_emulation_matches_ssd_ref_and_pallas(case):
    """The emulation is the same function at the bf16 tolerance the kernel
    is held to (5 x 2e-2), against the plain version and against the
    Pallas kernel in interpret mode."""
    _, args, (ref, _, _), (yj, _) = case
    split, _ = cs.ssd_split_ref(*args, CHUNK)
    assert split.dtype == torch.bfloat16 and split.shape == ref.shape
    torch.testing.assert_close(split.float(), ref.float(),
                               atol=5 * TOL_BF16, rtol=5 * TOL_BF16)
    np.testing.assert_allclose(split.float().numpy(), yj,
                               atol=5 * TOL_BF16, rtol=5 * TOL_BF16)


def test_split_emulation_state_matches_ssd_ref_and_pallas(case):
    """The emulation's final state, x o w split as launch 1 splits it, is
    the same function's at the tolerance the kernel's state is held to
    (1e-4 abs + rel), against the plain version and against the Pallas
    kernel in interpret mode; so is the state leaving each chunk, against
    ``ssd_ref_states``."""
    _, args, (_, ref_state, ref_states), (_, sj) = case
    _, states = cs.ssd_split_ref(*args, CHUNK)
    assert states.dtype == torch.float32 and states.shape == ref_states.shape
    state = states[:, :, -1]
    assert state.shape == ref_state.shape
    torch.testing.assert_close(state, ref_state, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), sj, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(states, ref_states, atol=1e-4, rtol=1e-4)


def test_ssd_ref_states_end_in_ssd_ref_final_state(case):
    """``ssd_ref_states`` (ssd_ref on each chunk alone, carried from chunk
    to chunk) ends in ssd_ref's final state and Pallas interpret's, and is
    the exact chunk states (float64, no rounding) to f32 precision at
    every chunk: the state gate's reference holds each chunk."""
    _, args, (_, ref_state, ref_states), (_, sj) = case
    B, L, H, P = args[0].shape
    assert ref_states.shape == (B, H, L // CHUNK, P, args[3].shape[-1])
    torch.testing.assert_close(ref_states[:, :, -1], ref_state, atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(ref_states[:, :, -1].numpy(), sj, atol=1e-4,
                               rtol=1e-4)
    exact = cs.ssd_split_ref(*args, CHUNK, split=None, state_split=None,
                             dtype=torch.float64)[1]
    assert cs.ssd_state_errors(ref_states, exact).max() < 2e-5


def test_gate_passes_the_split_and_fails_bf16_alone(case):
    """W and the state as hi + lo leave a fraction of a percent of the bf16
    outputs rounded otherwise than ``ssd_ref``'s; in bf16 alone, several
    percent or more: the gate's limit lies between, at both inputs (with
    slow decay the carried state reaches deep into each chunk)."""
    _, args, (ref, _, _), _ = case
    share, ok = cs.ssd_split_gate(cs.ssd_split_ref(*args, CHUNK)[0], ref)
    c_share, c_ok = cs.ssd_split_gate(
        cs.ssd_split_ref(*args, CHUNK, split=False)[0], ref)
    assert ok and share < cs.SSD_SPLIT_SHARE / 2
    assert not c_ok and c_share > 5 * cs.SSD_SPLIT_SHARE


def test_state_gate_passes_the_split_and_fails_bf16_alone(case):
    """x o w as hi + lo leaves the state leaving every chunk a few
    millionths from ``ssd_ref``'s in norm; in bf16 alone, over a
    thousandth at every chunk: the state gate's limit lies between, with
    room on both sides, at both inputs."""
    _, args, (_, _, ref_states), _ = case
    err, ok = cs.ssd_state_gate(cs.ssd_split_ref(*args, CHUNK)[1], ref_states)
    c_err, c_ok = cs.ssd_state_gate(
        cs.ssd_split_ref(*args, CHUNK, state_split=False)[1], ref_states)
    c_errs = cs.ssd_state_errors(
        cs.ssd_split_ref(*args, CHUNK, state_split=False)[1], ref_states)
    assert ok and err < cs.SSD_STATE_REL / 10
    assert not c_ok and c_errs.numel() == 4
    assert c_errs.min() > 10 * cs.SSD_STATE_REL


def test_state_gate_limit_from_float64_emulation(case):
    """The limit's source, in float64 against the exact states: the worst
    chunk of x o w as hi + lo times 10 and f32 ``ssd_ref_states`` times 5
    lie under it; the best chunk of x o w in bf16 alone lies 10 times
    over it.  Launch 3's roundings do not reach the states."""
    _, args, (_, _, ref_states), _ = case
    kw = dict(dtype=torch.float64)
    exact = cs.ssd_split_ref(*args, CHUNK, split=None, state_split=None,
                             **kw)[1]
    err = {mode: cs.ssd_state_errors(cs.ssd_split_ref(
        *args, CHUNK, state_split=mode, **kw)[1], exact)
        for mode in (True, False)}
    assert 10 * err[True].max() < cs.SSD_STATE_REL < err[False].min() / 10
    assert 5 * cs.ssd_state_errors(ref_states, exact).max() \
        < cs.SSD_STATE_REL
    assert torch.equal(cs.ssd_split_ref(*args, CHUNK, split=False,
                                        **kw)[1],
                       cs.ssd_split_ref(*args, CHUNK, **kw)[1])


def _views(B, L, H, P, N, dtype=torch.bfloat16, device="cpu"):
    conv = torch.zeros(B, L, H * P + 2 * N, dtype=dtype, device=device)
    di = H * P
    return (conv[..., :di].reshape(B, L, H, P), conv[..., di:di + N],
            conv[..., di + N:])


RULE_CASES = [
    ("mamba2-130m", (8, 512, 24, 64, 128), 256, True),
    ("zamba2-7b widths", (2, 512, 4, 64, 64), 256, True),
    ("test_kernels 3", (2, 256, 4, 32, 16), 128, True),
    ("Q = 128", (2, 512, 3, 64, 128), 128, True),
    ("Q = 1024, N = 128", (1, 2048, 6, 64, 128), 1024, True),
    ("Q < 64", (2, 96, 3, 16, 24), 32, False),
    ("N = 24", (2, 256, 3, 16, 24), 64, False),
    ("P = 48", (1, 256, 2, 48, 64), 128, False),
    ("Q = 100", (1, 200, 2, 64, 128), 100, False),
]


@pytest.mark.parametrize("name,shape,chunk,want", RULE_CASES)
def test_instance_rule(name, shape, chunk, want):
    """The model's shape (strided bf16 views of the conv output) goes to
    the tensor cores; shapes the instance has no tile for go to CUDA
    cores."""
    x, Bm, Cm = _views(*shape)
    assert ssd_mod.instance_for(x, Bm, Cm, chunk) == (
        "wgmma" if want else "cuda_core")


@pytest.mark.parametrize("bad", ["float32", "x address", "row stride"])
def test_instance_rule_needs_bf16_and_tma_alignment(bad):
    x, Bm, Cm = _views(2, 512, 4, 64, 128)
    assert ssd_mod.instance_for(x, Bm, Cm, 256) == "wgmma"
    if bad == "float32":
        x, Bm, Cm = _views(2, 512, 4, 64, 128, torch.float32)
    elif bad == "x address":        # one element in: 2 bytes off 16
        flat = torch.zeros(2 * 512 * 4 * 64 + 1, dtype=torch.bfloat16)
        x = flat[1:].reshape(2, 512, 4, 64)
    else:                           # a row of 1796 bf16 = 3592 bytes
        conv = torch.zeros(2, 512, 4 * 64 + 2 * 128 + 4,
                           dtype=torch.bfloat16)
        Bm = conv[..., 256:384]
    assert ssd_mod.instance_for(x, Bm, Cm, 256) != "wgmma"


@pytest.mark.parametrize("name,shape,chunk,want", RULE_CASES)
def test_instance_rule_on_meta_tensors(name, shape, chunk, want):
    """The rule needs no data: on ``meta`` tensors it sends each shape as
    on the CPU, float32 never to the bf16 instances (to the float32
    tensor-core ones where they take the shape; tests/test_torch_ssd_tf32.py
    holds those).  The one answer picks launches 1 and 3 together (the C
    side's one ``instance`` switch, held by
    ``test_state_wgmma_source_splits_x_o_w``)."""
    x, Bm, Cm = _views(*shape, device="meta")
    assert ssd_mod.instance_for(x, Bm, Cm, chunk) == (
        "wgmma" if want else "cuda_core")
    f32 = _views(*shape, dtype=torch.float32, device="meta")
    assert ssd_mod.instance_for(*f32, chunk) == ("tf32" if want
                                                  else "cuda_core")


@pytest.mark.parametrize("name,shape,chunk,want",
                         [c for c in RULE_CASES if not c[-1]])
def test_tensor_core_instance_refuses_what_the_rule_does(name, shape, chunk,
                                                         want):
    """Asked for the tensor-core instances at a shape the rule sends to
    CUDA cores, the instance entry raises before any launch."""
    B, L, H, P, N = shape
    x, Bm, Cm = _views(*shape, device="meta")
    dt = torch.zeros(B, L, H, device="meta")
    A, D = torch.zeros(H, device="meta"), torch.zeros(H, device="meta")
    with pytest.raises(ValueError, match="does not take these inputs"):
        ssd_mod._ssd_scan_instance(x, dt, A, Bm, Cm, D, chunk=chunk,
                                   instance="wgmma")


def test_state_wgmma_source_splits_x_o_w():
    """The tensor-core first launch builds A = (x o w)^T from the x piece,
    w = dt exp(cum[Q-1] - cum), splits it with split2 into hi and lo, and
    adds both as two wgmmas that read the same Bm descriptor into one f32
    accumulator; one C flag selects the tensor-core instances of launches
    1 and 3 together."""
    src = SRC.read_text()
    assert "w_s[g * Q + q] *= expf(end - cum_s[g * Q + q]);" in src
    assert "const float end = cum_s[g * Q + Q - 1];" in src
    assert re.search(r"split2\(xv\.x \* wk\[r / 2\]\.x, xv\.y \* "
                     r"wk\[r / 2\]\.y, a_hi\[ks\]\[r\],\s*"
                     r"a_lo\[ks\]\[r\]\);", src)
    assert re.search(r"const uint64_t bd =[^;]*;\s*"
                     r"Wgmma<NB>::rs_tb\(acc, a_hi\[ks\], bd\);\s*"
                     r"Wgmma<NB>::rs_tb\(acc, a_lo\[ks\], bd\);", src)
    assert "hopper::ldmatrix_x4_trans(" in src
    body = src[src.index("int launch(const void* x"):]
    assert body.index("wg::chunk_state(") < body.index("state_pass_kernel<<<") \
        < body.index("wg::chunk_scan(")
    assert body.count("instance == kWgmma") == 2


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
