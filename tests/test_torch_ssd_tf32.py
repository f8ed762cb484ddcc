"""The numerics of ``ssd_scan``'s float32 tensor-core instances, on the CPU.

``chunk_state_tf32_kernel`` and ``chunk_scan_tf32_kernel``
(``kernels/csrc/ssd_scan.cu``) compute launches 1 and 3 of the scan for
float32 inputs on the tensor cores: every product with float32 operands,
C.B^T, W.x with W = (C.B^T) o L o dt, the carried state C.S^T and each
chunk's own state (x o w)^T.Bm, as three tf32 products, big.big +
big.small + small.big with big = tf32(v) and small = tf32(v - big), into
f32 sums.  ``chip_smoke.py`` emulates them (``ssd_tf32x3_ref``) and holds
the kernel to a 3xTF32 gate: y at the worst head and the states leaving
each chunk at the worst chunk, relative in norm, against the exact function
(float64) on the kernel's own cumulative decay, within ``SSD_TF32_GATE``,
which the two controls (one tf32 product; bf16 hi + lo) must miss at every
head and chunk.  Here the emulation is held against ``ssd_ref`` and the
Pallas kernel in interpret mode on the same numpy inputs, the gate is shown
to tell the emulation from its controls, and the rule that picks the
instances is held at the shapes it must send each way.
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
TOL_F32 = 2e-5             # tests/test_kernels.py:14
# at the model's steps (cum near -200 in a chunk) f32 ssd_ref itself
# differs from Pallas interpret by more than TOL_F32 (each rounds its own
# f32 decay); there the emulation is held to Pallas interpret at the
# tolerance chip_smoke.py holds the kernel's y to, 5 x TOL_F32
TOL_MODEL = 5 * TOL_F32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _inputs(B, L, H, P, N, *, seed, model=False):
    """float32 inputs from numpy: the kernel search's draws (x 0.5 randn,
    steps softplus(randn) / 2, Bm and Cm 0.3 randn), or with ``model`` the
    model's layout and steps (x, Bm, Cm strided slices of one 0.4 randn
    conv output, steps softplus(randn)); A = -exp(0.3 randn), D = 1 + 0.2
    randn."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))
    if model:
        di = H * P
        conv = 0.4 * randn(B, L, di + 2 * N)
        x = conv[..., :di].reshape(B, L, H, P)
        Bm, Cm = conv[..., di:di + N], conv[..., di + N:]
    else:
        x, Bm, Cm = 0.5 * randn(B, L, H, P), 0.3 * randn(B, L, N), \
            0.3 * randn(B, L, N)
    dt = torch.nn.functional.softplus(randn(B, L, H)) * (1.0 if model
                                                         else 0.5)
    A = -torch.exp(0.3 * randn(H))
    D = 1 + 0.2 * randn(H)
    return x, dt, A, Bm, Cm, D


PRESETS = {"tiny": (1, 128, 1, 16, 16), "small": (1, 256, 2, 32, 32)}
CASES = [(f"{p} chunk {c}", PRESETS[p], c, False)
         for p in PRESETS for c in (128, 64, 32)] + [
    ("model shape", (1, 1024, 4, 64, 128), 256, True)]


def _case(shape, chunk, model):
    return _inputs(*shape, seed=31, model=model), chunk


def _pallas(args, chunk):
    x, dt, A, Bm, Cm, D = (jnp.asarray(t.contiguous().numpy()) for t in args)
    y, state = jax_ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, interpret=True)
    return (torch.from_numpy(np.array(y, np.float32)),
            torch.from_numpy(np.array(state, np.float32)))


def _kernel_cum(args, chunk):
    """The f32 cumulative decay of each chunk, (B, H, L/Q, Q), as the
    kernel hands it to the gate."""
    x, dt, A = args[:3]
    B, L, H, _ = x.shape
    Q = min(chunk, L)
    a = (dt * A[None, None, :]).reshape(B, L // Q, Q, H)
    return a.cumsum(2).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("name,shape,chunk,model", CASES)
def test_emulation_matches_ssd_ref_and_pallas(name, shape, chunk, model):
    """The 3xTF32 emulation is the same function as ``ssd_ref`` and as the
    Pallas kernel in interpret mode, y and the final state, on the same
    numpy inputs: at f32's 2e-5 at the presets; at the model shape at 2e-5
    against ssd_ref and 1e-4 against Pallas interpret."""
    args, chunk = _case(shape, chunk, model)
    y, states = cs.ssd_tf32x3_ref(*args, chunk)
    assert y.dtype == torch.float32 and y.shape == args[0].shape
    ry, rs = ssd_ref(*args, chunk)
    py, ps = _pallas(args, chunk)
    torch.testing.assert_close(y, ry, atol=TOL_F32, rtol=TOL_F32)
    torch.testing.assert_close(states[:, :, -1], rs, atol=TOL_F32,
                               rtol=TOL_F32)
    tol = TOL_MODEL if model else TOL_F32
    torch.testing.assert_close(y, py, atol=tol, rtol=tol)
    torch.testing.assert_close(states[:, :, -1], ps, atol=tol, rtol=tol)
    torch.testing.assert_close(states, cs.ssd_ref_states(*args, chunk),
                               atol=TOL_F32, rtol=TOL_F32)


@pytest.mark.parametrize("name,shape,chunk,model", CASES)
def test_gate_passes_tf32x3_and_fails_its_controls(name, shape, chunk,
                                                   model):
    """Against the exact function on the same f32 decay, the emulation's y
    (worst head) and states (worst chunk) lie under half the gate, and one
    tf32 product and bf16 hi + lo lie over it at every head and chunk."""
    args, chunk = _case(shape, chunk, model)
    cum = _kernel_cum(args, chunk)
    ex_y, ex_st = cs.ssd_tf32x3_ref(*args, chunk, split=None,
                                    dtype=torch.float64, cum=cum)
    gate = cs.SSD_TF32_GATE
    for split in ("tf32x3", "tf32", "bf16x3"):
        y, st = cs.ssd_tf32x3_ref(*args, chunk, split=split, cum=cum)
        e_y = cs.ssd_tf32_errors(y, ex_y)
        e_s = cs.ssd_state_errors(st, ex_st)
        if split == "tf32x3":
            assert e_y.max() < gate / 2 and e_s.max() < gate / 2, split
        else:
            assert e_y.min() > gate and e_s.min() > gate, split


def test_cum_given_is_the_cum_computed():
    """Handing the emulation the f32 decay it computes itself changes
    nothing: the gate's ``cum`` argument only fixes the decay."""
    args, chunk = _case(PRESETS["small"], 64, False)
    a = cs.ssd_tf32x3_ref(*args, chunk)
    b = cs.ssd_tf32x3_ref(*args, chunk, cum=_kernel_cum(args, chunk))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_product_roundings():
    """``_ssd_product``: tf32x3 is big.big + big.small + small.big of the
    tf32 halves (flash attention's ``_tf32``), tf32 is big.big alone,
    bf16x3 takes bf16 halves, None is exact; each against float64."""
    g = np.random.default_rng(5)
    a = torch.from_numpy(g.standard_normal((64, 96), np.float32))
    b = torch.from_numpy(g.standard_normal((96, 48), np.float32))
    exact = a.double() @ b.double()
    err = {s: ((cs._ssd_product(a, b, s, torch.float64) - exact).norm()
               / exact.norm()).item() for s in ("tf32x3", "tf32", "bf16x3")}
    assert err["tf32x3"] < 1e-6 < err["bf16x3"] < 1e-4 < err["tf32"]
    assert torch.equal(cs._ssd_product(a, b, None, torch.float64), exact)


def _views(B, L, H, P, N, dtype, device="cpu", extra=0):
    conv = torch.zeros(B, L, H * P + 2 * N + extra, dtype=dtype,
                       device=device)
    di = H * P
    return (conv[..., :di].reshape(B, L, H, P), conv[..., di:di + N],
            conv[..., di + N:di + 2 * N])


def _contiguous(B, L, H, P, N, dtype, device="cpu"):
    return (torch.zeros(B, L, H, P, dtype=dtype, device=device),
            torch.zeros(B, L, N, dtype=dtype, device=device),
            torch.zeros(B, L, N, dtype=dtype, device=device))


RULE_CASES = [   # name, (B, L, H, P, N), chunk, dtype, model views, instance
    *[(f"{p} preset chunk {c}", PRESETS[p], c, torch.float32, False, "tf32")
      for p in PRESETS for c in (128, 64, 32)],
    ("mamba2-130m views", (8, 512, 24, 64, 128), 256, torch.float32, True,
     "tf32"),
    ("zamba2-7b views", (2, 512, 112, 64, 64), 256, torch.float32, True,
     "tf32"),
    ("Q = 1024", (1, 2048, 6, 64, 128), 1024, torch.float32, True, "tf32"),
    ("N = 8", (1, 128, 1, 16, 8), 32, torch.float32, False, "cuda_core"),
    ("Q = 100", (1, 200, 2, 64, 128), 100, torch.float32, True, "cuda_core"),
    ("Q = 96", (1, 192, 2, 64, 64), 96, torch.float32, False, "cuda_core"),
    ("P = 48", (1, 256, 2, 48, 64), 128, torch.float32, False, "cuda_core"),
    ("bf16 model views", (8, 512, 24, 64, 128), 256, torch.bfloat16, True,
     "wgmma"),
    ("bf16 Q = 32", (1, 256, 2, 32, 32), 32, torch.bfloat16, False,
     "cuda_core"),
]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name,shape,chunk,dtype,model,want", RULE_CASES)
def test_instance_rule(name, shape, chunk, dtype, model, want, device):
    """float32 at the presets and the models' views goes to the tf32 pair,
    bfloat16 to the wgmma pair, and what neither takes (N = 8, a chunk not
    a multiple of 64 but float32's 32, P = 48) to CUDA cores; decided from
    dtype, shape and alignment, so ``meta`` tensors are sent the same
    way."""
    make = _views if model else _contiguous
    x, Bm, Cm = make(*shape, dtype, device=device)
    assert ssd_mod.instance_for(x, Bm, Cm, chunk) == want


@pytest.mark.parametrize("bad", ["x address", "row stride"])
def test_tf32_needs_tma_alignment(bad):
    """A view TMA cannot read goes to CUDA cores in float32 too: x one
    element (4 bytes) off a 16-byte boundary, or a conv row of 515 floats
    (a stride of 2060 bytes)."""
    x, Bm, Cm = _views(2, 512, 4, 64, 128, torch.float32)
    assert ssd_mod.instance_for(x, Bm, Cm, 256) == "tf32"
    if bad == "x address":
        flat = torch.zeros(2 * 512 * 4 * 64 + 1)
        x = flat[1:].reshape(2, 512, 4, 64)
    else:
        x, Bm, Cm = _views(2, 512, 4, 64, 128, torch.float32, extra=3)
    assert ssd_mod.instance_for(x, Bm, Cm, 256) == "cuda_core"


@pytest.mark.parametrize("name,shape,chunk,dtype,model,want",
                         [c for c in RULE_CASES if c[-1] == "cuda_core"])
def test_tf32_instance_refuses_what_the_rule_does(name, shape, chunk, dtype,
                                                  model, want):
    """Asked for the tf32 instances where the rule names CUDA cores, the
    instance entry raises before any launch; an unknown name raises too."""
    B, L, H, P, N = shape
    x, Bm, Cm = (_views if model else _contiguous)(*shape, dtype,
                                                   device="meta")
    dt = torch.zeros(B, L, H, device="meta")
    A, D = torch.zeros(H, device="meta"), torch.zeros(H, device="meta")
    with pytest.raises(ValueError, match="does not take these inputs"):
        ssd_mod._ssd_scan_instance(x, dt, A, Bm, Cm, D, chunk=chunk,
                                   instance="tf32")
    with pytest.raises(ValueError, match="instance must be one of"):
        ssd_mod._ssd_scan_instance(x, dt, A, Bm, Cm, D, chunk=chunk,
                                   instance="tensor_core")


def test_count_has_tf32():
    """``COUNT.tf32`` sits beside ``COUNT.wgmma`` and resets with it; a CPU
    call counts as plain."""
    ssd_mod.COUNT.reset()
    args, chunk = _case(PRESETS["tiny"], 64, False)
    ssd_mod.ssd_scan(*args, chunk=chunk)
    assert (ssd_mod.COUNT.launches, ssd_mod.COUNT.wgmma, ssd_mod.COUNT.tf32,
            ssd_mod.COUNT.plain) == (0, 0, 0, 1)
    ssd_mod.COUNT.tf32 = 3
    ssd_mod.COUNT.reset()
    assert ssd_mod.COUNT.tf32 == 0


def test_tf32_source_selects_w_and_splits_every_product():
    """The float32 third launch selects W above the diagonal (its exponent
    and its value, never a 0/1 product); every product is three tf32
    chains (big.big, big.small, small.big) added in f32; one C switch picks
    launches 1 and 3 together."""
    src = SRC.read_text()
    assert "const float e = exp_here(keep ? cq[jj][cc] - ck[i] : 0.f);" in src
    assert ("const float wv = keep ? g[4 * jj + 2 * i + cc] * e * dk[i] "
            ": 0.f;") in src
    assert re.search(r"WgmmaTf32<NW>::rs\(d, fb\[0\], fb\[1\], fb\[2\], "
                     r"fb\[3\], bb, ks > 0\);\s*"
                     r"WgmmaTf32<NW>::rs\(bs_sum, fb\[0\], fb\[1\], fb\[2\], "
                     r"fb\[3\], bsm, ks > 0\);\s*"
                     r"WgmmaTf32<NW>::rs\(sb_sum, fs\[0\], fs\[1\], fs\[2\], "
                     r"fs\[3\], bb, ks > 0\);", src)
    assert "d[e] += bs_sum[e] + sb_sum[e];" in src
    body = src[src.index("int launch(const void* x"):]
    assert body.count("instance == kTf32") == 2
    assert body.index("tf::chunk_state(") < body.index("state_pass_kernel<<<") \
        < body.index("tf::chunk_scan(")


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,chunk,model",
                         [c for c in CASES if c[0].startswith("small")
                          or c[3]])
def test_tf32_kernel_holds_the_gate_on_card(name, shape, chunk, model):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device; chip_smoke.py holds the kernel to the "
                    "3xTF32 gate on the card")
    args, chunk = _case(shape, chunk, model)
    args = tuple(t.cuda() for t in args)
    ssd_mod.COUNT.reset()
    y_err, s_err = cs.ssd_tf32_gate(name, args, chunk)
    assert ssd_mod.COUNT.tf32 == 2 and y_err <= cs.SSD_TF32_GATE
