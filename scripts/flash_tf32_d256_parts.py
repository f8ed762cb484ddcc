"""Where the float32 flash-attention kernel's time goes at head dim 256.

    python3 scripts/flash_tf32_d256_parts.py

Run from the root of a checkout, on a machine with an NVIDIA GPU and
``nvcc``.  It builds ``src/repro_torch/kernels/csrc/flash_attention.cu``
as it is and, side by side, copies of it that each drop one part of the
D = 256 body of ``flash_fwd_tf32_kernel`` (``tf32_cols``), or give its
32-key pieces a ring of five slots instead of four.  A copy that drops a
part computes the wrong function: it is timed only.  The working build
is held to f32 ``mha_ref`` first (3xTF32 gate, 8e-6).  Each build then
runs ``flash_attention`` at gemma-7b's prefill shape in float32 (B=1,
S=4096, 16 heads of 256, causal) at (bq, bk) = (128, 128) and (64, 32),
in turns (every build once, then every build again in reverse order),
timed as ``chip_smoke.py`` times its kernels.  What a part costs is the
working build's time less the copy's: the parts overlap, so the
differences do not add up to the whole.

Output: ptxas's registers and spills of each build's D = 256 instances,
then one line per build and turn, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import mha_ref  # noqa: E402

SOURCE = build.CSRC / "flash_attention.cu"
BODY_START = "__device__ __forceinline__ void tf32_cols("
BODY_END = "// grid (Sq / bq, Hq, B); block block_threads(NWG).  D <= 128"


def _cut(text, start, end):
    """text without the span from ``start`` to the end of the first
    ``end`` after it."""
    a = text.index(start)
    b = text.index(end, a) + len(end)
    return text[:a] + text[b:]


def _sole(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"expected one {old!r} in the kernel source")
    return text.replace(old, new)


def variants():
    """name -> source: the working kernel and the copies."""
    src = SOURCE.read_text()
    i0, i1 = src.index(BODY_START), src.index(BODY_END)
    body = src[i0:i1]
    parts = {
        "no K split": _sole(
            body, "split_tile<HALF / 16, NT>(ks, ks + HALF, ct);", ""),
        "no V split": _sole(body, "split_vt(vs, ct, bar);", ""),
        "no exchange": _cut(
            body, "hopper::named_sync<kSyncId, 2 * NT>();\n#pragma unroll\n"
            "        for (int j = 0; j < XN / 4; ++j)\n          x_mine",
            "s[4 * j + 3] += y.w;\n        }"),
        "no q.k wgmma": _cut(
            body, "#pragma unroll\n          for (int kk = 0; kk < 4 * KCB;"
            " ++kk) {", "kmajor(kb_addr + ko),\n                               "
            "1);\n          }"),
        "no p.v wgmma": _cut(
            body, "#pragma unroll\n          for (int ks = 0; ks < 4; ++ks) "
            "{\n            const uint32_t vo = ks * 32;",
            "kmajor(vb_addr + vo), 1);\n          }"),
        # the scores go to the A fragments as they are: no scale, mask,
        # max, exp2, sum or tf32 split
        "no softmax": _cut(
            body, "        // scale, mask, and the online softmax over the "
            "whole piece", "        for (int i = 0; i < 2; ++i) l[i] = l[i]"
            " * alpha[i] + sum[i];").replace(
            "        // pv = P.V = Pb.Vb",
            "        uint32_t pb[BKC / 8][4], ps[BKC / 8][4];\n"
            "        const float alpha[2] = {1.f, 1.f};\n"
            "#pragma unroll\n        for (int ks = 0; ks < BKC / 8; ++ks)\n"
            "#pragma unroll\n          for (int r = 0; r < 4; ++r)\n"
            "            pb[ks][r] = ps[ks][r] = "
            "__float_as_uint(s[(4 * ks + r) % XN]);\n"
            "        // pv = P.V = Pb.Vb", 1),
    }
    out = {"kernel": src}
    for name, b in parts.items():
        if b == body:
            raise ValueError(f"{name}: nothing was dropped")
        out[name] = src[:i0] + b + src[i1:]
    # 32-key pieces with five slots (their partial scores leave room)
    deeper = _sole(src, "  constexpr int D = 256, ST = kStages256;",
                   "  constexpr int D = 256, ST = BKC == 32 ? 5 : 4;")
    out["five slots at bk 32"] = _sole(
        deeper, "    p.stages = kStages256;",
        "    p.stages = bkc == 32 ? 5 : kStages256;")
    return out


def build_all(sources):
    """Every source compiled at once; name -> (library, ptxas lines of the
    D = 256 tf32 instances)."""
    out_dir = build.BUILD_DIR / "flash_d256_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    libs = {}
    for name, (proc, so) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text[-4000:]}")
        entries = [e for e in cs.ptxas_entries(text, fa.TF32_KERNEL)
                   if e[0].startswith("<256,")]
        print(f"{name}: " + "; ".join(f"{n} {r} registers, {s}"
                                      for n, r, s in entries), flush=True)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [i, i, i] + [p] * 4 + [i] * 9 + [p, ctypes.c_float, p])
        lib.flash_attention_launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i] * 5
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_tf32_d256_parts: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    libs = build_all(variants())
    print(f"built {len(libs)} in {time.time() - t0:.1f} s", flush=True)
    _, B, S, Hq, Hkv, D = cs.FLASH_D256
    q, k, v = (t.transpose(1, 2) for t in cs.flash_full_inputs(
        B, S, Hq, Hkv, D, torch.float32))
    fa._lib = libs["kernel"]
    out = fa.flash_attention(q, k, v, causal=True)
    err = (out - mha_ref(q, k, v, causal=True)).abs().max().item()
    print(f"kernel vs mha_ref: max abs err {err:.3e} (gate "
          f"{cs.TF32_GATE:g})", flush=True)
    if err > cs.TF32_GATE:
        raise AssertionError("the working build fails the 3xTF32 gate")
    names = list(libs)
    for name in names + names[::-1]:
        fa._lib = libs[name]
        times = [cs.time_ms(lambda: fa.flash_attention(  # noqa: B023
            q, k, v, causal=True, bq=bq, bk=bk), reps=10)
            for bq, bk in ((128, 128), (64, 32))]
        print(f"{name}: (128, 128) {times[0]:.4f} ms, (64, 32) "
              f"{times[1]:.4f} ms", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
