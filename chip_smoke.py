"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds every CUDA kernel of the
port's serving path from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
per source, all started together), holds each kernel against its plain
PyTorch version on the card, then serves requests through
``BatchedServer(use_kernel=True)`` at the full width of ``qwen1.5-4b``
(40 layers, d_model 2560, vocab 151936; random weights from a seeded
``torch.Generator``) and checks the kernels really ran there.  Any
failure raises, so the exit code is nonzero; without a CUDA device it
stops before printing a result.

Output: environment and per-phase lines, then one JSON line of kernel
measurements, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.models.blocks import ModelOpts  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.serve import BatchedServer, Request  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py:14
HBM_BYTES_PER_S = 3.35e12                           # H100 SXM data sheet
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
KERNELS = ["decode_attention"]

ARCH = "qwen1.5-4b"
BATCH, MAX_SEQ = 8, 512
N_REQUESTS, NEW_TOKENS, PROMPT_LEN = 16, 32, (8, 64)
TEACHER_STEPS = 4
BF16_MARGIN = 0.5     # bf16: greedy tokens must agree above this margin
F32_LOGIT_TOL = 1e-3  # f32: 40 layers summed in another order, abs and rel


def log(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, reps: int = 50) -> float:
    """Median device time of one call, L2 flushed before each (the model
    streams ~200 MB of weights between two layers' attention calls)."""
    flush = torch.empty(2 ** 26, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------
def decode_inputs(B, Hq, Hkv, S, D, lengths, dtype, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=g, device="cuda").to(dtype)
    # the model's (B, S, Hkv, D) cache, passed as a strided view
    kc = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    vc = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    ln = torch.as_tensor(np.broadcast_to(lengths, (B,)).copy(),
                         dtype=torch.int32, device="cuda")
    return q, kc.transpose(1, 2), vc.transpose(1, 2), ln


def check_decode_attention(main_lengths):
    rng = np.random.default_rng(1)
    cases = [   # name, B, Hq, Hkv, S, D, lengths, dtype
        ("test_kernels 1", 2, 8, 2, 1024, 64, 1000, torch.float32),
        ("test_kernels 2", 1, 4, 4, 2048, 128, 1024, torch.bfloat16),
        ("test_kernels 3 (G=8)", 1, 16, 2, 1024, 64, 17, torch.float32),
        ("per-slot lengths", 4, 8, 2, 1024, 64,
         rng.integers(1, 1025, 4), torch.float32),
        ("G=4 bf16 per-slot", 2, 16, 4, 1024, 128, (300, 1), torch.bfloat16),
        ("length 0", 2, 8, 2, 512, 64, 0, torch.float32),
        ("ragged S=300", 3, 8, 2, 300, 64, (0, 150, 300), torch.float32),
        ("D=16 ragged", 2, 4, 4, 77, 16, (77, 5), torch.bfloat16),
        ("D=256", 2, 8, 1, 200, 256, (200, 33), torch.bfloat16),
        ("main path", BATCH, 20, 20, MAX_SEQ, 128, main_lengths,
         torch.float32),
    ]
    errs = {}
    for i, (name, B, Hq, Hkv, S, D, lengths, dt) in enumerate(cases):
        q, k, v, ln = decode_inputs(B, Hq, Hkv, S, D, lengths, dt, seed=i)
        out = da.decode_attention(q, k, v, ln)
        torch.cuda.synchronize()
        ref = da.decode_attention_plain(q, k, v, ln).float()
        err = (out.float() - ref).abs().max().item()
        log(f"decode_attention {name}: B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} "
            f"{str(dt)[6:]} max_abs_err={err:.3e} (tol {TOL[dt]:g} abs+rel)")
        if not torch.allclose(out.float(), ref, atol=TOL[dt], rtol=TOL[dt]):
            raise AssertionError(f"decode_attention disagrees at {name}")
        errs[name] = err
    return errs["main path"]


def measure_decode_attention(main_lengths):
    """Times at the main path's shape: kernel, plain version, and SDPA
    (the library yardstick; the port never calls it)."""
    B, H, S, D, dt = BATCH, 20, MAX_SEQ, 128, torch.float32
    q, k, v, ln = decode_inputs(B, H, H, S, D, main_lengths, dt, seed=99)
    mask = (torch.arange(S, device="cuda")[None, :] < ln[:, None])
    mask = mask[:, None, None, :]                         # (B, 1, 1, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_out = sdpa(q[:, :, None], k, v, attn_mask=mask)[:, :, 0]
    ref = da.decode_attention_plain(q, k, v, ln)
    if not torch.allclose(sdpa_out, ref, atol=1e-4, rtol=1e-4):
        raise AssertionError("SDPA yardstick computes another function")
    ms = time_ms(lambda: da.decode_attention(q, k, v, ln))
    plain_ms = time_ms(lambda: da.decode_attention_plain(q, k, v, ln))
    library_ms = time_ms(lambda: sdpa(q[:, :, None], k, v, attn_mask=mask))
    n_read = int(np.minimum(np.asarray(main_lengths), S).sum())
    elem = torch.finfo(dt).bits // 8
    nbytes = (q.numel() * elem                      # q
              + 2 * n_read * H * D * elem           # K and V rows < length
              + B * 4                               # length
              + q.numel() * elem)                   # out
    ops = 4 * n_read * H * D                        # q.k and p.v, G = 1
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dt] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"decode_attention main path: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
        f" ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({nbytes} bytes at 3.35 TB/s; {ops} flops)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------
def serve_full_width():
    cfg = get_config(ARCH)
    model = build_model(cfg)
    t0 = time.time()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    server = BatchedServer(model, params, batch_size=BATCH, max_seq=MAX_SEQ,
                           opts=ModelOpts(attn_chunk=64),
                           use_kernel=True, device="cuda")
    del params                      # the server keeps its bf16 copy
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(server.params))
    log(f"{ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters, set up in {time.time() - t0:.1f} s; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if not server.use_kernel:
        raise AssertionError("the server refused the kernel")

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1)
            ).tolist(), max_new_tokens=NEW_TOKENS) for i in range(N_REQUESTS)]
    da.COUNT.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = da.COUNT.launches, da.COUNT.plain
    steps = server.steps
    generated = sum(len(v) for v in results.values())
    log(f"served {len(results)} requests: {steps} decode steps, {generated} "
        f"tokens generated, {wall:.3f} s, {wall / steps * 1e3:.3f} ms/step, "
        f"{generated / wall:.2f} tokens/s, "
        f"{(generated + sum(len(r.prompt) - 1 for r in reqs)) / wall:.2f} "
        f"tokens/s incl. prompt feeding")
    log(f"decode_attention launches: {launches} = {cfg.n_layers} x {steps} "
        f"steps; plain-version calls: {plain}")
    if sorted(results) != list(range(N_REQUESTS)) or any(
            len(v) != NEW_TOKENS for v in results.values()):
        raise AssertionError("not every request finished")
    if launches != cfg.n_layers * steps or plain != 0:
        raise AssertionError("the main path did not go through the kernel")
    return model, server, launches, dict(steps=steps, wall_s=wall,
                                         generated=generated)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def teacher_forced(model, params, cache_src):
    """The same tokens through decode_step with the kernel and without, on
    two copies of a cache -> [(kernel logits, plain logits)] per step."""
    rng = np.random.default_rng(2)
    pos = torch.as_tensor(rng.integers(1, 200, BATCH), dtype=torch.int32,
                          device="cuda")
    caches = [{k: v.clone() for k, v in cache_src.items()} for _ in range(2)]
    pairs = []
    for step in range(TEACHER_STEPS):
        tok = torch.as_tensor(rng.integers(0, model.cfg.vocab, (BATCH, 1)),
                              device="cuda")
        pairs.append([model.decode_step(
            params, {"token": tok, "pos": pos + step}, cache,
            opts=ModelOpts(use_kernel=use_kernel))[0]
            for cache, use_kernel in zip(caches, (True, False))])
    for a, _ in pairs:
        if a.shape != (BATCH, model.cfg.vocab) or not torch.isfinite(a).all():
            raise AssertionError("kernel-path logits are not finite")
    return pairs


def teacher_forced_check(model, server):
    """Kernel vs plain decode steps, at full width.

    In bf16 (the served dtype) a 1e-7 difference in an attention output
    can flip a bf16 rounding, and 40 layers of random weights amplify it,
    so there only decisive greedy tokens must agree: the kernel's argmax
    equals the plain path's wherever the plain top-2 margin exceeds
    BF16_MARGIN.  The same check in float32 compute dtype (f32 weights
    from the same seed) holds the logits at F32_LOGIT_TOL.
    """
    worst, decisive = 0.0, 0
    for a, b in teacher_forced(model, server.params, server.cache):
        worst = max(worst, (a - b).abs().max().item())
        top2 = b.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > BF16_MARGIN
        decisive += int(sure.sum())
        if not torch.equal(a.argmax(-1)[sure], b.argmax(-1)[sure]):
            raise AssertionError("kernel path changed a decisive token")
    log(f"teacher-forced bf16: {TEACHER_STEPS} steps, kernel vs plain "
        f"logits max diff {worst:.3e}; {decisive}/{TEACHER_STEPS * BATCH} "
        f"tokens with top-2 margin > {BF16_MARGIN:g}, all equal")

    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator("cuda").manual_seed(0))
    worst = 0.0
    for a, b in teacher_forced(model32, params32, server.cache):
        worst = max(worst, (a - b).abs().max().item())
        if not torch.allclose(a, b, atol=F32_LOGIT_TOL, rtol=F32_LOGIT_TOL):
            raise AssertionError(f"f32 kernel vs plain logits differ by "
                                 f"{(a - b).abs().max().item()}")
    log(f"teacher-forced float32: {TEACHER_STEPS} steps, kernel vs plain "
        f"logits max diff {worst:.3e} (tol {F32_LOGIT_TOL:g} abs+rel)")
    del params32


def profile_steps(model, server, n=3):
    """Device time by kernel over a few kernel-path decode steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tok = torch.zeros((BATCH, 1), dtype=torch.long, device="cuda")
    pos = torch.full((BATCH,), 100, dtype=torch.int32, device="cuda")
    opts = ModelOpts(use_kernel=True)
    model.decode_step(server.params, {"token": tok, "pos": pos}, server.cache,
                      opts=opts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            model.decode_step(server.params, {"token": tok, "pos": pos},
                              server.cache, opts=opts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device rows only: an operator's own "device time" repeats its kernels'
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.key, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True)
    if not rows:
        log("profile: no device time in the trace (not measured)")
        return
    busy = sum(r[0] for r in rows)
    log(f"profile over {n} steps (profiler on): wall {wall_ms / n:.3f} "
        f"ms/step, {sum(r[2] for r in rows) // n} kernels/step, device "
        f"busy {busy / n:.3f} ms/step, idle share {1 - busy / wall_ms:.1%}")
    for ms, key, count in rows[:10]:
        log(f"  {ms / n:9.4f} ms/step  x{count // n:<5d} {key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    logs = build.build_all(KERNELS)
    log(f"built {KERNELS} in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or ("spill" in line
                                  and "0 bytes spill" not in line):
                log(f"  {name}: {line.strip()}")

    # lengths of the served run: prompt 8-64 plus up to 32 new tokens
    main_lengths = np.random.default_rng(3).integers(
        PROMPT_LEN[0], PROMPT_LEN[1] + NEW_TOKENS + 1, BATCH)
    err = check_decode_attention(main_lengths)
    timing = measure_decode_attention(main_lengths)

    model, server, launches, run = serve_full_width()
    profile_steps(model, server)
    teacher_forced_check(model, server)

    kernels = [dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:59",
        launches=launches, max_abs_err=err, **timing)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
