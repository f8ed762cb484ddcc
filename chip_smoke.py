"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds every CUDA kernel of the
port from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all
started together) and holds each kernel against its plain PyTorch version
on the card.  Then it drives these paths at full width, with random weights
from a seeded ``torch.Generator``, and checks that each path's kernel
really ran there:

* dense serving: ``BatchedServer(use_kernel=True)`` on ``qwen1.5-4b``
  (40 layers, d_model 2560, vocab 151936) with the flash-decode kernel,
  one launch a call: a profiled step must hold one per layer.  Before it
  the kernel is timed at four readings (the main path's shape, the MoE
  path's, ``long_500k`` at zamba2-7b's widths, GQA ``decode_32k`` at
  minitron-8b's) beside its bytes bound, SDPA and the plain version;
* MoE serving: the same server and request mix on
  ``phi3.5-moe-42b-a6.6b`` at full width (d_model 4096, 32 heads, GQA kv
  8, 16 experts of d_ff 6400, top-2, vocab 32064), its depth cut to 16
  of 32 layers so its 42.1 GB of bf16 weights fit the card (all 32 need
  83.7 GB), drawn one layer at a time.  Every layer of every step runs
  the flash-decode kernel; a profiled step splits the device time into
  the kernel, the expert products, other GEMMs and other kernels, and
  kernel vs plain decode steps are held as for dense, in float32 at 4
  layers;
* ssm: ``Model.loss`` on ``mamba2-130m`` (24 layers, d_model 768, vocab
  50280) at 8 x 4096 tokens with the ``ssd_scan`` kernel, held against the
  plain path, then ``BatchedServer`` serving requests on the same model.
  Every bf16 call runs launches 1 and 3 on the tensor cores
  (``chunk_state_wgmma_kernel``, ``chunk_scan_wgmma_kernel``: both SASS
  must hold bf16 ``HGMMA``, their CUDA-core siblings none, and a profiled
  forward must show each once a layer).  Before it the scan is held to
  two gates at the main shape: the share of bf16 y that differs from
  ``ssd_ref`` and the final state's error, which controls keeping W and
  the carried state (launch 3) or x o w (launch 1) in bf16 alone fail;
  and timed by launch beside each launch's bound;
* hybrid: ``Model.loss`` on ``zamba2-7b`` at full width and depth (81
  Mamba layers in 13 groups of 6 and 3 in ``rem``, one shared attention
  block; 6.75 B parameters, 13.5 GB in bf16) at 8 x 4096 tokens with the
  ``ssd_scan`` kernel: exactly one call a Mamba layer, each on the
  tensor-core instances, a profiled forward split into ``ssd_scan``,
  GEMMs, attention's elementwise passes and the rest; held against the
  plain path (bf16: the loss and the first Mamba layer's mixer output;
  float32 at 2 groups).  Before it ``ssd_scan`` alone at zamba2's shape
  (H 112, P 64, N 64, chunk 256, on the model's strided views) is held to
  the split and state gates and timed by launch.  Then decode against
  prefill, and ``BatchedServer``'s lockstep fallback on the dense request
  mix, where no port kernel may launch (the reference's hybrid decode
  passes none);
* vlm: ``llama-3.2-vision-90b`` at full width (d_model 8192, 64 heads, kv
  8, d_ff 28672, vocab 128256, 1,601 image tokens), its depth cut to 2 of
  10 groups (18 self and 2 cross layers, 35.6 GB in bf16; all 100 layers
  need 161.2 GB): ``prefill`` at 1 x 4096 with seeded image embeddings, 32
  decode steps on its cache held against the prefill of the longer
  sequence, then the lockstep server on the dense mix; no port kernel;
* audio: ``prefill`` (the encoder pass, logits per frame) of
  ``hubert-xlarge`` at full width and depth (48 layers) on 8 x 4096
  seeded frames, and a float32 prefill card vs CPU at 2 layers; no port
  kernel;
* gemma3: ``gemma3-27b`` at full width and depth (62 layers: 10
  superblocks of 5 local layers and 1 global, then 2 local; 27.0 B
  parameters, 54.0 GB in bf16, drawn one layer at a time) through the
  banded local:global path (``ModelOpts(banded_local=True)``, whose local
  layers attend to 1,536 of 4,096 keys) and the unbanded one:
  ``Model.loss`` on B x 4096 tokens (B = 4 where twice B = 2's working
  set fits beside the weights, else 2), each timed and profiled, their
  losses held; in float32 at 8 layers (one superblock and a remainder of
  2) banded against unbanded, and decode after a prefill against the
  prefill of all the tokens; at 8 layers the loss and gradient (f32
  masters, remat "full") banded against unbanded in bf16, each timed with
  its peak memory, and in float32; prefill 1 x 4096 and 32 decode steps
  at full depth,
  and the per-slot server on the dense request mix.  The reference's
  banded path calls no kernel: no port kernel may launch in the phase;
* training: ``TrainLoop.train_step`` (``Model.loss`` and its gradient
  with ``remat="full"``, the cosine schedule, AdamW with clipping) on
  ``qwen1.5-4b`` at full width, its depth cut to 24 of 40 layers (f32
  masters, grads, m and v take 16 B a parameter: 42.9 GB at 24 layers,
  63.2 GB at 40), B = 2 x S = 4096 in bf16 on ``SyntheticLMData(seed=0)``
  batches, 6 steps timed and one profiled (kernels, idle share, device ms
  by part, model FLOP/s against 989 TFLOP/s).  Held: one f32 step on the
  card against the same step on the CPU (the path the CPU tests hold
  against the reference); bf16 against f32 and remat full against none at
  full width and 4 layers; ``TrainLoop.run`` crashed at step 6 and
  resumed against an uninterrupted run.  The path is the reference's,
  which differentiates no kernel: no port kernel may launch in the phase;
* kernel search: both rungs of the ``kernel`` fidelity ladder
  (``kernels/bench.py``) on every candidate of ``kernel_domain("tiny")``
  and ``kernel_domain("small")``, which runs all three kernels at every
  block size the domain offers (``flash_attention`` in float32, on its
  tensor-core kernel ``flash_fwd_tf32_kernel``: every launch of the search
  must be one of it).  That kernel's SASS must hold tf32 ``HGMMA``
  instructions (two instances at D = 256, which ptxas must build without
  a spill), and its output must pass a 3xTF32 gate against ``mha_ref`` at
  every block of both presets and at the qwen1.5-4b and gemma-7b prefill
  shapes in float32, which its two controls (one tf32 product; bf16 hi +
  lo, both emulated by ``flash_tf32x3_ref``) fail;
* search: the paper's methods search that ladder through the port's own
  engine (``repro_torch.exp``, serial backend, a store in a fresh
  temporary directory).  ``bind_ladder("kernel", preset="small",
  reps=5)``'s 15 top-rung units run exhaustively through
  ``ExperimentEngine.run`` (the measured optimum; each kernel's launches
  must grow by exactly its computed units times the calls one
  ``eval_kernel_time`` makes), then ``random``, ``smac``, ``mf_sh`` and
  ``mf_prefilter`` at budget 9 and ``cb_rbfopt`` at its least budget, 11,
  seeds 0 and 1, through ``drive_units``: every top-rung unit they ask
  for must be a store hit, no kernel may launch and no plain version run.
  Each pick, its time on the card, its regret against the optimum and its
  evaluations per rung are logged.  Then the offline leg on the host:
  ``examples/quickstart.py``'s flow (CloudBandit over RBFOpt, ``random``
  and ``smac`` at B = 33 on ``xgboost@santander`` / cost, each held equal
  to its run through the engine) and every registered method at B = 33
  on the whole table (30 workloads x 2 targets).  The phase holds itself
  to ``SEARCH_BUDGET_S``;
* bf16 prefill attention: ``ops.mha`` at three full-width shapes
  (qwen1.5-4b; a gemma3-27b local layer; gemma-7b, head dim 256) on the
  tensor-core ``flash_attention`` kernel, whose SASS must hold ``HGMMA``
  instructions in every instance (four at D = 256), whose instances ptxas
  must build without a spill, and which must be the only attention
  kernel in a profiler window around ``ops.mha``.  Its output must pass a
  gate against ``mha_ref`` that two controls keeping p in bf16 (SDPA,
  ``mha_p_bf16``) fail, so p.v is held to p_hi + p_lo.  At head dim 256
  the CUDA-core kernel is timed in turns with it on the same inputs, and
  float32 runs ``flash_fwd_tf32_kernel``, timed in turns with the
  CUDA-core kernel beside SDPA in float32.

Any failure raises, so the exit code is nonzero; without a CUDA device it
stops before printing a result.

Output: environment and per-phase lines, then one JSON line of kernel
measurements, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cloudbandit import b1_for_budget  # noqa: E402
from repro_torch.core.drivers import CloudBanditDriver  # noqa: E402
from repro_torch.core.evaluate import (  # noqa: E402
    run_search, savings_for_history)
from repro_torch.core.fidelity import bind_ladder  # noqa: E402
from repro_torch.core.objectives import bind_objective  # noqa: E402
from repro_torch.core.optimizers import RBFOpt  # noqa: E402
from repro_torch.core.registry import get_method, method_names  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData, to_device  # noqa: E402
from repro_torch.kernels import bench  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import mha_ref, ssd_ref  # noqa: E402
from repro_torch.distrib.logical import NOSHARD  # noqa: E402
from repro_torch.exp import (  # noqa: E402
    ExperimentEngine, ResultStore, drive_units)
from repro_torch.exp.runners import search_runner  # noqa: E402
from repro_torch.multicloud import build_dataset  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.blocks import ModelOpts  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    activation, chunked_cross_entropy, embed, rmsnorm)
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    _groups, build_model, layer_slice, precast, unstack_groups)
from repro_torch.optim import adamw_init, global_norm  # noqa: E402
from repro_torch.runtime.fault import (  # noqa: E402
    FailureInjector, SimulatedCrash)
from repro_torch.runtime.serve import BatchedServer, Request  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    TrainLoop, TrainLoopConfig)
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py:14
HBM_BYTES_PER_S = 3.35e12                           # H100 SXM data sheet
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TF32_OPS = 495e12                                   # tensor cores, dense
SPIN_CYCLES = 2_000_000   # ~1 ms of the card's clock queued before each rep
WGMMA_KERNEL = "flash_fwd_wgmma_kernel"           # bf16 flash attention
TF32_KERNEL = "flash_fwd_tf32_kernel"             # f32 flash attention
F32_FLASH_KERNEL = "flash_fwd_kernel"   # CUDA cores: what TMA cannot read
SSD_STATE_KERNEL = "chunk_state_wgmma_kernel"     # bf16 ssd_scan, launch 1
SSD_WGMMA_KERNEL = "chunk_scan_wgmma_kernel"      # bf16 ssd_scan, launch 3
SSD_LAUNCHES = (SSD_STATE_KERNEL, "state_pass_kernel",
                SSD_WGMMA_KERNEL)                 # one ssd_scan call, bf16
SSD_CUDA_CORE = ("chunk_state_kernel", "chunk_scan_kernel")  # their siblings
KERNELS = ["decode_attention", "ssd_scan", "flash_attention"]
DECODE_KERNEL = "decode_attention_kernel"        # one launch a call
PORT_KERNEL_NAMES = (DECODE_KERNEL, "chunk_state_kernel", SSD_STATE_KERNEL,
                     "state_pass_kernel", "chunk_scan_kernel", SSD_WGMMA_KERNEL,
                     "flash_fwd_kernel", "flash_fwd_wgmma_kernel",
                     "flash_fwd_tf32_kernel")  # the __global__s of csrc/

ARCH = "qwen1.5-4b"
BATCH, MAX_SEQ = 8, 512
N_REQUESTS, NEW_TOKENS, PROMPT_LEN = 16, 32, (8, 64)
TEACHER_STEPS = 4
BF16_MARGIN = 0.5     # bf16: greedy tokens must agree above this margin
F32_LOGIT_TOL = 1e-3  # f32: 40 layers summed in another order, abs and rel

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 16       # of 32: 42.1 GB of bf16 weights; all 32 need 83.7 GB
MOE_F32_LAYERS = 4    # the float32 teacher-forced check: 21.9 GB of weights
EXPERT_OPS = ("aten::bmm",)           # the expert products, batched by expert
GEMM_OPS = ("aten::mm", "aten::addmm")  # every other product of a step

SSM_ARCH = "mamba2-130m"
SSM_BATCH, SSM_LEN, SSM_CE_CHUNK = 8, 4096, 1024     # the train_4k length
SSM_FORWARDS = 3            # timed kernel-path Model.loss calls
SSM_F32_TOL = 1e-3          # f32 config: hidden states and loss, abs and rel
SSM_BF16_MIXER_REL = 1e-3   # bf16, layer 0's mixer output, ||k-p|| / ||p||
SSM_BF16_LOSS_REL = 1e-3    # bf16, 24 layers: the loss, relative
SSM_SERVE_SEQ = 128

# the hybrid family: zamba2-7b at full width and depth (81 Mamba layers in
# 13 groups of 6 and 3 in rem, one shared attention block; 6.75 B
# parameters, 13.5 GB in bf16), Model.loss at the forward metric's B x L
HYBRID_ARCH = "zamba2-7b"
HYBRID_FORWARDS = 2          # timed kernel-path Model.loss calls
HYBRID_F32_GROUPS = 2        # the float32 check: 2 of 13 groups, 12 layers
HYBRID_BF16_MIXER_REL = 1e-3  # bf16, the first Mamba layer's mixer output
HYBRID_BF16_LOSS_REL = 1e-3   # bf16, 81 layers: the loss, relative
# float32 at 2 groups, kernel vs plain: each Mamba layer's mixer output on
# the same input, and the forward's hidden states, relative in norm
# (hybrid_f32_check's log in PR 24's runs: 6.4-6.8e-6 a layer, 1.04e-4
# after two groups)
HYBRID_F32_MIXER_REL = 5e-5
HYBRID_F32_HIDDEN_REL = 1e-3
TEACHER_LEN = 32             # tokens decoded one by one against prefill
# ssd_scan alone at zamba2's shape on the model's strided views
SSD_HYBRID = (SSM_BATCH, SSM_LEN, 112, 64, 64, 256)  # B, L, H, P, N, chunk
# the vlm family: llama-3.2-vision-90b at full width, its depth cut to 2 of
# 10 groups (18 self and 2 cross layers, 17.8 B parameters, 35.6 GB in
# bf16; all 100 layers need 161.2 GB)
VLM_ARCH = "llama-3.2-vision-90b"
VLM_GROUPS = 2
VLM_LEN, VLM_STEPS = 4096, 32   # prefill B = 1 x 4096, then 32 decode steps
# the audio family: hubert-xlarge at full width and depth (48 layers)
AUDIO_ARCH = "hubert-xlarge"
AUDIO_FORWARDS = 2           # timed prefills
AUDIO_CHECK = (2, 1, 256)    # card vs CPU in float32: layers, B, frames
AUDIO_DEVICE_TOL = 1e-4      # f32 logits, card vs CPU, abs and rel
# the banded local:global path: gemma3-27b at full width and depth (62
# layers: 10 superblocks of 5 local + 1 global layer, then 2 local; 27.01 B
# parameters, 54.0 GB in bf16)
GEMMA_ARCH = "gemma3-27b"
GEMMA_FORWARDS = 3           # timed Model.loss calls each way: the median
GEMMA_MARGIN = 4 * 2**30     # B = 4 only if this much of the card is left
GEMMA_LOSS_REL = 1e-3        # bf16, banded vs unbanded: the loss, relative
GEMMA_CHECK_LAYERS = 8       # 1 superblock + 2 local, as 10 x 6 + 2 is
GEMMA_F32_REL = 1e-5         # float32: hidden states in norm, and the loss
# the gradients at 8 layers, whole tree, relative in norm: float32 banded
# vs unbanded at test_torch_train's f32 tolerance; bf16 banded vs unbanded
# within GEMMA_BF16_NOISE times the unbanded bf16 gradient's distance from
# the float32 one, the triangle's bound if banding adds no error beyond
# bf16's own (on an H100: 2.25e-2 banded vs unbanded, 6.3e-2 from f32)
GEMMA_F32_GRAD_REL = 1e-4
GEMMA_BF16_NOISE = 2.0
GEMMA_STEPS = 32             # decode steps after a prefill of 1 x 4096

# the training path: qwen1.5-4b at full width, its depth cut so that the
# f32 masters, grads, m and v (16 B a parameter) fit the card with the
# bf16 precast copy and the activations: 24 layers, 2.68 B parameters,
# 42.9 GB (all 40: 3.95 B and 63.2 GB, with no margin on 80 GB)
TRAIN_LAYERS = 24
TRAIN_BATCH, TRAIN_SEQ = 2, 4096     # train_4k's length
TRAIN_STEPS = 6                      # timed: the median of steps 1-5
TRAIN_OPTS = ModelOpts(attn_chunk=512, ce_chunk=1024, remat="full")
TRAIN_CHECK_LAYERS = 4     # full width: bf16 vs f32, remat full vs none
TRAIN_DEVICE_REL = 1e-5    # f32 step, card vs CPU: loss, grad norm, params
TRAIN_BF16_LOSS_REL = 5e-3    # bf16 vs f32 step from the same masters
TRAIN_BF16_GNORM_REL = 2e-2   # tests/test_kernels.py:14's bf16 TOL
TRAIN_REMAT_LOSS_REL = 1e-6   # remat full vs none: the same forward
TRAIN_REMAT_GRAD_REL = 1e-3   # the grads, whole tree, relative in norm
TRAIN_RESUME_REL = 1e-3       # resumed vs uninterrupted losses, bf16
TRAIN_LOOP_STEPS, TRAIN_CRASH_AT = 8, 6
PEAK_BF16 = PEAK_OPS[torch.bfloat16]

# full-width prefill shapes for flash_attention through ops.mha, bf16:
# name, B, S (the train_4k length), Hq, Hkv, D, window
FLASH_FULL = [("qwen1.5-4b prefill", 1, 4096, 20, 20, 128, 0),
              ("gemma3-27b local layer", 1, 4096, 32, 16, 128, 1024)]
# head dim 256: gemma-7b prefill (configs/gemma_7b.py) through ops.mha,
# causal; bf16 and f32 each on its tensor-core kernel
FLASH_D256 = ("gemma-7b prefill", 1, 4096, 16, 16, 256)
# the split-p gate at those shapes, bf16 outputs against mha_ref: the
# largest abs error (atol only) and the share of outputs that differ
SPLIT_MAX_ABS, SPLIT_DIFF_SHARE = 8e-3, 0.02
# the 3xTF32 gate, f32 outputs against f32 mha_ref: the largest abs error.
# Emulated (flash_tf32x3_ref): 3xTF32 0.7-2.5e-6; bf16 hi + lo 1.0-2.5e-5;
# one tf32 product ~1e-3.
TF32_GATE = 8e-6
# the ssd split gate: the share of bf16 y values that differ from ssd_ref's.
# W and the state as bf16 hi + lo differ in ~0.2 % (float64 emulation at
# the model's widths); either kept to bf16 alone, in 19-33 %.
SSD_SPLIT_SHARE = 0.01
# the ssd state gate: the state leaving each chunk against ssd_ref's,
# relative in norm, at the worst chunk (each chunk's own state from launch 1
# enters the next chunk's state undecayed, so every chunk is held).  Float64
# emulation (ssd_split_ref; tests/test_torch_ssd_split.py's inputs, B=1,
# L=1024, H=4, 4 chunks, and ssd_gate_phase's log at the main shape): x o w
# as bf16 hi + lo 2.4-2.7e-6 from the exact states at the worst chunk; f32
# ssd_ref_states itself up to 7.5e-6; x o w in bf16 alone 1.52e-3 or more
# at every chunk.  The limit is 19x the split's, room for the card's
# truncating sums and ssd_ref's own f32 error, and 30x below the control.
# (The y gate alone does not see x o w in bf16 at the model's steps: the
# share of y it moves stays under SSD_SPLIT_SHARE there; ssd_gate_phase
# logs it.)
SSD_STATE_REL = 5e-5
DOMAIN_REPS = 5           # eval_kernel_time reps per candidate
DOMAIN_TOL = {"flash_attention": TOL[torch.float32],     # f32 attention
              "decode_attention": TOL[torch.float32],
              "ssd_scan": 2e-2}                # tests/test_fidelity.py:347
#: the search phase (``search_phase``): fig6's kernel budget and seeds
#: (benchmarks/fig6_fidelity.py); cb_rbfopt's least budget over three
#: arms (b1_for_budget); the offline leg's budget (examples/quickstart.py)
SEARCH_METHODS = ("random", "smac", "mf_sh", "mf_prefilter", "cb_rbfopt")
SEARCH_BUDGET = {"cb_rbfopt": 11}
KERNEL_BUDGET = 9
SEARCH_SEEDS = (0, 1)
OFFLINE_BUDGET = 33
#: the search phase's wall-time budget, seconds, kernel sweep and offline
#: leg together (their readings are in PERF.md)
SEARCH_BUDGET_S = 90.0


def log(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, reps: int = 50) -> float:
    """Median device time of one call, L2 flushed before each (the model
    streams ~200 MB of weights between two layers' attention calls).

    Each rep's events and launches queue behind a spin of the card
    (``SPIN_CYCLES``, after the flush), so the host has enqueued the
    whole call before the start event runs and the pair reads device
    time: without it a call of a few microseconds is timed as its
    wrapper's host work whenever that outlasts the flush."""
    flush = torch.empty(2 ** 26, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def host_us(fn, calls: int = 2000) -> float:
    """Microseconds per call on the host clock over ``calls`` calls with
    one synchronise at the end: the wrapper's host cost wherever the
    device keeps up (a kernel shorter than it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


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
        ("D=80 (hubert-xlarge)", 2, 8, 2, 300, 80, (300, 17), torch.float32),
        ("D=80 bf16", 2, 8, 2, 300, 80, (129, 1), torch.bfloat16),
        ("D=112 (zamba2-7b)", 2, 8, 2, 300, 112, (300, 17),
         torch.float32),
        ("D=112 bf16", 2, 8, 2, 300, 112, (129, 1), torch.bfloat16),
        ("G=8 near S", 2, 16, 2, 1000, 128, (999, 1000), torch.float32),
        ("G=8 bf16 near S", 3, 64, 8, 4096, 128, (4095, 4096, 1),
         torch.bfloat16),
        ("G=5 (llama4-scout)", 2, 40, 8, 700, 128, (700, 333),
         torch.bfloat16),
        ("G=16, two head groups", 2, 32, 2, 500, 64, (499, 0),
         torch.float32),
        ("G=3 D=256", 2, 6, 2, 300, 256, (300, 1), torch.float32),
        ("main path", BATCH, 20, 20, MAX_SEQ, 128, main_lengths,
         torch.float32),
        ("MoE path (G=4)", BATCH, 32, 8, MAX_SEQ, 128, main_lengths,
         torch.float32),
        # the small shapes of tests/test_torch_decode_split.py's planner test
        ("G=5 ragged S=77", 3, 10, 2, 77, 64, (77, 30, 0), torch.float32),
        ("G=16 S=300", 2, 32, 2, 300, 64, (300, 129), torch.bfloat16),
    ]
    errs = {}
    for i, (name, B, Hq, Hkv, S, D, lengths, dt) in enumerate(cases):
        q, k, v, ln = decode_inputs(B, Hq, Hkv, S, D, lengths, dt, seed=i)
        da.COUNT.reset()
        out = da.decode_attention(q, k, v, ln)
        torch.cuda.synchronize()
        if da.COUNT.launches != 1:
            raise AssertionError(f"decode_attention took {da.COUNT.launches}"
                                 f" launches at {name}")
        ref = da.decode_attention_plain(q, k, v, ln).float()
        err = (out.float() - ref).abs().max().item()
        log(f"decode_attention {name}: B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} "
            f"{str(dt)[6:]} max_abs_err={err:.3e} (tol {TOL[dt]:g} abs+rel)")
        if not torch.allclose(out.float(), ref, atol=TOL[dt], rtol=TOL[dt]):
            raise AssertionError(f"decode_attention disagrees at {name}")
        errs[name] = err
    # rows 65 floats apart, not a multiple of 16 bytes: the element loads
    q, k, v, ln = decode_inputs(2, 8, 2, 300, 64, (300, 17), torch.float32,
                                seed=50)
    pad = [torch.zeros(2, 2, 300, 65, device="cuda") for _ in range(2)]
    for t, src in zip(pad, (k, v)):
        t[..., :64] = src
    out = da.decode_attention(q, pad[0][..., :64], pad[1][..., :64], ln)
    ref = da.decode_attention_plain(q, k, v, ln)
    log(f"decode_attention unaligned rows (stride 65): max_abs_err "
        f"{(out - ref).abs().max().item():.3e}")
    if not torch.allclose(out, ref, atol=TOL[torch.float32],
                          rtol=TOL[torch.float32]):
        raise AssertionError("decode_attention disagrees on unaligned rows")
    # a scalar length stands for every slot, as in the reference
    for length in (150, 0, 1000):
        out = da.decode_attention(q, k, v, length)
        ref = da.decode_attention_plain(q, k, v, length)
        log(f"decode_attention scalar length {length}: max_abs_err "
            f"{(out - ref).abs().max().item():.3e}")
        if not torch.allclose(out, ref, atol=TOL[torch.float32],
                              rtol=TOL[torch.float32]):
            raise AssertionError(f"decode_attention disagrees at scalar "
                                 f"length {length}")
    return errs["main path"]


def decode_readings(main_lengths):
    """The shapes decode_attention is timed at: name, B, Hq, Hkv, S, D,
    dtype, per-slot lengths, reps of the kernel's timer."""
    s32k = 32768
    return [
        # qwen1.5-4b serving: the server's f32 cache, the served lengths
        ("main path", BATCH, 20, 20, MAX_SEQ, 128, torch.float32,
         np.asarray(main_lengths), 50),
        # phi3.5-moe serving: GQA 32/8, the same cache and lengths
        ("MoE path", BATCH, 32, 8, MAX_SEQ, 128, torch.float32,
         np.asarray(main_lengths), 50),
        # long_500k (configs/base.py): zamba2-7b's shared attention, B = 1
        ("long_500k", 1, 32, 32, 524288, 112, torch.float32,
         np.array([524288]), 10),
        # decode_32k: minitron-8b's GQA attention, its batch of 128 cut to
        # 32 so the plain check fits beside the 4.3 GB cache
        ("decode_32k GQA", 32, 32, 8, s32k, 128, torch.bfloat16,
         np.random.default_rng(5).integers(1, s32k + 1, 32), 10),
    ]


def decode_bound(B, Hq, Hkv, S, D, dtype, lengths):
    """(bytes, flops) one call needs: K and V rows below each length (all
    S where it is 0) read once, q read and out written once; q.k and
    p.v at 2 flops an element for each of the G heads."""
    ln = np.asarray(lengths)
    n_read = int(np.where(ln <= 0, S, np.minimum(ln, S)).sum())
    elem = torch.finfo(dtype).bits // 8
    nbytes = (2 * n_read * Hkv * D * elem + 2 * B * Hq * D * elem + B * 4)
    return nbytes, 4 * n_read * Hq * D


def measure_decode_attention(main_lengths):
    """Each reading of ``decode_readings``: the kernel's device time with
    the L2 flushed, its bytes bound at 3.35 TB/s and achieved GB/s, the
    plain version's and SDPA's times (the library yardstick, boolean
    mask, ``enable_gqa`` where G > 1; the port never calls it), the
    wrapper's host cost at the main shape, and the kernel and
    ``decode_split_ref`` against the plain version at TOL."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for i, (name, B, Hq, Hkv, S, D, dt, lengths, reps) in enumerate(
            decode_readings(main_lengths)):
        q, k, v, ln = decode_inputs(B, Hq, Hkv, S, D, lengths, dt,
                                    seed=99 + i)
        out = da.decode_attention(q, k, v, ln)
        ref = da.decode_attention_plain(q, k, v, ln)
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), atol=TOL[dt],
                              rtol=TOL[dt]):
            raise AssertionError(f"decode_attention disagrees at {name}")
        split = da.decode_split_ref(q, k, v, ln, da.plan_for(q, k).keys)
        split_err = (split.float() - ref.float()).abs().max().item()
        if not torch.allclose(split.float(), ref.float(), atol=TOL[dt],
                              rtol=TOL[dt]):
            raise AssertionError(f"decode_split_ref disagrees at {name}")
        mask = (torch.arange(S, device="cuda")[None, :] < ln[:, None])
        mask = mask[:, None, None, :]                     # (B, 1, 1, S)
        gqa = dict(enable_gqa=True) if Hq != Hkv else {}
        lib = lambda: sdpa(q[:, :, None], k, v, attn_mask=mask, **gqa)
        lib_tol = 1e-4 if dt == torch.float32 else 4 * TOL[dt]
        if not torch.allclose(lib()[:, :, 0].float(), ref.float(),
                              atol=lib_tol, rtol=lib_tol):
            raise AssertionError("SDPA yardstick computes another function")
        del out, ref, split
        ms = time_ms(lambda: da.decode_attention(q, k, v, ln), reps=reps)
        plain_ms = time_ms(lambda: da.decode_attention_plain(q, k, v, ln),
                           reps=min(reps, 10))
        library_ms = time_ms(lib, reps=min(reps, 10))
        nbytes, flops = decode_bound(B, Hq, Hkv, S, D, dt, lengths)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_OPS[dt] * 1e3
        row = dict(name=name, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   gb_per_s=nbytes / ms * 1e-6, max_abs_err=err)
        if i == 0:
            row["host_us"] = host_us(lambda: da.decode_attention(q, k, v, ln))
        log(f"decode_attention {name}: B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} "
            f"{str(dt)[6:]}, {nbytes} bytes: kernel {ms:.4f} ms "
            f"({row['gb_per_s']:.1f} GB/s, {bytes_ms / ms:.1%} of 3.35 TB/s)"
            f", bound {row['bound_ms']:.5f} ms ({row['bound_by']}), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; max_abs_err "
            f"{err:.3e}, decode_split_ref {split_err:.3e} (tol {TOL[dt]:g} "
            f"abs+rel)" + (f"; wrapper {row['host_us']:.2f} us/call on the "
                           f"host" if "host_us" in row else ""))
        rows.append(row)
        del q, k, v, ln, mask, lib
        torch.cuda.empty_cache()
    return rows


def ssd_inputs(B, L, H, P, N, dtype, seed, *, d_dtype=torch.float32,
               strided=False, dt_scale=0.5):
    """x, Bm, Cm in ``dtype`` (as the strided slices of one (B, L, H*P+2N)
    conv output when ``strided``, as the model passes them), dt f32, A f32,
    D in ``d_dtype``."""
    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    if strided:
        di = H * P
        conv = (0.4 * randn(B, L, di + 2 * N)).to(dtype)
        x = conv[..., :di].reshape(B, L, H, P)
        Bm, Cm = conv[..., di:di + N], conv[..., di + N:]
    else:
        x = (0.5 * randn(B, L, H, P)).to(dtype)
        Bm = (0.3 * randn(B, L, N)).to(dtype)
        Cm = (0.3 * randn(B, L, N)).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, L, H)) * dt_scale
    A = -torch.exp(0.3 * randn(H))
    D = (1 + 0.2 * randn(H)).to(d_dtype)
    return x, dt, A, Bm, Cm, D


SSD_MAIN = (SSM_BATCH, SSM_LEN, 24, 64, 128, 256)   # B, L, H, P, N, chunk


def ssd_main_inputs():
    """The model's shape and layout: bf16 strided views of the conv
    output, bf16 D (precast), steps like the model's softplus(in_proj)
    so that cum reaches about -200 in a chunk and exp overflows above the
    diagonal."""
    B, L, H, P, N, _ = SSD_MAIN
    return ssd_inputs(B, L, H, P, N, torch.bfloat16, seed=50,
                      d_dtype=torch.bfloat16, strided=True, dt_scale=1.0)


def _ssd_compare(name, args, chunk):
    """One ``ssd_scan`` call against ``ssd_ref``; the counts are set to 0
    just before and read just after, so each case says which instance of
    the third launch it ran."""
    ssd.COUNT.reset()
    y, st = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    if (ssd.COUNT.launches, ssd.COUNT.plain) != (1, 0):
        raise AssertionError(f"ssd_scan at {name} did not launch the kernel")
    tc = ssd.COUNT.wgmma == 1
    yp, sp = ssd_ref(*args, chunk)
    dt = args[0].dtype
    err = (y.float() - yp.float()).abs().max().item()
    serr = (st - sp).abs().max().item()
    x, _, _, Bm, _, D = args
    log(f"ssd_scan {name}: x {tuple(x.shape)} {str(dt)[6:]} N={Bm.shape[-1]} "
        f"chunk={chunk} D {str(D.dtype)[6:]} strides {x.stride()} "
        f"[{', '.join(SSD_LAUNCHES[::2] if tc else SSD_CUDA_CORE)}]: "
        f"y max_abs_err={err:.3e} (tol {5 * TOL[dt]:g} abs+rel), state "
        f"max_abs_err={serr:.3e} (tol 1e-4 abs+rel)")
    if not (torch.isfinite(y.float()).all() and torch.isfinite(st).all()):
        raise AssertionError(f"ssd_scan is not finite at {name}")
    if not torch.allclose(y.float(), yp.float(), atol=5 * TOL[dt],
                          rtol=5 * TOL[dt]):
        raise AssertionError(f"ssd_scan y disagrees at {name}")
    if not torch.allclose(st, sp, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"ssd_scan state disagrees at {name}")
    return err, y, st, tc


def check_ssd_scan():
    """The sweep of tests/test_kernels.py:39-43, bf16 D, the model's
    strided layout, chunk invariance, bf16 shapes on the tensor-core
    instances (zamba2's widths; chunks of 128; chunks of 1024, whose Bm
    rows launch 1 takes in two column slices), and the main path's shape,
    each held at today's tolerances."""
    cases = [   # name, B, L, H, P, N, chunk, dtype, d_dtype, strided
        ("test_kernels 1", 2, 256, 3, 64, 32, 64, torch.float32,
         torch.float32, False),
        ("test_kernels 2", 1, 512, 2, 64, 64, 128, torch.float32,
         torch.float32, False),
        ("test_kernels 3", 2, 256, 4, 32, 16, 128, torch.bfloat16,
         torch.float32, False),
        ("test_kernels 4", 1, 128, 1, 16, 8, 32, torch.float32,
         torch.float32, False),
        ("bf16 D", 2, 256, 3, 64, 32, 64, torch.float32, torch.bfloat16,
         False),
        ("strided, Q < 64", 2, 96, 3, 16, 24, 32, torch.bfloat16,
         torch.bfloat16, True),
        ("Q not a multiple of 64", 1, 200, 2, 64, 128, 100, torch.float32,
         torch.float32, True),
        ("zamba2 widths P=64 N=64", 2, 1024, 4, 64, 64, 256, torch.bfloat16,
         torch.bfloat16, True),
        ("Q=128, 8 chunks", 2, 1024, 3, 64, 128, 128, torch.bfloat16,
         torch.bfloat16, True),
        ("P=16 N=32", 1, 512, 2, 16, 32, 64, torch.bfloat16, torch.float32,
         False),
        ("Q=1024 N=128: launch 1 in two column slices, 6 heads", 1, 2048, 6,
         64, 128, 1024, torch.bfloat16, torch.bfloat16, True),
    ]
    for i, (name, B, L, H, P, N, chunk, dt, ddt, strided) in enumerate(cases):
        args = ssd_inputs(B, L, H, P, N, dt, seed=10 + i, d_dtype=ddt,
                          strided=strided)
        _ssd_compare(name, args, chunk)
    args = ssd_inputs(1, 256, 2, 32, 16, torch.float32, seed=30)
    _, y64, s64, _ = _ssd_compare("chunk 64", args, 64)
    _, y256, s256, _ = _ssd_compare("chunk 256", args, 256)
    if not (torch.allclose(y64, y256, atol=1e-4, rtol=1e-4)
            and torch.allclose(s64, s256, atol=1e-4, rtol=1e-4)):
        raise AssertionError("ssd_scan depends on the chunk size")
    log(f"ssd_scan chunk invariance: y 64 vs 256 max diff "
        f"{(y64 - y256).abs().max().item():.3e} (tol 1e-4 abs+rel)")
    err, _, _, tc = _ssd_compare("main path", ssd_main_inputs(), SSD_MAIN[-1])
    if not tc:
        raise AssertionError("the main path's shape did not run "
                             f"{SSD_STATE_KERNEL} and {SSD_WGMMA_KERNEL}")
    return err


def ssd_split_ref(x, dt, A, Bm, Cm, D, chunk, *, split=True, state_split=True,
                  dtype=torch.float32):
    """``ssd_ref``'s function with the tensor-core instances' roundings;
    returns (y in x's dtype, the state leaving each chunk (B, H, L/Q, P, N)
    in ``dtype``, the final state last).  Launch 1's
    x o w (w = dt exp(cum[Q-1] - cum), each chunk's own state) is kept as
    bf16 hi + lo (``state_split`` True) or rounded to bf16 alone (False:
    the control the state gate must fail); launch 3's W = (C.B^T) o L o dt
    and the state entering each chunk likewise (``split``; False is the
    control the y gate must fail, as ``mha_p_bf16`` is for flash); None
    keeps a value as it is.  x, Bm, Cm as given, every sum in ``dtype``
    (float32 as the kernels sum; float64 sets the gates' limits)."""
    def rnd(t, mode):
        if mode is None:
            return t
        hi = t.bfloat16().to(dtype)
        return hi + (t - hi).bfloat16().to(dtype) if mode else hi
    B_, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    n = L // Q
    dt = dt.to(dtype)
    a = (dt * A.to(dtype)[None, None, :]).reshape(B_, n, Q, H)
    dt_c = dt.reshape(B_, n, Q, H)
    x_c = x.to(dtype).reshape(B_, n, Q, H, P)
    B_c = Bm.to(dtype).reshape(B_, n, Q, N)
    C_c = Cm.to(dtype).reshape(B_, n, Q, N)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros(B_, H, P, N, dtype=dtype, device=x.device)
    ys, states = [], []
    for c in range(n):
        cum = a[:, c].transpose(1, 2).cumsum(-1)                 # (B, H, Q)
        seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~keep, 0)
        G = torch.einsum("bqn,bsn->bqs", C_c[:, c], B_c[:, c])
        W = torch.where(keep, G[:, None] * torch.exp(seg)
                        * dt_c[:, c].transpose(1, 2)[:, :, None, :], 0.0)
        y = torch.einsum("bhqs,bshp->bqhp", rnd(W, split), x_c[:, c])
        y = y + torch.einsum("bqn,bhpn->bqhp", C_c[:, c], rnd(state, split)) \
            * torch.exp(cum).transpose(1, 2)[..., None]
        ys.append(y)
        w = dt_c[:, c] * torch.exp(cum[..., -1:] - cum).transpose(1, 2)
        xw = rnd(x_c[:, c] * w[..., None], state_split)       # (B, Q, H, P)
        state = state * torch.exp(cum[..., -1])[..., None, None] + \
            torch.einsum("bqn,bqhp->bhpn", B_c[:, c], xw)
        states.append(state)
    y = torch.stack(ys, dim=1).reshape(B_, L, H, P)
    return ((y + x.to(dtype) * D.to(dtype)[None, None, :, None]).to(x.dtype),
            torch.stack(states, dim=2))


def ssd_split_gate(y, ref):
    """The share of bf16 y values that differ from ``ref`` (``ssd_ref``'s
    y, rounded to bf16), and whether it is within SSD_SPLIT_SHARE."""
    share = (y.float() != ref.float()).float().mean().item()
    return share, share <= SSD_SPLIT_SHARE


def ssd_ref_states(x, dt, A, Bm, Cm, D, chunk):
    """``ssd_ref``'s state leaving each chunk, (B, H, L/Q, P, N) f32, the
    final state last: each chunk's own state is ssd_ref's final state of
    that chunk alone (one call on the chunks as a batch of sequences),
    carried from chunk to chunk as ssd_ref carries it."""
    B_, L, H, P = x.shape
    N, Q = Bm.shape[-1], min(chunk, L)
    n = L // Q

    def chunks(t):
        return t.reshape(B_ * n, Q, *t.shape[2:])
    own = ssd_ref(chunks(x), chunks(dt), A, chunks(Bm), chunks(Cm), D, Q)[1]
    own = own.reshape(B_, n, H, P, N)
    total = torch.exp((dt * A.float()[None, None, :]).reshape(B_, n, Q, H)
                      .cumsum(2)[:, :, -1])                     # (B, n, H)
    state = torch.zeros_like(own[:, 0])
    states = []
    for c in range(n):
        state = state * total[:, c, :, None, None] + own[:, c]
        states.append(state)
    return torch.stack(states, dim=2)


def ssd_state_errors(states, ref):
    """Each chunk's error of the states leaving the chunks, (..., n, P, N),
    against ``ref``'s, relative in norm over the other axes: (n,) float64."""
    d = (states.double() - ref.double()).movedim(-3, 0).flatten(1)
    return d.norm(dim=1) / ref.double().movedim(-3, 0).flatten(1).norm(dim=1)


def ssd_state_gate(states, ref):
    """The worst chunk's error of the states leaving the chunks against
    ``ref`` (``ssd_ref_states``'), and whether it is within SSD_STATE_REL."""
    err = ssd_state_errors(states, ref).max().item()
    return err, err <= SSD_STATE_REL


def ssd_gate_phase():
    """The split gates at the main shape (the model's steps: cum falls to
    about -200 in a chunk) and with slow decay (dt scaled by 0.05, so the
    carried state reaches deep into a chunk).  y: the share of bf16 values
    that differ from ssd_ref's; the states leaving the chunks (the kernel's
    states entering chunks 1.. after launch 2, then its final state): the
    worst chunk's error relative in norm.  The kernel passes both at both
    inputs; the y gate fails the control that keeps launch 3's W and
    carried state in bf16 alone, the state gate the one that keeps launch
    1's x o w in bf16 alone, at every chunk.  The float64 emulation beside
    them is what SSD_STATE_REL was set from."""
    B, L, H, P, N, chunk = SSD_MAIN
    for name, args in (("model steps", ssd_main_inputs()),
                       ("slow decay", ssd_inputs(
                           B, L, H, P, N, torch.bfloat16, seed=51,
                           d_dtype=torch.bfloat16, strided=True,
                           dt_scale=0.05))):
        ssd.COUNT.reset()
        y, st = ssd.ssd_scan(*args, chunk=chunk)
        if (ssd.COUNT.wgmma, ssd.COUNT.launches) != (1, 1):
            raise AssertionError("the gate's input did not run "
                                 f"{SSD_STATE_KERNEL} and {SSD_WGMMA_KERNEL}")
        y2, st2, entering = ssd._ssd_scan_instance(*args, chunk=chunk,
                                                   tensor_core=True)
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            raise AssertionError("ssd_scan and its tensor-core instance differ")
        states = torch.cat([entering[:, :, 1:], st[:, :, None]], dim=2)
        del y2, st2, entering
        ref, ref_st = ssd_ref(*args, chunk)
        ref_states = ssd_ref_states(*args, chunk)
        share, ok = ssd_split_gate(y, ref)
        errs = ssd_state_errors(states, ref_states)
        s_err, s_ok = ssd_state_gate(states, ref_states)
        f_err = ssd_state_errors(st[:, :, None], ref_st[:, :, None]).item()
        emu_y, emu_st = ssd_split_ref(*args, chunk)
        c_share, c_ok = ssd_split_gate(
            ssd_split_ref(*args, chunk, split=False)[0], ref)
        cs_y, cs_states = ssd_split_ref(*args, chunk, state_split=False)
        c_errs = ssd_state_errors(cs_states, ref_states)
        cs_share = ssd_split_gate(cs_y, ref)[0]
        del cs_y, cs_states
        exact = ssd_split_ref(*args, chunk, split=None, state_split=None,
                              dtype=torch.float64)[1]
        f64 = {tag: ssd_state_errors(ssd_split_ref(
            *args, chunk, dtype=torch.float64, state_split=mode)[1], exact)
            for tag, mode in (("hi + lo", True), ("bf16", False))}
        log(f"ssd_scan split gate, {name} (bf16 y differing from ssd_ref <= "
            f"{SSD_SPLIT_SHARE:.0%}): kernel {share:.4%}; the split "
            f"emulation {ssd_split_gate(emu_y, ref)[0]:.4%}; the bf16 control "
            f"{c_share:.4%}; x o w in bf16 alone (launch 1's control) "
            f"{cs_share:.4%}")
        log(f"ssd_scan state gate, {name} (the states leaving each of "
            f"{errs.numel()} chunks vs ssd_ref's, relative in norm, worst "
            f"chunk <= {SSD_STATE_REL:g}): kernel {s_err:.3e} (best chunk "
            f"{errs.min().item():.3e}; the final state {f_err:.3e}); the split "
            f"emulation {ssd_state_gate(emu_st, ref_states)[0]:.3e}; x o w "
            f"in bf16 alone {c_errs.min().item():.3e} at its best chunk; "
            f"float64 emulation against the exact states: hi + lo "
            f"{f64['hi + lo'].max().item():.3e} at the worst chunk, bf16 "
            f"alone {f64['bf16'].min().item():.3e} at the best, f32 "
            f"ssd_ref {ssd_state_gate(ref_states, exact)[0]:.3e} at the "
            f"worst; ssd_ref_states' last vs ssd_ref's final state "
            f"{ssd_state_errors(ref_states[:, :, -1:], ref_st[:, :, None]).item():.3e}")
        if c_ok:
            raise AssertionError("the ssd split gate passes the bf16 control")
        if (c_errs <= SSD_STATE_REL).any():
            raise AssertionError("the ssd state gate passes the control that "
                                 "keeps x o w in bf16 at some chunk")
        if not ok:
            raise AssertionError(f"ssd_scan fails the split gate at {name}: "
                                 "W or the state is not kept to hi + lo")
        if not s_ok:
            raise AssertionError(f"ssd_scan fails the state gate at {name}: "
                                 "x o w is not kept to hi + lo")
        del y, st, states, ref, ref_st, ref_states, emu_y, emu_st, exact


def measure_ssd_scan(shape=SSD_MAIN, args=None, name="main path",
                     reps=50):
    """Times at ``shape`` (the main path's unless given, with ``args`` its
    inputs): the kernel (launches 1 and 3 on the tensor cores) and the
    same call with both on CUDA cores, in turns in this call, and the
    plain version; each launch's device time in profiler windows of both
    calls, in turns, beside each launch's own bound.  No single PyTorch
    call computes the SSD scan, so there is no library time."""
    B, L, H, P, N, chunk = shape
    args = ssd_main_inputs() if args is None else args

    def instance(tc):
        return lambda: ssd._ssd_scan_instance(*args, chunk=chunk,
                                              tensor_core=tc)
    tc_ms, cc_ms = [], []
    for tc in (True, False, False, True):
        (tc_ms if tc else cc_ms).append(time_ms(instance(tc), reps))
    ms = time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk), reps)
    plain_ms = time_ms(lambda: ssd_ref(*args, chunk), reps=10)

    def launch_ms(rows, name):
        """A launch's mean over the window, by the launches it shows (a
        window now and then drops some events)."""
        hits = [r for r in rows if name in r[1]]
        return sum(r[0] for r in hits) / max(sum(r[2] for r in hits), 1)
    per = {k: [] for k in SSD_LAUNCHES + SSD_CUDA_CORE}
    for tc in (True, False, False, True):
        rows = profile_window(instance(tc), 5, "call")
        for k in (SSD_LAUNCHES if tc else SSD_CUDA_CORE + SSD_LAUNCHES[1:2]):
            per[k].append(launch_ms(rows, k))

    Q, n = chunk, L // chunk
    x, dt, A, Bm, Cm, D = args
    el = x.element_size()
    xb, nb = B * L * H * P * el, B * L * N * el       # x (or y); Bm (or Cm)
    dtb, cumb = dt.numel() * 4, B * H * n * Q * 4
    stb = B * H * n * P * N * 4                       # the chunk states, f32
    small = A.numel() * 4 + D.numel() * D.element_size()
    nbytes = 2 * xb + dtb + 2 * nb + B * H * P * N * 4 + small
    tri = Q * (Q + 1) // 2
    # C.B^T multiplies two bf16 operands with f32 sums.  The other three
    # products take an f32 operand (dt x and the decays in W, the state,
    # x o w), each as two bf16 products (hi + lo, held by the split and
    # state gates): all at the bf16 rate.
    ops_cb = B * n * tri * N * 2                  # causal, once per (b, c)
    ops_w = B * H * n * tri * P * 2               # (C.B^T o L o dt) . x
    ops_c = B * H * (n - 1) * Q * P * N * 2       # C . state; zero in chunk 0
    ops_s = B * H * n * Q * P * N * 2             # each chunk's new state
    ops_f32 = ops_w + ops_c + ops_s
    rate = PEAK_OPS[torch.bfloat16]

    def bound(nbytes, ops, rate=rate):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
        return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"
    bound_ms, bound_by = bound(nbytes, ops_cb + 2 * ops_f32)
    old_ms = (ops_cb / rate + ops_f32 / PEAK_OPS[torch.float32]) * 1e3
    # each launch's own: what it reads and writes once, its products
    own = {SSD_STATE_KERNEL: bound(xb + dtb + nb + small + cumb + stb,
                                   2 * ops_s),
           "state_pass_kernel": bound(2 * stb + B * H * P * N * 4
                                      + B * H * n * 4, 2 * B * H * n * P * N,
                                      PEAK_OPS[torch.float32]),
           SSD_WGMMA_KERNEL: bound(2 * xb + dtb + 2 * nb + small + cumb + stb,
                                   ops_cb + 2 * (ops_w + ops_c))}
    per_launch = []
    for k in SSD_LAUNCHES:
        t = per[k]
        row = dict(name=k, ms=float(np.mean(t)), turns=t, bound_ms=own[k][0],
                   bound_by=own[k][1])
        if k != "state_pass_kernel":
            sib = SSD_CUDA_CORE[k == SSD_WGMMA_KERNEL]
            row.update(cuda_core=sib, cuda_core_ms=float(np.mean(per[sib])),
                       cuda_core_turns=per[sib])
        per_launch.append(row)
        log(f"ssd_scan {name}, launch {k}: "
            f"{' / '.join(f'{v:.4f}' for v in t)} ms in "
            f"turns (profiler, 5 calls each), bound {own[k][0]:.5f} ms "
            f"({own[k][1]}), {row['ms'] / own[k][0]:.2f}x"
            + (f"; {row['cuda_core']} on the same inputs "
               f"{' / '.join(f'{v:.4f}' for v in row['cuda_core_turns'])} ms"
               if "cuda_core" in row else ""))
    log(f"ssd_scan {name}: kernel {ms:.4f} ms (launches 1 and 3 on the "
        f"tensor cores; in turns {' / '.join(f'{t:.4f}' for t in tc_ms)}), "
        f"both on CUDA cores {' / '.join(f'{t:.4f}' for t in cc_ms)} ms; "
        f"plain {plain_ms:.4f} ms, no library call; bound {bound_ms:.5f} ms "
        f"({nbytes} bytes at 3.35 TB/s = {nbytes / HBM_BYTES_PER_S * 1e3:.5f}"
        f" ms; {ops_cb} flops of C.B^T and 2 x {ops_f32} of hi + lo products "
        f"at 989 TFLOP/s = {(ops_cb + 2 * ops_f32) / rate * 1e3:.5f} ms); the "
        f"old count, the f32-operand products at the f32 rate of 67 TFLOP/s: "
        f"{old_ms:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, cuda_core_ms=float(np.mean(cc_ms)),
                per_launch=per_launch)


def ssd_hybrid_inputs():
    """zamba2-7b's shape and layout (``SSD_HYBRID``): bf16 strided views
    of the conv output, row stride d_inner + 2N = 7,296 elements, bf16 D,
    the model's steps."""
    B, L, H, P, N, _ = SSD_HYBRID
    return ssd_inputs(B, L, H, P, N, torch.bfloat16, seed=52,
                      d_dtype=torch.bfloat16, strided=True, dt_scale=1.0)


def check_ssd_hybrid_shape():
    """``ssd_scan`` at zamba2-7b's shape, which only the hybrid path runs:
    the tensor-core instances must take it; y at today's tolerance
    (``_ssd_compare``) and at the split gate, the states leaving each chunk
    at the state gate, as at the main shape.  Returns y's max abs error
    and the inputs."""
    chunk = SSD_HYBRID[-1]
    args = ssd_hybrid_inputs()
    err, y, st, tc = _ssd_compare("zamba2-7b shape", args, chunk)
    if not tc:
        raise AssertionError("zamba2-7b's shape did not run "
                             f"{SSD_STATE_KERNEL} and {SSD_WGMMA_KERNEL}")
    entering = ssd._ssd_scan_instance(*args, chunk=chunk,
                                      tensor_core=True)[2]
    states = torch.cat([entering[:, :, 1:], st[:, :, None]], dim=2)
    del entering
    share, ok = ssd_split_gate(y, ssd_ref(*args, chunk)[0])
    s_err, s_ok = ssd_state_gate(states, ssd_ref_states(*args, chunk))
    log(f"ssd_scan zamba2-7b shape: split gate {share:.4%} of bf16 y differ "
        f"(<= {SSD_SPLIT_SHARE:.0%}); state gate {s_err:.3e} at the worst "
        f"of {states.shape[2]} chunks (<= {SSD_STATE_REL:g})")
    if not (ok and s_ok):
        raise AssertionError("ssd_scan fails the split or state gate at "
                             "zamba2-7b's shape")
    return err, args


def flash_inputs(B, Hq, Hkv, Sq, D, dtype, seed, Sk=None):
    g = torch.Generator("cuda").manual_seed(seed)
    Sk = Sq if Sk is None else Sk

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    return randn(B, Hq, Sq, D), randn(B, Hkv, Sk, D), randn(B, Hkv, Sk, D)


def _flash_compare(name, q, k, v, causal, window, bq, bk, kernel=None):
    """One call against ``mha_ref``; it must be one launch of ``kernel``
    (default: the dtype's tensor-core kernel)."""
    if kernel is None:
        kernel = TF32_KERNEL if q.dtype == torch.float32 else WGMMA_KERNEL
    fa.COUNT.reset()
    out = fa.flash_attention(q, k, v, causal=causal, window=window, bq=bq,
                             bk=bk)
    torch.cuda.synchronize()
    counts = (fa.COUNT.launches, fa.COUNT.wgmma, fa.COUNT.tf32)
    if counts != (1, int(kernel == WGMMA_KERNEL), int(kernel == TF32_KERNEL)):
        raise AssertionError(f"flash_attention {name}: (launches, wgmma, "
                             f"tf32) {counts}, not one launch of {kernel}")
    ref = mha_ref(q, k, v, causal=causal, window=window).float()
    dt = q.dtype
    err = (out.float() - ref).abs().max().item()
    log(f"flash_attention {name}: q {tuple(q.shape)} k {tuple(k.shape)} "
        f"{str(dt)[6:]} causal={causal} window={window} bq={bq} bk={bk} "
        f"max_abs_err={err:.3e} (tol {TOL[dt]:g} abs+rel)")
    if not torch.allclose(out.float(), ref, atol=TOL[dt], rtol=TOL[dt]):
        raise AssertionError(f"flash_attention disagrees at {name}")
    return out


def _check_dead_rows(out, v, window):
    """Where Sq > Sk, rows Sk + window - 1 .. of ``out`` keep no key: each
    must be the mean of v over the Sk keys (of its kv head)."""
    Sq, Sk = out.shape[2], v.shape[2]
    if Sq <= Sk:
        return
    dead = Sk + window - 1
    mean = v.float().mean(dim=2).repeat_interleave(
        out.shape[1] // v.shape[1], dim=1)
    if not torch.allclose(out[:, :, dead:].float(),
                          mean[:, :, None].expand_as(out[:, :, dead:]),
                          atol=TOL[out.dtype]):
        raise AssertionError("a row with every key masked is not the mean "
                             "of v over Sk keys")


def check_flash_attention():
    """Kernel vs plain (``mha_ref``) on the card, in float32 and in
    bfloat16 (each on its tensor-core kernel, every call counted): the
    sweep of tests/test_kernels.py:17-25, every (bq, bk) of both presets
    of the kernel search domain (D = 32 and 64), D = 128 at small and at
    256-row tiles, q tiles that are not whole warpgroups, MQA, a window,
    rows with every key masked (Sq > Sk with a window: the mean of v), bk
    outside the domain's widths and q tiles of many passes, head dims
    padded to an instance (48, 80, 112, 200) and the D = 256 instance
    (bf16 and f32 each on its tensor-core kernel at every bq of one and
    two warpgroups and passes against every domain bk and bk = 100, with
    a window, GQA, MQA and rows that keep no key), float32 and bf16 at
    D = 256 that TMA cannot read (CUDA cores), and the window = Sk ==
    causal property."""
    f32, bf16 = torch.float32, torch.bfloat16
    sweep = [   # B, Hq, Hkv, S, D, causal, window, dtype
        (2, 4, 4, 256, 64, True, 0, f32), (1, 8, 2, 256, 64, True, 0, f32),
        (1, 8, 2, 256, 64, True, 0, bf16),
        (2, 4, 2, 512, 128, True, 128, f32),
        (1, 4, 1, 256, 64, True, 0, f32),      # MQA
        (1, 4, 4, 256, 64, False, 0, f32),     # bidirectional
        (1, 2, 2, 384, 64, True, 0, f32),      # non-pow2 seq
        (2, 4, 2, 512, 128, True, 128, bf16),  # window
        (1, 4, 1, 256, 64, True, 0, bf16),     # MQA
        (1, 4, 4, 256, 64, False, 0, bf16),    # bidirectional
        (1, 2, 2, 384, 64, True, 0, bf16)]     # non-pow2 seq
    for i, (B, Hq, Hkv, S, D, causal, window, dt) in enumerate(sweep):
        q, k, v = flash_inputs(B, Hq, Hkv, S, D, dt, seed=60 + i)
        _flash_compare(f"test_kernels {i + 1}", q, k, v, causal, window,
                       128, 128)
    for dt in (f32, bf16):
        for preset in ("tiny", "small"):
            B, Hq, Hkv, S, D = bench.PRESETS[preset]["flash_attention"]
            q, k, v = flash_inputs(B, Hq, Hkv, S, D, dt, seed=70)
            for bq in bench._BLOCKS[preset]["flash"]:
                for bk in bench._BLOCKS[preset]["flash"]:
                    _flash_compare(f"{preset} preset", q, k, v, True, 0, bq,
                                   bk)
    for dt in (f32, bf16):
        q, k, v = flash_inputs(1, 4, 2, 256, 32, dt, seed=71, Sk=64)
        for causal in (True, False):
            out = _flash_compare("Sq > Sk, rows 95.. keep no key", q, k, v,
                                 causal, 32, 64, 32)
            mean = v.float().mean(dim=2).repeat_interleave(2, dim=1)
            mean = mean[:, :, None].expand_as(out[:, :, 95:])
            tol = 1e-5 if dt == f32 else TOL[bf16]   # bf16: one rounding
            if not torch.allclose(out[:, :, 95:].float(), mean, atol=tol):
                raise AssertionError("a row with every key masked is not the "
                                     "mean of v")
    for dt in (f32, bf16):
        q, k, v = flash_inputs(1, 4, 2, 512, 128, dt, seed=72)
        for bq, bk in ((256, 256), (64, 64), (32, 128), (128, 32)):
            _flash_compare("D=128", q, k, v, True, 0, bq, bk)
        q, k, v = flash_inputs(1, 4, 2, 384, 64, dt, seed=75)
        for bq, bk in ((96, 128), (48, 64), (192, 32)):
            _flash_compare("bq not a multiple of 64", q, k, v, True, 0, bq,
                           bk)
    # any bk = min(bk, Sk) (a piece padded past its tile, a tile walked in
    # pieces) and a q tile of many passes (q loaded per pass)
    for i, (Hq, Hkv, Sq, Sk, D, window, bq, bk, dt) in enumerate(
            (Hq, Hkv, Sq, Sk, D, window, bq, bk, dt) for dt in (bf16, f32)
            for (Hq, Hkv, Sq, Sk, D, window, bq, bk) in (
                (2, 1, 48, 48, 64, 0, 128, 128),
                (2, 1, 16, 16, 32, 0, 128, 128),
                (4, 2, 96, 96, 128, 0, 32, 48),
                (4, 2, 200, 100, 64, 40, 40, 100),
                (2, 1, 1024, 1024, 128, 0, 128, 512),
                (2, 1, 4096, 4096, 128, 0, 1024, 128))):
        q, k, v = flash_inputs(1, Hq, Hkv, Sq, D, dt, seed=76 + i, Sk=Sk)
        out = _flash_compare("any bk, any bq", q, k, v, True, window, bq, bk)
        _check_dead_rows(out, v, window)
    # head dims outside the instances: zero-padded to the next one (48 ->
    # 64, 80 and 112 -> 128, 200 -> 256), and the D = 256 instance: the
    # tensor cores in both dtypes; each one launch
    for i, (D, dt) in enumerate((
            (48, f32), (48, bf16), (80, f32), (80, bf16), (112, f32),
            (112, bf16), (200, f32), (200, bf16), (256, f32), (256, bf16))):
        q, k, v = flash_inputs(1, 4, 2, 256, D, dt, seed=90 + i)
        for bq, bk in ((128, 128), (64, 32)):
            _flash_compare(f"D={D} (instance {fa.instance_dim(D)})", q, k, v,
                           True, 0, bq, bk)
    # D = 256 on the tensor cores, in both dtypes: q tiles of one
    # warpgroup, two and two passes (bf16; f32 runs one block a 64-row
    # pass) against a 32-key piece (bk = 32), 64-key pieces of 64, 128 and
    # 256, and bk = 100 (Sk = 500: a 64-key piece padded past its tile)
    for j, dt in enumerate((bf16, f32)):
        q, k, v = flash_inputs(1, 4, 2, 512, 256, dt, seed=110 + 20 * j)
        _, k100, v100 = flash_inputs(1, 4, 2, 512, 256, dt,
                                     seed=111 + 20 * j, Sk=500)
        for bq in (64, 128, 256):
            for bk in (32, 64, 128, 256, 100):
                kk, vv = (k100, v100) if bk == 100 else (k, v)
                _flash_compare("D=256", q, kk, vv, True, 0, bq, bk)
        for i, (name, Hq, Hkv, Sq, Sk, causal, window, bq, bk) in enumerate((
                ("D=256 window", 4, 2, 512, 512, True, 100, 128, 64),
                ("D=256 GQA", 8, 2, 256, 256, True, 0, 128, 128),
                ("D=256 MQA", 4, 1, 256, 256, True, 0, 64, 32),
                ("D=256 bidirectional", 4, 4, 256, 256, False, 0, 64, 256),
                ("D=256 Sq > Sk, rows 95.. keep no key", 4, 2, 256, 64,
                 True, 32, 64, 32),
                ("D=256 Sq > Sk, rows 95.. keep no key", 4, 2, 256, 64,
                 False, 32, 128, 64),
                ("D=256 bq = 96, not whole passes", 4, 2, 384, 384, True, 0,
                 96, 64))):
            q, k, v = flash_inputs(1, Hq, Hkv, Sq, 256, dt,
                                   seed=112 + i + 20 * j, Sk=Sk)
            out = _flash_compare(name, q, k, v, causal, window, bq, bk)
            _check_dead_rows(out, v, window)
    # D = 256 that TMA cannot read (k's and v's rows 257 elements apart:
    # 514 bytes in bf16, 1028 in f32): the CUDA-core kernel, in both dtypes
    for j, dt in enumerate((bf16, f32)):
        q, k, v = flash_inputs(1, 4, 2, 256, 256, dt, seed=118 + 20 * j)
        wide = [torch.zeros(1, 2, 256, 257, dtype=dt, device="cuda")
                for _ in range(2)]
        for t, src in zip(wide, (k, v)):
            t[..., :256] = src
        for bq, bk in ((128, 128), (64, 32)):
            _flash_compare(f"{str(dt)[6:]} D=256 rows 257 elements apart", q,
                           wide[0][..., :256], wide[1][..., :256], True, 0,
                           bq, bk, F32_FLASH_KERNEL)
    # float32 that TMA cannot read (k's and v's rows 65 floats apart, q 4
    # bytes past an aligned address): the CUDA-core kernel
    q, k, v = flash_inputs(1, 4, 2, 256, 64, f32, seed=98)
    wide = [torch.zeros(1, 2, 256, 65, device="cuda") for _ in range(2)]
    for t, src in zip(wide, (k, v)):
        t[..., :64] = src
    shifted = torch.zeros(q.numel() + 1, device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    for bq, bk in ((128, 128), (64, 32)):
        _flash_compare("f32 rows 65 floats apart", q, wide[0][..., :64],
                       wide[1][..., :64], True, 0, bq, bk, F32_FLASH_KERNEL)
        _flash_compare("f32 q base not 16-byte aligned", shifted, k, v, True,
                       0, bq, bk, F32_FLASH_KERNEL)
    q, k, v = flash_inputs(2, 4, 2, 256, 64, f32, seed=73)
    a = fa.flash_attention(q, k, v, causal=True, window=0)
    b = fa.flash_attention(q, k, v, causal=True, window=256)
    diff = (a - b).abs().max().item()
    log(f"flash_attention window = Sk vs causal: max diff {diff:.3e} "
        "(tol 1e-5)")
    if diff > 1e-5:
        raise AssertionError("window = Sk differs from causal")


def ptxas_entries(text, kernel):
    """(instance, registers, spill report) of every entry function whose
    name holds ``kernel`` in ``nvcc -Xptxas -v`` output; the instance is
    its template arguments as the mangled name gives them."""
    out = []
    for block in text.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if kernel not in name:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+ bytes stack frame, \d+ bytes spill stores, "
                          r"\d+ bytes spill loads)", block)
        args = re.search(r"kernelI((?:Li\d+E)+)E", name)
        args = re.findall(r"\d+", args.group(1)) if args else None
        out.append((f"<{', '.join(args)}>" if args else name,
                    regs.group(1) if regs else "?",
                    spill.group(1) if spill else "no spill report"))
    return out


def check_wgmma_sass(source, kernel, other, operand):
    """The tensor-core kernel's SASS, from ``cuobjdump -sass`` of the built
    library of ``source``: every instance of ``kernel`` must hold HGMMA
    (wgmma) instructions on ``operand`` inputs (``BF16`` or ``TF32``), and
    ``other``, its CUDA-core sibling, none."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(source))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
        elif name is not None and "HGMMA" in line:
            counts[name][0] += 1
            counts[name][1] += bool(re.search(r"HGMMA\.\S*" + operand, line))
    wg = {n: c for n, c in counts.items() if kernel in n}
    sib = sum(c[0] for n, c in counts.items() if other in n)
    typed = [c[1] for c in wg.values()]
    log(f"SASS of {source}: {len(wg)} instances of {kernel}, HGMMA "
        f"instructions on {operand} {min(typed, default=0)}-"
        f"{max(typed, default=0)} each; {other}: {sib}")
    if not wg or min(typed) == 0:
        raise AssertionError(f"an instance of {kernel} has no HGMMA "
                             f"instruction on {operand}")
    if sib:
        raise AssertionError(f"{other} holds HGMMA instructions")
    return wg


def _pairs(S, window):
    """(q, k) pairs a causal mask with this window keeps, per head."""
    qpos = np.arange(S)
    return int((np.minimum(qpos + 1, window) if window else qpos + 1).sum())


def flash_full_inputs(B, S, Hq, Hkv, D, dtype=torch.bfloat16):
    g = torch.Generator("cuda").manual_seed(80)
    return tuple(torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
                 for H in (Hq, Hkv, Hkv))


def mha_p_bf16(q, k, v, *, causal, window):
    """``mha_ref``'s function with p rounded to bf16 for p.v (p = exp(s -
    m) unnormalised, divided by its f32 sum at the end, as SDPA's flash
    path does): the design that the split-p gate must tell apart."""
    Sq, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    G = q.shape[1] // k.shape[1]
    kq, vq = (t.repeat_interleave(G, dim=1).float() for t in (k, v))
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), kq) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    keep = kpos <= qpos if causal else torch.ones_like(kpos > qpos)
    if window:
        keep = keep & (kpos > qpos - window)
    s = torch.where(keep, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    p = p.bfloat16().float()
    return (torch.einsum("bhqs,bhsd->bhqd", p, vq) / l).to(q.dtype)


def split_p_gate(out, ref):
    """Max abs error and the share of bf16 outputs that differ from ``ref``
    (``mha_ref``, rounded to bf16), and whether both are within the split-p
    limits: p kept to about 16 bits leaves the f32 output within ~3e-6 of
    the exact one, so few outputs round otherwise; bf16 p (~8 bits) moves
    it by ~2e-3 and flips a large share."""
    d = (out.float() - ref.float()).abs()
    err, share = d.max().item(), (d > 0).float().mean().item()
    return err, share, err <= SPLIT_MAX_ABS and share <= SPLIT_DIFF_SHARE


def flash_bf16_reading(name, B, S, Hq, Hkv, D, window):
    """``ops.mha`` at one full-width bf16 shape, (B,S,H,D), with the counts
    set to 0 just before and read just after (the main path: one launch of
    the tensor-core kernel, no plain call); kernel vs plain at the bf16
    tolerance and at the split-p gate, which two bf16-p controls (SDPA,
    ``mha_p_bf16``) must fail; the kernels in a profiler window; then the
    times of the kernel, the plain version and SDPA (the library
    yardstick; the port never calls it).  At head dim 256 the CUDA-core
    kernel runs on the same inputs too, held to ``mha_ref`` and timed in
    turns with the kernel (kernel, CUDA cores, CUDA cores, kernel)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = flash_full_inputs(B, S, Hq, Hkv, D)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fa.COUNT.reset()
    o = ops.mha(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    counts = (fa.COUNT.launches, fa.COUNT.wgmma, fa.COUNT.tf32,
              fa.COUNT.plain)
    if counts != (1, 1, 0, 0):
        raise AssertionError(f"ops.mha at {name}: (launches, wgmma, tf32, "
                             f"plain) = {counts}, not one {WGMMA_KERNEL} "
                             "launch")
    ref = mha_ref(qt, kt, vt, causal=True, window=window).transpose(1, 2)
    if o.shape != q.shape or not torch.isfinite(o.float()).all() or \
            not torch.allclose(o.float(), ref.float(), atol=TOL[q.dtype],
                               rtol=TOL[q.dtype]):
        raise AssertionError(f"ops.mha disagrees with mha_ref at {name}")
    err, share, ok = split_p_gate(o, ref)
    if window:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        lib_fn = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                              enable_gqa=True)
    else:
        lib_fn = lambda: sdpa(qt, kt, vt, is_causal=True)  # noqa: E731
    controls = {
        "sdpa": lib_fn().transpose(1, 2),
        "mha_p_bf16": mha_p_bf16(qt, kt, vt, causal=True,
                                 window=window).transpose(1, 2)}
    # SDPA rounds p to bf16 for p.v: the same function at 4x the tolerance
    lib_err = (controls["sdpa"].float() - ref.float()).abs().max().item()
    if lib_err > 4 * TOL[q.dtype]:
        raise AssertionError("SDPA yardstick computes another function")
    gate = [f"{WGMMA_KERNEL} {err:.3e} / {share:.4%}"]
    for cname, c in controls.items():
        c_err, c_share, c_ok = split_p_gate(c, ref)
        gate.append(f"{cname} {c_err:.3e} / {c_share:.4%}")
        if c_ok:
            raise AssertionError(f"the split-p gate passes {cname} at {name},"
                                 " which keeps p in bf16")
    log(f"flash_attention {name}: split-p gate (max abs err <= "
        f"{SPLIT_MAX_ABS:g}, outputs that differ from mha_ref <= "
        f"{SPLIT_DIFF_SHARE:.0%}): {'; '.join(gate)}")
    if not ok:
        raise AssertionError(f"ops.mha at {name} fails the split-p gate: "
                             "p.v is not kept to p_hi + p_lo")
    cuda_core = None
    if D == 256:
        cuda_core = lambda: fa._flash_attention_instance(  # noqa: E731
            qt, kt, vt, kernel=F32_FLASH_KERNEL, causal=True, window=window)
        cc_err = (cuda_core().transpose(1, 2).float() - ref.float()
                  ).abs().max().item()
        if cc_err > TOL[q.dtype]:
            raise AssertionError(f"{F32_FLASH_KERNEL} disagrees with mha_ref "
                                 f"at {name}: {cc_err:.3e}")
    del o, ref, controls
    rows = profile_window(lambda: ops.mha(q, k, v, causal=True,
                                          window=window), 3, "call")
    names = [r[1] for r in rows]
    if not any(WGMMA_KERNEL in n for n in names) or any(
            F32_FLASH_KERNEL in n for n in names):
        raise AssertionError(f"the profiler window around ops.mha shows "
                             f"{names}, not {WGMMA_KERNEL} alone")
    mha = lambda: ops.mha(q, k, v, causal=True, window=window)  # noqa: E731
    ms = time_ms(mha)
    turns = ""
    if cuda_core is not None:
        cc_ms = [time_ms(cuda_core, reps=10) for _ in range(2)]
        ms_again = time_ms(mha)
        turns = (f"; in turns: kernel {ms:.4f}, {F32_FLASH_KERNEL} "
                 f"{cc_ms[0]:.4f}, {cc_ms[1]:.4f}, kernel {ms_again:.4f} ms "
                 f"({F32_FLASH_KERNEL} vs mha_ref {cc_err:.3e})")
        # the kernel at other blocks on the same inputs (ops.mha: 128, 128)
        blocks = []
        for bq in (64, 128, 256):
            for bk in (32, 64, 128):
                t = time_ms(lambda: fa.flash_attention(  # noqa: B023
                    qt, kt, vt, causal=True, window=window, bq=bq, bk=bk))
                blocks.append(f"({bq}, {bk}) {t:.4f}")
        log(f"flash_attention {name}, {WGMMA_KERNEL} by (bq, bk), ms: "
            + ", ".join(blocks))
    plain_ms = time_ms(lambda: mha_ref(qt, kt, vt, causal=True,
                                       window=window), reps=10)
    library_ms = time_ms(lib_fn)
    pairs = B * Hq * _pairs(S, window)
    flops = 2 * D * pairs                  # each of q.k and p.v
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)  # q,o,k,v
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # q.k once and p.v twice (p_hi.v + p_lo.v, held by the gate), all
    # bf16 operands with f32 sums, at the bf16 rate
    ops_ms = 3 * flops / PEAK_OPS[torch.bfloat16] * 1e3
    f32_rate_ms = (flops / PEAK_OPS[torch.bfloat16]
                   + flops / PEAK_OPS[torch.float32]) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"flash_attention {name} (B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
        f"window={window}, ops.mha bf16, {WGMMA_KERNEL}): max_abs_err="
        f"{err:.3e} (tol {TOL[q.dtype]:g} abs+rel; split-p gate "
        f"{SPLIT_MAX_ABS:g}), sdpa vs plain {lib_err:.3e}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms,"
        f" bound {bound_ms:.5f} ms ({pairs} kept pairs: {flops} flops of "
        f"q.k and 2 x {flops} of p.v at 989 TFLOP/s = {ops_ms:.5f} ms; "
        f"{nbytes} bytes at 3.35 TB/s = {bytes_ms:.5f} ms); kernel/bound "
        f"{ms / bound_ms:.2f}, kernel/sdpa {ms / library_ms:.2f}, "
        f"{3 * flops / ms / 1e9:.1f} TFLOP/s; the old count, p.v at the "
        f"f32 rate of 67 TFLOP/s: {f32_rate_ms:.5f} ms{turns}")
    reading = dict(shape=name, kernel=WGMMA_KERNEL, launches=counts[1],
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    if cuda_core is not None:
        reading.update(ms_in_turns=[ms, ms_again], cuda_core_ms=cc_ms)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return reading


def measure_flash_attention():
    """The bf16 readings through ``ops.mha``: the two FLASH_FULL shapes and
    FLASH_D256 (head dim 256), each one launch of the tensor-core kernel
    (:func:`flash_bf16_reading`).  Returns them, the first shape's first."""
    return [flash_bf16_reading(*shape) for shape in FLASH_FULL] + [
        flash_bf16_reading(*FLASH_D256, 0)]


def measure_flash_f32_d256():
    """float32 at FLASH_D256 through ``ops.mha``: one counted launch of
    ``flash_fwd_tf32_kernel`` (the tensor cores take float32 at head dim
    256), held to the 3xTF32 gate against f32 ``mha_ref`` (both controls
    outside it) and timed in turns on the same inputs with
    ``flash_fwd_kernel`` (kernel, CUDA cores, CUDA cores, kernel), beside
    the plain version and SDPA in float32 (``allow_tf32`` off).  The bound
    counts q.k and p.v as three tf32 products each at 495 TFLOP/s against
    the bytes of q, k, v and o; both products at the f32 CUDA-core rate
    are logged beside it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    name, B, S, Hq, Hkv, D = FLASH_D256
    name = f"{name} float32"
    q, k, v = flash_full_inputs(B, S, Hq, Hkv, D, torch.float32)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fa.COUNT.reset()
    o = ops.mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    counts = (fa.COUNT.launches, fa.COUNT.wgmma, fa.COUNT.tf32,
              fa.COUNT.plain)
    if counts != (1, 0, 1, 0):
        raise AssertionError(f"ops.mha at {name}: (launches, wgmma, tf32, "
                             f"plain) = {counts}, not one {TF32_KERNEL} "
                             "launch")
    if o.shape != q.shape or not torch.isfinite(o).all():
        raise AssertionError(f"ops.mha at {name}: bad output")
    ref = mha_ref(qt, kt, vt, causal=True).transpose(1, 2)
    err = tf32_gate(name, o, ref, qt, kt, vt)
    lib_err = (sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
               - ref).abs().max().item()
    cuda_core = lambda: fa._flash_attention_instance(  # noqa: E731
        qt, kt, vt, kernel=F32_FLASH_KERNEL, causal=True)
    cc_err = (cuda_core().transpose(1, 2) - ref).abs().max().item()
    if lib_err > 4 * TOL[q.dtype] or cc_err > TOL[q.dtype]:
        raise AssertionError(f"at {name}, SDPA ({lib_err:.3e}) or "
                             f"{F32_FLASH_KERNEL} ({cc_err:.3e}) computes "
                             "another function")
    del o, ref
    mha = lambda: ops.mha(q, k, v, causal=True)  # noqa: E731
    ms = time_ms(mha, reps=20)
    cc_ms = [time_ms(cuda_core, reps=10) for _ in range(2)]
    ms_again = time_ms(mha, reps=20)
    plain_ms = time_ms(lambda: mha_ref(qt, kt, vt, causal=True), reps=5)
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), reps=10)
    pairs = B * Hq * _pairs(S, 0)
    flops = 2 * D * pairs                  # each of q.k and p.v
    nbytes = 4 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 6 * flops / TF32_OPS * 1e3
    f32_rate_ms = 2 * flops / PEAK_OPS[torch.float32] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"flash_attention {name} (B={B} S={S} Hq={Hq} Hkv={Hkv} D={D}, "
        f"causal, ops.mha, {TF32_KERNEL}): max_abs_err={err:.3e} (3xTF32 "
        f"gate {TF32_GATE:g}), {F32_FLASH_KERNEL} {cc_err:.3e}, sdpa "
        f"{lib_err:.3e}; in turns: kernel {ms:.4f}, {F32_FLASH_KERNEL} "
        f"{cc_ms[0]:.4f}, {cc_ms[1]:.4f}, kernel {ms_again:.4f} ms; plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.5f}"
        f" ms ({pairs} kept pairs: 6 x {flops} flops of tf32 products at "
        f"495 TFLOP/s = {ops_ms:.5f} ms; {nbytes} bytes at 3.35 TB/s = "
        f"{bytes_ms:.5f} ms); kernel/bound {ms / bound_ms:.2f}, kernel/sdpa"
        f" {ms / library_ms:.2f}, {F32_FLASH_KERNEL}/kernel "
        f"{np.mean(cc_ms) / ms:.2f}, {6 * flops / ms / 1e9:.1f} TFLOP/s of "
        f"tf32 products; both products at the f32 rate of 67 TFLOP/s: "
        f"{f32_rate_ms:.5f} ms")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(shape=name, kernel=TF32_KERNEL, launches=counts[0],
                max_abs_err=err, ms=ms, ms_in_turns=[ms, ms_again],
                cuda_core_ms=cc_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def tf32_gate(name, out, ref, q, k, v, *, causal=True, window=0, bq=128,
              bk=128):
    """The 3xTF32 gate: ``out`` (``flash_fwd_tf32_kernel``'s) within
    TF32_GATE of f32 ``mha_ref`` (``ref``, same layout), and the two
    controls of ``flash_tf32x3_ref`` (one tf32 product; bf16 hi + lo) on
    the (B,H,S,D) inputs q, k, v outside it.  Returns the kernel's
    error."""
    err = (out - ref).abs().max().item()
    if out.shape != ref.shape:
        raise AssertionError("the gate compares outputs of one layout")
    line = [f"{TF32_KERNEL} {err:.3e}"]
    for split in fa.SPLITS:
        emu = fa.flash_tf32x3_ref(q, k, v, causal=causal, window=window,
                                  bq=bq, bk=bk, split=split)
        if emu.shape != ref.shape:
            emu = emu.transpose(1, 2)
        e = (emu - ref).abs().max().item()
        line.append(f"emulated {split} {e:.3e}")
        if split != "tf32x3" and e <= TF32_GATE:
            raise AssertionError(f"the 3xTF32 gate passes the {split} "
                                 "control")
        del emu
    log(f"flash_attention {name}: 3xTF32 gate (max abs err vs mha_ref <= "
        f"{TF32_GATE:g}): {'; '.join(line)}")
    if err > TF32_GATE:
        raise AssertionError(f"{TF32_KERNEL} fails the 3xTF32 gate at {name}")
    return err


def tf32_gate_presets():
    """The 3xTF32 gate at every (bq, bk) of both presets of the kernel
    search domain, causal as the search runs them."""
    for preset in ("tiny", "small"):
        B, Hq, Hkv, S, D = bench.PRESETS[preset]["flash_attention"]
        q, k, v = flash_inputs(B, Hq, Hkv, S, D, torch.float32, seed=74)
        ref = mha_ref(q, k, v, causal=True)
        for bq in bench._BLOCKS[preset]["flash"]:
            for bk in bench._BLOCKS[preset]["flash"]:
                out = _flash_compare(f"{preset} preset", q, k, v, True, 0,
                                     bq, bk)
                tf32_gate(f"{preset} preset bq={bq} bk={bk}", out, ref, q, k,
                          v, bq=bq, bk=bk)


def measure_flash_f32():
    """The float32 kernel at the shape and blocks the kernel search runs
    most (the small preset, its incumbent bq = bk = 128, causal) and at
    the qwen1.5-4b prefill shape through ``ops.mha`` (one counted tf32
    launch, the 3xTF32 gate): the kernel, the CUDA-core kernel on the same
    inputs, the plain version and SDPA in float32 (``allow_tf32`` off).
    The bound counts six tf32 products (q.k and p.v, three each) at 495
    TFLOP/s against the bytes of q, k, v and o.  Returns the small
    preset's reading with the full shape's under ``readings``."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Hq, Hkv, S, D = bench.PRESETS["small"]["flash_attention"]
    bq = bk = bench._BLOCKS["small"]["flash"][0]
    full = FLASH_FULL[0]
    shapes = [("small preset", B, S, Hq, Hkv, D, bq, bk),
              (f"{full[0]} float32", full[1], full[2], full[3], full[4],
               full[5], 128, 128)]
    readings = []
    for name, B, S, Hq, Hkv, D, bq, bk in shapes:
        q, k, v = flash_full_inputs(B, S, Hq, Hkv, D, torch.float32)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fa.COUNT.reset()
        out = ops.mha(q, k, v, causal=True)
        torch.cuda.synchronize()
        counts = (fa.COUNT.launches, fa.COUNT.tf32, fa.COUNT.plain)
        if counts != (1, 1, 0):
            raise AssertionError(f"ops.mha float32 at {name}: (launches, tf32,"
                                 f" plain) = {counts}, not one tf32 launch")
        ref = mha_ref(qt, kt, vt, causal=True).transpose(1, 2)
        if out.shape != q.shape or not torch.isfinite(out).all():
            raise AssertionError(f"ops.mha float32 at {name}: bad output")
        err = tf32_gate(name, out, ref, qt, kt, vt, bq=bq, bk=bk)
        cuda_core = fa._flash_attention_instance(
            qt, kt, vt, kernel=F32_FLASH_KERNEL, causal=True, bq=bq, bk=bk)
        cc_err = (cuda_core - ref.transpose(1, 2)).abs().max().item()
        lib_err = (sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
                   - ref.transpose(1, 2)).abs().max().item()
        if lib_err > 4 * TOL[torch.float32] or cc_err > TOL[torch.float32]:
            raise AssertionError(f"at {name}, SDPA ({lib_err:.3e}) or "
                                 f"{F32_FLASH_KERNEL} ({cc_err:.3e}) computes"
                                 " another function")
        del out, ref, cuda_core
        reps = 50 if S < 1024 else 20
        ms = time_ms(lambda: ops.mha(q, k, v, causal=True), reps=reps)
        cc_ms = time_ms(lambda: fa._flash_attention_instance(
            qt, kt, vt, kernel=F32_FLASH_KERNEL, causal=True, bq=bq, bk=bk),
            reps=reps)
        plain_ms = time_ms(lambda: mha_ref(qt, kt, vt, causal=True),
                           reps=reps if S < 1024 else 10)
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                          enable_gqa=True), reps=reps)
        pairs = B * Hq * _pairs(S, 0)
        flops = 2 * D * pairs                  # each of q.k and p.v
        nbytes = 4 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 6 * flops / TF32_OPS * 1e3
        f32_rate_ms = 2 * flops / PEAK_OPS[torch.float32] * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"flash_attention float32 {name} (B={B} S={S} Hq={Hq} Hkv={Hkv} "
            f"D={D}, bq=bk={bq}, ops.mha, {TF32_KERNEL}): max_abs_err="
            f"{err:.3e} (3xTF32 gate {TF32_GATE:g}), {F32_FLASH_KERNEL} "
            f"{cc_err:.3e}, sdpa {lib_err:.3e}; kernel {ms:.4f} ms, "
            f"{F32_FLASH_KERNEL} {cc_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({pairs} "
            f"kept pairs: 6 x {flops} flops of tf32 products at 495 TFLOP/s ="
            f" {ops_ms:.5f} ms; {nbytes} bytes at 3.35 TB/s = {bytes_ms:.5f} "
            f"ms); kernel/bound {ms / bound_ms:.2f}, kernel/sdpa "
            f"{ms / library_ms:.2f}, {6 * flops / ms / 1e9:.1f} TFLOP/s of "
            f"tf32 products; the old count, both products at the f32 rate "
            f"of 67 TFLOP/s: {f32_rate_ms:.5f} ms")
        readings.append(dict(shape=name, max_abs_err=err, ms=ms,
                             cuda_core_ms=cc_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by="bytes" if bytes_ms >= ops_ms
                             else "operations"))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    first = readings[0]
    return dict({key: first[key] for key in (
        "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by")}, readings=readings)


# ---------------------------------------------------------------------------
# phase 3: the dense serving path at full width
# ---------------------------------------------------------------------------
def request_mix(vocab):
    """The dense request mix: N_REQUESTS prompts of PROMPT_LEN tokens from
    seed 0, NEW_TOKENS each."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(
                0, vocab, rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1)
            ).tolist(), max_new_tokens=NEW_TOKENS) for i in range(N_REQUESTS)]


def serve_full_width(cfg, init_dtype=torch.float32):
    """``N_REQUESTS`` requests through ``BatchedServer(use_kernel=True)``
    (batch 8, f32 KV cache of 512) with weights drawn in ``init_dtype``
    from seed 0: every request must finish with ``NEW_TOKENS`` tokens, and
    every layer of every step must launch the flash-decode kernel once."""
    model = build_model(cfg)
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator("cuda").manual_seed(0), init_dtype)
    server = BatchedServer(model, params, batch_size=BATCH, max_seq=MAX_SEQ,
                           opts=ModelOpts(attn_chunk=64),
                           use_kernel=True, device="cuda")
    del params                      # the server keeps its bf16 copy
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(server.params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters drawn in {str(init_dtype)[6:]}, set up in "
        f"{time.time() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    if not server.use_kernel:
        raise AssertionError("the server refused the kernel")

    reqs = request_mix(cfg.vocab)
    da.COUNT.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = da.COUNT.launches, da.COUNT.plain
    steps = server.steps
    generated = sum(len(v) for v in results.values())
    log(f"{cfg.name} served {len(results)} requests: {steps} decode steps, "
        f"{generated} "
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


def teacher_forced_check(model, server, f32_layers=None):
    """Kernel vs plain decode steps, at full width.

    In bf16 (the served dtype) a 1e-7 difference in an attention output
    can flip a bf16 rounding, and many layers of random weights amplify
    it (in an MoE layer it can also swap a token's experts), so there only
    decisive greedy tokens must agree: the kernel's argmax equals the
    plain path's wherever the plain top-2 margin exceeds BF16_MARGIN.  The
    same check in float32 compute dtype (f32 weights from the same seed,
    the first ``f32_layers`` layers where given) holds the logits at
    F32_LOGIT_TOL.
    """
    worst, decisive = 0.0, 0
    for a, b in teacher_forced(model, server.params, server.cache):
        worst = max(worst, (a - b).abs().max().item())
        decisive += decisive_tokens(a, b, "the kernel path")[0]
    log(f"teacher-forced bf16: {TEACHER_STEPS} steps, kernel vs plain "
        f"logits max diff {worst:.3e}; {decisive}/{TEACHER_STEPS * BATCH} "
        f"tokens with top-2 margin > {BF16_MARGIN:g}, all equal")

    cfg32 = dataclasses.replace(model.cfg, dtype="float32",
                                n_layers=f32_layers or model.cfg.n_layers)
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator("cuda").manual_seed(0))
    cache = {k: v[:cfg32.n_layers] for k, v in server.cache.items()}
    worst = 0.0
    for a, b in teacher_forced(model32, params32, cache):
        worst = max(worst, (a - b).abs().max().item())
        if not torch.allclose(a, b, atol=F32_LOGIT_TOL, rtol=F32_LOGIT_TOL):
            raise AssertionError(f"f32 kernel vs plain logits differ by "
                                 f"{(a - b).abs().max().item()}")
    log(f"teacher-forced float32 ({cfg32.n_layers} layers): {TEACHER_STEPS} "
        f"steps, kernel vs plain logits max diff {worst:.3e} (tol "
        f"{F32_LOGIT_TOL:g} abs+rel)")
    del params32


def profile_steps(model, server, n=3):
    """Device time by kernel over a few decode steps of the server's
    path (with the kernel where the server uses it); on the kernel path
    exactly one decode kernel per layer a step.  Returns the device ms a
    step of the decode kernel, the products (the operators ``EXPERT_OPS``
    and ``GEMM_OPS``, their kernels' device time) and the rest."""
    tok = torch.zeros((server.B, 1), dtype=torch.long, device="cuda")
    pos = torch.full((server.B,), 100, dtype=torch.int32, device="cuda")
    use_kernel = server.use_kernel
    if not server.continuous:       # the lockstep fallback: one position
        server, pos = server._lockstep, 100
    opts = ModelOpts(use_kernel=use_kernel)
    ops_ms = {}
    rows = profile_window(lambda: model.decode_step(
        server.params, {"token": tok, "pos": pos}, server.cache, opts=opts),
        n, "step", ops_ms)
    if not (use_kernel and rows):
        return {}
    decode = [(ms, count) for ms, key, count in rows if DECODE_KERNEL in key]
    per_step = sum(c for _, c in decode) / n
    log(f"  {DECODE_KERNEL}: {per_step:g} a step ({model.cfg.n_layers} "
        f"layers), {sum(ms for ms, _ in decode) / n:.4f} ms of device time a "
        f"step")
    if per_step != model.cfg.n_layers:
        raise AssertionError("the step did not run one decode kernel per "
                             "layer")
    split = {"decode_attention": sum(ms for ms, _ in decode) / n,
             "expert products": sum(ops_ms.get(o, 0.0)
                                    for o in EXPERT_OPS) / n,
             "other GEMMs": sum(ops_ms.get(o, 0.0) for o in GEMM_OPS) / n}
    split["other kernels"] = sum(r[0] for r in rows) / n - sum(
        split.values())
    log("  by part: " + ", ".join(f"{k} {v:.3f} ms/step"
                                  for k, v in split.items()))
    return split


def profile_window(fn, n, unit, ops_ms=None):
    """Device time by kernel over ``n`` calls of ``fn`` after one warm-up
    call: device busy and idle share of the window's wall time.  Returns
    the rows (ms, kernel name, count), longest first; none where the trace
    has no device time.  ``ops_ms``, where given, is filled with each
    operator's device ms over the window (the kernels it launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if ops_ms is not None:
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                ops_ms[e.key] = e.device_time_total / 1e3
    # device rows only: an operator's own "device time" repeats its kernels'
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.key, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True)
    if not rows:
        log("profile: no device time in the trace (not measured)")
        return rows
    busy = sum(r[0] for r in rows)
    log(f"profile over {n} {unit}s (profiler on): wall {wall_ms / n:.3f} "
        f"ms/{unit}, {sum(r[2] for r in rows) // n} kernels/{unit}, device "
        f"busy {busy / n:.3f} ms/{unit}, idle share "
        f"{1 - busy / wall_ms:.1%}")
    groups = {"port kernels": 0.0, "GEMMs": 0.0, "other": 0.0}
    for ms, key, _ in rows:
        if any(k in key for k in PORT_KERNEL_NAMES):
            groups["port kernels"] += ms
        elif "nvjet" in key or "gemm" in key.lower():
            groups["GEMMs"] += ms
        else:
            groups["other"] += ms
    log("  by kind: " + ", ".join(f"{k} {v / n:.3f} ms/{unit}"
                                  for k, v in groups.items()))
    for ms, key, count in rows[:10]:
        log(f"  {ms / n:9.4f} ms/{unit}  x{count // n:<5d} {key[:90]}")
    return rows


# ---------------------------------------------------------------------------
# phase 3b: the MoE family at full width
# ---------------------------------------------------------------------------
def moe_config():
    """phi3.5-moe-42b-a6.6b at full width, its depth cut to MOE_LAYERS."""
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)


def expert_bytes(cfg):
    """Bytes of one layer's expert weights (wi, wg, wo) in bf16."""
    return 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * 2


def moe_dropped_at_decode(server, cfg):
    """Capacity C at the served batch, which must hold a group's every
    routing slot (each decode slot is its own group, so C = 8 >= top_k),
    and the slots ``moe.dropped_slots`` counts on layer 0's experts at a
    decode-shaped input."""
    G = moe._num_groups(BATCH)
    C = moe.capacity(cfg, BATCH // G)
    if C < (BATCH // G) * cfg.top_k:
        raise AssertionError(f"C = {C} < {BATCH // G} tokens x top-"
                             f"{cfg.top_k} a group: decode would drop slots")
    p = layer_slice(server.params["layers"], 0)["moe"]
    g = torch.Generator("cuda").manual_seed(6)
    x = torch.randn(BATCH, 1, cfg.d_model, generator=g,
                    device="cuda").bfloat16()
    return G, C, int(moe.dropped_slots(p, x, cfg))


def time_expert_products(server, cfg):
    """One layer's three expert products at the decode shape (every
    expert's (G*C, D) buffer against its weights, bf16) and its whole
    ``moe_ffn``, device ms with the L2 flushed, beside the bytes floor of
    its expert weights."""
    p = layer_slice(server.params["layers"], 0)["moe"]
    G = moe._num_groups(BATCH)
    C = moe.capacity(cfg, BATCH // G)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    g = torch.Generator("cuda").manual_seed(7)
    xe = torch.randn(E, G * C, D, generator=g, device="cuda").bfloat16()
    x = torch.randn(BATCH, 1, D, generator=g, device="cuda").bfloat16()
    act = activation(cfg)
    ms = time_ms(lambda: (act(xe @ p["wg"]) * (xe @ p["wi"])) @ p["wo"],
                 reps=20)
    ffn_ms = time_ms(lambda: moe.moe_ffn(p, x, cfg, NOSHARD), reps=20)
    nbytes = expert_bytes(cfg)
    floor = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"expert products of one layer at decode (E={E}, G*C={G * C} rows, "
        f"D={D}, F={F}, bf16): {ms:.4f} ms, bytes floor {floor:.4f} ms "
        f"({nbytes} bytes, {nbytes / ms * 1e-6:.1f} GB/s); the layer's "
        f"moe_ffn {ffn_ms:.4f} ms; x {cfg.n_layers} layers: "
        f"{ms * cfg.n_layers:.3f} ms a step beside a floor of "
        f"{floor * cfg.n_layers:.3f}")
    return dict(ms=ms, moe_ffn_ms=ffn_ms, bound_ms=floor)


def moe_serve_full_width():
    """phi3.5-moe at full width on the dense phase's request mix: every
    request finishes, every layer of every step runs the flash-decode
    kernel, no routing slot is dropped at decode (C = 8 >= Tg * K = 2),
    and kernel vs plain decode steps agree (float32 at MOE_F32_LAYERS)."""
    t0 = time.time()
    cfg, full = moe_config(), get_config(MOE_ARCH)
    layer_bytes = 2 * (expert_bytes(cfg) // 2 + cfg.d_model * cfg.n_experts
                       + cfg.d_model * cfg.head_dim
                       * (2 * cfg.n_heads + 2 * cfg.n_kv_heads))
    log(f"MoE: {MOE_ARCH} at full width, depth cut to {cfg.n_layers} of "
        f"{full.n_layers} layers: {cfg.n_params() * 2 / 1e9:.1f} GB of bf16 "
        f"weights (all {full.n_layers}: {full.n_params() * 2 / 1e9:.1f} GB, "
        f"beyond the card), {layer_bytes / 1e9:.2f} GB a layer")
    model, server, launches, run = serve_full_width(cfg, torch.bfloat16)
    G, C, dropped = moe_dropped_at_decode(server, cfg)
    log(f"MoE routing at decode: {G} groups of {BATCH // G} token, top-"
        f"{cfg.top_k} of {cfg.n_experts}, capacity C = {C} a group and "
        f"expert; {dropped} of {BATCH * cfg.top_k} slots dropped on "
        f"layer 0's experts at a decode-shaped input")
    if dropped:
        raise AssertionError("the decode step dropped routing slots")
    split = profile_steps(model, server)
    floor = cfg.n_layers * expert_bytes(cfg) / HBM_BYTES_PER_S * 1e3
    log(f"  expert products {split.get('expert products', float('nan')):.3f}"
        f" ms/step beside their bytes floor of {floor:.3f} ms "
        f"({cfg.n_layers * expert_bytes(cfg) / 1e9:.2f} GB of expert weights"
        f" a step at 3.35 TB/s); all layer weights once a step "
        f"{cfg.n_layers * layer_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    run.update(split=split, experts=time_expert_products(server, cfg))
    teacher_forced_check(model, server, f32_layers=MOE_F32_LAYERS)
    del model, server
    torch.cuda.empty_cache()
    log(f"MoE phase: {time.time() - t0:.1f} s, initialisation included")
    return launches, run


# ---------------------------------------------------------------------------
# phase 4: the ssm family at full width
# ---------------------------------------------------------------------------
def ssm_batch(cfg, rows=SSM_BATCH):
    toks = np.random.default_rng(4).integers(0, cfg.vocab,
                                             (rows, SSM_LEN + 1))
    return {"tokens": torch.as_tensor(toks[:, :-1], device="cuda"),
            "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32,
                                      device="cuda")}


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def ssm_forward_full_width():
    """``Model.loss`` on mamba2-130m at B=8 x L=4096, kernel path timed and
    counted, then held against the plain path.  In a float32 config, the
    decisive check, the hidden states and the loss at SSM_F32_TOL.  In
    bf16 one flipped bf16 rounding grows over 24 random layers (the hidden
    states of the two paths differ by a few percent in norm there), so
    bf16 holds the 24-layer loss at SSM_BF16_LOSS_REL and the first
    layer's mixer output (the scan's result before the residual add) at
    SSM_BF16_MIXER_REL in norm."""
    cfg = get_config(SSM_ARCH)
    model = build_model(cfg)
    t0 = time.time()
    params = precast(model.init(torch.Generator("cuda").manual_seed(0)),
                     torch.bfloat16)
    n_params = sum(t.numel() for t in _leaves(params))
    batch = ssm_batch(cfg)
    kopts = ModelOpts(use_kernel=True, ce_chunk=SSM_CE_CHUNK)
    popts = dataclasses.replace(kopts, use_kernel=False)
    tokens = SSM_BATCH * SSM_LEN
    with torch.no_grad():
        model.loss(params, batch, opts=kopts)           # warm-up
        torch.cuda.synchronize()
        log(f"{SSM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
            f"{cfg.ssm_state}, {n_params} parameters, set up in "
            f"{time.time() - t0:.1f} s")
        ssd.COUNT.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SSM_FORWARDS):
            loss_k = model.loss(params, batch, opts=kopts)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / SSM_FORWARDS
        launches, plain = ssd.COUNT.launches, ssd.COUNT.plain
        wgmma = ssd.COUNT.wgmma
        log(f"Model.loss with the kernel: {SSM_BATCH} x {SSM_LEN} tokens, "
            f"{wall * 1e3:.3f} ms/forward, {tokens / wall:.0f} tokens/s; "
            f"ssd_scan launches {launches} = {cfg.n_layers} x "
            f"{SSM_FORWARDS} forwards, {wgmma} of them with "
            f"{SSD_STATE_KERNEL} and {SSD_WGMMA_KERNEL}; plain-version calls "
            f"{plain}")
        if not launches == wgmma == cfg.n_layers * SSM_FORWARDS or plain:
            raise AssertionError("the ssm forward did not go through the "
                                 "tensor-core kernels on every layer")
        t0 = time.perf_counter()
        loss_p = model.loss(params, batch, opts=popts)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        log(f"Model.loss on the plain path: {plain_wall * 1e3:.3f} "
            f"ms/forward, {tokens / plain_wall:.0f} tokens/s")
        rows = profile_window(lambda: model.loss(params, batch, opts=kopts),
                              1, "forward")
        busy = sum(r[0] for r in rows) or float("nan")
        log("  ssd_scan's launches in the forward: " + ", ".join(
            f"{k} {sum(r[0] for r in rows if k in r[1]):.3f} ms "
            f"({sum(r[0] for r in rows if k in r[1]) / busy:.1%} of device "
            f"busy)" for k in SSD_LAUNCHES))
        shown = {k: sum(r[2] for r in rows if k in r[1])
                 for k in SSD_LAUNCHES + SSD_CUDA_CORE}
        if any(shown[k] != cfg.n_layers for k in SSD_LAUNCHES) or any(
                shown[k] for k in SSD_CUDA_CORE):
            raise AssertionError(f"the profiled forward shows {shown}, not "
                                 f"each of {SSD_LAUNCHES} once a layer")

        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = build_model(cfg32)
        params32 = model32.init(torch.Generator("cuda").manual_seed(0))
        h_k, _ = model32.forward(params32, batch, opts=kopts)
        h_p, _ = model32.forward(params32, batch, opts=popts)
        l_k = model32.loss(params32, batch, opts=kopts).item()
        l_p = model32.loss(params32, batch, opts=popts).item()
        herr = (h_k - h_p).abs().max().item()
        log(f"float32 kernel vs plain: hidden states max diff {herr:.3e}, "
            f"loss {l_k:.6f} vs {l_p:.6f} (tol {SSM_F32_TOL:g} abs+rel)")
        if not torch.allclose(h_k, h_p, atol=SSM_F32_TOL, rtol=SSM_F32_TOL) \
                or abs(l_k - l_p) > SSM_F32_TOL * (1 + abs(l_p)):
            raise AssertionError("float32 kernel and plain ssm forwards "
                                 "differ")
        del h_k, h_p, params32

        lk, lp = loss_k.item(), loss_p.item()
        h_k = model.forward(params, batch, opts=kopts)[0]
        h_p = model.forward(params, batch, opts=popts)[0]
        if h_k.shape != (SSM_BATCH, SSM_LEN, cfg.d_model) or not (
                np.isfinite(lk) and torch.isfinite(h_k.float()).all()):
            raise AssertionError("the ssm forward is not finite or is "
                                 f"shaped {tuple(h_k.shape)}")
        rel_24 = _rel(h_k, h_p)
        del h_k, h_p
        p0 = layer_slice(params["layers"], 0)
        u = rmsnorm(p0["ln"], embed(params["embed"], batch["tokens"],
                                    torch.bfloat16))
        y_k = ssm_mod.mamba_block(p0["mixer"], u, cfg, NOSHARD,
                                  use_kernel=True)
        y_p = ssm_mod.mamba_block(p0["mixer"], u, cfg, NOSHARD,
                                  use_kernel=False)
        rel_mixer = _rel(y_k, y_p)
        log(f"bf16 kernel vs plain: loss {lk:.6f} vs {lp:.6f} (rel tol "
            f"{SSM_BF16_LOSS_REL:g}); first layer's mixer output "
            f"{rel_mixer:.3e} in norm (tol {SSM_BF16_MIXER_REL:g}); hidden "
            f"states after {cfg.n_layers} layers {rel_24:.3e} (not held)")
        if abs(lk - lp) > SSM_BF16_LOSS_REL * abs(lp) \
                or rel_mixer > SSM_BF16_MIXER_REL:
            raise AssertionError("bf16 kernel and plain ssm forwards differ")
        del y_k, y_p, u
    return model, params, launches


def ssm_serve_full_width(model, params):
    """16 requests through ``BatchedServer`` at full mamba2-130m width;
    then one request served in a reused slot against serving it alone."""
    server = BatchedServer(model, params, batch_size=BATCH,
                           max_seq=SSM_SERVE_SEQ, use_kernel=True,
                           device="cuda")
    if server.use_kernel:
        raise AssertionError("the ssm server must run no kernel")
    reqs = request_mix(model.cfg.vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = server.steps
    generated = sum(len(v) for v in results.values())
    log(f"{SSM_ARCH} served {len(results)} requests: {steps} decode steps, "
        f"{generated} tokens generated, {wall:.3f} s, "
        f"{wall / steps * 1e3:.3f} ms/step, {generated / wall:.2f} tokens/s")
    if sorted(results) != list(range(N_REQUESTS)) or any(
            len(v) != NEW_TOKENS for v in results.values()):
        raise AssertionError("not every ssm request finished")
    profile_steps(model, server)

    mk = lambda: Request(rid=7, prompt=reqs[-1].prompt, max_new_tokens=8)
    alone = BatchedServer(model, params, batch_size=1,
                          max_seq=SSM_SERVE_SEQ, device="cuda").run([mk()])
    reused = BatchedServer(model, params, batch_size=1,
                           max_seq=SSM_SERVE_SEQ, device="cuda")
    reused.run([Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=8)])
    again = reused.run([mk()])
    log(f"ssm slot reuse: {again[7]} vs alone {alone[7]}")
    if again != alone:
        raise AssertionError("the reused slot leaked recurrent state")


# ---------------------------------------------------------------------------
# phase 4c: the hybrid family at full width and depth
# ---------------------------------------------------------------------------
def no_port_launches(what, fn):
    """``fn()``, failing if it launched a port kernel or ran a plain
    version."""
    before = port_launches()
    out = fn()
    after = port_launches()
    log(f"  port kernels in {what}: {before} before, {after} after")
    if after != before:
        raise AssertionError(f"{what} launched a port kernel")
    return out


def decisive_tokens(a, b, what):
    """``a``'s argmax equals ``b``'s wherever b's top-2 margin exceeds
    BF16_MARGIN; -> (decisive count, logits relative in norm)."""
    top2 = b.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > BF16_MARGIN
    if not torch.equal(a.argmax(-1)[sure], b.argmax(-1)[sure]):
        raise AssertionError(f"{what}: a decisive token differs")
    return int(sure.sum()), _rel(a, b)


def decode_vs_prefill(model, params, tokens):
    """``tokens`` (B, T) decoded one at a time from an empty f32 cache and
    prefilled at once -> (the last decode step's logits, prefill's)."""
    B, T = tokens.shape
    cache = model.init_cache(B, T, torch.float32, "cuda")
    for i in range(T):
        lg, cache = model.decode_step(
            params, {"token": tokens[:, i:i + 1], "pos": i}, cache)
    full, _ = model.prefill(params, {"tokens": tokens},
                            opts=ModelOpts(attn_chunk=T))
    return lg, full


def serve_lockstep(model, params):
    """The dense request mix through ``BatchedServer``'s lockstep fallback
    (batch 8, f32 cache of MAX_SEQ): every request finishes, no port kernel
    launches; a profiled window of steps gives the idle share."""
    server = BatchedServer(model, params, batch_size=BATCH, max_seq=MAX_SEQ,
                           opts=ModelOpts(attn_chunk=64), use_kernel=True,
                           device="cuda")
    if server.continuous or server.use_kernel:
        raise AssertionError(f"{model.cfg.name}: the server must fall back "
                             "to lockstep, with no kernel")
    reqs = request_mix(model.cfg.vocab)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = server.run(reqs)
        torch.cuda.synchronize()
        return results, time.perf_counter() - t0
    results, wall = no_port_launches("the lockstep server", run)
    steps = server._lockstep.pos
    generated = sum(len(v) for v in results.values())
    log(f"{model.cfg.name} served {len(results)} requests (lockstep "
        f"fallback): {steps} decode steps, {generated} tokens generated, "
        f"{wall:.3f} s, {wall / steps * 1e3:.3f} ms/step, "
        f"{generated / wall:.2f} tokens/s")
    if sorted(results) != list(range(N_REQUESTS)) or any(
            len(v) != NEW_TOKENS for v in results.values()):
        raise AssertionError("not every request finished")
    no_port_launches("the profiled steps",
                     lambda: profile_steps(model, server))
    return dict(steps=steps, wall_s=wall, generated=generated)


def hybrid_f32_check(cfg, batch, kopts, ce):
    """The float32 config at HYBRID_F32_GROUPS groups: every Mamba layer's
    mixer output with the kernel against the plain one on the same input
    (the plain path's hidden states, walked layer by layer as
    ``Model.forward`` walks them) at HYBRID_F32_MIXER_REL in norm; then the
    kernel path's ``Model.forward`` against that walk: the hidden states
    at HYBRID_F32_HIDDEN_REL in norm, the loss at SSM_F32_TOL.  (Held in
    norm: one layer's kernel vs plain difference, ~7e-6 in norm, grows
    through the random layers, to ~1e-4 after two groups, and its
    largest elements sit in the tails.)  -> (the model, its parameters)."""
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=(
        HYBRID_F32_GROUPS * cfg.shared_attn_every))
    g, k, _ = _groups(cfg32)
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator("cuda").manual_seed(0))
    popts = dataclasses.replace(kopts, use_kernel=False)
    positions = torch.arange(SSM_LEN, device="cuda")[None]
    h = embed(params32["embed"], batch["tokens"], torch.float32)
    errs = []
    for p_g in unstack_groups(params32["groups"], g, k):
        for p in p_g:
            u = rmsnorm(p["ln"], h)
            y_p = ssm_mod.mamba_block(p["mixer"], u, cfg32, NOSHARD,
                                      use_kernel=False)
            errs.append(_rel(ssm_mod.mamba_block(
                p["mixer"], u, cfg32, NOSHARD, use_kernel=True), y_p))
            h = h + y_p
        h = blocks.dense_block(params32["shared"], h, cfg32, NOSHARD, popts,
                               positions=positions)[0]
    h_p = rmsnorm(params32["ln_f"], h)
    del h
    h_k = model32.forward(params32, batch, opts=kopts)[0]
    rel_h = _rel(h_k, h_p)
    l_k, l_p = ce(h_k, params32, cfg32), ce(h_p, params32, cfg32)
    log(f"float32 kernel vs plain ({cfg32.n_layers} layers, "
        f"{HYBRID_F32_GROUPS} groups): each Mamba layer's mixer output on "
        f"the same input {min(errs):.3e}-{max(errs):.3e} in norm (tol "
        f"{HYBRID_F32_MIXER_REL:g}); the forward's hidden states "
        f"{rel_h:.3e} in norm (tol {HYBRID_F32_HIDDEN_REL:g}), max diff "
        f"{(h_k - h_p).abs().max().item():.3e}; loss {l_k:.6f} vs "
        f"{l_p:.6f} (tol {SSM_F32_TOL:g} abs+rel)")
    if max(errs) > HYBRID_F32_MIXER_REL or rel_h > HYBRID_F32_HIDDEN_REL \
            or abs(l_k - l_p) > SSM_F32_TOL * (1 + abs(l_p)):
        raise AssertionError("float32 kernel and plain hybrid forwards "
                             "differ")
    return model32, params32


def hybrid_forward_full_width():
    """zamba2-7b at full width and depth: ``Model.loss`` on 8 x 4096 tokens
    with the kernel, timed; exactly one ``ssd_scan`` a Mamba layer (81 a
    forward), each on the tensor-core instances; a profiled forward split
    by part; held against the plain path (bf16: the loss and the first
    Mamba layer's mixer output; float32 at HYBRID_F32_GROUPS groups: the
    hidden states and the loss at SSM_F32_TOL); decode against prefill;
    then the lockstep server on the dense request mix."""
    t_phase = time.time()
    cfg = get_config(HYBRID_ARCH)
    g, k, r = _groups(cfg)
    model = build_model(cfg)
    t0 = time.time()
    params = model.init(torch.Generator("cuda").manual_seed(0),
                        torch.bfloat16)
    n_params = sum(t.numel() for t in _leaves(params))
    batch = ssm_batch(cfg)
    kopts = ModelOpts(use_kernel=True, ce_chunk=SSM_CE_CHUNK)
    popts = dataclasses.replace(kopts, use_kernel=False)
    tokens = SSM_BATCH * SSM_LEN

    def ce(h, p=params, c=cfg):
        """Model.loss's value from the hidden states (no aux term)."""
        return chunked_cross_entropy(p["embed"], c, h, batch["labels"],
                                     NOSHARD, chunk=SSM_CE_CHUNK).item()
    with torch.no_grad():
        model.loss(params, batch, opts=kopts)           # warm-up
        torch.cuda.synchronize()
        log(f"hybrid: {HYBRID_ARCH} at full width and depth: {cfg.n_layers} "
            f"Mamba layers ({g} groups of {k}, {r} in rem) and one shared "
            f"attention block, d_model {cfg.d_model}, {cfg.ssm_heads} heads "
            f"of {cfg.ssm_head_dim}, state {cfg.ssm_state}; {n_params} "
            f"parameters, {2 * n_params / 1e9:.1f} GB in bf16, set up in "
            f"{time.time() - t0:.1f} s")
        for count in (da.COUNT, fa.COUNT, ssd.COUNT):
            count.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HYBRID_FORWARDS):
            model.loss(params, batch, opts=kopts)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / HYBRID_FORWARDS
        counts = port_launches()
        launches, wgmma = ssd.COUNT.launches, ssd.COUNT.wgmma
        log(f"Model.loss with the kernel: {SSM_BATCH} x {SSM_LEN} tokens, "
            f"{wall * 1e3:.3f} ms/forward, {tokens / wall:.0f} tokens/s; "
            f"ssd_scan launches {launches} = {cfg.n_layers} x "
            f"{HYBRID_FORWARDS} forwards, {wgmma} of them with "
            f"{SSD_STATE_KERNEL} and {SSD_WGMMA_KERNEL}; all counts {counts}")
        if not launches == wgmma == cfg.n_layers * HYBRID_FORWARDS or \
                counts != {"decode_attention": (0, 0),
                           "flash_attention": (0, 0),
                           "ssd_scan": (launches, 0)}:
            raise AssertionError("the hybrid forward did not run one "
                                 "tensor-core ssd_scan per Mamba layer, and "
                                 "nothing else")
        parts, rows = profile_train_step(
            lambda: model.loss(params, batch, opts=kopts),
            [(kopts.attn_chunk, SSM_LEN)], "forward")
        shown = {name: sum(row[2] for row in rows if name in row[1])
                 for name in SSD_LAUNCHES + SSD_CUDA_CORE}
        if rows and (any(shown[n] != cfg.n_layers for n in SSD_LAUNCHES)
                     or any(shown[n] for n in SSD_CUDA_CORE)):
            raise AssertionError(f"the profiled forward shows {shown}, not "
                                 f"each of {SSD_LAUNCHES} once a layer")

        h_k = model.forward(params, batch, opts=kopts)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h_p = model.forward(params, batch, opts=popts)[0]
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        if h_k.shape != (SSM_BATCH, SSM_LEN, cfg.d_model) or not \
                torch.isfinite(h_k.float()).all():
            raise AssertionError("the hybrid forward is not finite or is "
                                 f"shaped {tuple(h_k.shape)}")
        lk, lp = ce(h_k), ce(h_p)
        rel_h = _rel(h_k, h_p)
        del h_k, h_p
        p0 = layer_slice(layer_slice(params["groups"], 0), 0)
        u = rmsnorm(p0["ln"], embed(params["embed"], batch["tokens"],
                                    torch.bfloat16))
        rel_mixer = _rel(*(ssm_mod.mamba_block(p0["mixer"], u, cfg, NOSHARD,
                                               use_kernel=kern)
                           for kern in (True, False)))
        del u
        log(f"Model.forward on the plain path: {plain_wall * 1e3:.3f} ms; "
            f"bf16 kernel vs plain: loss {lk:.6f} vs {lp:.6f} (rel tol "
            f"{HYBRID_BF16_LOSS_REL:g}); the first Mamba layer's mixer "
            f"output {rel_mixer:.3e} in norm (tol {HYBRID_BF16_MIXER_REL:g});"
            f" hidden states after {cfg.n_layers} layers {rel_h:.3e} in norm"
            f" (not held)")
        if not np.isfinite(lk) or abs(lk - lp) > HYBRID_BF16_LOSS_REL * abs(
                lp) or rel_mixer > HYBRID_BF16_MIXER_REL:
            raise AssertionError("bf16 kernel and plain hybrid forwards "
                                 "differ")

        model32, params32 = hybrid_f32_check(cfg, batch, kopts, ce)

    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (BATCH, TEACHER_LEN)), device="cuda")

    def teacher():
        a, b = decode_vs_prefill(model, params, toks)
        decisive, rel = decisive_tokens(a, b, "hybrid decode vs prefill")
        a32, b32 = decode_vs_prefill(model32, params32, toks)
        err32 = (a32 - b32).abs().max().item()
        log(f"hybrid decode vs prefill, {BATCH} x {TEACHER_LEN} tokens: bf16 "
            f"({cfg.n_layers} layers) logits {rel:.3e} in norm, {decisive}/"
            f"{BATCH} tokens with top-2 margin > {BF16_MARGIN:g}, all equal;"
            f" float32 ({model32.cfg.n_layers} layers) max diff {err32:.3e} "
            f"(tol {F32_LOGIT_TOL:g} abs+rel)")
        if not torch.allclose(a32, b32, atol=F32_LOGIT_TOL,
                              rtol=F32_LOGIT_TOL):
            raise AssertionError("float32 hybrid decode and prefill differ")
    no_port_launches("decode vs prefill", teacher)
    del params32, model32
    run = serve_lockstep(model, params)
    del params
    torch.cuda.empty_cache()
    log(f"hybrid phase: {time.time() - t_phase:.1f} s")
    return dict(ms_per_forward=wall * 1e3, plain_ms=plain_wall * 1e3,
                launches=launches, parts=parts, serve=run)


# ---------------------------------------------------------------------------
# phase 4d: the vlm family at full width
# ---------------------------------------------------------------------------
def spec_params(cfg):
    """Parameters of ``cfg``'s tree, counted from its spec."""
    return sum(math.prod(p.shape)
               for p in _leaves(build_model(cfg).param_spec()))


def vlm_full_width():
    """llama-3.2-vision-90b at full width, its depth cut to VLM_GROUPS
    groups: ``prefill`` at 1 x VLM_LEN with seeded image embeddings, then
    VLM_STEPS decode steps on its cache (image K/V included) held against
    the prefill of the longer sequence; then the lockstep server on the
    dense request mix.  No port kernel launches in the phase."""
    t_phase = time.time()
    before = port_launches()
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full,
                              n_layers=VLM_GROUPS * full.cross_attn_every)
    g, k, _ = _groups(cfg)
    model = build_model(cfg)
    t0 = time.time()
    params = model.init(torch.Generator("cuda").manual_seed(0),
                        torch.bfloat16)
    n_params, n_full = spec_params(cfg), spec_params(full)
    torch.cuda.synchronize()
    log(f"vlm: {VLM_ARCH} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, kv {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.n_image_tokens} image tokens), depth cut to "
        f"{g} of {full.n_layers // full.cross_attn_every} groups ({g * k} "
        f"self and {g} cross layers): {n_params} parameters, "
        f"{2 * n_params / 1e9:.1f} GB in bf16 (all {full.n_layers} layers: "
        f"{2 * n_full / 1e9:.1f} GB); set up in {time.time() - t0:.1f} s")
    S, T = VLM_LEN, VLM_STEPS
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, S + T)), device="cuda")
    img = torch.randn(1, cfg.n_image_tokens, cfg.d_model,
                      generator=torch.Generator("cuda").manual_seed(1),
                      device="cuda")
    batch = {"tokens": toks[:, :S], "image_embeds": img}
    model.prefill(params, batch)                        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, pc = model.prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if logits.shape != (1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError("the vlm prefill's logits are not finite")
    cache = model.init_cache(1, S + T, torch.bfloat16, "cuda")
    cache["k"][:, :, :, :S].copy_(pc["k"])
    cache["v"][:, :, :, :S].copy_(pc["v"])
    cache["xk"].copy_(pc["xk"])
    cache["xv"].copy_(pc["xv"])
    del pc
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(T):
        lg, cache = model.decode_step(
            params, {"token": toks[:, S + i:S + i + 1], "pos": S + i}, cache)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / T
    del cache
    full_lg, _ = model.prefill(params, {"tokens": toks, "image_embeds": img},
                               opts=ModelOpts(attn_chunk=S + T))
    decisive, rel = decisive_tokens(lg, full_lg, "vlm decode vs prefill")
    log(f"vlm prefill 1 x {S} tokens and {cfg.n_image_tokens} image tokens: "
        f"{prefill_s * 1e3:.3f} ms; {T} decode steps on its cache: "
        f"{step_s * 1e3:.3f} ms/step; the last step's logits vs the prefill "
        f"of all {S + T} tokens: {rel:.3e} in norm, {decisive}/1 tokens with "
        f"top-2 margin > {BF16_MARGIN:g}, all equal")
    run = serve_lockstep(model, params)
    del params
    torch.cuda.empty_cache()
    after = port_launches()
    log(f"port kernels over the vlm phase: {before} before, {after} after; "
        f"vlm phase {time.time() - t_phase:.1f} s")
    if after != before:
        raise AssertionError("the vlm phase launched a port kernel")
    return dict(prefill_ms=prefill_s * 1e3, decode_ms=step_s * 1e3,
                serve=run)


# ---------------------------------------------------------------------------
# phase 4e: the audio family at full width and depth
# ---------------------------------------------------------------------------
def audio_full_width():
    """hubert-xlarge at full width and depth: ``prefill`` (the encoder
    pass, logits per frame) on 8 x 4096 seeded frames, timed and profiled;
    held: its logits finite and shaped, and a float32 prefill at
    AUDIO_CHECK's size on the card against the same on the CPU.  No port
    kernel launches in the phase."""
    t_phase = time.time()
    before = port_launches()
    cfg = get_config(AUDIO_ARCH)
    model = build_model(cfg)
    t0 = time.time()
    params = model.init(torch.Generator("cuda").manual_seed(0),
                        torch.bfloat16)
    n_params = sum(t.numel() for t in _leaves(params))
    frames = torch.randn(SSM_BATCH, SSM_LEN, cfg.frame_dim,
                         generator=torch.Generator("cuda").manual_seed(2),
                         device="cuda")
    batch = {"frames": frames}
    logits, _ = model.prefill(params, batch)             # warm-up
    torch.cuda.synchronize()
    log(f"audio: {AUDIO_ARCH} at full width and depth ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, bidirectional): {n_params} parameters, set up in "
        f"{time.time() - t0:.1f} s")
    if logits.shape != (SSM_BATCH, SSM_LEN, cfg.vocab) or not \
            torch.isfinite(logits).all():
        raise AssertionError("the audio prefill's logits are not finite or "
                             f"are shaped {tuple(logits.shape)}")
    del logits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(AUDIO_FORWARDS):
        model.prefill(params, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / AUDIO_FORWARDS
    log(f"audio prefill {SSM_BATCH} x {SSM_LEN} frames: {wall * 1e3:.3f} "
        f"ms/forward, {SSM_BATCH * SSM_LEN / wall:.0f} frames/s")
    parts, _ = profile_train_step(lambda: model.prefill(params, batch),
                                  [(ModelOpts().attn_chunk, SSM_LEN)],
                                  "forward")
    del params, frames, batch
    torch.cuda.empty_cache()

    n, B, L = AUDIO_CHECK
    cfg32 = dataclasses.replace(cfg, n_layers=n, dtype="float32")
    model32 = build_model(cfg32)
    p_cpu = model32.init(torch.Generator().manual_seed(0))
    f_cpu = torch.randn(B, L, cfg.frame_dim,
                        generator=torch.Generator().manual_seed(3))
    opts = ModelOpts(attn_chunk=L)
    ref, _ = model32.prefill(p_cpu, {"frames": f_cpu}, opts=opts)
    out, _ = model32.prefill(tree_map(lambda t: t.cuda(), p_cpu),
                             {"frames": f_cpu.cuda()}, opts=opts)
    err = (out.cpu() - ref).abs().max().item()
    log(f"audio float32 prefill card vs CPU ({n} layers, {B} x {L} "
        f"frames): logits max diff {err:.3e} (tol {AUDIO_DEVICE_TOL:g} "
        f"abs+rel)")
    if not torch.allclose(out.cpu(), ref, atol=AUDIO_DEVICE_TOL,
                          rtol=AUDIO_DEVICE_TOL):
        raise AssertionError("the audio prefill differs between the card "
                             "and the CPU")
    after = port_launches()
    log(f"port kernels over the audio phase: {before} before, {after} "
        f"after; audio phase {time.time() - t_phase:.1f} s")
    if after != before:
        raise AssertionError("the audio phase launched a port kernel")
    return dict(ms_per_forward=wall * 1e3, parts=parts)


# ---------------------------------------------------------------------------
# phase 4f: the banded local:global path, gemma3-27b at full width and depth
# ---------------------------------------------------------------------------
def prefill_then_decode(model, params, toks, S, cache_dtype):
    """``prefill`` of ``toks[:, :S]`` (timed after a warm-up), then the
    rest of ``toks`` decoded one at a time on its cache -> (prefill s,
    s a decode step, the last step's logits, the logits of the prefill of
    all of ``toks``)."""
    B, T = toks.shape[0], toks.shape[1] - S
    batch = {"tokens": toks[:, :S]}
    model.prefill(params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, pc = model.prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if logits.shape != (B, model.cfg.vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError("the prefill's logits are not finite")
    cache = model.init_cache(B, S + T, cache_dtype, "cuda")
    for key, c in cache.items():
        c[:, :, :S].copy_(pc[key])
    del pc
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(T):
        lg, cache = model.decode_step(
            params, {"token": toks[:, S + i:S + i + 1], "pos": S + i}, cache)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / T
    del cache
    full, _ = model.prefill(params, {"tokens": toks},
                            opts=ModelOpts(attn_chunk=S + T))
    return prefill_s, step_s, lg, full


def gemma_forwards(model, params, batch, band):
    """``Model.loss`` under ``no_grad`` banded and unbanded: a warm-up
    ``Model.forward``, GEMMA_FORWARDS timed calls (the median), peak
    memory, one profiled forward split by part -> {banded: dict(loss, ms,
    peak, parts, the warm-up's hidden states)}."""
    chunk, S = ModelOpts().attn_chunk, batch["tokens"].shape[1]
    B, runs = batch["tokens"].shape[0], {}
    for banded in (True, False):
        opts = ModelOpts(banded_local=banded)

        def fn():
            return model.loss(params, batch, opts=opts)
        torch.cuda.reset_peak_memory_stats()
        h = model.forward(params, batch, opts=opts)[0]      # warm-up
        times = []
        for _ in range(GEMMA_FORWARDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        wall = float(np.median(times))
        name = "banded" if banded else "unbanded"
        log(f"gemma3 Model.loss {name}, {B} x {S} tokens: {wall * 1e3:.3f} "
            f"ms/forward (median of {GEMMA_FORWARDS}: "
            f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), "
            f"{B * S / wall:.0f} tokens/s; peak memory "
            f"{peak / 2**30:.2f} GiB; loss {float(loss):.6f}")
        # local layers' score chunks are (chunk, band) when banded
        scores = [(chunk, S)] + ([(chunk, band)] if banded else [])
        parts, _ = profile_train_step(fn, scores, "forward")
        runs[banded] = dict(loss=float(loss), ms=wall * 1e3, peak=peak,
                            parts=parts, hidden=h)
    return runs


def gemma_check_layers(cfg, toks):
    """gemma3-27b at full width and GEMMA_CHECK_LAYERS layers from one set
    of f32 masters: the float32 config's banded forward against the
    unbanded one on 1 x 4096 (hidden states and loss at GEMMA_F32_REL),
    its decode after a prefill against the prefill of all of ``toks``
    (F32_LOGIT_TOL); then the loss and gradient in bf16 with remat
    "full", banded and unbanded, each timed with its peak memory (the
    loss at GEMMA_LOSS_REL), and in float32, unbanded and banded.  Held
    in norm: the float32 grads banded vs unbanded at GEMMA_F32_GRAD_REL,
    the bf16 ones within GEMMA_BF16_NOISE times the bf16 unbanded grads'
    distance from the float32 ones.  At most three sets of grads are on
    the card at once: the float32 unbanded set waits on the host while
    the banded one is taken (on the card beside it, that backward's
    fragments leave no room for its last leaf)."""
    cfg32 = dataclasses.replace(cfg, n_layers=GEMMA_CHECK_LAYERS,
                                dtype="float32")
    model32 = build_model(cfg32)
    params = model32.init(torch.Generator("cuda").manual_seed(1))
    batch = ssm_batch(cfg, 1)

    def ce(h):
        return chunked_cross_entropy(params["embed"], cfg32, h,
                                     batch["labels"], NOSHARD).item()
    with torch.no_grad():
        h_b, h_u = (model32.forward(params, batch, opts=ModelOpts(
            banded_local=banded))[0] for banded in (True, False))
        rel_h, l_b, l_u = _rel(h_b, h_u), ce(h_b), ce(h_u)
        del h_b, h_u
    log(f"gemma3 float32 at {cfg32.n_layers} layers, 1 x {SSM_LEN}: banded "
        f"vs unbanded hidden states {rel_h:.3e} in norm, loss {l_b:.7f} vs "
        f"{l_u:.7f} (tol {GEMMA_F32_REL:g} each)")
    if rel_h > GEMMA_F32_REL or abs(l_b - l_u) > GEMMA_F32_REL * abs(l_u):
        raise AssertionError("float32 banded and unbanded forwards differ")
    prefill_s, step_s, lg, full = prefill_then_decode(
        model32, params, toks, SSM_LEN, torch.float32)
    err = (lg - full).abs().max().item()
    log(f"gemma3 float32 decode vs prefill ({cfg32.n_layers} layers): "
        f"prefill 1 x {SSM_LEN} {prefill_s * 1e3:.3f} ms, {GEMMA_STEPS} "
        f"decode steps {step_s * 1e3:.3f} ms/step; the last step's logits "
        f"vs the prefill of all {toks.shape[1]} tokens max diff {err:.3e} "
        f"(tol {F32_LOGIT_TOL:g} abs+rel)")
    if not torch.allclose(lg, full, atol=F32_LOGIT_TOL, rtol=F32_LOGIT_TOL):
        raise AssertionError("float32 gemma3 decode and prefill differ")
    del lg, full

    model = build_model(dataclasses.replace(cfg32, dtype="bfloat16"))
    opts = {banded: ModelOpts(remat="full", banded_local=banded)
            for banded in (True, False)}
    loss_and_grads(model, params, batch, opts[True])        # warm-up
    runs = {}
    for banded in (True, False):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, params, batch, opts[banded])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        runs[banded] = dict(loss=float(loss), grads=grads, ms=wall * 1e3,
                            peak=peak, held=held)
        log(f"gemma3 training at {cfg32.n_layers} layers ("
            f"{'banded' if banded else 'unbanded'}; f32 masters, bf16, remat "
            f"full, 1 x {SSM_LEN}): loss and gradient {wall * 1e3:.1f} ms; "
            f"peak memory {peak / 2**30:.2f} GiB, {held / 2**30:.2f} GiB of "
            f"it held before the call; loss {float(loss):.6f}")
    rel16 = _tree_rel(runs[True].pop("grads"), runs[False]["grads"])
    t0 = time.perf_counter()
    g32 = loss_and_grads(model32, params, batch, opts[False])[1]
    noise = _tree_rel(runs[False].pop("grads"), g32)
    g32 = [g.cpu() for g in g32]         # room for the banded f32 grads
    rel32 = _tree_rel(g32, loss_and_grads(model32, params, batch,
                                          opts[True])[1])
    del g32
    dl = abs(runs[True]["loss"] - runs[False]["loss"]) / abs(
        runs[False]["loss"])
    log(f"gemma3 gradients at {cfg32.n_layers} layers, relative in norm: "
        f"float32 banded vs unbanded {rel32:.3e} (tol "
        f"{GEMMA_F32_GRAD_REL:g}); bf16 banded vs unbanded {rel16:.3e} (tol "
        f"{GEMMA_BF16_NOISE:g} x {noise:.3e}, the bf16 unbanded grads' "
        f"distance from the float32 ones); bf16 loss {dl:.3e} relative (tol "
        f"{GEMMA_LOSS_REL:g}); float32 grads in "
        f"{time.perf_counter() - t0:.1f} s")
    if rel32 > GEMMA_F32_GRAD_REL or rel16 > GEMMA_BF16_NOISE * noise \
            or dl > GEMMA_LOSS_REL:
        raise AssertionError("banded and unbanded gradients differ")
    return {"banded" if b else "unbanded": run for b, run in runs.items()}


def gemma3_full_width():
    """gemma3-27b at full width and depth (62 layers, 27.0 B parameters in
    bf16, drawn one layer at a time): ``Model.loss`` on B x 4096 tokens
    banded and unbanded, each timed and profiled (B = 4 where twice B =
    2's working set fits beside the weights, else 2), their losses held
    at GEMMA_LOSS_REL; ``prefill`` of 1 x 4096 and GEMMA_STEPS decode
    steps on its cache against the prefill of all the tokens; the
    per-slot server on the dense request mix (``use_kernel`` asked for,
    refused for a windowed config as in the reference); then
    ``gemma_check_layers`` at 8 layers.  No port kernel launches in the
    phase: the reference's banded path calls none."""
    t_phase = time.time()
    cfg = get_config(GEMMA_ARCH)
    model = build_model(cfg)
    r = cfg.local_global_ratio + 1
    chunk = ModelOpts().attn_chunk
    band = min(SSM_LEN, -(-(cfg.sliding_window + chunk) // chunk) * chunk)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = model.init(torch.Generator("cuda").manual_seed(0),
                        torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    weights, total = torch.cuda.memory_allocated(), \
        torch.cuda.get_device_properties(0).total_memory
    log(f"gemma3: {GEMMA_ARCH} at full width and depth ({cfg.n_layers} "
        f"layers: {cfg.n_layers // r} superblocks of {r - 1} local + 1 "
        f"global, then {cfg.n_layers % r} local; d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, kv {cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, window {cfg.sliding_window}, band "
        f"{band} keys at chunk {chunk}): {n_params} parameters "
        f"(ArchConfig.n_params {cfg.n_params()}), {2 * n_params / 1e9:.1f} "
        f"GB in bf16, drawn in {time.time() - t0:.1f} s; device memory "
        f"{weights / 2**30:.2f} GiB (peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) of "
        f"{total / 2**30:.2f} GiB")
    if n_params != spec_params(cfg):
        raise AssertionError("the drawn tree is not the spec's")

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        model.loss(params, ssm_batch(cfg, 2),
                   opts=ModelOpts(banded_local=False))
        torch.cuda.synchronize()
        work2 = torch.cuda.max_memory_allocated() - weights
        B = 4 if weights + 2 * work2 + GEMMA_MARGIN <= total else 2
        log(f"gemma3 batch: the unbanded forward's working set at B = 2 is "
            f"{work2 / 2**30:.2f} GiB beside {weights / 2**30:.2f} GiB of "
            f"weights; twice it {'fits' if B == 4 else 'does not fit'} with "
            f"{GEMMA_MARGIN / 2**30:.0f} GiB to spare: B = {B}")
        batch = ssm_batch(cfg, B)
        runs = gemma_forwards(model, params, batch, band)
        h_b, h_u = (runs[banded].pop("hidden") for banded in (True, False))
        if h_b.shape != (B, SSM_LEN, cfg.d_model) or \
                not torch.isfinite(h_b.float()).all():
            raise AssertionError("the banded forward is not finite or is "
                                 f"shaped {tuple(h_b.shape)}")
        rel_h = _rel(h_b, h_u)
        del h_b, h_u, batch
    l_b, l_u = runs[True]["loss"], runs[False]["loss"]
    log(f"gemma3 banded vs unbanded at full depth: "
        f"{runs[False]['ms'] / runs[True]['ms']:.3f}x faster banded; loss "
        f"{l_b:.6f} vs {l_u:.6f} (rel tol {GEMMA_LOSS_REL:g}); hidden states "
        f"after {cfg.n_layers} layers {rel_h:.3e} in norm (not held)")
    if not np.isfinite(l_b) or abs(l_b - l_u) > GEMMA_LOSS_REL * abs(l_u):
        raise AssertionError("the banded and unbanded losses differ")

    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, (1, SSM_LEN + GEMMA_STEPS)), device="cuda")
    prefill_s, step_s, lg, full = prefill_then_decode(
        model, params, toks, SSM_LEN, torch.bfloat16)
    decisive, rel = decisive_tokens(lg, full, "gemma3 decode vs prefill")
    del lg, full
    log(f"gemma3 prefill 1 x {SSM_LEN}: {prefill_s * 1e3:.3f} ms; "
        f"{GEMMA_STEPS} decode steps on its cache: {step_s * 1e3:.3f} "
        f"ms/step; the last step's logits vs the prefill of all "
        f"{toks.shape[1]} tokens: {rel:.3e} in norm, {decisive}/1 tokens "
        f"with top-2 margin > {BF16_MARGIN:g}, all equal")

    server = BatchedServer(model, params, batch_size=BATCH, max_seq=MAX_SEQ,
                           opts=ModelOpts(attn_chunk=64), use_kernel=True,
                           device="cuda")
    if not server.continuous or server.use_kernel:
        raise AssertionError("the gemma3 server must serve per slot, with "
                             "no kernel (a windowed config)")
    reqs = request_mix(cfg.vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    generated = sum(len(v) for v in results.values())
    log(f"{GEMMA_ARCH} served {len(results)} requests per slot: "
        f"{server.steps} decode steps, {generated} tokens generated, "
        f"{wall:.3f} s, {wall / server.steps * 1e3:.3f} ms/step, "
        f"{generated / wall:.2f} tokens/s")
    if sorted(results) != list(range(N_REQUESTS)) or any(
            len(v) != NEW_TOKENS for v in results.values()):
        raise AssertionError("not every request finished")
    profile_steps(model, server)
    serve = dict(steps=server.steps, ms_per_step=wall / server.steps * 1e3)
    del server, params
    torch.cuda.empty_cache()

    train = gemma_check_layers(cfg, toks)
    torch.cuda.empty_cache()
    log(f"gemma3 phase: {time.time() - t_phase:.1f} s")
    return dict(forward={("banded" if k else "unbanded"): v
                         for k, v in runs.items()},
                prefill_ms=prefill_s * 1e3, decode_ms=step_s * 1e3,
                serve=serve, train=train)


# ---------------------------------------------------------------------------
# phase 4b: the training path at full width
# ---------------------------------------------------------------------------
def train_config(n_layers=TRAIN_LAYERS, dtype=None):
    """qwen1.5-4b at full width, its depth cut to ``n_layers``."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=n_layers)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def port_launches():
    """Each port kernel's (launches, plain-version calls) so far."""
    return {name: (c.launches, c.plain) for name, c in (
        ("decode_attention", da.COUNT), ("flash_attention", fa.COUNT),
        ("ssd_scan", ssd.COUNT))}


def loss_and_grads(model, params, batch, opts):
    """The loss and the gradient of every leaf of ``params``, in
    ``leaves`` order."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = model.loss(params, batch, opts=opts)
    return loss.detach(), torch.autograd.grad(loss, flat)


def _tree_rel(a, b):
    """||a - b|| / ||b|| over two lists of tensors, summed in float64 on
    b's device a slice of each leaf at a time (two sets of full-width
    gradients leave no room for a float64 copy of either)."""
    def slices(x):
        return x.detach().reshape(-1).split(2**26)
    diff = sum(float((cx.to(cy.device, torch.float64) - cy.double())
                     .square().sum())
               for x, y in zip(a, b) for cx, cy in zip(slices(x), slices(y)))
    norm = sum(float(cy.double().square().sum()) for y in b
               for cy in slices(y))
    return math.sqrt(diff / norm)


def train_device_check():
    """Two f32 steps (lr 0, then lr > 0) of reduced qwen1.5-4b in a float32
    config through ``TrainLoop.train_step`` on the card and on the CPU, the
    path the CPU tests hold against the reference, from one state drawn on
    the CPU.  Loss and grad norm at TRAIN_DEVICE_REL; the params after the
    steps at TRAIN_DEVICE_REL relative in norm over the tree, and each
    element within twice the steps' summed lr (what AdamW's sign-like
    first steps can move an element whose gradient is rounding noise,
    such as the key bias's, whose exact gradient is zero)."""
    t0 = time.time()
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=64, global_batch=2)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cpu", "cuda"):
            loop = TrainLoop(build_model(cfg), data,
                             TrainLoopConfig(out_dir=os.path.join(tmp, dev)),
                             opts=ModelOpts(attn_chunk=16, ce_chunk=32,
                                            remat="full"), device=dev)
            state = tree_map(lambda t: t.to(dev), loop.init_state(
                torch.Generator().manual_seed(0)))
            ms = [{k: float(v) for k, v in loop.train_step(
                state, to_device(data.batch_at(s), dev)).items()}
                for s in range(2)]
            runs[dev] = ([p.detach() for p in leaves(state["params"])], ms)
    (pc, mc), (pg, mg) = runs["cpu"], runs["cuda"]
    worst = max(abs(g[k] - c[k]) / abs(c[k]) for g, c in zip(mg, mc)
                for k in ("loss", "grad_norm"))
    rel = _tree_rel([p.cpu() for p in pg], pc)
    atol = 2 * sum(m["lr"] for m in mc)
    elem = max(float((g.cpu() - c).abs().max()) for g, c in zip(pg, pc))
    log(f"train step, card vs CPU (reduced {ARCH}, float32, 2 steps): loss "
        f"{mg[-1]['loss']:.7f} vs {mc[-1]['loss']:.7f}, grad_norm "
        f"{mg[-1]['grad_norm']:.7f} vs {mc[-1]['grad_norm']:.7f}, worst "
        f"{worst:.3e} relative (tol {TRAIN_DEVICE_REL:g}); params "
        f"{rel:.3e} relative in norm (tol {TRAIN_DEVICE_REL:g}), largest "
        f"element {elem:.3e} (tol {atol:.3e}); {time.time() - t0:.1f} s")
    if worst > TRAIN_DEVICE_REL or rel > TRAIN_DEVICE_REL or elem > atol:
        raise AssertionError("the training step differs between the card "
                             "and the CPU")


def train_dtype_remat_check(batch):
    """At full width and TRAIN_CHECK_LAYERS layers, from one set of f32
    masters: the bf16 loss and global grad norm against the float32
    config's, and remat "full" against "none" in bf16."""
    t0 = time.time()
    cfg = train_config(TRAIN_CHECK_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(1))
    l16, g16 = loss_and_grads(model, params, batch, TRAIN_OPTS)
    n16 = float(global_norm(g16))
    lnone, gnone = loss_and_grads(
        model, params, batch, dataclasses.replace(TRAIN_OPTS, remat="none"))
    remat_loss = abs(float(lnone) - float(l16)) / abs(float(l16))
    remat_grad = _tree_rel(g16, gnone)
    del g16, gnone
    l32, g32 = loss_and_grads(build_model(dataclasses.replace(
        cfg, dtype="float32")), params, batch, TRAIN_OPTS)
    n32 = float(global_norm(g32))
    del g32, params
    torch.cuda.empty_cache()
    l16, l32 = float(l16), float(l32)
    dl, dn = abs(l16 - l32) / abs(l32), abs(n16 - n32) / abs(n32)
    log(f"train check at full width, {cfg.n_layers} layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: bf16 vs float32 loss {l16:.6f} vs "
        f"{l32:.6f} ({dl:.3e} relative, tol {TRAIN_BF16_LOSS_REL:g}), grad "
        f"norm {n16:.6f} vs {n32:.6f} ({dn:.3e}, tol "
        f"{TRAIN_BF16_GNORM_REL:g}); remat full vs none: loss {remat_loss:.3e}"
        f" relative (tol {TRAIN_REMAT_LOSS_REL:g}), grads {remat_grad:.3e} "
        f"relative in norm (tol {TRAIN_REMAT_GRAD_REL:g}); "
        f"{time.time() - t0:.1f} s")
    if dl > TRAIN_BF16_LOSS_REL or dn > TRAIN_BF16_GNORM_REL:
        raise AssertionError("bf16 and float32 training steps differ")
    if remat_loss > TRAIN_REMAT_LOSS_REL or remat_grad > TRAIN_REMAT_GRAD_REL:
        raise AssertionError("remat full and none differ")


def train_loop_check():
    """``TrainLoop.run`` on the card at reduced qwen1.5-4b (bf16): 8 steps
    checkpointed every 4; a run that a ``FailureInjector`` crashes at step
    6, and its resume from step 4, whose losses and params must match the
    uninterrupted run's at TRAIN_RESUME_REL."""
    cfg = get_config(ARCH).reduced()
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=64, global_batch=2)

    def loop(out, failure=None):
        return TrainLoop(build_model(cfg), data, TrainLoopConfig(
            steps=TRAIN_LOOP_STEPS, ckpt_every=4, log_every=1, out_dir=out),
            opts=ModelOpts(attn_chunk=32, ce_chunk=32), failure=failure,
            device="cuda")

    t_check = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        full = loop(os.path.join(tmp, "full")).run()
        wall = time.perf_counter() - t0
        crash_dir = os.path.join(tmp, "crash")
        try:
            loop(crash_dir, FailureInjector((TRAIN_CRASH_AT,))).run()
            raise AssertionError("the injected crash did not happen")
        except SimulatedCrash:
            pass
        start = latest_step(os.path.join(crash_dir, "ckpt"))
        resumed = loop(crash_dir).run()
        with open(os.path.join(crash_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    want = full["losses"][start:]
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], want))
    rel = _tree_rel(leaves(resumed["state"]["params"]),
                    leaves(full["state"]["params"]))
    log(f"TrainLoop.run on the card (reduced {ARCH}, bf16): "
        f"{TRAIN_LOOP_STEPS} steps in {wall:.2f} s; crashed at step "
        f"{TRAIN_CRASH_AT}, resumed from step {start}: losses "
        f"{', '.join(f'{x:.6f}' for x in resumed['losses'])} vs "
        f"{', '.join(f'{x:.6f}' for x in want)}, largest difference "
        f"{worst:.3e} relative (tol {TRAIN_RESUME_REL:g}); params "
        f"{rel:.3e} relative in norm; {len(records)} metrics records; "
        f"{time.time() - t_check:.1f} s")
    if start != 4 or len(resumed["losses"]) != TRAIN_LOOP_STEPS - start \
            or worst > TRAIN_RESUME_REL or rel > TRAIN_RESUME_REL:
        raise AssertionError("the resumed run does not match the "
                             "uninterrupted one")


def is_gemm(kernel_name):
    return "nvjet" in kernel_name or "gemm" in kernel_name.lower()


def is_port(kernel_name):
    return any(k in kernel_name for k in PORT_KERNEL_NAMES)


def step_parts(rows, events, scores):
    """Device time by part of a profiled training step or forward.  From
    ``rows``, a window of device activity alone (ms, kernel name, count):
    the port's kernels and GEMMs by kernel name, and the busy time.  From
    ``events``, a second window with host ops and their input shapes:
    of the other kernels, the optimizer's (launched after the backward's
    last autograd node) and attention's elementwise passes (launched by an
    op with an input shaped like attention's scores, whose last two
    dimensions are one of the (query chunk, keys) pairs in ``scores``).
    The rest is busy less those.
    -> (parts, the ms the second window's ops launched)."""
    from torch.autograd import DeviceType
    parts = {"port kernels": sum(r[0] for r in rows if is_port(r[1])),
             "GEMMs": sum(r[0] for r in rows
                          if is_gemm(r[1]) and not is_port(r[1])),
             "attention elementwise": 0.0, "optimizer": 0.0}
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    backward_end = max((e.time_range.end for e in ops if e.name.startswith(
        "autograd::engine::evaluate_function")), default=float("inf"))
    launched = 0.0
    for e in ops:
        for k in e.kernels:
            launched += k.duration / 1e3
            if is_port(k.name) or is_gemm(k.name):
                continue
            if e.time_range.start > backward_end:
                parts["optimizer"] += k.duration / 1e3
            elif any(len(s) >= 4 and tuple(s[-2:]) in scores
                     for s in e.input_shapes or ()):
                parts["attention elementwise"] += k.duration / 1e3
    parts["rest"] = sum(r[0] for r in rows) - sum(parts.values())
    return parts, launched


def profile_train_step(fn, scores, unit="step"):
    """Two profiled calls of ``fn`` (a training step or a forward, already
    warm). The first records device activity alone: its window gives the
    kernels, device busy and idle share (recording host ops, as the second
    does, lengthens the host's part of a step). The second records host
    ops with their input shapes, which ``step_parts`` splits the kernels
    by.  Returns the parts' device ms and the first window's rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    if rows:
        busy = sum(r[0] for r in rows)
        log(f"profile over 1 {unit} (device activity only): wall "
            f"{wall_ms:.3f} ms, {sum(r[2] for r in rows)} kernels, device "
            f"busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.1%}")
        for ms, key, count in rows[:10]:
            log(f"  {ms:9.4f} ms  x{count:<5d} {key[:90]}")
    else:
        log("profile: no device time in the trace (not measured)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    parts, launched = step_parts(rows, prof.events(), scores)
    total = sum(parts.values()) or float("nan")
    log(f"  by part (port kernels and GEMMs by name in the first window; "
        f"attention elementwise and optimizer by op in a second profiled "
        f"{unit}, host ops and input shapes recorded; the rest busy less "
        f"those): " + ", ".join(f"{k} {v:.1f} ms ({v / total:.1%})"
                                for k, v in parts.items())
        + f" of {total:.1f} ms busy; the second window's ops launched "
        f"{launched:.1f} ms")
    return parts, rows


def train_full_width(smi):
    """The training phase: card vs CPU, bf16 vs f32 and remat at full
    width and 4 layers, then TRAIN_STEPS steps of qwen1.5-4b at full width
    and TRAIN_LAYERS layers through ``TrainLoop.train_step`` on
    ``SyntheticLMData(seed=0)`` batches, timed and profiled, then
    ``TrainLoop.run`` with a crash and its resume.  No port kernel may
    launch in the phase: the path is the reference's."""
    t_phase = time.time()
    before = port_launches()
    train_device_check()
    cfg, full = train_config(), get_config(ARCH)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=0)
    t0 = time.time()
    batches = [to_device(data.batch_at(s), "cuda")
               for s in range(TRAIN_STEPS + 1)]
    log(f"training data: {len(batches)} SyntheticLMData batches of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {time.time() - t0:.1f} s")
    train_dtype_remat_check(batches[0])

    model = build_model(cfg)
    t0 = time.time()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    state = {"params": params, "opt": adamw_init(params), "err": None}
    n_params = sum(p.numel() for p in leaves(params))
    n_full = n_params + (full.n_layers - cfg.n_layers) * sum(
        p[0].numel() for p in leaves(params["layers"]))
    torch.cuda.synchronize()
    log(f"training: {ARCH} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}), depth cut to {cfg.n_layers} of {full.n_layers} "
        f"layers: {n_params} parameters, f32 masters + grads + m + v "
        f"{16 * n_params / 1e9:.1f} GB and a bf16 copy "
        f"{2 * n_params / 1e9:.1f} GB (all {full.n_layers}: {n_full} "
        f"parameters, {16 * n_full / 1e9:.1f} GB + "
        f"{2 * n_full / 1e9:.1f} GB); {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"{TRAIN_OPTS}; set up in {time.time() - t0:.1f} s")
    # err is read only with compress_grads, which is off: no error
    # feedback (another 4 B a parameter) beside the state
    with tempfile.TemporaryDirectory() as tmp:
        loop = TrainLoop(model, data, TrainLoopConfig(out_dir=tmp),
                         opts=TRAIN_OPTS, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        for step in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = loop.train_step(state, batches[step])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            log(f"train step {step}: loss {metrics[-1]['loss']:.6f}, "
                f"grad_norm {metrics[-1]['grad_norm']:.6f}, lr "
                f"{metrics[-1]['lr']:.4e}, {times[-1] * 1e3:.1f} ms [{smi}]")
        peak = torch.cuda.max_memory_allocated()
        step_s = float(np.median(times[1:]))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        n_dense = n_params - params["embed"]["tok"].numel()
        flops = 6 * n_dense * tokens + 6 * cfg.n_layers * TRAIN_BATCH \
            * TRAIN_SEQ ** 2 * cfg.q_dim
        log(f"training {ARCH} ({cfg.n_layers} layers): {step_s * 1e3:.1f} "
            f"ms/step (median of steps 1-{TRAIN_STEPS - 1}, host clock, "
            f"synchronised), {tokens / step_s:.0f} tokens/s, peak memory "
            f"{peak / 2**30:.2f} GiB ({peak / 1e9:.1f} GB); model FLOPs "
            f"{flops:.4e} a step (6 N T, N = {n_dense} less the token "
            f"embedding, + 6 L B S^2 q_dim), {flops / step_s / 1e12:.1f} "
            f"TFLOP/s, {flops / step_s / PEAK_BF16:.1%} of 989 TFLOP/s "
            f"[{smi}]")
        if metrics[0]["lr"] != 0.0 or not all(
                np.isfinite([m["loss"], m["grad_norm"]]).all()
                for m in metrics):
            raise AssertionError("the training steps are not finite, or "
                                 "step 0 had a learning rate")
        parts, _ = profile_train_step(
            lambda: loop.train_step(state, batches[-1]),
            [(TRAIN_OPTS.attn_chunk, TRAIN_SEQ)])
        log(f"  [{smi}]")
    del state, params, loop, model, batches
    torch.cuda.empty_cache()

    train_loop_check()
    after = port_launches()
    log(f"port kernels over the training phase: {before} before, {after} "
        f"after")
    if after != before:
        raise AssertionError("the training phase launched a port kernel")
    log(f"training phase: {time.time() - t_phase:.1f} s")
    return dict(ms_per_step=step_s * 1e3, peak_bytes=peak, parts=parts,
                flops=flops, losses=[m["loss"] for m in metrics])


# ---------------------------------------------------------------------------
# phase 5: the kernel search domain on the card
# ---------------------------------------------------------------------------
def _ranks(x):
    """Average ranks (ties share their mean rank)."""
    x = np.asarray(x, dtype=float)
    order = np.argsort(x, kind="stable")
    r = np.empty(len(x))
    r[order] = np.arange(len(x), dtype=float)
    for val in np.unique(x):
        tie = x == val
        r[tie] = r[tie].mean()
    return r


def spearman(a, b) -> float:
    ra, rb = _ranks(a), _ranks(b)
    if ra.std() == 0 or rb.std() == 0:
        return float("nan")
    return float(np.corrcoef(ra, rb)[0, 1])


DOMAIN_COUNTS = {"flash_attention": fa.COUNT, "decode_attention": da.COUNT,
                 "ssd_scan": ssd.COUNT}


def kernel_domain_phase():
    """Both rungs of the ``kernel`` ladder on every candidate of the
    ``tiny`` and ``small`` domains, on the card (``context`` without a
    device means cuda), then the candidate's call on the host clock.  Each
    candidate's maxerr is held; each kernel's launches must grow by
    exactly the calls made (``eval_kernel_time``: a warm-up, the reps, one
    for maxerr; then the host-clock reps), with no plain-version call.
    Returns the launches per kernel over both presets."""
    for c in DOMAIN_COUNTS.values():
        c.reset()
    for preset in ("tiny", "small"):
        before = {n: (c.launches, c.plain) for n, c in DOMAIN_COUNTS.items()}
        calls = dict.fromkeys(DOMAIN_COUNTS, 0)
        rows = []
        t0 = time.perf_counter()
        for provider, config in bench.kernel_domain(preset).all_candidates():
            params = dict(provider=provider, preset=preset,
                          config=tuple(sorted(config.items())),
                          reps=DOMAIN_REPS)
            an = bench.eval_kernel_analytic(params, {})
            r = bench.eval_kernel_time(params, {})
            # what a caller waits for one call: host clock, synchronised
            fn, args = bench._kernel_fn(provider, preset, config, "cuda")
            host = []
            for _ in range(DOMAIN_REPS):
                t1 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                host.append(time.perf_counter() - t1)
            calls[provider] += 2 * DOMAIN_REPS + 2
            log(f"domain {preset} {provider} {config}: analytic "
                f"{an['value']:.1f} ({an['grid_steps']} grid steps); card "
                f"{r['kernel_us']:.2f} us, plain {r['ref_us']:.2f} us, ratio "
                f"{r['ratio']:.4f}, maxerr {r['maxerr']:.3e} (tol "
                f"{DOMAIN_TOL[provider]:g}); one call on the host clock "
                f"{np.median(host) * 1e6:.2f} us")
            if not (r["value"] == r["kernel_us"] > 0
                    and r["maxerr"] < DOMAIN_TOL[provider]):
                raise AssertionError(f"candidate {provider} {config} failed")
            rows.append((provider, config, an["value"], r["kernel_us"]))
        for name, c in DOMAIN_COUNTS.items():
            grew = c.launches - before[name][0]
            if grew != calls[name] or c.plain != before[name][1]:
                raise AssertionError(
                    f"{name}: {grew} launches for {calls[name]} calls, "
                    f"{c.plain - before[name][1]} plain calls")
        log(f"domain {preset}: {len(rows)} candidates in "
            f"{time.perf_counter() - t0:.1f} s; launches "
            + ", ".join(f"{n} +{calls[n]}" for n in calls)
            + "; no plain-version call")
        for provider in DOMAIN_COUNTS:
            mine = [r for r in rows if r[0] == provider]
            best = min(mine, key=lambda r: r[3])
            best_an = min(mine, key=lambda r: r[2])
            log(f"domain {preset} {provider}: best on the card {best[1]} "
                f"({best[3]:.2f} us); analytic pick {best_an[1]}; rank "
                f"correlation analytic vs card "
                f"{spearman([r[2] for r in mine], [r[3] for r in mine]):.3f}")
        log(f"domain {preset}, all {len(rows)} candidates: rank correlation "
            f"analytic vs card "
            f"{spearman([r[2] for r in rows], [r[3] for r in rows]):.3f}")
    return {n: c.launches for n, c in DOMAIN_COUNTS.items()}


def driver_pick(drv):
    """(provider, config, value) a finished driver picks: a bandit's
    surviving arm's incumbent, a flat driver's optimizer argmin, else its
    history's best (the rule of the reference's ``driver_best``)."""
    res = getattr(drv, "result", None)
    if res is not None:
        out = res()
        if hasattr(out, "provider"):            # CloudBanditResult
            return out.provider, out.config, float(out.loss)
        prov, cfg, loss, _hist = out            # (.., .., loss, history)
        return prov, cfg, float(loss)
    opt = getattr(drv, "opt", None)
    (prov, cfg), val = opt.best() if opt is not None else drv.history.best()
    return prov, cfg, float(val)


def rung_evals(drv):
    """(top-rung, lower-rung) evaluations a finished driver spent."""
    spend = getattr(drv, "spend", None)
    if spend:
        top = max(spend)
        return int(spend[top]), int(sum(v for k, v in spend.items()
                                        if k != top))
    return len(drv.history.values), 0


def search_phase():
    """The kernel ladder searched through the port's engine, then the
    offline leg on the host; see the module docstring.  Returns each
    kernel's launches in the phase."""
    t_phase = time.perf_counter()
    ladder = bind_ladder("kernel", preset="small", reps=DOMAIN_REPS)
    domain = ladder.make_domain()
    cands = domain.all_candidates()
    before = {n: (c.launches, c.plain) for n, c in DOMAIN_COUNTS.items()}
    with tempfile.TemporaryDirectory() as tmp:
        engine = ExperimentEngine(
            search_runner, executor="serial",
            store=ResultStore(os.path.join(tmp, "units.jsonl")))
        t0 = time.perf_counter()
        top_units = [ladder.unit(p, c) for p, c in cands]
        truth = engine.run(top_units)
        sweep = engine.stats
        calls = dict.fromkeys(DOMAIN_COUNTS, 0)
        for (prov, _cfg), r in zip(cands, truth):
            calls[prov] += DOMAIN_REPS + 2  # warm-up, reps, one for maxerr
            if not (r["value"] == r["kernel_us"] > 0
                    and r["maxerr"] < DOMAIN_TOL[prov]):
                raise AssertionError(f"search sweep: {prov} {_cfg}: {r}")
        grew = {n: c.launches - before[n][0]
                for n, c in DOMAIN_COUNTS.items()}
        if (sweep.computed != len(cands) or grew != calls
                or any(c.plain != before[n][1]
                       for n, c in DOMAIN_COUNTS.items())):
            raise AssertionError(
                f"search sweep: {sweep.computed} of {len(cands)} units "
                f"computed, launches {grew} for calls {calls}")
        values = {(p, tuple(sorted(c.items()))): r["value"]
                  for (p, c), r in zip(cands, truth)}
        best_key = min(values, key=values.get)
        optimum = values[best_key]
        log(f"search: kernel ladder small, {len(cands)} top-rung units "
            f"through ExperimentEngine.run in {time.perf_counter() - t0:.2f}"
            f" s (computed {sweep.computed}, cached {sweep.cached}); "
            f"launches " + ", ".join(f"{n} +{g}" for n, g in grew.items())
            + f"; optimum {best_key[0]} {dict(best_key[1])} "
            f"{optimum:.3f} us")
        after_sweep = {n: (c.launches, c.plain)
                       for n, c in DOMAIN_COUNTS.items()}
        regrets = {}
        for method in SEARCH_METHODS:
            budget = SEARCH_BUDGET.get(method, KERNEL_BUDGET)
            for seed in SEARCH_SEEDS:
                drv = get_method(method).make_driver(domain, budget, seed,
                                                     target="time")
                keys = set(engine.store.keys())
                t1 = time.perf_counter()
                drive_units(engine, [(drv, ladder)])
                dt = time.perf_counter() - t1
                st = engine.stats
                new = [engine.store.get(k) for k in engine.store.keys()
                       if k not in keys]
                if any(r["params"].get("fidelity") != 0 for r in new):
                    raise AssertionError(
                        f"search {method} seed {seed}: a top-rung unit "
                        "missed the store")
                prov, cfg, val = driver_pick(drv)
                card = values[(prov, tuple(sorted(cfg.items())))]
                regret = (card - optimum) / optimum
                regrets.setdefault(method, []).append(regret)
                top, low = rung_evals(drv)
                log(f"search {method} B={budget} seed {seed}: picks {prov} "
                    f"{cfg}, {card:.3f} us on the card (driver's value "
                    f"{val:.3f}), regret {regret:.4f}; top-rung evals "
                    f"{top}, lower-rung {low}; engine computed "
                    f"{st.computed}, cached {st.cached}; {dt:.3f} s")
        grew = {n: (c.launches - after_sweep[n][0],
                    c.plain - after_sweep[n][1])
                for n, c in DOMAIN_COUNTS.items()}
        if any(g != (0, 0) for g in grew.values()):
            raise AssertionError(f"the searches launched or ran a plain "
                                 f"version: {grew}")
        low = engine.run([ladder.rung_unit(0, p, c) for p, c in cands])
        rows = [(p, a["value"], t["value"])
                for (p, _c), a, t in zip(cands, low, truth)]
        by_prov = "; ".join(
            f"{prov} " + format(spearman(
                [a for p, a, _t in rows if p == prov],
                [t for p, _a, t in rows if p == prov]), ".3f")
            for prov in DOMAIN_COUNTS)
        log(f"search: analytic rung vs card, rank correlation over all "
            f"{len(rows)} " + format(spearman([r[1] for r in rows],
                                             [r[2] for r in rows]), ".3f")
            + f"; by kernel {by_prov}")
        log("search: mean regret on the card "
            + ", ".join(f"{m} {np.mean(r):.4f}" for m, r in regrets.items()))
    launches = {n: c.launches - before[n][0]
                for n, c in DOMAIN_COUNTS.items()}
    offline_leg()
    dt = time.perf_counter() - t_phase
    log(f"search phase: {dt:.1f} s of its {SEARCH_BUDGET_S:.0f} s budget")
    if dt > SEARCH_BUDGET_S:
        raise AssertionError(f"the search phase took {dt:.1f} s, over its "
                             f"{SEARCH_BUDGET_S:.0f} s budget")
    return launches


def offline_leg():
    """``examples/quickstart.py``'s flow through the port, each search
    held equal to its run through the engine, then every registered
    method on every task of the table."""
    t0 = time.perf_counter()
    ds = build_dataset()
    task = ds.task("xgboost@santander", "cost")
    engine = ExperimentEngine(search_runner, context={"dataset_seed": 0},
                              executor="serial")
    binding = bind_objective("offline", workload=task.workload,
                             target="cost", dataset_seed=0)
    b1 = b1_for_budget(OFFLINE_BUDGET, K=3)
    cb = CloudBanditDriver(ds.domain, RBFOpt, b1=b1, seed=0)
    while not cb.done:
        batch = cb.ask_batch()
        cb.tell_batch([task.objective(p, c) for p, c in batch])
    res = cb.result()
    hists = {"cb_rbfopt": res.history}
    for m in ("random", "smac"):
        hists[m] = run_search(m, task, ds.domain, OFFLINE_BUDGET, seed=0)
    for m, hist in hists.items():
        drv = get_method(m).make_driver(ds.domain, OFFLINE_BUDGET, 0,
                                        target="cost")
        via = drive_units(engine, [(drv, binding)])[0]
        if (via.points, via.values) != (hist.points, hist.values):
            raise AssertionError(f"offline {m}: the engine's history "
                                 "differs from the inline loop's")
    log(f"offline quickstart xgboost@santander cost B={OFFLINE_BUDGET}: "
        f"CloudBandit b1={b1} eliminated {res.eliminated}, pulls "
        f"{res.pulls}, picks {res.provider} {res.config} ${res.loss:.4f} "
        f"(regret {task.regret(res.loss):.4f}); random regret "
        f"{task.regret(min(hists['random'].values)):.4f}; smac regret "
        f"{task.regret(min(hists['smac'].values)):.4f}; savings at N=64 "
        f"{savings_for_history(task, res.history, n_production=64):.4f}; "
        f"{time.perf_counter() - t0:.2f} s")
    tasks = [ds.task(w, t) for w in ds.workloads for t in ("cost", "time")]
    t_all = time.perf_counter()
    for m in method_names():
        cells = []
        for t in tasks:
            drv = get_method(m).make_driver(ds.domain, OFFLINE_BUDGET, 0,
                                            target=t.target)
            kw = dict(workload=t.workload, target=t.target, dataset_seed=0)
            cells.append((drv, bind_ladder("offline", **kw)
                          if hasattr(drv, "attach_ladder")
                          else bind_objective("offline", **kw)))
        t1 = time.perf_counter()
        hists = drive_units(engine, cells)
        dt = time.perf_counter() - t1
        regret = [t.regret(min(h.values)) for t, h in zip(tasks, hists)]
        if not all(h.values for h in hists) or \
                not all(math.isfinite(r) and r >= 0 for r in regret):
            raise AssertionError(f"offline {m}: bad histories or regret")
        log(f"offline {m}: {len(tasks)} tasks at B={OFFLINE_BUDGET}, mean "
            f"regret {np.mean(regret):.4f} (max {max(regret):.4f}); "
            f"computed {engine.stats.computed}, cached "
            f"{engine.stats.cached}; {dt:.2f} s on the host")
    dt = time.perf_counter() - t_all
    log(f"offline: {len(method_names())} methods x {len(tasks)} tasks in "
        f"{dt:.1f} s on the host")


def main() -> None:
    t_start = time.time()
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
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        if not regs:
            log(f"  {name}: {text}")
            continue
        spills = sorted({line.strip() for line in text.splitlines()
                         if "spill" in line and "0 bytes spill" not in line})
        log(f"  {name}: {len(regs)} kernels, registers "
            f"{min(regs)}-{max(regs)}"
            + (f"; {'; '.join(spills)}" if spills else "; no spills"))
        for line in text.splitlines():    # wgmma serialised, setmaxnreg
            if "Performance Loss" in line or "setmaxnreg" in line:
                log(f"    {line.strip()[:160]}")
        if name == "ssd_scan":
            for kname, regs, spill in ptxas_entries(text, SSD_STATE_KERNEL):
                log(f"    {kname}: {regs} registers, {spill}")
        if name == "flash_attention":
            # no wgmma instance and no D = 256 tf32 instance may spill;
            # the tf32 instances below 256 are logged (PERF.md names
            # those that spill)
            entries = ptxas_entries(text, WGMMA_KERNEL)
            tf32 = ptxas_entries(text, TF32_KERNEL)
            for kernel, found in ((WGMMA_KERNEL, entries),
                                  (TF32_KERNEL, tf32)):
                for kname, regs, spill in found:
                    log(f"    {kernel}{kname}: {regs} registers, {spill}")
            held = entries + [e for e in tf32 if e[0].startswith("<256,")]
            spilled = [e for e in held
                       if "0 bytes spill stores, 0 bytes spill loads"
                       not in e[2]]
            if not entries or len(held) == len(entries) or spilled:
                raise AssertionError(
                    f"{WGMMA_KERNEL} or {TF32_KERNEL} at D = 256: ptxas "
                    f"reports spills (or no report) in "
                    f"{spilled or 'no instance'}")
        if name == "decode_attention":    # its instances must not spill
            reports = re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
            spilled = [r for r in reports if r != ("0", "0")]
            if not reports or spilled:
                raise AssertionError(
                    f"decode_attention: ptxas reports spills (stores, "
                    f"loads) {spilled} in {len(regs)} kernels" if reports
                    else "decode_attention: ptxas gave no spill report")

    # lengths of the served run: prompt 8-64 plus up to 32 new tokens
    main_lengths = np.random.default_rng(3).integers(
        PROMPT_LEN[0], PROMPT_LEN[1] + NEW_TOKENS + 1, BATCH)
    err = check_decode_attention(main_lengths)
    readings = measure_decode_attention(main_lengths)
    timing = {key: readings[0][key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_us")}

    check_wgmma_sass("ssd_scan", SSD_STATE_KERNEL, "chunk_state_kernel",
                     "BF16")
    check_wgmma_sass("ssd_scan", SSD_WGMMA_KERNEL, "chunk_scan_kernel",
                     "BF16")
    ssd_err = check_ssd_scan()
    ssd_gate_phase()
    ssd_timing = measure_ssd_scan()
    ssd_hybrid_err, args = check_ssd_hybrid_shape()
    ssd_hybrid = measure_ssd_scan(SSD_HYBRID, args, "zamba2-7b shape",
                                  reps=20)
    del args

    wg = check_wgmma_sass("flash_attention", WGMMA_KERNEL, F32_FLASH_KERNEL,
                          "BF16")
    d256 = [c[1] for n, c in wg.items() if f"{WGMMA_KERNEL}ILi256E" in n]
    log(f"  D = 256: {len(d256)} instances of {WGMMA_KERNEL}, HGMMA on BF16 "
        f"{min(d256, default=0)}-{max(d256, default=0)} each")
    if len(d256) != 4:
        raise AssertionError(f"{len(d256)} D = 256 instances of "
                             f"{WGMMA_KERNEL}, not 4 (bk 32 or 64-key "
                             "pieces, one or two warpgroups)")
    tf = check_wgmma_sass("flash_attention", TF32_KERNEL, F32_FLASH_KERNEL,
                          "TF32")
    d256 = [c[1] for n, c in tf.items() if f"{TF32_KERNEL}ILi256E" in n]
    log(f"  D = 256: {len(d256)} instances of {TF32_KERNEL}, HGMMA on TF32 "
        f"{min(d256, default=0)}-{max(d256, default=0)} each")
    if len(d256) != 2:
        raise AssertionError(f"{len(d256)} D = 256 instances of "
                             f"{TF32_KERNEL}, not 2 (32- or 64-key pieces)")
    check_flash_attention()
    tf32_gate_presets()
    flash_readings = measure_flash_attention()
    flash_f32_timing = measure_flash_f32()
    flash_f32_timing["readings"].append(measure_flash_f32_d256())

    model, server, launches, run = serve_full_width(get_config(ARCH))
    profile_steps(model, server)
    teacher_forced_check(model, server)
    del model, server
    torch.cuda.empty_cache()

    moe_launches, moe_run = moe_serve_full_width()
    log(f"decode_attention launches on the serving paths: {ARCH} {launches} "
        f"({run['steps']} steps), {MOE_ARCH} {moe_launches} "
        f"({moe_run['steps']} steps); {launches + moe_launches} in all")

    ssm_model, ssm_params, ssd_launches = ssm_forward_full_width()
    ssm_serve_full_width(ssm_model, ssm_params)
    del ssm_model, ssm_params
    torch.cuda.empty_cache()

    hybrid = hybrid_forward_full_width()
    vlm_full_width()
    audio_full_width()
    no_port_launches("the gemma3 phase", gemma3_full_width)

    train_full_width(smi)

    domain_launches = kernel_domain_phase()
    search_launches = search_phase()
    if ssd.COUNT.wgmma:
        raise AssertionError(f"the float32 kernel search made {ssd.COUNT.wgmma}"
                             " ssd_scan launches on the tensor cores")
    if fa.COUNT.wgmma or fa.COUNT.tf32 != fa.COUNT.launches:
        raise AssertionError(f"the float32 kernel search made {fa.COUNT.tf32}"
                             f" {TF32_KERNEL} launches of {fa.COUNT.launches}"
                             f", {fa.COUNT.wgmma} bf16 launches")

    flash_timing = {key: flash_readings[0][key] for key in (
        "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by")}
    kernels = [dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:59",
        launches=launches + moe_launches, max_abs_err=err, **timing,
        search_launches=search_launches["decode_attention"],
        readings=readings[1:]), dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:68",
        launches=ssd_launches + hybrid["launches"], max_abs_err=ssd_err,
        **ssd_timing, search_launches=search_launches["ssd_scan"], readings=[dict(
            shape="zamba2-7b", launches=hybrid["launches"],
            max_abs_err=ssd_hybrid_err, **ssd_hybrid)]), dict(
        name="flash_attention_bf16", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:75",
        launches=sum(r["launches"] for r in flash_readings), **flash_timing,
        readings=flash_readings[1:]), dict(
        name="flash_attention_f32", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:75",
        launches=domain_launches["flash_attention"], **flash_f32_timing,
        search_launches=search_launches["flash_attention"])]
    log(f"chip_smoke: {time.time() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
