"""Each metric reader's arithmetic on a synthetic window and trace: busy
time from the union of intervals, bytes and operations from slot
lengths."""
import numpy as np
import pytest

from harness import costs
from harness.cell import Run, reader
from harness.loop import Record
from harness.trace import breakdown, busy_us, gaps, read_chrome, union

H100 = "NVIDIA H100 80GB HBM3"
DENSE = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 4,
         "n_kv_heads": 2, "head_dim": 4, "d_ff": 16, "vocab": 10,
         "activation": "swiglu", "dtype": "bfloat16",
         "kv_cache_dtype": "float32"}
PLAIN = dict(DENSE, activation="gelu")
MOE = dict(DENSE, family="moe", n_experts=4, top_k=2)


def trace():
    events = [
        {"ph": "X", "cat": "kernel", "name": "gemm_a", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "decode_attention_kernel",
         "ts": 120, "dur": 40},                   # overlaps gemm_a
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 300,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "decode_attention_kernel",
         "ts": 400, "dur": 60},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 90, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 390, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 170, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 280,
         "dur": 15},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]
    tr = read_chrome(events)
    tr.start_us, tr.end_us = 100.0, 500.0
    tr.wall_s, tr.steps = 400e-6, 2
    return tr


def run_of(cfg, lengths, dt, traced=None, tr=None, slots=4):
    rec = Record(slots=slots)
    rec.step_lengths = [np.array(x) for x in lengths]
    rec.step_dt = list(dt)
    rec.step_end = list(np.cumsum(dt))
    rec.step_traced = traced or [False] * len(dt)
    rec.step_outputs = [len(x) for x in lengths]
    rec.window_s = float(sum(dt))
    rec.trace = tr
    return Run("x", cfg, {}, rec, 1.5, H100)


def test_union_and_busy():
    tr = trace()
    assert union(tr.device) == [(100, 160), (300, 320), (400, 460)]
    assert busy_us(tr) == 60 + 20 + 60
    assert gaps(tr) == [(160, 300), (320, 400), (460, 500)]


def test_breakdown_labels_gaps_by_the_host():
    b = breakdown(trace())
    assert b["device_ops"][0] == ["decode_attention_kernel", 100e-6]
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", 140e-6]
    assert b["idle_gaps"][1][1] == pytest.approx(80e-6)


def test_decode_attn_roofline():
    lengths = [[3, 5], [4, 6]]
    run = run_of(DENSE, lengths, [1.0, 1.0], traced=[True, True],
                 tr=trace())
    # per layer: K and V rows 2 * sum(lengths) * Hkv * D * 4 B, q and out
    # 2 * slots * Hq * D * 4 B, lengths 4 B a slot; two layers a step
    per_layer = [2 * 8 * 2 * 4 * 4 + 2 * 2 * 4 * 4 * 4 + 8,
                 2 * 10 * 2 * 4 * 4 + 2 * 2 * 4 * 4 * 4 + 8]
    bound = 2 * sum(per_layer) / 3.35e12
    # two kernels in the trace of the four launches the steps made
    want = 100 * bound * (2 / 4) / 100e-6
    assert reader("decode_attention_roofline")(run) == pytest.approx(want)


def test_step_flops_from_slot_lengths():
    lengths = np.array([3, 5, 9])
    per_layer = (2 * 8 * 16 + 2 * 8 * 8) + 3 * 8 * 16   # attn + mlp
    active = 2 * per_layer + 8 * 10                      # two layers, head
    attn = 4 * 2 * 4 * 4 * lengths.sum()
    assert costs.step_flops(DENSE, lengths) == 2 * active * 3 + attn


def test_plain_mlp_counts_two_matrices():
    lengths = np.array([3, 5, 9])
    per_layer = (2 * 8 * 16 + 2 * 8 * 8) + 2 * 8 * 16
    attn = 4 * 2 * 4 * 4 * lengths.sum()
    assert costs.step_flops(PLAIN, lengths) == \
        2 * (2 * per_layer + 8 * 10) * 3 + attn
    assert costs.step_bytes(DENSE, lengths) - \
        costs.step_bytes(PLAIN, lengths) == 2 * (8 * 16) * 2


def test_moe_active_params_and_experts_touched():
    assert costs.active_params(MOE) == 2 * (
        (2 * 8 * 16 + 2 * 8 * 8) + 2 * 3 * 8 * 16 + 8 * 4) + 8 * 10
    assert costs.experts_touched(MOE, 1) == pytest.approx(2)
    assert costs.experts_touched(MOE, 64) == pytest.approx(4, abs=1e-12)


def test_step_bytes_from_slot_lengths():
    lengths = np.array([3, 5])
    weights = 2 * (2 * 8 * 16 + 2 * 8 * 8 + 3 * 8 * 16 + 16) + 8 * 10 \
        + 8 + 2 * 8
    kv = 2 * 2 * (2 * 4 * 4) * (8 + 2)
    assert costs.step_bytes(DENSE, lengths) == weights * 2 + kv


def test_mfu_and_hbm_leave_traced_steps_out():
    lengths = [[3, 5], [100, 100]]
    run = run_of(DENSE, lengths, [0.5, 9.0], traced=[False, True])
    assert reader("decode_mfu_pct")(run) == pytest.approx(
        100 * costs.step_flops(DENSE, np.array([3, 5])) / 0.5 / 989e12)
    assert reader("decode_hbm_pct")(run) == pytest.approx(
        100 * costs.step_bytes(DENSE, np.array([3, 5])) / 0.5 / 3.35e12)


def test_peaks_only_for_a_known_card():
    run = run_of(DENSE, [[3]], [1.0])
    run.device_kind = "cpu"
    assert reader("decode_mfu_pct")(run) is None


def test_rates_and_tails():
    run = run_of(DENSE, [[1, 2], [2, 3], [3]], [0.1, 0.2, 0.2])
    assert reader("output_tok_s")(run) == pytest.approx(5 / 0.5)
    assert reader("slot_occupancy_pct")(run) == pytest.approx(
        100 * 5 / 12)
    run.rec.itl_s = list(np.arange(1, 20) / 1000)
    assert reader("itl_p95_ms")(run) is None            # under 20 gaps
    run.rec.itl_s = list(np.arange(1, 101) / 1000)
    assert reader("itl_p95_ms")(run) == pytest.approx(95.05)
    run.rec.ttft_s = [1.0] * 40
    assert reader("ttft_p95_ms")(run) == pytest.approx(1000.0)
    assert reader("setup_s")(run) == 1.5
