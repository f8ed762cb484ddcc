"""The partition of the port's flash-decode kernel, on the CPU.

``csrc/decode_attention.cu`` cuts each (b, kv head)'s keys into ranges of
K keys, one block each; a range at or past ``min(length, S)`` does not
run, each range that runs takes its own softmax in base 2, and the last
block merges the ranges by log-sum-exp.  ``decode_split_ref`` (beside the
kernel in ``kernels/decode_attention.py``) emulates that in plain torch;
here it is held against the Pallas kernel in interpret mode on the same
numpy inputs, and the host's launch planner (``plan``) is held to the
grid and scratch the kernel indexes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro_torch.kernels import decode_attention as da

TOL = 2e-5                      # tests/test_kernels.py:14, float32


def _inputs(B, Hq, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, D), np.float32),
            rng.standard_normal((B, Hkv, S, D), np.float32),
            rng.standard_normal((B, Hkv, S, D), np.float32))


def _check(B, Hq, Hkv, S, D, lengths, K, seed=0):
    q, k, v = _inputs(B, Hq, Hkv, S, D, seed)
    ln = np.broadcast_to(np.asarray(lengths, np.int32), (B,)).copy()
    # one Pallas block of all S keys: any S, whatever K is
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(ln), bk=S, interpret=True)
    out = da.decode_split_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(ln), K)
    assert out.shape == (B, Hq, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 32


@pytest.mark.parametrize("length", [0, 1, K - 1, K, K + 1, 256],
                         ids=["0", "1", "K-1", "K", "K+1", "S"])
def test_split_ref_at_the_range_edges(length):
    """A length of 0 (every range runs, the mean of v), inside the first
    range, at its edge, one key into the second, and the whole cache."""
    _check(2, 4, 2, 256, 64, length, K)


@pytest.mark.parametrize("S,lengths", [
    (256, (5, 256, 130)),
    (300, (300, 33, 0)),          # S not a multiple of K, a ragged range
    (100, (99, 64, 65)),
])
def test_split_ref_with_per_slot_lengths(S, lengths):
    _check(3, 4, 2, S, 64, lengths, K, seed=S)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [80, 112, 128])
def test_split_ref_with_grouped_heads(G, D):
    """GQA with G heads per kv head at the head dims of zamba2-7b (112),
    hubert-xlarge (80) and the main path (128)."""
    _check(2, 2 * G, 2, 200, D, (200, 70), K, seed=G * D)


@pytest.mark.parametrize("K_big", [256, 1000])
def test_split_ref_with_one_range_larger_than_s(K_big):
    _check(2, 4, 2, 200, 32, (150, 0), K_big)


def test_plan_takes_an_explicit_bk_as_the_key_budget():
    pl = da.plan(2, 4, 1, 1024, 64, bk=128, sms=132, round_keys=64,
                 resident=8)
    assert (pl.keys, pl.ranges, pl.grid) == (128, 8, (8, 4, 2))


@pytest.mark.parametrize("B,Hkv,G,S,D", [
    (8, 20, 1, 512, 128),           # the main path, qwen1.5-4b
    (1, 32, 1, 524288, 112),        # long_500k, zamba2-7b
    (32, 8, 4, 32768, 128),         # decode_32k, minitron-8b
    (3, 2, 5, 77, 64),              # llama4-scout's G, a ragged S
    (2, 2, 16, 300, 64),            # G > 8: two head groups
])
def test_plan_grid_covers_s_and_sizes_the_scratch(B, Hkv, G, S, D):
    """The grid's ranges cover S in whole ranges of K keys (a multiple of
    the round), its y covers every head group, there is one counter per
    block column, and partials only where ranges are merged.  That the
    scratch fits the kernel's indexing is held on the card, at these
    shapes, by ``chip_smoke.py``."""
    pl = da.plan(B, Hkv, G, S, D, sms=132, round_keys=64, resident=2)
    assert pl.keys % 64 == 0
    assert (pl.ranges - 1) * pl.keys < S <= pl.ranges * pl.keys
    assert pl.heads in (1, 2, 4, 8) and pl.heads * pl.groups >= G
    assert (pl.groups - 1) * pl.heads < G
    assert pl.grid == (pl.ranges, Hkv * pl.groups, B)
    assert pl.counters == pl.grid[1] * pl.grid[2]
    assert (pl.part_floats > 0) == (pl.ranges > 1)
    # a full-length cache fills at most WAVES waves of the card, or one
    # range per (b, kv head, group) where those alone exceed them
    blocks = pl.ranges * Hkv * pl.groups * B
    assert blocks <= max(da.WAVES * 132 * 2, B * Hkv * pl.groups)


def test_plan_picks_the_instance_for_g():
    assert [da.plan(1, 1, g, 64, 64, sms=1, round_keys=1, resident=1).heads
            for g in (1, 2, 3, 4, 5, 8, 9, 16)] == [1, 2, 4, 4, 8, 8, 8, 8]


def test_a_bk_that_does_not_divide_s_is_refused_before_planning():
    """On ``meta`` tensors (no card) the reference's ``S % bk`` check
    still refuses a bk before any plan or launch."""
    q = torch.zeros(1, 4, 64, device="meta")
    k = torch.zeros(1, 2, 256, 64, device="meta")
    with pytest.raises(ValueError, match="multiple"):
        da.decode_attention(q, k, k, 10, bk=96)
