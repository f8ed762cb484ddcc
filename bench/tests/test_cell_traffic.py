"""The traffic generator: mixes made again from the seed, lengths that
keep their stated distributions, one draw from every band of a block."""
import numpy as np
import pytest

from harness.cell import BENCH, load_json
from harness.traffic import (Traffic, check_mix, length_quantile,
                             mean_length, steady_steps)

MIXES = ("long_decode", "chat")


def mix_file(name):
    return load_json(BENCH, "traffic", f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = (Traffic(mix_file(name), 2**31 + 11, 32064) for _ in range(2))
    for i in (0, 1, 63, 64, 500):
        assert a.lengths(i) == b.lengths(i)
        assert a.prompt(i) == b.prompt(i)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_sends_the_same_work(name):
    a = Traffic(mix_file(name), 2**31 + 11, 32064)
    c = Traffic(mix_file(name), 2**31 + 12, 32064)
    assert [a.lengths(i) for i in range(300)] == \
        [c.lengths(i) for i in range(300)]
    assert a.prompt(5) != c.prompt(5)
    other = dict(mix_file(name), schedule_seed=1)
    assert [a.lengths(i) for i in range(64)] != \
        [Traffic(other, 2**31 + 11, 32064).lengths(i) for i in range(64)]


@pytest.mark.parametrize("name", MIXES)
def test_block_holds_one_draw_a_band(name):
    mix = mix_file(name)
    t = Traffic(mix, 7, 100)
    n = mix["strata"]
    for key, col in (("prompt", 0), ("output", 1)):
        got = sorted(t.lengths(i)[col] for i in range(n))
        lo = length_quantile(mix[key], np.arange(n) / n)
        hi = length_quantile(mix[key], (np.arange(n) + 1) / n)
        assert all(a <= g <= b for a, g, b in zip(lo, got, hi))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_keep_their_distribution(name):
    mix = mix_file(name)
    t = Traffic(mix, 3, 100)
    n = 40 * mix["strata"]
    lens = np.array([t.lengths(i) for i in range(n)])
    for col, key in enumerate(("prompt", "output")):
        d = mix[key]
        x = lens[:, col]
        assert x.min() >= d["low"] and x.max() <= d["high"]
        if d["dist"] == "uniform":
            assert abs(x.mean() - (d["low"] + d["high"]) / 2) < \
                0.01 * d["high"]
        else:
            assert abs(np.median(x) / d["median"] - 1) < 0.03
            # sigma of the log-lengths inside the clip
            inner = x[(x > d["low"]) & (x < d["high"])]
            q = np.percentile(np.log(inner), [25, 75])
            assert abs((q[1] - q[0]) / 1.349 / d["sigma"] - 1) < 0.1


def test_prompt_tokens_span_the_vocabulary():
    t = Traffic(mix_file("chat"), 5, 50)
    toks = np.concatenate([t.prompt(i) for i in range(64)])
    assert toks.min() >= 0 and toks.max() < 50
    assert len(np.unique(toks)) == 50


def test_a_mix_the_cache_cannot_hold_is_refused():
    mix = mix_file("long_decode")
    mix["max_seq"] = mix["prompt"]["high"] + mix["output"]["high"] - 1
    with pytest.raises(ValueError):
        check_mix(mix)


def test_chat_keeps_sharegpts_mean_lengths():
    # the vLLM paper's ShareGPT means: 161.31 prompt, 337.99 answer tokens
    mix = mix_file("chat")
    assert abs(mean_length(mix["prompt"]) / 161.31 - 1) < 0.01
    assert abs(mean_length(mix["output"]) / 337.99 - 1) < 0.01


def test_steady_steps_of_chat():
    # ~1.5 requests' worth of steps is the warm-up
    s = steady_steps(mix_file("chat"))
    assert 490 < s < 505
    assert 1.4 < mix_file("chat")["warmup_steps"] / s < 1.6
