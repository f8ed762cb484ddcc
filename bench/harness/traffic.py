"""The one traffic generator: a mix file's parameters and a seed make the
same requests every time.

A mix (``bench/traffic/<name>.json``) states a closed loop of ``slots``
clients, the server's ``max_seq``, the distributions of prompt and output
lengths, and how many steps run before the window opens.  The requests
form one pool that the clients take in order, the next one going to
whichever client finished first.

Lengths are stratified: each block of ``strata`` requests holds one draw
from each of ``strata`` equal-probability bands of the distribution, in
a shuffled order (prompt and output shuffled apart).  The sizes and
their order come from the mix's own ``schedule_seed``, so every run seed
sends the same work: with the order drawn from the run's seed, which
requests straddle the window's edges changed the output share and the
TTFT tail from seed to seed far more than two runs of one seed differ.
The run's seed draws the prompt tokens, uniform over the vocabulary (and
elsewhere the weights).
"""
from __future__ import annotations

import hashlib
import statistics
from typing import Dict, List, Tuple

import numpy as np

DISTS = ("uniform", "lognormal")


def derive(seed: int, *what) -> int:
    """A 63-bit seed for one stream, from the run's seed and a label."""
    h = hashlib.blake2b(repr((int(seed),) + what).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def length_quantile(dist: Dict, u: np.ndarray) -> np.ndarray:
    """Lengths at probabilities ``u`` in (0, 1) of a mix's distribution:
    uniform over the whole numbers [low, high], or log-normal with a
    median and sigma, rounded and clipped to [low, high]."""
    kind, lo, hi = dist["dist"], int(dist["low"]), int(dist["high"])
    u = np.clip(np.asarray(u, np.float64), 1e-12, 1 - 1e-12)
    if kind == "uniform":
        out = lo + np.floor(u * (hi - lo + 1))
    elif kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(x)) for x in u])
        out = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
    else:
        raise ValueError(f"unknown length distribution {kind!r}; "
                         f"one of {DISTS}")
    return np.clip(out, lo, hi).astype(np.int64)


def check_mix(mix: Dict) -> None:
    """Refuse a mix whose requests the server would cut short."""
    if mix["loop"] != "closed":
        raise ValueError(f"loop {mix['loop']!r}: only closed loops")
    longest = int(mix["prompt"]["high"]) + int(mix["output"]["high"])
    if longest > int(mix["max_seq"]):
        raise ValueError(f"a prompt of {mix['prompt']['high']} and an "
                         f"answer of {mix['output']['high']} exceed max_seq "
                         f"{mix['max_seq']}")


class Traffic:
    """The requests of one mix and seed, made on demand in pool order:
    ``lengths(i)`` -> (prompt length, output length), ``prompt(i)`` ->
    its tokens."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        check_mix(mix)
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.strata = int(mix["strata"])
        self._blocks: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _block(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        got = self._blocks.get(b)
        if got is None:
            rng = np.random.default_rng(
                derive(self.mix["schedule_seed"], "lengths", b))
            n = self.strata
            out = []
            for key in ("prompt", "output"):
                u = (rng.permutation(n) + rng.random(n)) / n
                out.append(length_quantile(self.mix[key], u))
            got = self._blocks[b] = (out[0], out[1])
        return got

    def lengths(self, i: int) -> Tuple[int, int]:
        prompts, outputs = self._block(i // self.strata)
        j = i % self.strata
        return int(prompts[j]), int(outputs[j])

    def prompt(self, i: int) -> List[int]:
        n, _ = self.lengths(i)
        rng = np.random.default_rng(derive(self.seed, "tokens", i))
        return rng.integers(0, self.vocab, n).tolist()


def mean_length(dist: Dict, n: int = 4096) -> float:
    """The mean of a mix's length distribution (a fine quantile grid)."""
    u = (np.arange(n) + 0.5) / n
    return float(length_quantile(dist, u).mean())


def steady_steps(mix: Dict) -> float:
    """Decode steps one request holds its slot on average: its prompt fed
    one token a step, then one step a token of its answer but the first,
    which the last prompt step gives."""
    return mean_length(mix["prompt"]) + mean_length(mix["output"]) - 1
