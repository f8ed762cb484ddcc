"""``chip_smoke.py``'s bf16 teacher-forced check for a top-1 MoE
(llama4-scout): ``routing_trace`` and ``step_routes`` trace each layer's
routing on the kernel and plain paths, and ``top1_decisive_tokens``
lets a slot's two paths part only at a near-tie (``ROUTE_TIE``) and
holds the decisive tokens of the slots that have not parted.  The rule
on made-up steps, and the trace on the reduced config's decode steps on
the CPU."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()
B, L, V = 4, 3, 6


def _logits(top):
    """(B, V) logits whose argmax is ``top`` with a margin of 2."""
    out = torch.zeros(B, V)
    out[torch.arange(B), torch.as_tensor(top)] = 2.0
    return out


def _routes(k_ids, k_gap=0.3, p_ids=None, p_gap=0.3):
    """One step's (kernel path, plain path) of ``step_routes``, router
    inputs 1 and 1.5."""
    k_ids = torch.as_tensor(k_ids)
    p_ids = k_ids if p_ids is None else torch.as_tensor(p_ids)
    return ((k_ids, torch.full((L, B), k_gap), torch.ones(L, B, 2)),
            (p_ids, torch.full((L, B), p_gap), torch.full((L, B, 2), 1.5)))


SAME = [[0, 1, 2, 3]] * L
PART = [[0, 1, 2, 3], [0, 1, 2, 3], [0, 5, 2, 3]]     # slot 1, layer 2


def test_agreeing_routing_holds_every_decisive_token():
    pairs = [(_logits([1, 2, 3, 4]), _logits([1, 2, 3, 4]))] * 2
    n, parted = cs.top1_decisive_tokens(pairs, [_routes(SAME)] * 2, "t")
    assert (n, parted) == (2 * B, {})


def test_a_slot_parted_at_a_near_tie_is_held_before_it():
    gap = cs.ROUTE_TIE / 2
    pairs = [(_logits([1, 2, 3, 4]), _logits([1, 2, 3, 4])),
             (_logits([1, 0, 3, 4]), _logits([1, 2, 3, 4]))]
    n, parted = cs.top1_decisive_tokens(
        pairs, [_routes(SAME), _routes(SAME, gap, PART, gap)], "t")
    assert parted == {1: (1, 2, pytest.approx(gap), pytest.approx(gap),
                          pytest.approx(1 / 3))}
    assert n == B + B - 1


@pytest.mark.parametrize("which", ["kernel", "plain"])
def test_parting_past_a_near_tie_fails(which):
    gaps = dict(k_gap=0.001, p_gap=0.001)
    gaps[f"{which[0]}_gap"] = 2 * cs.ROUTE_TIE
    pairs = [(_logits([1, 2, 3, 4]), _logits([1, 2, 3, 4]))]
    with pytest.raises(AssertionError, match="no near-tie"):
        cs.top1_decisive_tokens(pairs, [_routes(SAME, p_ids=PART, **gaps)],
                                "t")


def test_a_decisive_token_that_differs_on_a_slot_not_parted_fails():
    pairs = [(_logits([1, 0, 3, 4]), _logits([1, 2, 3, 4]))]
    with pytest.raises(AssertionError, match="decisive token differs"):
        cs.top1_decisive_tokens(pairs, [_routes(SAME)], "t")


def test_no_decisive_token_held_fails():
    flat = torch.zeros(B, V)
    with pytest.raises(AssertionError, match="no decisive token"):
        cs.top1_decisive_tokens([(flat, flat)], [_routes(SAME)], "t")


def test_trace_follows_each_layer_of_both_paths():
    """The reduced llama4-scout (G = 5, top-1) on the CPU, two steps of
    kernel-path and plain-path decode as ``teacher_forced`` takes them:
    one traced call a layer, split by ``step_routes`` into the experts
    ``moe._route`` picks, and the gaps of its probabilities."""
    cfg = dataclasses.replace(
        tconfigs.REGISTRY["llama4-scout-17b-a16e"].reduced(), n_heads=10,
        n_kv_heads=2, dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    caches = [model.init_cache(B, 16, torch.float32) for _ in range(2)]
    g = torch.Generator("cpu").manual_seed(1)
    toks = [torch.randint(0, cfg.vocab, (B, 1), generator=g)
            for _ in range(2)]
    seen = []
    ffn = tmoe.moe_ffn

    def steps():
        out = []
        for t, tok in enumerate(toks):
            out.append([model.decode_step(
                params, {"token": tok, "pos": torch.full((B,), t)}, cache,
                opts=ModelOpts(use_kernel=k))[0]
                for cache, k in zip(caches, (True, False))])
        return out

    def spy(p, x, c, ctx):
        seen.append(tmoe._route(p, x.reshape(B, 1, -1), c)[1][:, 0, 0])
        return ffn(p, x, c, ctx)

    tmoe.moe_ffn = spy
    try:
        pairs, calls = cs.routing_trace(steps)
    finally:
        tmoe.moe_ffn = ffn
    n = cfg.n_layers
    assert tmoe.moe_ffn is ffn and len(calls) == len(seen) == 2 * 2 * n
    routes = cs.step_routes(calls, n)
    assert len(routes) == 2
    for t, ((k_ids, k_gap, k_x), (p_ids, p_gap, p_x)) in enumerate(routes):
        assert k_ids.shape == k_gap.shape == (n, B)
        assert k_x.shape == p_x.shape == (n, B, cfg.d_model)
        assert torch.equal(k_ids, torch.stack(seen[2 * t * n:][:n]))
        assert torch.equal(p_ids, torch.stack(seen[(2 * t + 1) * n:][:n]))
        assert bool((k_gap >= 0).all() and (p_gap <= 1).all())
        # float32 on the CPU: both paths route alike, gaps alike
        assert torch.equal(k_ids, p_ids)
        torch.testing.assert_close(k_gap, p_gap, atol=1e-5, rtol=0)
        torch.testing.assert_close(k_x, p_x, atol=1e-4, rtol=1e-4)
    for a, b in pairs:
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
