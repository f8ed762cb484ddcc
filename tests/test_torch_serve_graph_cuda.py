"""The servers' decode step as a CUDA graph, on the card (``cuda``-marked;
each skips without one).  No JAX here: these run where the port runs,
``PYTHONPATH=src python -m pytest tests/test_torch_serve_graph_cuda.py``.

For reduced dense with the decode kernel, MoE with it, SSM and hybrid:
the server's replays give the eager step's logits and cache bit for bit,
one capture a server and one replay a step, and the kernel's launch
counts stay exact over replays.  A step that cannot be captured raises,
naming the op.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY
from repro_torch.kernels import decode_attention as da
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import build_model
from repro_torch.runtime.graph import CaptureError, StepGraph
from repro_torch.runtime.serve import BatchedServer, Request

pytestmark = pytest.mark.cuda

B, S, STEPS = 3, 32, 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device; the servers' graphs are held on the "
                    "card by chip_smoke.py")
    return torch.device("cuda")


def _server(arch, card, use_kernel):
    model = build_model(REGISTRY[arch].reduced())
    params = model.init(torch.Generator("cuda").manual_seed(0))
    return model, BatchedServer(model, params, batch_size=B, max_seq=S,
                                opts=ModelOpts(attn_chunk=32),
                                use_kernel=use_kernel, device=card)


@pytest.mark.parametrize("arch,use_kernel", [
    ("qwen1.5-4b", True), ("phi3.5-moe-42b-a6.6b", True),
    ("mamba2-130m", False), ("zamba2-7b", False)])
def test_replay_bit_equal_to_eager(card, arch, use_kernel):
    model, srv = _server(arch, card, use_kernel)
    graph = srv.step_graph
    per_slot = srv.continuous
    g = torch.Generator("cuda").manual_seed(3)
    for v in graph.cache.values():
        v.copy_(0.3 * torch.randn(v.shape, generator=g, device=card))
    eager_cache = {k: v.clone() for k, v in graph.cache.items()}
    rng = np.random.default_rng(5)
    da.COUNT.reset()
    for t in range(STEPS):
        tok = rng.integers(0, model.cfg.vocab, (B, 1)).astype(np.int32)
        pos = (rng.integers(0, S - 1, B).astype(np.int32) if per_slot
               else 7 + t)
        nxt = graph.step(tok, pos)
        replayed = graph.logits.clone()
        eager = model.decode_step(
            graph.params,
            {"token": torch.as_tensor(tok, device=card),
             "pos": torch.as_tensor(pos, dtype=torch.int32, device=card)},
            eager_cache, opts=graph.opts)[0]
        assert torch.equal(replayed, eager), f"step {t}"
        np.testing.assert_array_equal(nxt, eager.argmax(-1).cpu().numpy())
    for k, v in graph.cache.items():
        assert torch.equal(v, eager_cache[k]), k
    assert graph.captures == 1 and graph.replays == STEPS
    kernel = srv.use_kernel
    # the warm-up's launches, then one a layer for each replay and eager step
    want = model.cfg.n_layers * (1 + 2 * STEPS) if kernel else 0
    assert (da.COUNT.launches, da.COUNT.plain) == (want, 0)


def test_served_run_is_one_capture_and_a_replay_a_step(card):
    model, srv = _server("qwen1.5-4b", card, True)
    reqs = [Request(rid=i, prompt=[1 + i, 3, 5], max_new_tokens=4)
            for i in range(5)]
    da.COUNT.reset()
    out = srv.run(reqs)
    assert sorted(out) == list(range(5))
    graph = srv.step_graph
    assert graph.captures == 1 and graph.replays == srv.steps
    assert da.COUNT.launches == model.cfg.n_layers * (srv.steps + 1)


def test_lockstep_reset_serves_each_epoch_alike(card):
    """The hybrid's lockstep server: the same closed batch twice with a
    reset between gives the same tokens on the one graph."""
    model, srv = _server("zamba2-7b", card, False)
    lock = srv._lockstep
    mk = lambda: [Request(rid=i, prompt=[2 + i, 4], max_new_tokens=3)
                  for i in range(B)]
    first = lock.run(mk())
    lock.reset()
    assert lock.pos == 0
    assert lock.run(mk()) == first
    assert srv.step_graph.captures == 1


@dataclasses.dataclass(frozen=True)
class _SyncingModel:
    """A decode step that asks the host for a value mid-step."""
    inner: object

    @property
    def cfg(self):
        return self.inner.cfg

    def decode_step(self, params, batch, cache, ctx, opts):
        if int(batch["pos"].sum().item()) < 0:
            raise AssertionError("unreachable")
        return self.inner.decode_step(params, batch, cache, ctx, opts)


def test_capture_failure_raises_naming_the_op(card):
    model, srv = _server("qwen1.5-4b", card, True)
    graph = StepGraph(_SyncingModel(model), srv.params, srv.cache,
                      srv.step_graph.opts, batch=B, per_slot=True,
                      device=card)
    with pytest.raises(CaptureError, match="item"):
        graph.step(np.zeros((B, 1), np.int32), np.zeros(B, np.int32))
    assert graph.graph is None and graph.replays == 0
