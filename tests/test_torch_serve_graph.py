"""The servers' decode step (``runtime/graph.py``) on the CPU, and
``LockstepServer.reset``.

* ``reset()`` against the reference's: closed batches served as epochs
  with a reset between them, as ``benchmarks/fig7_serve.py:97`` serves
  them, give the reference's tokens and ``pos`` after every epoch
  (reduced qwen1.5-4b in float32, so no bf16 near-tie can flip an argmax
  across frameworks; parameters from the reference's ``Model.init``).
* ``decode_step`` with ``pos`` as a 0-d int32 tensor, as the servers now
  pass it, is bit-equal to an int ``pos`` (reduced dense, hybrid, vlm).
* A server on the CPU builds no graph: its step runs eagerly.

The graph itself needs the card: ``test_torch_serve_graph_cuda.py``
holds replays against eager steps there, and ``chip_smoke.py`` holds the
full-width servers.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import build_model as jbuild
from repro.runtime.serve import LockstepServer as JLockstepServer
from repro.runtime.serve import Request as JRequest
from repro_torch.configs import REGISTRY
from repro_torch.interop import params_from_numpy
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import build_model
from repro_torch.runtime.graph import StepGraph
from repro_torch.runtime.serve import BatchedServer, LockstepServer, Request

OPTS = ModelOpts(attn_chunk=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(n, vocab, seed=11):
    """(rid, prompt, max_new_tokens) specs: prompts of 1-6 tokens, 2-7 new
    tokens each (fig7's ``make_load``, cut to a 32-token cache)."""
    rng = np.random.default_rng(seed)
    return [(rid, [int(t) for t in rng.integers(1, vocab,
                                                int(rng.integers(1, 7)))],
             int(rng.integers(2, 8))) for rid in range(n)]


def _epochs(server, load, batch_size, cls):
    """fig7's epoch serving: reset, then one closed batch, per epoch ->
    [(results, pos)] per epoch."""
    out = []
    for i in range(0, len(load), batch_size):
        server.reset()
        batch = [cls(rid=r, prompt=list(p), max_new_tokens=g)
                 for r, p, g in load[i:i + batch_size]]
        out.append((server.run(batch), server.pos))
    return out


@pytest.mark.parametrize("batch_size,n", [(2, 5), (3, 7)])
def test_lockstep_reset_epochs_match_reference(batch_size, n):
    jcfg = dataclasses.replace(JREGISTRY["qwen1.5-4b"].reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(REGISTRY["qwen1.5-4b"].reduced(),
                               dtype="float32")
    jmodel = jbuild(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    load = _load(n, jcfg.vocab)
    jsrv = JLockstepServer(jmodel, params, batch_size=batch_size, max_seq=32,
                           opts=JOpts(attn_chunk=32, remat="none"))
    tsrv = LockstepServer(build_model(tcfg), params_from_numpy(params),
                          batch_size=batch_size, max_seq=32, opts=OPTS,
                          device="cpu")
    ref = _epochs(jsrv, load, batch_size, JRequest)
    got = _epochs(tsrv, load, batch_size, Request)
    assert len(got) == -(-n // batch_size)
    assert got == ref
    assert all(pos > 0 for _, pos in got)


def _reduced(arch, seed=0):
    model = build_model(REGISTRY[arch].reduced())
    return model, model.init(torch.Generator("cpu").manual_seed(seed))


def _random_cache(model, B, S, seed=3):
    g = torch.Generator("cpu").manual_seed(seed)
    return {k: 0.3 * torch.randn(v.shape, generator=g, dtype=v.dtype)
            for k, v in model.init_cache(B, S, torch.float32).items()}


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "zamba2-7b",
                                  "llama-3.2-vision-90b"])
def test_reset_zeroes_the_cache_in_place(arch):
    """``reset()``: position 0 and the values of a fresh ``init_cache``,
    in the tensors the step holds."""
    model, params = _reduced(arch)
    srv = LockstepServer(model, params, batch_size=2, max_seq=16, opts=OPTS,
                         device="cpu")
    held = dict(srv.cache)
    for k, v in _random_cache(model, 2, 16).items():
        srv.cache[k].copy_(v)
    srv.pos = 9
    srv.reset()
    fresh = model.init_cache(2, 16, torch.float32)
    assert srv.pos == 0
    assert all(srv.cache[k] is held[k] for k in held)
    assert all(srv.step_graph.cache[k] is held[k] for k in held)
    assert all(torch.equal(srv.cache[k], fresh[k]) for k in fresh)


@pytest.mark.parametrize("arch,use_kernel", [
    ("qwen1.5-4b", False), ("qwen1.5-4b", True), ("zamba2-7b", False),
    ("llama-3.2-vision-90b", False)])
def test_decode_step_tensor_pos_bit_equal_to_int(arch, use_kernel):
    """Three steps at shared positions 5, 6, 7, on two copies of one
    seeded cache: an int ``pos`` and a 0-d int32 tensor give the same
    logits and caches, bit for bit."""
    model, params = _reduced(arch)
    B, S = 3, 16
    opts = dataclasses.replace(OPTS, use_kernel=use_kernel)
    base = _random_cache(model, B, S)
    caches = [{k: v.clone() for k, v in base.items()} for _ in range(2)]
    rng = np.random.default_rng(4)
    for pos in (5, 6, 7):
        tok = torch.as_tensor(rng.integers(0, model.cfg.vocab, (B, 1)),
                              dtype=torch.int32)
        a = model.decode_step(params, {"token": tok, "pos": pos}, caches[0],
                              opts=opts)[0]
        b = model.decode_step(
            params, {"token": tok, "pos": torch.tensor(pos, dtype=torch.int32)},
            caches[1], opts=opts)[0]
        assert torch.equal(a, b)
    assert all(torch.equal(caches[0][k], caches[1][k]) for k in base)
    assert not all(torch.equal(caches[0][k], base[k]) for k in base)


def _reqs(n, vocab, gen=4):
    return [Request(rid=i, prompt=[1 + i % (vocab - 1), 3, 5],
                    max_new_tokens=gen) for i in range(n)]


@pytest.mark.parametrize("arch,cls", [
    ("qwen1.5-4b", BatchedServer), ("phi3.5-moe-42b-a6.6b", BatchedServer),
    ("mamba2-130m", BatchedServer), ("zamba2-7b", BatchedServer),
    ("llama-3.2-vision-90b", BatchedServer), ("qwen1.5-4b", LockstepServer)])
def test_cpu_server_builds_no_graph(arch, cls):
    """On the CPU every step runs eagerly through the server's
    ``StepGraph``: no capture, no replay, no CUDA stream."""
    model, params = _reduced(arch)
    srv = cls(model, params, batch_size=2, max_seq=32, opts=OPTS,
              device="cpu")
    out = srv.run(_reqs(3, model.cfg.vocab))
    graph = srv.step_graph
    assert isinstance(graph, StepGraph) and sorted(out) == [0, 1, 2]
    assert graph.graph is None and graph.captures == 0 == graph.replays
    assert not hasattr(graph, "_stream")
    assert graph.logits.device.type == "cpu"
    assert graph.logits.shape == (2, model.cfg.vocab)
    assert graph.cache is (srv._lockstep.cache if getattr(
        srv, "_lockstep", None) else srv.cache)


def test_cpu_step_matches_decode_step():
    """``StepGraph.step`` on the CPU: ``decode_step``'s logits and their
    argmax, per slot, on the cache it holds."""
    model, params = _reduced("qwen1.5-4b")
    cache = _random_cache(model, 2, 16)
    twin = {k: v.clone() for k, v in cache.items()}
    step = StepGraph(model, params, cache, OPTS, batch=2, per_slot=True,
                     device=torch.device("cpu"))
    tok = np.array([[7], [9]], np.int32)
    pos = np.array([3, 11], np.int32)
    nxt = step.step(tok, pos)
    ref = model.decode_step(params, {"token": torch.from_numpy(tok),
                                     "pos": torch.from_numpy(pos)}, twin,
                            opts=OPTS)[0]
    assert torch.equal(step.logits, ref)
    np.testing.assert_array_equal(nxt, ref.argmax(-1).numpy())
    assert all(torch.equal(cache[k], twin[k]) for k in cache)
