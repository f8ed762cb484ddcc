"""The port's servers: the behaviour of ``tests/test_serve.py:63-174`` for
the dense family, in torch, plus greedy-token parity with the JAX
``BatchedServer`` on the same numpy parameters.

Within torch the contract is bit-identity (continuous vs lockstep); across
frameworks greedy tokens are compared on a ``dtype="float32"`` config,
where no bf16 near-tie can flip an argmax.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.models.blocks import ModelOpts as JOpts
from repro.models.model import build_model as jbuild
from repro.runtime.serve import BatchedServer as JBatchedServer
from repro.runtime.serve import Request as JRequest
from repro_torch.configs import REGISTRY
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import decode_attention as da
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import build_model
from repro_torch.runtime.serve import BatchedServer, LockstepServer, Request

OPTS = ModelOpts(attn_chunk=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's CPU thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch):
    cfg = REGISTRY[arch].reduced()
    model = build_model(cfg)
    return model, model.init(torch.Generator("cpu").manual_seed(0))


def _reqs(n, base=3, gen=5, cls=Request):
    return [cls(rid=i, prompt=[1 + i, base, base + i % 3],
                max_new_tokens=gen) for i in range(n)]


def _server(model, params, cls=BatchedServer, **kw):
    kw.setdefault("opts", OPTS)
    return cls(model, params, device="cpu", **kw)


@pytest.fixture(scope="module")
def dense():
    return _model("qwen1.5-4b")


@pytest.mark.parametrize("B,n", [(3, 3), (4, 2)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_closed_batch_bit_identical_to_lockstep(dense, B, n, use_kernel):
    model, params = dense
    opts = dataclasses.replace(OPTS, use_kernel=use_kernel)
    lock = _server(model, params, LockstepServer, batch_size=B, max_seq=64,
                   opts=opts)
    cont = _server(model, params, batch_size=B, max_seq=64, opts=opts)
    assert cont.use_kernel == use_kernel
    assert cont.run(_reqs(n)) == lock.run(_reqs(n))


def test_kernel_path_matches_reference(dense):
    """On the CPU "kernel" runs the wrapper's plain version, counted apart
    from launches."""
    model, params = dense
    ref = _server(model, params, batch_size=2, max_seq=64, use_kernel=False)
    ker = _server(model, params, batch_size=2, max_seq=64, use_kernel=True)
    assert ker.use_kernel
    da.COUNT.reset()
    out = ker.run(_reqs(4))
    assert da.COUNT.launches == 0
    assert da.COUNT.plain == ker.steps * model.cfg.n_layers
    assert out == ref.run(_reqs(4))


def test_kernel_refused_for_sliding_window():
    model, params = _model("gemma3-27b")      # sliding_window set
    srv = _server(model, params, batch_size=2, max_seq=64, use_kernel=True)
    assert not srv.use_kernel                 # forced off, as in the reference
    assert len(srv.run(_reqs(2))) == 2


def test_mid_flight_admission_position_independent(dense):
    model, params = dense
    late = Request(rid=99, prompt=[7, 8, 9], max_new_tokens=6)
    solo = _server(model, params, batch_size=2, max_seq=64)
    ref = solo.run([Request(rid=99, prompt=[7, 8, 9], max_new_tokens=6)])
    srv = _server(model, params, batch_size=2, max_seq=64)
    for r in _reqs(2, gen=8):
        srv.submit(r)
    for _ in range(5):
        srv.step()
    srv.submit(late)
    out = srv.drain()
    assert out[99] == ref[99]
    assert late.arrived == 5
    assert late.started > late.arrived
    assert set(out) == {0, 1, 99}


def test_per_slot_truncation_spares_neighbours(dense):
    model, params = dense
    long = Request(rid=0, prompt=[5, 6], max_new_tokens=100)
    srv = _server(model, params, batch_size=2, max_seq=24)
    srv.submit(long)
    srv.step()
    short = Request(rid=1, prompt=[9, 10], max_new_tokens=4)
    srv.submit(short)
    out = srv.drain()
    assert len(out[0]) < 100
    assert len(out[1]) == 4
    assert not srv.queue and all(a is None for a in srv.active)


def test_slot_reuse_serves_like_solo(dense):
    """A request in a reused slot (stale KV above its position) decodes as
    if served alone."""
    model, params = dense
    mk = lambda: Request(rid=7, prompt=[11, 12], max_new_tokens=5)
    ref = _server(model, params, batch_size=1, max_seq=64).run([mk()])
    srv = _server(model, params, batch_size=1, max_seq=64, use_kernel=True)
    srv.run([Request(rid=0, prompt=[3, 4, 5], max_new_tokens=6)])
    assert srv.run([mk()]) == ref


def test_streaming_api_finish_order_and_bookkeeping(dense):
    model, params = dense
    srv = _server(model, params, batch_size=2, max_seq=64)
    a = Request(rid=0, prompt=[2, 3], max_new_tokens=2)
    b = Request(rid=1, prompt=[4, 5], max_new_tokens=9)
    srv.submit(a), srv.submit(b)
    finished = []
    while srv.queue or any(s is not None for s in srv.active):
        finished.extend(srv.step())
    assert [r.rid for r in finished] == [0, 1]
    assert a.done and b.done
    assert a.finished < b.finished
    assert srv.results[0] == a.output


def test_servers_refuse_a_missing_card(dense):
    """With no device given the servers want CUDA; without a card they
    raise instead of running on the CPU."""
    model, params = dense
    if torch.cuda.is_available():
        assert BatchedServer(model, params).device.type == "cuda"
        return
    for cls in (BatchedServer, LockstepServer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(model, params)


@pytest.mark.parametrize("n_kv_heads,use_kernel", [(4, True), (2, False)])
def test_greedy_tokens_match_jax_server(n_kv_heads, use_kernel):
    """Same numpy parameters, same requests, float32 config: the torch and
    JAX continuous servers emit the same greedy tokens."""
    jcfg = dataclasses.replace(JREGISTRY["qwen1.5-4b"].reduced(),
                               n_kv_heads=n_kv_heads, dtype="float32")
    tcfg = dataclasses.replace(REGISTRY["qwen1.5-4b"].reduced(),
                               n_kv_heads=n_kv_heads, dtype="float32")
    jmodel = jbuild(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for leaf in ("bq", "bk", "bv"):
        shape = params["layers"]["attn"][leaf].shape
        params["layers"]["attn"][leaf] = (
            0.1 * rng.standard_normal(shape)).astype(np.float32)
    jsrv = JBatchedServer(jmodel, params, batch_size=2, max_seq=32,
                          opts=JOpts(attn_chunk=32, remat="none"),
                          use_kernel=use_kernel)
    tsrv = BatchedServer(build_model(tcfg), params_from_numpy(params),
                         batch_size=2, max_seq=32, opts=OPTS,
                         use_kernel=use_kernel, device="cpu")
    ref = jsrv.run(_reqs(3, gen=6, cls=JRequest))
    assert tsrv.run(_reqs(3, gen=6)) == ref
