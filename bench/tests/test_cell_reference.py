"""The frozen reference against the port's CPU path at a tiny size of
both families, in float32: the weights' layout, the forward's hidden
states and logits, the MoE routing, and the server's greedy tokens."""
import pytest
import torch

import tiny
from harness import check
from harness import weights as W
from harness.cell import Cell, arch_config, run_cell

from repro_torch.models.model import Model


def leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaves(v, name + ".")
        else:
            yield name, v


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_layout_is_the_ports_tree(name):
    cfg = tiny.config(name)
    spec = dict(leaves(Model(arch_config(cfg)).param_spec()))
    mine = W.layout(cfg)
    assert sorted(spec) == sorted(mine)
    for k, p in spec.items():
        assert tuple(p.shape) == mine[k][0]
        assert (p.init == "ones") == (mine[k][1] == "ones")


def test_draw_is_made_again_from_the_seed():
    cfg = tiny.config("phi3.5-moe-16L")
    a, b = W.draw(cfg, 2**31 + 3, "cpu"), W.draw(cfg, 2**31 + 3, "cpu")
    c = W.draw(cfg, 2**31 + 4, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
        assert a[k].dtype == torch.bfloat16
    assert not torch.equal(a["layers.attn.wq"], c["layers.attn.wq"])
    assert W.n_bytes(cfg) == sum(t.numel() * 2 for t in a.values())


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_forward_matches_the_port_in_f32(name):
    cfg = tiny.config(name, dtype="float32")
    flat = W.draw(cfg, 11, "cpu")
    ref = check.load_reference(cfg["reference"])
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg["vocab"], (2, 12), generator=gen)
    h_port, _ = Model(arch_config(cfg)).forward(
        W.nest(flat), {"tokens": toks})
    spans = [range(0, 12), range(12, 24)]
    pos = torch.cat([torch.arange(12), torch.arange(12)])
    with torch.no_grad():
        h_ref = ref.forward_hidden(cfg, flat.__getitem__, toks.reshape(-1),
                                   pos, spans)
    torch.testing.assert_close(h_ref, h_port.detach().reshape(24, -1),
                               rtol=1e-5, atol=1e-5)
    head = flat["embed.unembed"]
    torch.testing.assert_close(h_ref @ head,
                               h_port.detach().reshape(24, -1) @ head,
                               rtol=1e-5, atol=1e-5)


def test_routing_is_the_ports():
    from repro_torch.models import moe
    cfg = tiny.config("phi3.5-moe-16L", dtype="float32")
    ref = check.load_reference(cfg["reference"])
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 16, cfg["d_model"], generator=gen)
    router = torch.randn(cfg["d_model"], cfg["n_experts"], generator=gen)
    # a tie between the second and third expert: the lower one wins
    router[:, 2] = router[:, 1]
    w, ids, *_ = moe._route({"router": router}, x, arch_config(cfg))
    gw, gids = ref.route(x[0], router, cfg["top_k"])
    assert torch.equal(ids[0], gids)
    torch.testing.assert_close(w[0], gw)


@pytest.mark.parametrize("slots,ok", [(64, True), (4, True), (96, True),
                                      (8192, False)])
def test_no_drop_guard(slots, ok):
    cfg = tiny.config("phi3.5-moe-16L")
    ref = check.load_reference("decoder")
    if ok:
        ref.check_no_drop(cfg, slots)
    else:
        with pytest.raises(ValueError):
            ref.check_no_drop(cfg, slots)


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_served_tokens_are_the_references_in_f32(name):
    cfg = tiny.config(name, dtype="float32")
    limits = {"limits": {"max_logit_gap": {"limit": 1e-4}}}
    out = run_cell(Cell("t", 1, cfg, tiny.mix(), {}), 5, 2.0, False,
                   device="cpu", limits=limits)
    assert out["readings"]["tokens"] >= 100
    assert out["readings"]["program"]["max_logit_gap"] < 1e-4
    assert out["correct"]
