"""decode_mfu_pct: the model operations of the window's steps over their
seconds and the card's bf16 peak (model step layer, decode_step): two a
weight a token for each live slot, the embedding left out, and
attention's q.k and p.v over each slot's length.  Steps under the
profiler are left out."""
from harness import costs
from harness.stats import untraced


def read(run):
    peak = costs.peak(run.device_kind)
    lengths, dt = untraced(run.rec)
    if peak is None or not dt or sum(dt) <= 0:
        return None
    flops = sum(costs.step_flops(run.cfg, x) for x in lengths)
    return 100.0 * flops / sum(dt) / peak["bf16_flops"]
