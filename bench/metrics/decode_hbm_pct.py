"""decode_hbm_pct: the bytes the window's steps need over their seconds
and the card's HBM bandwidth (model step layer, decode_step): every
weight a step reads once (the experts its tokens route to), the K and V
of each live slot's length.  Steps under the profiler are left out."""
from harness import costs
from harness.stats import untraced


def read(run):
    peak = costs.peak(run.device_kind)
    lengths, dt = untraced(run.rec)
    if peak is None or not dt or sum(dt) <= 0:
        return None
    nbytes = sum(costs.step_bytes(run.cfg, x) for x in lengths)
    return 100.0 * nbytes / sum(dt) / peak["hbm_bytes_s"]
