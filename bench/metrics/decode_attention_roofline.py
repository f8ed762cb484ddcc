"""decode_attention_roofline: decode attention's bytes bound over its
device time in the traced steps (kernels layer, decode_attention).  The
bound is K and V below each live slot's length, q and the output, at the
card's HBM bandwidth, for each layer of each traced step; the kernels
that make up decode attention are named in
decode_attention_roofline.json.  Where the trace lost some of their
records, the bound is taken for the launches it shows."""
import json
import os

from harness import costs
from harness.stats import traced_lengths

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "decode_attention_roofline.json")) as _f:
    KERNELS = tuple(json.load(_f)["kernels"])


def read(run):
    tr, peak = run.rec.trace, costs.peak(run.device_kind)
    if tr is None or peak is None:
        return None
    mine = [d for name, _, d in tr.device if any(k in name for k in KERNELS)]
    steps = traced_lengths(run.rec)
    if not mine or not steps:
        return None
    launches = run.cfg["n_layers"] * len(steps)
    bound_s = sum(costs.decode_attn_bytes(run.cfg, x) for x in steps) \
        * run.cfg["n_layers"] / peak["hbm_bytes_s"]
    bound_s *= min(1.0, len(mine) / launches)
    return 100.0 * bound_s / (sum(mine) / 1e6)
