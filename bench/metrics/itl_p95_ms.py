"""itl_p95_ms: 95th percentile of the gaps between consecutive output
tokens of a request, over every gap with both tokens in the window."""
from harness.stats import p95


def read(run):
    v = p95(run.rec.itl_s)
    return None if v is None else v * 1e3
