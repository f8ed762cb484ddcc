"""ttft_p95_ms: 95th percentile, over every request whose first output
token came in the window, of the time from its submit() to that token."""
from harness.stats import p95


def read(run):
    v = p95(run.rec.ttft_s)
    return None if v is None else v * 1e3
