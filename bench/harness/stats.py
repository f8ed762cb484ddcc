"""Arithmetic the metric readers share."""
from __future__ import annotations

import numpy as np


def p95(values, least: int = 20):
    """The 95th percentile (linear between ranks), or None with fewer
    than ``least`` values, where it would be a maximum."""
    if len(values) < least:
        return None
    return float(np.percentile(np.asarray(values, np.float64), 95))


def untraced(rec):
    """(lengths, seconds) of each of the window's steps that ran without
    the profiler."""
    keep = [i for i, t in enumerate(rec.step_traced) if not t]
    return [rec.step_lengths[i] for i in keep], [rec.step_dt[i] for i in keep]


def traced_lengths(rec):
    """The live slots' lengths of each step that ran under the
    profiler."""
    steps = [i for i, t in enumerate(rec.step_traced) if t]
    n = rec.trace.steps if rec.trace is not None else len(steps)
    return [rec.step_lengths[i] for i in steps[:n]]
