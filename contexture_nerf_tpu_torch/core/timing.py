"""Repeated timing windows: the port's copy of
contexture_nerf_tpu/core/timing.py (`timed_windows`, `median_iqr_ms`), so a
benchmark reads a median and a spread over windows, not one mean."""

from __future__ import annotations

import statistics
import time


def timed_windows(fn, ready, n_iters: int, reps: int):
    """reps timing windows of n_iters chained calls each; `ready` blocks on
    the last result (torch.cuda.synchronize on the card). Returns the
    per-call seconds of each window."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = None
        for _ in range(n_iters):
            r = fn()
        ready(r)
        out.append((time.perf_counter() - t0) / n_iters)
    return out


def median_iqr_ms(samples_s):
    """(median, interquartile range) of per-call times, in milliseconds."""
    ms = sorted(1000.0 * s for s in samples_s)
    med = statistics.median(ms)
    if len(ms) >= 4:
        q = statistics.quantiles(ms, n=4)
        iqr = q[2] - q[0]
    else:
        iqr = max(ms) - min(ms)
    return med, iqr
