"""Device timing on the card, shared by ``chip_smoke.py`` and the probe
scripts."""

from __future__ import annotations

import time

import numpy as np
import torch

WARMUP = 3
REPS = 25


def time_gpu(fn, reps=REPS):
    """Median device time of fn() in ms over `reps` CUDA-event timings,
    after WARMUP untimed calls. A sleep kernel queued before each timed
    call keeps the card busy while the host enqueues it, so host launch
    overhead does not count."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        if hasattr(torch.cuda, "_sleep"):
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def host_ms(fn, reps=200):
    """Host wall time per call of fn() in ms over `reps` back-to-back calls,
    the card synchronised before and after: what a caller waits per call
    when the host's launches, not the device, set the pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3
