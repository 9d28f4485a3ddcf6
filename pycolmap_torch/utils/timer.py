"""Timer + profiling hooks (parity: colmap/util Timer, ref helpers.h:4,317).

Port of ``pycolmap_tpu/utils/timer.py``. ``Timer`` mirrors the upstream
elapsed-time API used by the controllers; ``trace`` wraps a
``torch.profiler`` trace (the reference wraps ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time


class Timer:
    def __init__(self):
        self._start = None
        self._pause_at = None
        self._elapsed = 0.0

    def start(self):
        self._start = time.perf_counter()
        self._elapsed = 0.0
        self._pause_at = None

    def restart(self):
        self.start()

    def pause(self):
        if self._start is not None and self._pause_at is None:
            self._pause_at = time.perf_counter()
            self._elapsed += self._pause_at - self._start

    def resume(self):
        if self._pause_at is not None:
            self._start = time.perf_counter()
            self._pause_at = None

    def reset(self):
        self._start = None
        self._pause_at = None
        self._elapsed = 0.0

    def elapsed_seconds(self) -> float:
        if self._start is None:
            return 0.0
        if self._pause_at is not None:
            return self._elapsed
        return self._elapsed + (time.perf_counter() - self._start)

    def elapsed_minutes(self) -> float:
        return self.elapsed_seconds() / 60.0

    def elapsed_hours(self) -> float:
        return self.elapsed_seconds() / 3600.0

    def elapsed_micro_seconds(self) -> float:
        return self.elapsed_seconds() * 1e6

    def print_seconds(self):
        print(f"Elapsed time: {self.elapsed_seconds():.5f} [seconds]")

    def print_minutes(self):
        print(f"Elapsed time: {self.elapsed_minutes():.3f} [minutes]")

    def print_hours(self):
        print(f"Elapsed time: {self.elapsed_hours():.3f} [hours]")


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler trace of the block, host and (when there is one) card
    activity, written as a TensorBoard trace file into `log_dir` (default
    ``pycolmap_torch_trace`` in the temporary directory) when it ends."""
    import torch
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "pycolmap_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield log_dir
