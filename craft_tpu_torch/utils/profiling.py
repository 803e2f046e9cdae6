"""Profiling helpers (port of ``craft_tpu.utils.profiling``): a
``torch.profiler`` trace of the host and the card, and a wall-clock step
timer."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the CPU and, where there is one, the card into
    log_dir/trace.json (a Chrome trace, readable by Perfetto)."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"Profiler trace written to {path}")


class StepTimer:
    """Wall-clock time a step with a running mean after `warmup` steps
    (the reference's 'time' metric, train.py:218-241)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t = None

    def tic(self):
        self._t = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count - self.warmup, 1)
