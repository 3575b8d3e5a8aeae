"""Tracing and step timing (port of nerfpp_tpu/utils/profiling.py).

``trace`` records a ``torch.profiler`` trace of the enclosed work (host
activity, and the card's kernels and copies where the device is a card)
and writes it into a directory as a Chrome trace (open it in Perfetto or
chrome://tracing). ``StepTimer`` keeps an exponential moving average of
the step time and the rays per second it gives.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir, enabled: bool = True, device=None):
    """Profile the enclosed steps into ``log_dir``/trace.json. ``device``:
    the device the work runs on; CUDA activity is recorded where it is a
    card (by default, where CUDA is available)."""
    if not enabled:
        yield
        return
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path / TRACE_FILE))


class StepTimer:
    """EMA step timing and throughput accounting."""

    def __init__(self, rays_per_step: int, ema: float = 0.9):
        self.rays_per_step = rays_per_step
        self.ema = ema
        self._last = None
        self.step_time = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_time = (dt if self.step_time is None
                              else self.ema * self.step_time
                              + (1 - self.ema) * dt)
        self._last = now

    @property
    def rays_per_sec(self) -> float:
        if not self.step_time:
            return 0.0
        return self.rays_per_step / self.step_time
