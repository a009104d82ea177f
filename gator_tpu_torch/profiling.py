"""Profiling and step-time observability (counterpart of
gator_tpu/profiling.py): a `torch.profiler` trace written as a
Chrome/Perfetto trace file, a rolling step timer, and the cards' memory
statistics."""
from __future__ import annotations

import contextlib
import os
import os.path as osp
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the host and, where there is a card, the device, and write the
    trace to `log_dir`/trace.json (Perfetto or chrome://tracing):

        with profiling.trace("/tmp/trace"):
            train_step(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step-time / throughput tracker for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Call once per step; returns the step time (None on first)."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def throughput(self, batch_size: int) -> float:
        st = self.mean_step_time
        return batch_size / st if st > 0 else 0.0


def device_memory_stats() -> dict:
    """{"cuda:i (name)": torch.cuda.memory_stats(i)} for each visible card;
    {} where there is none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i} ({torch.cuda.get_device_name(i)})":
            torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
