"""The card's name and CUDA-event timing, shared by the tools (they need
a CUDA device); `span_profile`, which attributes
one profiled window's launches, device time and idle to the program's
spans (`profiling.attribute`); and `measure`, which profiles a call on the
card or times it on the host clock where a tool runs with --device cpu."""
from __future__ import annotations

import json
import os.path as osp
import subprocess
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

from .. import profiling


def card_name() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn: Callable[[], object], reps: int = 5, calls: int = 3) -> float:
    """Median ms per call over `reps` runs of `calls` calls (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def read_spans(log_dir: str, calls: int) -> Dict[str, dict]:
    """`profiling.attribute` of the trace that `profiling.trace(log_dir)`
    wrote, every figure divided by `calls` (the calls of the window)."""
    with open(osp.join(log_dir, "trace.json")) as f:
        got = profiling.attribute(json.load(f))
    return {name: {k: v / calls for k, v in fig.items()}
            for name, fig in got.items()}


def span_profile(fn: Callable[[], object], calls: int) -> Dict[str, dict]:
    """fn() `calls` times in one `profiling.trace` window (CPU and CUDA
    activity) -> {span: {calls, host_ms, launches, device_ms, idle_ms}} per
    call of fn (`read_spans`); the whole window is the span "trace"."""
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir):
            for _ in range(calls):
                fn()
        return read_spans(log_dir, calls)


def measure(fn: Callable[[], object], cuda: bool, reps: int = 5) -> dict:
    """fn() per call: on the card `profile_packed_step.profile`'s device
    ms, launches, idle share (of its profiled window) and host ms; on the CPU the host ms alone
    (median of `reps` calls after one warm-up), with no device number."""
    if cuda:
        from .profile_packed_step import profile
        return profile(fn, reps)
    fn()
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t.append((time.perf_counter() - t0) * 1e3)
    return {"host_ms": float(np.median(t)), "device_ms": None,
            "launches": None, "idle_share": None}
