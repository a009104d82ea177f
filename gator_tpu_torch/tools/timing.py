"""The card's name and CUDA-event timing, shared by the tools and by
chip_smoke.py (both need a CUDA device), and `measure`, which profiles a
call on the card or times it on the host clock where a tool runs with
--device cpu."""
from __future__ import annotations

import subprocess
import time
from typing import Callable

import numpy as np
import torch


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


def measure(fn: Callable[[], object], cuda: bool, reps: int = 5) -> dict:
    """fn() per call: on the card `profile_packed_step.profile`'s device
    ms, launches, idle share and host ms; on the CPU the host ms alone
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
