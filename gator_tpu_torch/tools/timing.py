"""The card's name and CUDA-event timing, shared by the tools and by
chip_smoke.py. Both need a CUDA device."""
from __future__ import annotations

import subprocess
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
