"""What the harness hands a driver, and what a driver hands back."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

from .trace import Spans


@dataclasses.dataclass
class Ctx:
    cell: str                     # the cell's name in BENCHMARK.json
    seed: int
    seconds: float
    trace: bool
    cfg: dict                     # configs/<config>.json
    mix: dict                     # traffic/<traffic>.json
    device: Any = "cuda"
    chips: int = 1
    spans: Spans = dataclasses.field(default_factory=Spans)
    scratch: str = "."            # where a trace file may be written
    # the time (perf_counter) the measured window opened; set by the
    # driver, read for setup_s
    window_start: Optional[float] = None

    def open_window(self) -> float:
        self.window_start = time.perf_counter()
        return self.window_start


@dataclasses.dataclass
class Result:
    attempted: int = 0
    failed: int = 0
    # end-to-end metrics measured by the driver (setup_s is the harness's)
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    # what the per-layer readers read (the trace, counts, shapes, host
    # spans); see metrics/*.py
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    values: Dict[str, float] = dataclasses.field(default_factory=dict)
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
