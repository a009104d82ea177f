"""The comparisons that decide `correct`.

Each number compared has a limit of its own, set in the traffic mix's
file from readings of sound runs and of the control (PERF.md gives them).
A run is correct when every number is at or under its limit and none is
missing or not finite.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def rel_rms(got: torch.Tensor, ref: torch.Tensor, scale: float) -> float:
    return float(torch.sqrt(((got.double() - ref.double()) ** 2).mean())
                 / scale)


def rms(x: torch.Tensor) -> float:
    return float(torch.sqrt((x.double() ** 2).mean()))


def row_rel_rms_max(got: torch.Tensor, ref: torch.Tensor,
                    scale: float) -> float:
    """The worst row's RMS gap over the scale (rows: the leading dim)."""
    d = (got.double() - ref.double()).reshape(got.shape[0], -1)
    return float(torch.sqrt((d ** 2).mean(1)).max() / scale)


def max_abs(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).abs().max())


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """-> (correct, {name: {"value", "limit"}}) over the limits' names."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, float("nan"))
        out[name] = {"value": v, "limit": limit}
        if not (isinstance(v, float) and math.isfinite(v) and v <= limit):
            ok = False
    return ok, out
