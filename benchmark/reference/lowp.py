"""The control's precision: the reference with every matrix product's
operands rounded to float8 (e4m3), each tensor scaled by its own largest
magnitude first, as an fp8 path with per-tensor scales would hold them.
It is the nearest precision below the bfloat16 that the configurations
state; `correct` must come out false for it."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


class FP8:
    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        amax = x.detach().abs().amax()
        if float(amax) == 0.0:
            return x
        s = amax / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s


class FP8Train(FP8):
    """FP8 in a training step: the forward's operands rounded, the
    gradient passed straight through the rounding."""

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return x + (FP8.q(x.detach()) - x).detach()
