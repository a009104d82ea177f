"""Train state (counterpart of gator_tpu/train/state.py): the module with
its f32 master weights and BatchNorm buffers, its optimizer, the step
counter that keys each step's dropout masks, and the step-indexed LR
schedule, if any, that sets the optimizer's lr before every update."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .schedule import set_learning_rate


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # lr(step) for `scheduler: step` (schedule.multistep_lr); None leaves
    # the param groups' lr as it is (the plateau path sets it per epoch)
    lr_schedule: Optional[Callable[[int], float]] = None

    def apply_gradients(self) -> None:
        """One optimizer step on the gradients in the parameters' .grad.
        Update number `step` (0-based) runs at `lr_schedule(step)`, as
        optax evaluates a schedule inside the optimizer on every update."""
        if self.lr_schedule is not None:
            set_learning_rate(self, self.lr_schedule(self.step))
        self.optimizer.step()
        self.step += 1
