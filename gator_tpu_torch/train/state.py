"""Train state (counterpart of gator_tpu/train/state.py): the module with
its f32 master weights and BatchNorm buffers, its optimizer, and the step
counter that keys each step's dropout masks."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer step on the gradients in the parameters' .grad."""
        self.optimizer.step()
        self.step += 1
