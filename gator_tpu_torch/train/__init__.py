"""Training (counterpart of gator_tpu/train): the train steps of both
stages on the training kernels K4 and K5, their forward, optimizers and
schedules, and the train state."""
from .fused_forward import (gat_train_forward, make_fused_forward,
                            mdr_train_forward, rates_from_spec)
from .loop import make_gat_train_step, make_gator_train_step
from .schedule import Adam, ReduceLROnPlateau, make_optimizer, multistep_lr
from .state import TrainState

__all__ = ["Adam", "ReduceLROnPlateau", "TrainState", "gat_train_forward",
           "make_fused_forward", "make_gat_train_step",
           "make_gator_train_step", "make_optimizer", "mdr_train_forward",
           "multistep_lr", "rates_from_spec"]
