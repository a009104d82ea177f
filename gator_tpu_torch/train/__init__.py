"""Training and evaluation (counterpart of gator_tpu/train): the train steps
of both stages on the training kernels K4 and K5, the eval steps of both
stages and the exact-mean eval loop, checkpoints, optimizers and
schedules, and the train state."""
from .checkpoint import (load_checkpoint, load_weights, pick_checkpoint,
                         save_checkpoint)
from .evaluate import run_eval
from .fused_forward import (gat_train_forward, make_fused_forward,
                            mdr_train_forward, rates_from_spec)
from .loop import (make_gat_eval_step, make_gat_train_step,
                   make_gator_eval_step, make_gator_train_step,
                   with_gt_synthesis)
from .schedule import (Adam, ReduceLROnPlateau, RMSprop, make_optimizer,
                       multistep_lr)
from .state import TrainState

__all__ = ["Adam", "RMSprop", "ReduceLROnPlateau", "TrainState",
           "gat_train_forward", "load_checkpoint", "load_weights",
           "make_fused_forward", "make_gat_eval_step", "make_gat_train_step",
           "make_gator_eval_step", "make_gator_train_step", "make_optimizer",
           "mdr_train_forward", "multistep_lr", "pick_checkpoint",
           "rates_from_spec", "run_eval", "save_checkpoint",
           "with_gt_synthesis"]
