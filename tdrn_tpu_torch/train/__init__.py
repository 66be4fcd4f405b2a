"""Training of the port: matching targets, the dual-refinement loss, the
train step and its optimizer (trainer.py) and the checkpoints, train states
included (checkpoint.py)."""

from tdrn_tpu_torch.train.loss import Targets, refine_multibox_loss, smooth_l1  # noqa: F401
from tdrn_tpu_torch.train.trainer import (  # noqa: F401
    TrainState,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
