"""Training: losses, optimizer, train and eval steps, checkpoints and the
trainer loop."""

from .checkpoint import CheckpointManager
from .losses import (mlm_loss, seq2seq_greedy_acc, seq2seq_loss,
                     template_loss)
from .optim import Optimizer, lr_schedule, make_optimizer
from .step import (TrainState, make_accum_train_step, make_eval_step,
                   make_loss_fn, make_train_step)
from .trainer import Trainer, run

__all__ = [
    "mlm_loss", "seq2seq_greedy_acc", "seq2seq_loss", "template_loss",
    "Optimizer", "lr_schedule", "make_optimizer", "TrainState",
    "make_accum_train_step", "make_eval_step", "make_loss_fn",
    "make_train_step", "CheckpointManager", "Trainer", "run",
]
