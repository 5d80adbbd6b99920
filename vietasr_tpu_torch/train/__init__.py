"""Training (counterpart of vietasr_tpu/train/): optimizers, schedules,
freezing and value schedules (`freeze.py`), state, train/eval steps and
the Trainer, checkpoints, metrics and synthetic data."""

from vietasr_tpu_torch.train.checkpoint import CheckpointManager
from vietasr_tpu_torch.train.loop import (Trainer, make_eval_step,
                                          make_train_step)
from vietasr_tpu_torch.train.metrics import levenshtein, word_error_rate
from vietasr_tpu_torch.train.optim import Novograd, make_optimizer
from vietasr_tpu_torch.train.schedules import make_schedule
from vietasr_tpu_torch.train.state import TrainState

__all__ = ["CheckpointManager", "Trainer", "make_eval_step",
           "make_train_step", "levenshtein", "word_error_rate", "Novograd",
           "make_optimizer", "make_schedule", "TrainState"]
