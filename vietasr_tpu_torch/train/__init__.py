"""Training (counterpart of vietasr_tpu/train/): optimizers, schedules,
freezing and value schedules (`freeze.py`), state, train/eval steps and
the Trainer, checkpoints, metrics and synthetic data."""

from vietasr_tpu_torch.train.checkpoint import CheckpointManager
from vietasr_tpu_torch.train.freeze import (freeze, make_value_schedule,
                                            unfreeze_schedule)
from vietasr_tpu_torch.train.loop import (Trainer, make_eval_step,
                                          make_train_step)
from vietasr_tpu_torch.train.metrics import levenshtein, word_error_rate
from vietasr_tpu_torch.train.optim import Novograd, make_optimizer, novograd
from vietasr_tpu_torch.train.schedules import (inverse_square_root,
                                               make_schedule,
                                               polynomial_decay,
                                               warmup_cosine,
                                               warmup_hold_cosine)
from vietasr_tpu_torch.train.state import TrainState

__all__ = ["CheckpointManager", "Trainer", "make_eval_step",
           "make_train_step", "levenshtein", "word_error_rate", "Novograd",
           "novograd", "make_optimizer", "make_schedule", "warmup_cosine",
           "warmup_hold_cosine", "inverse_square_root", "polynomial_decay",
           "TrainState", "freeze", "unfreeze_schedule",
           "make_value_schedule"]
