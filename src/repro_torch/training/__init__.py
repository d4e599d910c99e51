"""Training on PyTorch (counterpart of ``repro.training``): the AdamW /
Adafactor optimizers and schedule, the train step with microbatching,
remat and the int8-compressed data-parallel sum (one controller, or
ranks of a process group), checkpoints in the
reference's on-disk layout, and the fault-tolerant loop."""

from repro_torch.training import checkpoint, elastic
from repro_torch.training.optimizer import (OptConfig, opt_init, opt_update,
                                            schedule)
from repro_torch.training.step import (TrainConfig, abstract_train_state,
                                       init_dp_error_feedback,
                                       init_placed_dp_error_feedback,
                                       init_train_state, make_dp_train_step,
                                       make_train_step)

__all__ = ["OptConfig", "opt_init", "opt_update", "schedule", "TrainConfig",
           "make_train_step", "make_dp_train_step", "init_dp_error_feedback",
           "init_placed_dp_error_feedback", "init_train_state",
           "abstract_train_state", "checkpoint", "elastic"]
