"""repro_torch.training — optimizers and the train step, ported from
``repro.training``."""
from repro_torch.training import optimizer
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import (TrainState, make_train_step,
                                             train_state_init)

__all__ = ["OptConfig", "TrainState", "make_train_step", "optimizer",
           "train_state_init"]
