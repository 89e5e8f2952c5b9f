"""Training substrate: step builder + fault-tolerant trainer loop (port of
`repro.train`)."""
from repro_torch.train.step import (TrainState, build_train_step, init_state,
                                    state_shardings)
from repro_torch.train.trainer import Trainer

__all__ = ["TrainState", "build_train_step", "init_state", "state_shardings",
           "Trainer"]
