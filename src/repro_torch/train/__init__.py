"""Single-device training (the JAX package's ``repro.train``): AdamW,
the microbatched train step, atomic checkpoints and the fault-tolerance
logic.  Sharded training comes with the sharding slice."""
from repro_torch.train import checkpoint, fault, optimizer, train_step
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)

__all__ = ["checkpoint", "fault", "optimizer", "train_step", "TrainState",
           "init_train_state", "make_train_step"]
