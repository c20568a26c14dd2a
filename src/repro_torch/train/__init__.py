"""Training substrate: optimizer, train-step builder, checkpointing, fault
tolerance and elastic remeshing, gradient compression, the train state's
sharding specs."""
from repro_torch.train import (checkpoint, compression, elastic, optimizer,
                               train_loop)
from repro_torch.train.elastic import FaultTolerantTrainer, Prefetcher, remesh
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_loop import (TrainOptions, build_train_step,
                                          init_train_state, train_state_specs)

__all__ = ["FaultTolerantTrainer", "OptimizerConfig", "Prefetcher",
           "TrainOptions", "adamw_update", "build_train_step", "checkpoint",
           "compression", "elastic", "init_opt_state", "init_train_state",
           "optimizer", "remesh", "train_loop", "train_state_specs"]
