"""Training on one card (port of ``repro.train``): the train step and the
fault-tolerant trainer loop.  Training over a mesh (``manual_dp``,
``pipeline``) belongs to a later slice."""
from repro_torch.train.step import TrainStepConfig, make_train_state, make_train_step
from repro_torch.train.trainer import SimulatedFailure, Trainer, TrainerConfig

__all__ = [
    "TrainStepConfig",
    "make_train_state",
    "make_train_step",
    "SimulatedFailure",
    "Trainer",
    "TrainerConfig",
]
