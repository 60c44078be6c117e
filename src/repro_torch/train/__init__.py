"""Training (port of ``repro.train``): the train step and the
fault-tolerant trainer loop, on one card or over a mesh of ranks; the
manual data-parallel step (``train.manual_dp``) and the GPipe pipeline
(``train.pipeline``)."""
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
