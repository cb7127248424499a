"""Optimizers (counterpart of ``paddle_tpu/optimizer``)."""
from .optimizers import (
    OPTIMIZERS,
    AdaDelta,
    Adagrad,
    Adam,
    Adamax,
    DecayedAdagrad,
    ModelAverage,
    Momentum,
    Optimizer,
    ProximalAdagrad,
    ProximalGD,
    RMSProp,
    SGD,
    create_optimizer,
)
from .schedules import SCHEDULES, make_schedule

__all__ = [
    "OPTIMIZERS",
    "SCHEDULES",
    "AdaDelta",
    "Adagrad",
    "Adam",
    "Adamax",
    "DecayedAdagrad",
    "ModelAverage",
    "Momentum",
    "Optimizer",
    "ProximalAdagrad",
    "ProximalGD",
    "RMSProp",
    "SGD",
    "create_optimizer",
    "make_schedule",
]
