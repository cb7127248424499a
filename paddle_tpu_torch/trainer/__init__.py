"""Training (counterpart of ``paddle_tpu/trainer``): the trainer, its
events and checkpoints."""
from . import events
from .checkpoint import (
    latest_checkpoint,
    latest_valid_checkpoint,
    load_buffers,
    load_opt_state,
    load_params,
    save_checkpoint,
    sweep_retention,
    verify_checkpoint,
)
from .trainer import Trainer, optimizer_from_config

__all__ = [
    "Trainer",
    "events",
    "latest_checkpoint",
    "latest_valid_checkpoint",
    "load_buffers",
    "load_opt_state",
    "load_params",
    "optimizer_from_config",
    "save_checkpoint",
    "sweep_retention",
    "verify_checkpoint",
]
