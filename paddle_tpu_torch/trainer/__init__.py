"""Training (counterpart of ``paddle_tpu/trainer``): the trainer and its
events."""
from . import events  # noqa: F401
from .trainer import Trainer, optimizer_from_config  # noqa: F401
