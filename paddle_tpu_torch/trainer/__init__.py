"""Training (counterpart of ``paddle_tpu/trainer``)."""
from .trainer import Trainer, optimizer_from_config  # noqa: F401
