"""Model configurations (counterpart of ``paddle_tpu/models``)."""
from .text import lstm_text_classifier  # noqa: F401
