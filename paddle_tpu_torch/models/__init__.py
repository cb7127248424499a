"""Model configurations (counterpart of ``paddle_tpu/models``)."""
from .ctr import CTR_OPT, ctr_classifier  # noqa: F401
from .image import resnet, resnet_cifar10  # noqa: F401
from .seq2seq import seq2seq_config, seq2seq_generator_config  # noqa: F401
from .text import (lstm_text_classifier,  # noqa: F401
                   transformer_text_classifier)
