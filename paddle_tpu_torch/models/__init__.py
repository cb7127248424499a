"""Model configurations (counterpart of ``paddle_tpu/models``)."""
from .ctr import CTR_OPT, ctr_classifier  # noqa: F401
from .image import (alexnet, googlenet, resnet,  # noqa: F401
                    resnet_cifar10, smallnet_mnist_cifar, vgg)
from .seq2seq import seq2seq_config, seq2seq_generator_config  # noqa: F401
from .text import (lstm_text_classifier,  # noqa: F401
                   transformer_text_classifier)
