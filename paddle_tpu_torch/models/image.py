"""Image model builders (counterpart of ``paddle_tpu/models/image.py``):
ResNet-50/101/152 (bottleneck blocks) and ``resnet_cifar10`` (basic
blocks), as ``bench.py`` builds them — a dense ``image`` data layer of
``3·H·W`` floats and an integer ``label``, the network, and a
classification cost.

The blocks are the JAX package's config-DSL calls made through the
port's DSL, so a config built here dumps to the same JSON as the JAX
package's and parameters carry across by name.
"""

from __future__ import annotations

from typing import Callable

from ..config import dsl
from ..config.dsl import (AvgPooling, LinearActivation, MaxPooling,
                          ReluActivation, SoftmaxActivation)
from ..config.model_config import ModelConfig
from ..data.feeder import dense_vector, integer_value


def _conv(net, fs, nf, stride=1, pad=None, channels=None, act=None,
          groups=1):
    return dsl.img_conv(net, filter_size=fs, num_filters=nf, stride=stride,
                        padding=fs // 2 if pad is None else pad,
                        num_channels=channels, groups=groups,
                        act=act or ReluActivation())


def _pool(net, size=3, stride=2, pad=0, avg=False):
    return dsl.img_pool(net, pool_size=size, stride=stride, padding=pad,
                        pool_type=AvgPooling() if avg else MaxPooling())


def fc(net, size: int, act: str = ""):
    """``dsl.fc`` (bias on) with the activation named."""
    return dsl.fc(net, size=size, act=dsl.Activation(act))


def _bn_conv(net, fs, nf, stride=1, pad=None, channels=None,
             act=None, linear=False):
    c = _conv(net, fs, nf, stride, pad, channels=channels,
              act=LinearActivation())
    return dsl.batch_norm(c, act=LinearActivation() if linear
                          else (act or ReluActivation()))


def _shortcut(net, out_ch, stride):
    if getattr(net, "channels", None) != out_ch or stride != 1:
        return _bn_conv(net, 1, out_ch, stride, 0, linear=True)
    return net


def _residual(short, main):
    out = dsl.addto([short, main], act=ReluActivation())
    out.channels = main.channels
    out.img_size = main.img_size
    out.img_size_y = main.img_size_y
    return out


def _basic_block(net, ch, stride):
    short = _shortcut(net, ch, stride)
    c1 = _bn_conv(net, 3, ch, stride, 1)
    c2 = _bn_conv(c1, 3, ch, 1, 1, linear=True)
    return _residual(short, c2)


def _bottleneck(net, ch, stride):
    short = _shortcut(net, ch * 4, stride)
    c1 = _bn_conv(net, 1, ch, stride, 0)
    c2 = _bn_conv(c1, 3, ch, 1, 1)
    c3 = _bn_conv(c2, 1, ch * 4, 1, 0, linear=True)
    return _residual(short, c3)


def resnet_cifar10_body(img, num_classes: int = 10, depth: int = 32):
    """``test_image_classification_train.py:13`` resnet_cifar10:
    6n+2 layers of basic blocks over 16/32/64 channels."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    net = _bn_conv(img, 3, 16, 1, 1, channels=3)
    for ch, first_stride in ((16, 1), (32, 2), (64, 2)):
        for i in range(n):
            net = _basic_block(net, ch, first_stride if i == 0 else 1)
    net = _pool(net, 8, 1, 0, avg=True)
    return dsl.fc(net, size=num_classes, act=SoftmaxActivation())


def resnet_body(img, num_classes: int = 1000, depth: int = 50):
    """``model_zoo/resnet``: ImageNet ResNet-50/101/152 (bottlenecks)."""
    cfg = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[depth]
    net = _bn_conv(img, 7, 64, 2, 3, channels=3)
    net = _pool(net, 3, 2, 1)
    for stage, blocks in enumerate(cfg):
        ch = 64 * (2 ** stage)
        for i in range(blocks):
            stride = 2 if stage > 0 and i == 0 else 1
            net = _bottleneck(net, ch, stride)
    net = _pool(net, 7, 1, 0, avg=True)
    return dsl.fc(net, size=num_classes, act=SoftmaxActivation())


def image_classifier(body: Callable, img_size: int,
                     num_classes: int) -> ModelConfig:
    """data ``image`` (``3·img_size²`` dense floats), ``label``,
    ``body(image, num_classes)`` → softmax probabilities, and the
    classification cost: the topology of ``bench.py``'s image rows."""
    with dsl.config_scope():
        img = dsl.data("image", dense_vector(3 * img_size * img_size),
                       height=img_size, width=img_size)
        lab = dsl.data("label", integer_value(num_classes))
        cost = dsl.classification_cost(body(img, num_classes), lab)
        return dsl.topology(cost)


def resnet(depth: int = 50, num_classes: int = 1000,
           img_size: int = 224) -> ModelConfig:
    """``bench.py``'s ResNet row as a ModelConfig."""
    return image_classifier(
        lambda img, k: resnet_body(img, k, depth), img_size, num_classes)


def resnet_cifar10(depth: int = 32, num_classes: int = 10,
                   img_size: int = 32) -> ModelConfig:
    """``resnet_cifar10`` (``bench.py``'s small image config) as a
    ModelConfig."""
    return image_classifier(
        lambda img, k: resnet_cifar10_body(img, k, depth), img_size,
        num_classes)
