"""Image model builders (counterpart of ``paddle_tpu/models/image.py``):
the image benchmark's nets (``benchmark/paddle/image/``'s
``smallnet_mnist_cifar``, ``alexnet``, ``vgg`` 16 / 19 and
``googlenet``), ResNet-50/101/152 (bottleneck blocks) and
``resnet_cifar10`` (basic blocks).  ``*_body(img, num_classes)`` builds
a net over a data layer; :func:`resnet` and :func:`resnet_cifar10` wrap
one as ``bench.py`` builds it — a dense ``image`` data layer of
``3·H·W`` floats and an integer ``label``, the network, and a
classification cost.

The blocks are the JAX package's config-DSL calls made through the
port's DSL, so a config built here dumps to the same JSON as the JAX
package's and parameters carry across by name.
"""

from __future__ import annotations

from typing import Callable

from ..config import dsl
from ..config.dsl import (AvgPooling, ExtraAttr, LinearActivation,
                          MaxPooling, ReluActivation, SoftmaxActivation)
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


def smallnet_body(img, num_classes: int = 10):
    """``smallnet_mnist_cifar.py`` (CIFAR quick): 3 conv + 2 fc."""
    net = _conv(img, 5, 32, 1, 2, channels=3)
    net = _pool(net, 3, 2, 1)
    net = _conv(net, 5, 32, 1, 2)
    net = _pool(net, 3, 2, 1, avg=True)
    net = _conv(net, 3, 64, 1, 1)
    net = _pool(net, 3, 2, 1, avg=True)
    net = dsl.fc(net, size=64, act=ReluActivation())
    return dsl.fc(net, size=num_classes, act=SoftmaxActivation())


def _fc_drop(net, size=4096):
    return dsl.fc(net, size=size, act=ReluActivation(),
                  layer_attr=ExtraAttr(drop_rate=0.5))


def alexnet_body(img, num_classes: int = 1000):
    """``alexnet.py``: 5 conv (LRN after the first two) + 3 fc with
    dropout."""
    net = _conv(img, 11, 96, 4, 1, channels=3)
    net = dsl.img_cmrnorm(net, size=5, scale=0.0001, power=0.75)
    net = _pool(net)
    net = _conv(net, 5, 256, 1, 2)
    net = dsl.img_cmrnorm(net, size=5, scale=0.0001, power=0.75)
    net = _pool(net)
    net = _conv(net, 3, 384, 1, 1)
    net = _conv(net, 3, 384, 1, 1)
    net = _conv(net, 3, 256, 1, 1)
    net = _pool(net)
    net = _fc_drop(_fc_drop(net))
    return dsl.fc(net, size=num_classes, act=SoftmaxActivation())


def vgg_body(img, num_classes: int = 1000, depth: int = 19):
    """``vgg.py``: VGG-16/19 as conv groups + 2 × 4096 fc."""
    from ..v2.networks import img_conv_group
    assert depth in (16, 19)
    reps = 3 if depth == 16 else 4
    net = img
    for i, nf in enumerate((64, 128, 256, 512, 512)):
        net = img_conv_group(net, conv_num_filter=[nf] * (2 if i < 2
                                                          else reps),
                             conv_filter_size=3, conv_act=ReluActivation(),
                             pool_size=2, pool_stride=2,
                             num_channels=3 if i == 0 else None)
    net = _fc_drop(_fc_drop(net))
    return dsl.fc(net, size=num_classes, act=SoftmaxActivation())


def _inception(name, net, channels, f1, f3r, f3, f5r, f5, proj):
    """GoogleNet's inception module (``googlenet.py`` inception2): four
    branches concatenated as ``<name>_concat``."""
    cov1 = _conv(net, 1, f1, 1, 0, channels=channels)
    cov3 = _conv(_conv(net, 1, f3r, 1, 0, channels=channels), 3, f3, 1, 1)
    cov5 = _conv(_conv(net, 1, f5r, 1, 0, channels=channels), 5, f5, 1, 2)
    covprj = _conv(_pool(net, 3, 1, 1), 1, proj, 1, 0)
    out = dsl.concat([cov1, cov3, cov5, covprj], name=f"{name}_concat")
    out.channels = f1 + f3 + f5 + proj
    out.img_size = cov1.img_size
    out.img_size_y = cov1.img_size_y
    out.size = out.channels * out.img_size * out.img_size_y
    return out


#: googlenet's inception modules: (name, in channels, 1x1, 3x3 reduce,
#: 3x3, 5x5 reduce, 5x5, pool projection); a max pool follows 3b and 4e
INCEPTIONS = (("i3a", 192, 64, 96, 128, 16, 32, 32),
              ("i3b", 256, 128, 128, 192, 32, 96, 64),
              ("i4a", 480, 192, 96, 208, 16, 48, 64),
              ("i4b", 512, 160, 112, 224, 24, 64, 64),
              ("i4c", 512, 128, 128, 256, 24, 64, 64),
              ("i4d", 512, 112, 144, 288, 32, 64, 64),
              ("i4e", 528, 256, 160, 320, 32, 128, 128),
              ("i5a", 832, 256, 160, 320, 32, 128, 128),
              ("i5b", 832, 384, 192, 384, 48, 128, 128))


def googlenet_body(img, num_classes: int = 1000):
    """``googlenet.py``: stem + 9 inception modules + avg pool."""
    net = _conv(img, 7, 64, 2, 3, channels=3)
    net = _pool(net, 3, 2, 1)
    net = _conv(net, 1, 64, 1, 0)
    net = _conv(net, 3, 192, 1, 1)
    net = _pool(net, 3, 2, 1)
    for spec in INCEPTIONS:
        net = _inception(spec[0], net, *spec[1:])
        if spec[0] in ("i3b", "i4e"):
            net = _pool(net, 3, 2, 1)
    net = _pool(net, 7, 1, 0, avg=True)
    net = dsl.dropout(net, dropout_rate=0.4)
    return dsl.fc(net, size=num_classes, act=SoftmaxActivation())


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


def smallnet_mnist_cifar(num_classes: int = 10,
                         img_size: int = 32) -> ModelConfig:
    """The image benchmark's ``smallnet`` as a ModelConfig."""
    return image_classifier(smallnet_body, img_size, num_classes)


def alexnet(num_classes: int = 1000, img_size: int = 227) -> ModelConfig:
    """The image benchmark's ``alexnet`` as a ModelConfig."""
    return image_classifier(alexnet_body, img_size, num_classes)


def vgg(depth: int = 19, num_classes: int = 1000,
        img_size: int = 224) -> ModelConfig:
    """The image benchmark's ``vgg`` (VGG-16 or VGG-19) as a
    ModelConfig."""
    return image_classifier(lambda img, k: vgg_body(img, k, depth),
                            img_size, num_classes)


def googlenet(num_classes: int = 1000, img_size: int = 224) -> ModelConfig:
    """The image benchmark's ``googlenet`` as a ModelConfig."""
    return image_classifier(googlenet_body, img_size, num_classes)
