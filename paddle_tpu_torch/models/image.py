"""Image model configurations (counterpart of
``paddle_tpu/models/image.py``): ResNet-50/101/152 (bottleneck blocks)
and ``resnet_cifar10`` (basic blocks), as ``bench.py`` builds them —
a dense ``image`` data layer of ``3·H·W`` floats and an integer
``label``, the network, and a classification cost.

The JAX package builds these through its config DSL; this module writes
out the few DSL calls they use (``data``, ``img_conv``, ``img_pool``,
``batch_norm``, ``addto``, ``fc``, ``classification_cost``,
``topology``) with the DSL's naming — unnamed layers are
``__<type>_<k>__``, k counting unnamed layers in creation order — and
its geometry attributes, so a config built here dumps to the same JSON
as the JAX package's and parameters carry across by name.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..config.model_config import LayerConfig, LayerInput, ModelConfig
from ..layers.conv import conv_out_size


class _Out:
    """A layer handle, as the DSL's ``LayerOutput``: name, size and the
    image geometry the next layer reads (absent on a data layer)."""

    def __init__(self, builder: "_Builder", name: str, size: int):
        self.b = builder
        self.name = name
        self.size = size


class _Builder:
    """Collects layer configs in creation order (the DSL's collector)."""

    def __init__(self):
        self.by_name: Dict[str, LayerConfig] = {}
        self.counter = 0

    def add(self, name: Optional[str], ltype: str, size: int,
            inputs: List[_Out], act: str = "", with_bias: bool = False,
            attrs: Optional[Dict] = None) -> _Out:
        if name is None:
            self.counter += 1
            name = f"__{ltype}_{self.counter}__"
        self.by_name[name] = LayerConfig(
            name=name, type=ltype, size=size, active_type=act,
            inputs=[LayerInput(input_layer_name=i.name) for i in inputs],
            with_bias=with_bias, attrs=attrs or {})
        return _Out(self, name, size)

    def data(self, name: str, dim: int, height: int = 0, width: int = 0,
             kind: str = "dense") -> _Out:
        return self.add(name, "data", dim,
                        [], attrs={"height": height, "width": width,
                                   "seq_level": 0, "kind": kind})

    def topology(self, out: _Out) -> ModelConfig:
        """The subgraph reaching ``out``, in the DSL's depth-first order."""
        needed: List[str] = []
        seen = set()

        def visit(name: str) -> None:
            if name in seen:
                return
            seen.add(name)
            for i in self.by_name[name].inputs:
                visit(i.input_layer_name)
            needed.append(name)

        visit(out.name)
        layers = [self.by_name[n] for n in needed]
        return ModelConfig(layers=layers,
                           input_layer_names=[l.name for l in layers
                                              if l.type == "data"],
                           output_layer_names=[out.name])


# ------------------------------------------------------------ DSL calls
def img_conv(inp: _Out, filter_size: int, num_filters: int,
             num_channels: Optional[int] = None, stride: int = 1,
             padding: int = 0, act: str = "") -> _Out:
    """``dsl.img_conv`` (exconv with a bias, one group)."""
    c = num_channels or getattr(inp, "channels", 1)
    img = int(round((inp.size / c) ** 0.5))
    out_x = conv_out_size(img, filter_size, padding, stride)
    attrs = {"channels": c, "filter_size": filter_size,
             "num_filters": num_filters, "stride": stride,
             "padding": padding, "groups": 1, "img_size": img,
             "img_size_y": img, "output_x": out_x, "output_y": out_x}
    out = inp.b.add(None, "exconv", num_filters * out_x * out_x, [inp], act,
                    True, attrs)
    out.channels, out.img_size, out.img_size_y = num_filters, out_x, out_x
    return out


def img_pool(inp: _Out, pool_size: int, stride: int = 2, padding: int = 0,
             avg: bool = False) -> _Out:
    """``dsl.img_pool`` (max, or average when ``avg``)."""
    c = getattr(inp, "channels", 1)
    img = getattr(inp, "img_size", int(round((inp.size / c) ** 0.5)))
    img_y = getattr(inp, "img_size_y", img)
    out_x = conv_out_size(img, pool_size, padding, stride)
    out_y = conv_out_size(img_y, pool_size, padding, stride)
    attrs = {"channels": c, "pool_size": pool_size, "stride": stride,
             "padding": padding, "img_size": img, "img_size_y": img_y,
             "pool_type": ("average" if avg else "max") + "-projection"}
    out = inp.b.add(None, "pool", c * out_x * out_y, [inp], "", False,
                    attrs)
    out.channels, out.img_size, out.img_size_y = c, out_x, out_y
    return out


def batch_norm(inp: _Out, act: str = "") -> _Out:
    """``dsl.batch_norm`` (bias on, moving-average fraction 0.9)."""
    c = getattr(inp, "channels", inp.size)
    attrs = {"channels": c, "moving_average_fraction": 0.9}
    if hasattr(inp, "img_size"):
        attrs["img_size"] = inp.img_size
        attrs["img_size_y"] = getattr(inp, "img_size_y", inp.img_size)
    out = inp.b.add(None, "batch_norm", inp.size, [inp], act, True, attrs)
    for a in ("img_size", "img_size_y"):
        if hasattr(inp, a):
            setattr(out, a, getattr(inp, a))
    out.channels = c
    return out


def addto(ins: List[_Out], act: str = "") -> _Out:
    """``dsl.addto`` (no bias)."""
    return ins[0].b.add(None, "addto", ins[0].size, ins, act)


def fc(inp: _Out, size: int, act: str = "") -> _Out:
    """``dsl.fc`` (bias on)."""
    return inp.b.add(None, "fc", size, [inp], act, True)


# ------------------------------------------------------------ blocks
def _conv(net, fs, nf, stride=1, pad=None, channels=None, act="relu"):
    return img_conv(net, fs, nf, num_channels=channels, stride=stride,
                    padding=fs // 2 if pad is None else pad, act=act)


def _pool(net, size=3, stride=2, pad=0, avg=False):
    return img_pool(net, size, stride, pad, avg)


def _bn_conv(net, fs, nf, stride=1, pad=None, channels=None, act="relu",
             linear=False):
    c = _conv(net, fs, nf, stride, pad, channels=channels, act="")
    return batch_norm(c, act="" if linear else act)


def _shortcut(net, out_ch, stride):
    if getattr(net, "channels", None) != out_ch or stride != 1:
        return _bn_conv(net, 1, out_ch, stride, 0, linear=True)
    return net


def _residual(short, main):
    out = addto([short, main], act="relu")
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


# ------------------------------------------------------------ networks
def image_classifier(body: Callable[[_Out, int], _Out], img_size: int,
                     num_classes: int) -> ModelConfig:
    """data ``image`` (``3·img_size²`` dense floats), ``label``,
    ``body(image, num_classes)`` → softmax probabilities, and the
    classification cost: the topology of ``bench.py``'s image rows."""
    b = _Builder()
    img = b.data("image", 3 * img_size * img_size, img_size, img_size)
    lab = b.data("label", num_classes, kind="index")
    probs = body(img, num_classes)
    cost = b.add(None, "multi-class-cross-entropy", 1, [probs, lab],
                 attrs={"coeff": 1.0})
    return b.topology(cost)


def resnet_cifar10_body(img: _Out, num_classes: int, depth: int = 32
                        ) -> _Out:
    """``resnet_cifar10``: 6n+2 layers of basic blocks over 16/32/64
    channels."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    net = _bn_conv(img, 3, 16, 1, 1, channels=3)
    for ch, first_stride in ((16, 1), (32, 2), (64, 2)):
        for i in range(n):
            net = _basic_block(net, ch, first_stride if i == 0 else 1)
    net = _pool(net, 8, 1, 0, avg=True)
    return fc(net, num_classes, act="softmax")


def resnet_body(img: _Out, num_classes: int, depth: int = 50) -> _Out:
    """ImageNet ResNet-50/101/152 (bottleneck blocks)."""
    cfg = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[depth]
    net = _bn_conv(img, 7, 64, 2, 3, channels=3)
    net = _pool(net, 3, 2, 1)
    for stage, blocks in enumerate(cfg):
        ch = 64 * (2 ** stage)
        for i in range(blocks):
            net = _bottleneck(net, ch, 2 if stage > 0 and i == 0 else 1)
    net = _pool(net, 7, 1, 0, avg=True)
    return fc(net, num_classes, act="softmax")


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
