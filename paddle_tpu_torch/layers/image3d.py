"""3-D image layers (counterpart of ``paddle_tpu/layers/image3d.py``):
``conv3d``, ``deconv3d`` and ``pool3d``.

Reference: ``Conv3DLayer``, ``DeConv3DLayer`` and ``Pool3DLayer``
(``paddle/gserver/layers/*3DLayer.cpp``).  Geometry attrs are the 3-D
extensions of ``ConvConfig``/``PoolConfig`` (``filter_size_z`` /
``stride_z`` / ``padding_z``, ``img_size_z``).  Activations are NDHWC; a
flat ``[B, C·D·H·W]`` row is read in CDHW order.  Weights are
``[fz, fy, fx, c/g, nf]`` (``conv3d``) and ``[fz, fy, fx, nf, c]``
(``deconv3d``).

``deconv3d`` takes ``nn_ops.conv3d_transpose``'s sizes, which are
``lax.conv_transpose``'s with explicit pads: (i − 1)·s + 2p − k + 2 a
side, not what the config DSL declares (its forward formula).
"""

from __future__ import annotations

import torch

from ..core.sequence import like, value_of
from ..ops import nn_ops
from ..utils import PaddleTpuError
from .base import Layer, register_layer
from .conv import conv_out_size


def to_ndhwc(v: torch.Tensor, channels: int, depth: int, height: int,
             width: int) -> torch.Tensor:
    """Accept ``[B, C·D·H·W]`` flat rows (reference layout) or NDHWC."""
    if v.dim() == 2:
        return torch.movedim(v.reshape(v.shape[0], channels, depth, height,
                                       width), 1, -1).contiguous()
    if v.dim() == 5:
        return v
    raise PaddleTpuError(f"cannot interpret 3-D image input of rank {v.dim()}")


class _Img3DLayer(Layer):
    def geo(self, key: str, default=None):
        val = self.conf.attrs.get(key, default)
        if val is None:
            raise PaddleTpuError(
                f"layer {self.name}: missing 3-D attr {key!r}")
        return val

    def _triple(self, key: str, default):
        """(z, y, x) from the attrs ``key_z`` / ``key_y`` / ``key``."""
        base = self.conf.attrs.get(key, default)
        return (self.conf.attrs.get(key + "_z", base),
                self.conf.attrs.get(key + "_y", base), base)

    def _input(self, inputs):
        a = self.conf.attrs
        return to_ndhwc(value_of(inputs[0]), self.geo("channels"),
                        self.geo("img_size_z", a.get("depth")),
                        self.geo("img_size_y", a.get("img_size")),
                        self.geo("img_size"))

    def _filter_specs(self, shape):
        specs = [self._weight_spec(0, shape, initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((self.geo("num_filters"),)))
        return specs


@register_layer("conv3d")
class Conv3DLayer(_Img3DLayer):
    def param_specs(self):
        groups = self.conf.attrs.get("groups", 1)
        return self._filter_specs((*self._triple("filter_size", None),
                                   self.geo("channels") // groups,
                                   self.geo("num_filters")))

    def forward(self, params, inputs, ctx):
        out = nn_ops.conv3d(self._input(inputs), params[self.weight_name(0)],
                            stride=self._triple("stride", 1),
                            padding=[(p, p) for p in
                                     self._triple("padding", 0)])
        if self.conf.with_bias:
            out = out + params[self.bias_name()]
        return self.finalize(like(inputs[0], out), ctx)


@register_layer("deconv3d")
class DeConv3DLayer(_Img3DLayer):
    def param_specs(self):
        return self._filter_specs((*self._triple("filter_size", None),
                                   self.geo("num_filters"),
                                   self.geo("channels")))

    def forward(self, params, inputs, ctx):
        out = nn_ops.conv3d_transpose(
            self._input(inputs), params[self.weight_name(0)],
            stride=self._triple("stride", 1),
            padding=[(p, p) for p in self._triple("padding", 0)])
        if self.conf.with_bias:
            out = out + params[self.bias_name()]
        return self.finalize(like(inputs[0], out), ctx)


@register_layer("pool3d")
class Pool3DLayer(_Img3DLayer):
    def forward(self, params, inputs, ctx):
        kind = "max" if "max" in self.geo("pool_type", "max-projection") \
            else "avg"
        out = nn_ops.pool3d(self._input(inputs), kind,
                            window=self._triple("pool_size", 2),
                            stride=self._triple("stride", 2),
                            padding=self._triple("padding", 0))
        return self.finalize(like(inputs[0], out), ctx)


def conv3d_out_shape(d, h, w, filt, pad, stride, caffe_mode=True):
    """Output (D, H, W) for a z/y/x triple of filter/pad/stride."""
    return tuple(conv_out_size(i, f, p, s, caffe_mode)
                 for i, f, p, s in zip((d, h, w), filt, pad, stride))
