"""Image layers of the ResNet slice (counterpart of
``paddle_tpu/layers/conv.py``): ``exconv`` / ``cudnn_conv`` / ``conv``,
``pool`` and ``batch_norm`` with its running-stat buffers.

Geometry attrs are the reference's ``ConvConfig``/``PoolConfig`` names
(channels, filter_size, stride, padding, num_filters, img_size(_y),
groups, pool_size, output_x/_y).  Activations are NHWC; a flat
``[B, C*H*W]`` input row (the reference's layout, a dense data layer) is
reshaped in CHW order.

A batch norm takes part in the network's fusion peepholes
(:class:`~paddle_tpu_torch.layers.network.NeuralNetwork`) through
:meth:`BatchNormLayer.forward_deferred` (it publishes a
:class:`DeferredBN` for its consuming conv) and
:meth:`BatchNormLayer.forward_fused` (it runs its producing conv).
"""

from __future__ import annotations

import torch

from ..core.sequence import like, value_of
from ..ops import nn_ops
from ..utils import PaddleTpuError
from .base import Layer, register_layer


def conv_out_size(img: int, filt: int, pad: int, stride: int,
                  caffe_mode: bool = True) -> int:
    """``cnn_output_size`` (paddle/math/MathUtil): floor (caffe) or ceil."""
    if caffe_mode:
        return (img + 2 * pad - filt) // stride + 1
    return (img + 2 * pad - filt + stride - 1) // stride + 1


def to_nhwc(v: torch.Tensor, channels: int, height: int,
            width: int) -> torch.Tensor:
    """Accept ``[B, C*H*W]`` flat rows (reference layout) or NHWC.  Flat
    rows are copied into an NHWC tensor: a strided view would make the
    first conv's output, and every elementwise pass over it, strided."""
    if v.dim() == 2:
        return torch.movedim(v.reshape(v.shape[0], channels, height, width),
                             1, -1).contiguous()
    if v.dim() == 4:
        return v
    raise PaddleTpuError(f"cannot interpret image input of rank {v.dim()}")


class _ImgLayer(Layer):
    def geo(self, key: str, default=None):
        val = self.conf.attrs.get(key, default)
        if val is None:
            raise PaddleTpuError(
                f"layer {self.name}: missing conv attr {key!r}")
        return val

    def img_hw(self):
        return (self.geo("img_size_y", self.conf.attrs.get("img_size")),
                self.geo("img_size"))


class DeferredBN:
    """The value a batch norm publishes when its normalize+activation is
    deferred into its consuming conv (forward conv+BN fusion): the raw
    input ``z`` and the folded per-channel affine, so the conv forms
    ``act(a·z + c)`` as it reads its input.  ``act`` / ``training`` gate
    the kernel dispatch."""

    __slots__ = ("z", "a", "c", "act", "training")

    def __init__(self, z, a, c, act: str, training: bool):
        self.z = z
        self.a = a
        self.c = c
        self.act = act
        self.training = training


@register_layer("exconv", "cudnn_conv", "conv")
class ConvLayer(_ImgLayer):
    def param_specs(self):
        c = self.geo("channels")
        f = self.geo("filter_size")
        fy = self.conf.attrs.get("filter_size_y", f)
        nf = self.geo("num_filters")
        groups = self.conf.attrs.get("groups", 1)
        # HWIO layout
        specs = [self._weight_spec(0, (fy, f, c // groups, nf),
                                   initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((nf,)))
        return specs

    def geometry(self):
        """(channels, (h, w) image size, (sy, sx) stride, (py, px) pad,
        groups), shared with the fused conv→BN path."""
        a = self.conf.attrs
        stride = (a.get("stride_y", a.get("stride", 1)), a.get("stride", 1))
        pad = (a.get("padding_y", a.get("padding", 0)), a.get("padding", 0))
        return self.geo("channels"), self.img_hw(), stride, pad, \
            a.get("groups", 1)

    def forward(self, params, inputs, ctx):
        c, (h, w), stride, pad, groups = self.geometry()
        v = value_of(inputs[0])
        padding = [(pad[0], pad[0]), (pad[1], pad[1])]
        if isinstance(v, DeferredBN):
            # the producing batch norm deferred its apply pass into this
            # conv's input (forward conv+BN fusion)
            out = nn_ops.affine_act_conv2d(
                to_nhwc(v.z, c, h, w), v.a, v.c,
                params[self.weight_name(0)], act=v.act,
                is_training=v.training, stride=stride, padding=padding,
                groups=groups)
        else:
            out = nn_ops.conv2d(to_nhwc(v, c, h, w),
                                params[self.weight_name(0)], stride=stride,
                                padding=padding, groups=groups)
        if self.conf.with_bias:
            out = out + params[self.bias_name()]
        return self.finalize(like(inputs[0], out), ctx)


@register_layer("pool")
class PoolLayer(_ImgLayer):
    def forward(self, params, inputs, ctx):
        a = self.conf.attrs
        h, w = self.img_hw()
        x = to_nhwc(value_of(inputs[0]), self.geo("channels"), h, w)
        kind = "max" if "max" in self.geo("pool_type", "max-projection") \
            else "avg"
        window = (a.get("size_y", a.get("pool_size", 2)),
                  a.get("pool_size", 2))
        stride = (a.get("stride_y", a.get("stride", 2)), a.get("stride", 2))
        pad = (a.get("padding_y", a.get("padding", 0)), a.get("padding", 0))
        out = nn_ops.pool2d(x, kind, window=window, stride=stride,
                            padding=list(pad))
        return self.finalize(like(inputs[0], out), ctx)


@register_layer("batch_norm", "cudnn_batch_norm")
class BatchNormLayer(_ImgLayer):
    """Batch normalization with running-stat buffers ``<name>.mean`` and
    ``<name>.var`` (the reference keeps them as non-learnable
    parameters)."""

    def _channels(self) -> int:
        return self.conf.attrs.get("channels", self.conf.size)

    def param_specs(self):
        c = self._channels()
        specs = [self._weight_spec(0, (c,), initial_mean=1.0,
                                   initial_std=0.0)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((c,)))
        return specs

    def buffer_specs(self):
        c = self._channels()
        return {self.name + ".mean": torch.zeros(c),
                self.name + ".var": torch.ones(c)}

    def _args(self, params, ctx, like_t):
        """(scale, bias, running mean, running var, momentum, training)."""
        c = self._channels()
        bias = params.get(self.bias_name())
        if bias is None:
            bias = torch.zeros(c, device=like_t.device)
        rm = ctx.buffers.get(self.name + ".mean")
        rv = ctx.buffers.get(self.name + ".var")
        rm = torch.zeros(c, device=like_t.device) if rm is None else rm
        rv = torch.ones(c, device=like_t.device) if rv is None else rv
        use_global = self.conf.attrs.get("use_global_stats", None)
        training = ctx.is_training if use_global is None else not use_global
        return (params[self.weight_name(0)], bias, rm, rv,
                self.conf.attrs.get("moving_average_fraction", 0.9),
                training)

    def _image(self, v):
        if v.dim() == 2 and self.conf.attrs.get("img_size") is not None:
            h, w = self.img_hw()
            return to_nhwc(v, self._channels(), h, w)
        return v

    def _publish(self, ctx, nrm, nrv):
        ctx.new_buffers[self.name + ".mean"] = nrm
        ctx.new_buffers[self.name + ".var"] = nrv

    def forward(self, params, inputs, ctx):
        img = self._image(value_of(inputs[0]))
        scale, bias, rm, rv, momentum, training = self._args(params, ctx,
                                                             img)
        y, nrm, nrv = nn_ops.batch_norm(img, scale, bias, rm, rv,
                                        momentum=momentum,
                                        is_training=training)
        self._publish(ctx, nrm, nrv)
        return self.finalize(like(inputs[0], y), ctx)

    def forward_deferred(self, params, inputs, ctx):
        """Publish the folded affine instead of applying it (this BN's
        sole consumer is a fusable conv): the raw input z and (a, c);
        the buffers update as in :meth:`forward`."""
        img = self._image(value_of(inputs[0]))
        scale, bias, rm, rv, momentum, training = self._args(params, ctx,
                                                             img)
        a, c, nrm, nrv = nn_ops.bn_folded_affine(
            img, scale, bias, rm, rv, momentum=momentum,
            is_training=training)
        self._publish(ctx, nrm, nrv)
        act = "relu" if self.conf.active_type == "relu" else ""
        return DeferredBN(img, a, c, act, training)

    def forward_fused(self, params, conv, conv_inputs, ctx):
        """Run the fused conv→BN pair: ``conv`` is the producing
        :class:`ConvLayer` (linear), ``conv_inputs`` its inputs.  Exactly
        conv-forward then :meth:`forward`; a :class:`DeferredBN` input
        composes the forward fusion into the pair (the chain op)."""
        c, (h, w), stride, pad, groups = conv.geometry()
        v = value_of(conv_inputs[0])
        in_affine = None
        if isinstance(v, DeferredBN):
            in_affine = (v.a, v.c, v.act)
            v = v.z
        x = to_nhwc(v, c, h, w)
        cw = params[conv.weight_name(0)]
        cb = params.get(conv.bias_name()) if conv.conf.with_bias else None
        scale, bias, rm, rv, momentum, training = self._args(params, ctx, x)
        y, nrm, nrv = nn_ops.conv2d_bn(
            x, cw, cb, scale, bias, rm, rv, momentum=momentum,
            is_training=training, stride=stride,
            padding=[(pad[0], pad[0]), (pad[1], pad[1])], groups=groups,
            in_affine=in_affine)
        self._publish(ctx, nrm, nrv)
        return self.finalize(like(conv_inputs[0], y), ctx)
