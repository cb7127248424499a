"""Dense / glue layers the ported slices use (counterpart of
``paddle_tpu/layers/common.py``): data, fc, embedding, addto, concat,
scaling.  Layer type strings match the reference's registered names."""

from __future__ import annotations

import torch

from ..core.sequence import SequenceBatch, like, value_of
from ..ops import embedding_ops, math_ops
from ..parallel import sparse as psparse
from ..utils import PaddleTpuError
from .base import Layer, register_layer


def flatten_image(v: torch.Tensor) -> torch.Tensor:
    """NHWC image tensor → flat ``[B, C*H*W]`` rows in the reference's CHW
    element order (so fc weights keep the reference layout)."""
    if v.dim() == 4:
        return torch.movedim(v, -1, 1).reshape(v.shape[0], -1)
    return v.reshape(v.shape[0], -1)


def _flat_apply(fn, x):
    """Apply a ``[N, D] → [N, D']`` function across the batch (and time)
    dims: a sequence per timestep, an image tensor flattened to
    ``[B, C*H*W]`` rows."""
    v = value_of(x)
    if isinstance(x, SequenceBatch) and v.dim() > 2:
        out = fn(v.reshape(-1, v.shape[-1]))
        out = out.reshape(v.shape[:-1] + out.shape[1:])
    elif v.dim() > 2:
        out = fn(flatten_image(v))
    else:
        out = fn(v)
    return like(x, out)


@register_layer("data")
class DataLayer(Layer):
    """Feed entry point; its value comes from the feed dict."""

    def forward(self, params, inputs, ctx):
        raise PaddleTpuError("data layers are fed, not computed")


@register_layer("fc")
class FullyConnectedLayer(Layer):
    """``FullyConnectedLayer``: out = act(sum_i x_i W_i + b), W ``[in,
    out]``, the products under the precision policy
    (``math_ops.matmul``); a sequence input is projected at every
    timestep, an image input flattened to CHW rows first."""

    def param_specs(self):
        specs = []
        for i, inp in enumerate(self.conf.inputs):
            in_size = self.conf.attrs.get(f"input_size{i}") or \
                self.model.find_size(inp.input_layer_name)
            specs.append(self._weight_spec(
                i, (in_size, self.conf.size), initial_smart=True))
        if self.conf.with_bias:
            specs.append(self._bias_spec((self.conf.size,)))
        return specs

    def forward(self, params, inputs, ctx):
        out = None
        for i, x in enumerate(inputs):
            w = params[self.weight_name(i)]
            y = value_of(_flat_apply(lambda v: math_ops.matmul(v, w), x))
            out = y if out is None else out + y
        if self.conf.with_bias:
            # added in the activation dtype, as the JAX package does
            out = out + params[self.bias_name()].to(out.dtype)
        out = like(inputs[0], out)
        if self.conf.active_type == "softmax":
            # expose the pre-activation as '.logits' so a classification
            # cost can take the fused logits path
            return {"out": self.finalize(out), "logits": out}
        return self.finalize(out)


@register_layer("embedding")
class EmbeddingLayer(Layer):
    """Table lookup ``[V, D]``.  Under the trainer's sparse gradient
    exchange the lookup goes through the batch's prefetched ``(rows,
    block)`` pair (``parallel.sparse.exchange_entry``), so autograd
    gives a ``[K, D]`` block gradient instead of the dense table's."""

    def param_specs(self):
        vocab = self.conf.attrs["vocab_size"]
        return [self._weight_spec(
            0, (vocab, self.conf.size), initial_smart=True,
            sharded=self.conf.attrs.get("sharded", False))]

    def forward(self, params, inputs, ctx):
        name = self.weight_name(0)
        ids = value_of(inputs[0])
        entry = psparse.exchange_entry(name)
        if entry is not None:
            rows, block = entry
            out = psparse.lookup_rows(rows, block, ids)
        else:
            out = embedding_ops.lookup_table(params[name], ids)
        return self.finalize(like(inputs[0], out))


@register_layer("addto")
class AddtoLayer(Layer):
    """``AddtoLayer``: the sum of its inputs, then the activation (the
    residual join of ResNet).  A bias is not ported."""

    def forward(self, params, inputs, ctx):
        if self.conf.with_bias:
            raise PaddleTpuError(f"layer {self.name!r}: addto with a bias "
                                 "is not ported")
        out = value_of(inputs[0])
        for x in inputs[1:]:
            out = out + value_of(x)
        return self.finalize(like(inputs[0], out))


@register_layer("concat")
class ConcatLayer(Layer):
    """Concatenation of its inputs along the feature axis, then the
    activation.  A bias is not ported."""

    def forward(self, params, inputs, ctx):
        if self.conf.with_bias:
            raise PaddleTpuError(f"layer {self.name!r}: concat with a bias "
                                 "is not ported")
        out = torch.cat([value_of(x) for x in inputs], dim=-1)
        return self.finalize(like(inputs[0], out))


@register_layer("scaling")
class ScalingLayer(Layer):
    """Row-wise scale: the first input (one scalar per row or timestep)
    times the second; a sequence stays a sequence."""

    def forward(self, params, inputs, ctx):
        w = value_of(inputs[0])
        x = value_of(inputs[1])
        if w.dim() != x.dim():
            w = w.reshape(tuple(w.shape) + (1,) * (x.dim() - w.dim()))
        return self.finalize(like(inputs[1], w * x))
