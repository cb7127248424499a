"""Dense / glue layers this slice uses (counterpart of
``paddle_tpu/layers/common.py``): data, fc, embedding.  Layer type
strings match the reference's registered names."""

from __future__ import annotations

from ..core.sequence import like, value_of
from ..ops import embedding_ops, math_ops
from ..utils import PaddleTpuError
from .base import Layer, register_layer


@register_layer("data")
class DataLayer(Layer):
    """Feed entry point; its value comes from the feed dict."""

    def forward(self, params, inputs):
        raise PaddleTpuError("data layers are fed, not computed")


@register_layer("fc")
class FullyConnectedLayer(Layer):
    """``FullyConnectedLayer``: out = act(sum_i x_i W_i + b), W ``[in,
    out]``, the products under the precision policy
    (``math_ops.matmul``); a sequence input is projected at every
    timestep."""

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

    def forward(self, params, inputs):
        out = None
        for i, x in enumerate(inputs):
            y = math_ops.matmul(value_of(x), params[self.weight_name(i)])
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
    """Table lookup ``[V, D]``."""

    def param_specs(self):
        vocab = self.conf.attrs["vocab_size"]
        return [self._weight_spec(
            0, (vocab, self.conf.size), initial_smart=True,
            sharded=self.conf.attrs.get("sharded", False))]

    def forward(self, params, inputs):
        out = embedding_ops.lookup_table(params[self.weight_name(0)],
                                         value_of(inputs[0]))
        return self.finalize(like(inputs[0], out))
