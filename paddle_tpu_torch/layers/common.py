"""Dense and glue layers (counterpart of ``paddle_tpu/layers/common.py``):
data, fc (``mkldnn_fc``), embedding, addto, concat, ``mixed`` with its
eight projections and two operators, ``concat2``, and the parameter-free
dense types (interpolation, out_prod, power, scaling, slope_intercept,
convex_comb, cos, cos_vm, sum_to_one_norm, row_l2_norm, trans, resize,
clip, multiplex, dot_prod, featmap_expand, conv_shift), and the types
that own parameters or sample: tensor, selective_fc, prelu,
scale_shift, data_norm, hsigmoid, nce, print.  Layer type strings match
the reference's registered names.

Each layer reaches :meth:`~paddle_tpu_torch.layers.base.Layer.finalize`
(activation, dropout, error clip) exactly where its JAX counterpart
does: cos, cos_vm, sum_to_one_norm, row_l2_norm, trans, resize, clip,
multiplex, dot_prod, featmap_expand, selective_fc (its activation
inside the op), prelu, data_norm, hsigmoid and nce return their value
as it is, as there.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.sequence import SequenceBatch, like, value_of
from ..ops import embedding_ops, math_ops, nn_ops, sequence_ops
from ..parallel import sparse as psparse
from ..utils import PaddleTpuError, enforce
from .base import Layer, register_layer
from .conv import to_nhwc


def map_value(fn, x):
    return like(x, fn(value_of(x)))


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


@register_layer("fc", "mkldnn_fc")
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
        if self.conf.active_type == "softmax" and self.conf.drop_rate == 0:
            # expose the pre-activation as '.logits' so a classification
            # cost can take the fused logits path
            return {"out": self.finalize(out, ctx), "logits": out}
        return self.finalize(out, ctx)


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
        return self.finalize(like(inputs[0], out), ctx)


def _add_flat_bias(out: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Add a per-element bias stored in the reference's flat CHW order to
    an output that may be in NHWC image layout (googlenet's inception
    ``concat_layer(bias_attr=True)`` owns a bias of size C*H*W)."""
    if out.dim() == 4 and bias.dim() == 1 \
            and bias.numel() == out.shape[1] * out.shape[2] * out.shape[3]:
        _, h, w, c = out.shape
        bias = torch.movedim(bias.reshape(c, h, w), 0, -1)
    return out + bias


@register_layer("addto")
class AddtoLayer(Layer):
    """``AddtoLayer``: the sum of its inputs (+ bias), then the
    activation (the residual join of ResNet)."""

    def param_specs(self):
        return [self._bias_spec((self.conf.size,))] \
            if self.conf.with_bias else []

    def forward(self, params, inputs, ctx):
        out = value_of(inputs[0])
        for x in inputs[1:]:
            out = out + value_of(x)
        if self.conf.with_bias:
            out = _add_flat_bias(out, params[self.bias_name()])
        return self.finalize(like(inputs[0], out), ctx)


@register_layer("concat")
class ConcatLayer(Layer):
    """Concatenation of its inputs along the feature axis (+ bias), then
    the activation."""

    def param_specs(self):
        return [self._bias_spec((self.conf.size,))] \
            if self.conf.with_bias else []

    def forward(self, params, inputs, ctx):
        out = torch.cat([value_of(x) for x in inputs], dim=-1)
        if self.conf.with_bias:
            out = _add_flat_bias(out, params[self.bias_name()])
        return self.finalize(like(inputs[0], out), ctx)


def _per_sample_conv(op: Dict[str, Any], a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """``ConvOperator``: image rows ``a`` convolved with a filter of each
    sample's own (``b``'s row, ``[num_filters, C, fh, fw]`` flattened;
    ``ConvOperator.cpp:61``, ``:72``) → flat CHW rows.  One grouped
    convolution over the batch: the samples become the groups."""
    c = op["channels"]
    h = op.get("img_size_y", op.get("img_size"))
    w = op.get("img_size")
    fh = op.get("filter_size_y", op["filter_size"])
    fw = op["filter_size"]
    nf = op["num_filters"]
    x = to_nhwc(a, c, h, w)                         # [B, H, W, C]
    n = x.shape[0]
    # samples side by side on the channel axis: [1, H, W, B*C]
    xs = torch.movedim(x, 0, 2).reshape(1, x.shape[1], x.shape[2], n * c)
    # HWIO with the output channels grouped by sample: [fh, fw, C, B*nf]
    filt = b.reshape(n, nf, c, fh, fw).permute(3, 4, 2, 0, 1) \
        .reshape(fh, fw, c, n * nf)
    stride = (op.get("stride_y", op.get("stride", 1)), op.get("stride", 1))
    padding = [(op.get("padding_y", op.get("padding", 0)),) * 2,
               (op.get("padding", 0),) * 2]
    y = nn_ops.conv2d(xs, filt, stride=stride, padding=padding, groups=n)
    oh, ow = y.shape[1], y.shape[2]
    y = y.reshape(oh, ow, n, nf)                    # [H', W', B, nf]
    # flat rows are channel-major (CHW) like every image layer here
    return y.permute(2, 3, 0, 1).reshape(n, -1)


@register_layer("mixed")
class MixedLayer(Layer):
    """``MixedLayer``: the sum of per-input projections (fc, trans_fc,
    identity, dot_mul, scaling, table, context, slice) and operators
    (``dot_mul``, ``conv`` with one filter per sample) over the inputs
    that carry no projection, + bias, then the activation.  A context
    projection makes the output a sequence with its input's lengths."""

    def param_specs(self):
        specs = []
        for i, inp in enumerate(self.conf.inputs):
            p = inp.proj
            if p is None:
                continue
            # the conf.size fallback holds for a sum of projections,
            # where every projection's output is the layer's size
            psize = p.resolved_output_size() or self.conf.size
            if p.type in ("fc", "table"):
                specs.append(self._weight_spec(
                    i, (p.input_size, psize), initial_smart=True))
            elif p.type == "trans_fc":
                # TransposedFullMatrixProjection: W [out, in], applied
                # transposed
                specs.append(self._weight_spec(
                    i, (psize, p.input_size), initial_smart=True))
            elif p.type == "dot_mul":
                specs.append(self._weight_spec(
                    i, (psize,), initial_mean=1.0, initial_std=0.0))
            elif p.type == "scaling":
                specs.append(self._weight_spec(
                    i, (1,), initial_mean=1.0, initial_std=0.0))
            elif p.type == "context" and p.trainable_padding:
                begin = max(0, -p.context_start)
                end = max(0, p.context_start + p.context_length - 1)
                specs.append(self._weight_spec(
                    i, (begin + end, p.input_size)))
        if self.conf.with_bias:
            specs.append(self._bias_spec((self.conf.size,)))
        return specs

    def _project(self, params, inputs, i):
        """Input ``i``'s projection → ``(y, template)``; template is the
        input when the projection dictates the sequence (context), else
        None."""
        x = inputs[i]
        p = self.conf.inputs[i].proj
        v = value_of(x)
        template = None
        if p.type == "fc":
            w = params[self.weight_name(i)]
            y = value_of(_flat_apply(lambda t: math_ops.matmul(t, w), x))
        elif p.type == "trans_fc":
            w = params[self.weight_name(i)]
            y = value_of(_flat_apply(lambda t: math_ops.matmul(t, w.T), x))
        elif p.type == "identity":
            y = v
        elif p.type == "dot_mul":
            y = v * params[self.weight_name(i)]
        elif p.type == "scaling":
            y = v * params[self.weight_name(i)][0]
        elif p.type == "table":
            y = embedding_ops.lookup_table(params[self.weight_name(i)], v)
        elif p.type == "context":
            enforce(isinstance(x, SequenceBatch),
                    "context projection needs a sequence input")
            pad_w = params.get(self.weight_name(i)) \
                if p.trainable_padding else None
            y = sequence_ops.context_projection(
                x, p.context_start, p.context_length, pad_w).data
            template = x
        elif p.type == "slice":
            slices = p.slices or [(p.slice_begin, p.slice_end)]
            y = torch.cat([v[..., b:e] for b, e in slices], dim=-1)
        else:
            raise PaddleTpuError(f"unknown projection type {p.type!r}")
        return y, template

    def forward(self, params, inputs, ctx):
        out = None
        template = inputs[0]
        for i in range(len(inputs)):
            if self.conf.inputs[i].proj is None:    # an operator's input,
                continue                            # read below
            y, tmpl = self._project(params, inputs, i)
            if tmpl is not None:
                template = tmpl
            out = y if out is None else out + y
        if self.conf.attrs.get("dot_mul_operator"):
            out = value_of(inputs[0]) * value_of(inputs[1]) * \
                self.conf.attrs.get("dotmul_scale", 1.0)
        for op in self.conf.attrs.get("operators", []):
            out = self._apply_operator(op, inputs, out)
        if self.conf.with_bias:
            out = out + params[self.bias_name()]
        return self.finalize(like(template, out), ctx)

    @staticmethod
    def _apply_operator(op: Dict[str, Any], inputs, out):
        """An operator inside a mixed layer (``DotMulOperator``,
        ``ConvOperator``): it reads other inputs' values and owns no
        parameter."""
        kind = op["type"]
        ia, ib = op.get("input_indices", (0, 1))
        a = value_of(inputs[ia])
        b = value_of(inputs[ib])
        if kind == "dot_mul":
            y = a * b * op.get("scale", 1.0)
        elif kind == "conv":
            y = _per_sample_conv(op, a, b)
        else:
            raise PaddleTpuError(f"unknown mixed operator {kind!r}")
        return y if out is None else out + y


@register_layer("concat2")
class Concat2Layer(MixedLayer):
    """``concat2``: each input through its own projection, the outputs
    concatenated instead of summed (``ConcatenateLayer2``,
    ``paddle/gserver/layers/ConcatenateLayer.cpp:99``)."""

    def param_specs(self):
        total = 0
        for i, inp in enumerate(self.conf.inputs):
            enforce(inp.proj is not None,
                    f"concat2 layer {self.conf.name!r} input {i} has no "
                    "projection")
            psize = inp.proj.resolved_output_size()
            enforce(psize > 0,
                    f"concat2 layer {self.conf.name!r} input {i}: "
                    f"{inp.proj.type} projection needs an explicit size")
            total += psize
        enforce(total == self.conf.size,
                f"concat2 layer {self.conf.name!r} size {self.conf.size} != "
                f"sum of projection outputs {total}")
        return super().param_specs()

    def forward(self, params, inputs, ctx):
        outs = []
        template = inputs[0]
        for i in range(len(inputs)):
            y, tmpl = self._project(params, inputs, i)
            if tmpl is not None:
                template = tmpl
            outs.append(y)
        out = torch.cat(outs, dim=-1)
        if self.conf.with_bias:
            out = out + params[self.bias_name()]
        return self.finalize(like(template, out), ctx)


@register_layer("interpolation")
class InterpolationLayer(Layer):
    def forward(self, params, inputs, ctx):
        w, x, y = (value_of(i) for i in inputs)
        return self.finalize(
            like(inputs[1], math_ops.interpolation(w, x, y)), ctx)


@register_layer("out_prod")
class OuterProdLayer(Layer):
    def forward(self, params, inputs, ctx):
        return self.finalize(like(inputs[0], math_ops.outer_prod(
            value_of(inputs[0]), value_of(inputs[1]))), ctx)


@register_layer("power")
class PowerLayer(Layer):
    """out = x ^ w with a per-row scalar exponent w (first input)."""

    def forward(self, params, inputs, ctx):
        w = value_of(inputs[0]).reshape(-1, 1)
        x = value_of(inputs[1])
        return self.finalize(like(inputs[1], torch.pow(x, w)), ctx)


@register_layer("scaling")
class ScalingLayer(Layer):
    """Row-wise scale: the first input (one scalar per row or timestep)
    times the second; a sequence stays a sequence."""

    def forward(self, params, inputs, ctx):
        w = value_of(inputs[0])
        x = value_of(inputs[1])
        if w.dim() != x.dim():
            w = w.reshape(tuple(w.shape) + (1,) * (x.dim() - w.dim()))
        return self.finalize(like(inputs[1], w * x), ctx)


@register_layer("slope_intercept")
class SlopeInterceptLayer(Layer):
    def forward(self, params, inputs, ctx):
        out = math_ops.slope_intercept(
            value_of(inputs[0]), self.conf.attrs.get("slope", 1.0),
            self.conf.attrs.get("intercept", 0.0))
        return self.finalize(like(inputs[0], out), ctx)


@register_layer("convex_comb")
class ConvexCombinationLayer(Layer):
    def forward(self, params, inputs, ctx):
        return self.finalize(like(inputs[1], math_ops.convex_combination(
            value_of(inputs[0]), value_of(inputs[1]))), ctx)


@register_layer("cos")
class CosSimLayer(Layer):
    def forward(self, params, inputs, ctx):
        out = math_ops.cos_sim(value_of(inputs[0]), value_of(inputs[1]),
                               scale=self.conf.attrs.get("cos_scale", 1.0))
        return like(inputs[0], out.reshape(-1, 1))


@register_layer("cos_vm")
class CosSimVecMatLayer(Layer):
    """Cosine of vec ``[B, D]`` against each row of mat ``[B, K*D]`` →
    ``[B, K]``."""

    def forward(self, params, inputs, ctx):
        vec = value_of(inputs[0])
        mat = value_of(inputs[1])
        b, d = vec.shape
        m = mat.reshape(b, mat.shape[1] // d, d)
        dot = math_ops.einsum("bd,bkd->bk", vec, m)
        nv = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
        nm = torch.linalg.vector_norm(m, dim=-1)
        out = self.conf.attrs.get("cos_scale", 1.0) * dot / (nv * nm + 1e-10)
        return like(inputs[0], out)


@register_layer("sum_to_one_norm")
class SumToOneNormLayer(Layer):
    def forward(self, params, inputs, ctx):
        return map_value(math_ops.sum_to_one_norm, inputs[0])


@register_layer("row_l2_norm")
class RowL2NormLayer(Layer):
    def forward(self, params, inputs, ctx):
        return map_value(math_ops.row_l2_norm, inputs[0])


@register_layer("trans")
class TransLayer(Layer):
    def forward(self, params, inputs, ctx):
        return like(inputs[0], value_of(inputs[0]).transpose(-1, -2))


@register_layer("resize")
class ResizeLayer(Layer):
    def forward(self, params, inputs, ctx):
        return like(inputs[0],
                    value_of(inputs[0]).reshape(-1, self.conf.size))


@register_layer("clip")
class ClipLayer(Layer):
    def forward(self, params, inputs, ctx):
        return map_value(
            lambda v: torch.clamp(v, self.conf.attrs.get("min", -1.0),
                                  self.conf.attrs.get("max", 1.0)),
            inputs[0])


@register_layer("multiplex")
class MultiplexLayer(Layer):
    def forward(self, params, inputs, ctx):
        idx = value_of(inputs[0]).reshape(-1)
        return like(inputs[1], math_ops.multiplex(
            idx, *[value_of(x) for x in inputs[1:]]))


@register_layer("dot_prod")
class DotProdLayer(Layer):
    def forward(self, params, inputs, ctx):
        out = torch.sum(value_of(inputs[0]) * value_of(inputs[1]), dim=-1,
                        keepdim=True)
        return like(inputs[0], out)


@register_layer("featmap_expand")
class FeatureMapExpandLayer(Layer):
    def forward(self, params, inputs, ctx):
        return map_value(lambda v: nn_ops.feature_map_expand(
            v, self.conf.attrs["num_filters"],
            self.conf.attrs.get("as_row_vector", True)), inputs[0])


@register_layer("conv_shift")
class ConvShiftLayer(Layer):
    """Circular convolution of each row of a with the kernel row b
    (``ConvShiftLayer.cpp``; NTM addressing): b's width must be odd."""

    def forward(self, params, inputs, ctx):
        out = math_ops.conv_shift(value_of(inputs[0]), value_of(inputs[1]))
        return self.finalize(like(inputs[0], out), ctx)


@register_layer("selective_fc")
class SelectiveFcLayer(Layer):
    """``SelectiveFullyConnectedLayer``: with a second input of ids ``[B,
    K]``, only those output columns (``[B, K]``); else a plain fc.  The
    activation is applied inside the op, and no dropout or error clip,
    as in the JAX layer."""

    def param_specs(self):
        in_size = self.model.find_size(self.conf.inputs[0].input_layer_name)
        specs = [self._weight_spec(0, (in_size, self.conf.size),
                                   initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((self.conf.size,)))
        return specs

    def forward(self, params, inputs, ctx):
        sel = value_of(inputs[1]).to(torch.int32) if len(inputs) > 1 \
            else None
        out = embedding_ops.selective_fc(
            value_of(inputs[0]), params[self.weight_name(0)],
            params[self.bias_name()] if self.conf.with_bias else None,
            sel, act=self.conf.active_type or "linear")
        return like(inputs[0], out)


@register_layer("scale_shift")
class ScaleShiftLayer(Layer):
    """x · w + b with one learned scalar each (w starts at 1)."""

    def param_specs(self):
        specs = [self._weight_spec(0, (1,), initial_mean=1.0,
                                   initial_std=0.0)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((1,)))
        return specs

    def forward(self, params, inputs, ctx):
        out = value_of(inputs[0]) * params[self.weight_name(0)][0]
        if self.conf.with_bias:
            out = out + params[self.bias_name()][0]
        return self.finalize(like(inputs[0], out), ctx)


@register_layer("prelu")
class ParameterReluLayer(Layer):
    """Parametric ReLU: one learned slope (starting at 0.25) for each
    ``partial_sum`` neighbouring features; no activation, as in the JAX
    layer."""

    def param_specs(self):
        n = self.conf.size // self.conf.attrs.get("partial_sum", 1)
        return [self._weight_spec(0, (n,), initial_mean=0.25,
                                  initial_std=0.0)]

    def forward(self, params, inputs, ctx):
        v = value_of(inputs[0])
        a = torch.repeat_interleave(params[self.weight_name(0)],
                                    self.conf.attrs.get("partial_sum", 1)
                                    )[:v.shape[-1]]
        return like(inputs[0], torch.where(v >= 0, v, a * v))


@register_layer("tensor")
class TensorLayer(Layer):
    """``TensorLayer``: out_k = x1 W_k x2ᵀ for each output unit k, W
    ``[size, d1, d2]``, through ``math_ops.einsum``."""

    def param_specs(self):
        d1 = self.model.find_size(self.conf.inputs[0].input_layer_name)
        d2 = self.model.find_size(self.conf.inputs[1].input_layer_name)
        specs = [self._weight_spec(0, (self.conf.size, d1, d2),
                                   initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((self.conf.size,)))
        return specs

    def forward(self, params, inputs, ctx):
        out = math_ops.einsum("bi,kij,bj->bk", value_of(inputs[0]),
                              params[self.weight_name(0)],
                              value_of(inputs[1]))
        if self.conf.with_bias:
            out = out + params[self.bias_name()]
        return self.finalize(like(inputs[0], out), ctx)


@register_layer("nce")
class NCELayer(Layer):
    """Noise-contrastive estimation cost ``[B, 1]`` (``NCELayer``) with
    ``num_neg_samples`` negatives a row drawn uniformly over the classes
    from the layer's own generator (:meth:`ForwardContext.layer_rng`)."""

    def param_specs(self):
        d = self.model.find_size(self.conf.inputs[0].input_layer_name)
        num_classes = self.conf.attrs["num_classes"]
        specs = [self._weight_spec(0, (num_classes, d), initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((num_classes,)))
        return specs

    def forward(self, params, inputs, ctx):
        x = value_of(inputs[0])
        labels = value_of(inputs[1]).reshape(-1)
        num_classes = self.conf.attrs["num_classes"]
        num_neg = self.conf.attrs.get("num_neg_samples", 10)
        sample_ids = torch.randint(
            0, num_classes, (x.shape[0], num_neg),
            generator=ctx.layer_rng(self.name, x.device), device=x.device)
        probs = torch.full((x.shape[0], num_neg), 1.0 / num_classes,
                           device=x.device)
        b = params[self.bias_name()] if self.conf.with_bias else \
            torch.zeros(num_classes, dtype=x.dtype, device=x.device)
        cost = embedding_ops.nce_loss(x, labels, params[self.weight_name(0)],
                                      b, sample_ids, probs)
        return like(inputs[0], cost.reshape(-1, 1))


@register_layer("hsigmoid")
class HierarchicalSigmoidLayer(Layer):
    """Hierarchical sigmoid cost ``[B, 1]`` over ``num_classes - 1``
    inner nodes."""

    def param_specs(self):
        d = self.model.find_size(self.conf.inputs[0].input_layer_name)
        n = self.conf.attrs["num_classes"] - 1
        specs = [self._weight_spec(0, (n, d), initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((n,)))
        return specs

    def forward(self, params, inputs, ctx):
        x = value_of(inputs[0])
        num_classes = self.conf.attrs["num_classes"]
        b = params[self.bias_name()] if self.conf.with_bias else \
            torch.zeros(num_classes - 1, dtype=x.dtype, device=x.device)
        cost = embedding_ops.hierarchical_sigmoid(
            x, value_of(inputs[1]).reshape(-1), params[self.weight_name(0)],
            b, num_classes)
        return like(inputs[0], cost.reshape(-1, 1))


@register_layer("data_norm")
class DataNormLayer(Layer):
    """Normalisation with fixed statistics from ``attrs``
    (``DataNormLayer``): ``z-score`` (mean, std), ``min-max`` (min, max)
    or decimal scaling (a)."""

    def forward(self, params, inputs, ctx):
        v = value_of(inputs[0])
        attrs = self.conf.attrs

        def stat(key, default):
            return torch.as_tensor(attrs.get(key, default), dtype=v.dtype,
                                   device=v.device)

        strategy = attrs.get("data_norm_strategy", "z-score")
        if strategy == "z-score":
            out = (v - stat("mean", 0.0)) / torch.clamp(stat("std", 1.0),
                                                        min=1e-8)
        elif strategy == "min-max":
            mn = stat("min", 0.0)
            out = (v - mn) / torch.clamp(stat("max", 1.0) - mn, min=1e-8)
        else:                                       # decimal-scaling
            out = v / stat("a", 1.0)
        return like(inputs[0], out)


@register_layer("print")
class PrintLayer(Layer):
    """Writes ``name: value`` to stdout from the host (``PrintLayer``);
    its output is its input."""

    def forward(self, params, inputs, ctx):
        print(f"{self.name}: {value_of(inputs[0]).detach().cpu().numpy()}",
              flush=True)
        return inputs[0]
