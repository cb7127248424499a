"""Sequence layers (counterpart of ``paddle_tpu/layers/seq.py``): the
pooling family (``average``, ``max``, ``seqlastins``, ``seqfirstins``;
strided, and over nested sequences), ``expand``, ``seqconcat``,
``seqreshape``, ``seq_slice``, ``subseq``, ``sub_nested_seq``,
``kmax_seq_score``, ``maxid``, ``sampling_id``, ``eos_id``, the
pass-through ``get_output`` and recurrent-group agents, and
``row_conv``.

Each layer reaches :meth:`~paddle_tpu_torch.layers.base.Layer.finalize`
exactly where its JAX counterpart does.  The pooling layers apply their
activation (with dropout and the error clip) on the flat path only: a
strided or nested pool returns its value as it is, as in the JAX
package, and an ``average_strategy`` other than ``average``, ``sum`` or
``squarerootn`` reads as ``average`` there too.
"""

from __future__ import annotations

import torch

from ..core.sequence import NestedSequenceBatch, SequenceBatch, like, value_of
from ..ops import embedding_ops, sequence_ops
from ..utils import enforce
from .base import Layer, register_layer


def _as_seq(layer: Layer, x):
    enforce(isinstance(x, (SequenceBatch, NestedSequenceBatch)),
            f"layer {layer.name!r} requires a sequence input")
    return x


def _strided_reshape(seq: SequenceBatch, stride: int) -> NestedSequenceBatch:
    """The time axis cut into windows of ``stride`` steps → ``[B, n,
    stride, ...]`` with each window's valid steps as its length."""
    b, t = seq.data.shape[:2]
    n = (t + stride - 1) // stride
    trail = tuple(seq.data.shape[2:])
    data = torch.cat([seq.data, seq.data.new_zeros(
        (b, n * stride - t) + trail)], 1).reshape((b, n, stride) + trail)
    starts = torch.arange(n, device=seq.length.device)[None, :] * stride
    sub_len = torch.clamp(seq.length[:, None] - starts, 0, stride)
    num_sub = (seq.length + stride - 1) // stride
    return NestedSequenceBatch(data=data, num_subseq=num_sub,
                               sub_length=sub_len)


class _PoolBase(Layer):
    """Pooling over time: ``[B, D]`` from a sequence; with ``stride`` > 0
    the pool of each window of ``stride`` steps (a shorter sequence); of
    a nested sequence the pool of each subsequence (a sequence over the
    subsequences)."""

    pool_type = "average"

    def forward(self, params, inputs, ctx):
        seq = _as_seq(self, inputs[0])
        stride = self.conf.attrs.get("stride", -1)
        if stride > 0:
            nested = _strided_reshape(seq, stride)
            b, n = nested.data.shape[:2]
            flat = SequenceBatch(
                data=nested.data.reshape((b * n,)
                                         + tuple(nested.data.shape[2:])),
                length=nested.sub_length.reshape(b * n))
            pooled = sequence_ops.sequence_pool(flat, self.pool_type)
            return SequenceBatch(
                data=pooled.reshape((b, n) + tuple(pooled.shape[1:])),
                length=nested.num_subseq)
        if isinstance(seq, NestedSequenceBatch):
            b, s = seq.data.shape[:2]
            pooled = sequence_ops.sequence_pool(seq.flatten_to_subseq(),
                                                self.pool_type)
            return SequenceBatch(
                data=pooled.reshape((b, s) + tuple(pooled.shape[1:])),
                length=seq.num_subseq)
        return self.finalize(sequence_ops.sequence_pool(seq, self.pool_type),
                             ctx)


@register_layer("average")
class AverageLayer(_PoolBase):
    """``average_strategy`` ``average``, ``sum`` or ``squarerootn``
    (``sqrt``); any other reads as ``average``, as in the JAX package."""

    @property
    def pool_type(self):
        t = self.conf.attrs.get("average_strategy", "average")
        return {"average": "average", "sum": "sum",
                "squarerootn": "sqrt"}.get(t, "average")


@register_layer("max")
class MaxPoolSeqLayer(_PoolBase):
    pool_type = "max"


@register_layer("seqlastins")
class SequenceLastInstanceLayer(_PoolBase):
    """Each sequence's value at its last valid step (step 0 for an empty
    one)."""

    pool_type = "last"


@register_layer("seqfirstins")
class SequenceFirstInstanceLayer(_PoolBase):
    pool_type = "first"


@register_layer("expand")
class ExpandLayer(Layer):
    """The first input's rows ``[B, D]`` broadcast over the time axis of
    the second (a sequence; of a nested sequence, over its subsequence
    slots); no activation, as in the JAX package."""

    def forward(self, params, inputs, ctx):
        x = value_of(inputs[0])
        template = _as_seq(self, inputs[1])
        if isinstance(template, NestedSequenceBatch):
            s = template.data.shape[1]
            data = x[:, None].expand((x.shape[0], s) + tuple(x.shape[1:]))
            return SequenceBatch(data=data, length=template.num_subseq)
        return sequence_ops.seq_expand(x, template)


@register_layer("seqconcat")
class SequenceConcatLayer(Layer):
    def forward(self, params, inputs, ctx):
        return sequence_ops.sequence_concat(_as_seq(self, inputs[0]),
                                            _as_seq(self, inputs[1]))


@register_layer("seqreshape")
class SequenceReshapeLayer(Layer):
    def forward(self, params, inputs, ctx):
        return sequence_ops.sequence_reshape(_as_seq(self, inputs[0]),
                                             self.conf.size)


def _ids(x) -> torch.Tensor:
    return value_of(x).reshape(-1).to(torch.int32)


@register_layer("seq_slice")
class SequenceSliceLayer(Layer):
    """Steps ``[offset, offset + size)`` of each sequence; offsets default
    to 0, sizes to the rest of the sequence."""

    def forward(self, params, inputs, ctx):
        seq = _as_seq(self, inputs[0])
        offsets = _ids(inputs[1]) if len(inputs) > 1 \
            else torch.zeros_like(seq.length)
        sizes = _ids(inputs[2]) if len(inputs) > 2 \
            else seq.length - offsets
        return sequence_ops.sequence_slice(seq, offsets, sizes)


@register_layer("subseq")
class SubSequenceLayer(Layer):
    def forward(self, params, inputs, ctx):
        return sequence_ops.sequence_slice(_as_seq(self, inputs[0]),
                                           _ids(inputs[1]), _ids(inputs[2]))


@register_layer("sub_nested_seq")
class SubNestedSequenceLayer(Layer):
    """The subsequences of a nested sequence picked by per-sequence
    indices ``[B, K]`` (−1 pads) (``SubNestedSequenceLayer``)."""

    def forward(self, params, inputs, ctx):
        nested = inputs[0]
        enforce(isinstance(nested, NestedSequenceBatch),
                f"layer {self.name!r}: sub_nested_seq needs a nested "
                "sequence")
        sel = value_of(inputs[1]).to(torch.int64)
        safe = torch.clamp(sel, min=0)
        idx = safe.reshape(safe.shape + (1,) * (nested.data.dim() - 2))
        data = torch.gather(nested.data, 1, idx.expand(
            tuple(safe.shape) + tuple(nested.data.shape[2:])))
        valid = sel >= 0
        sub_len = torch.gather(nested.sub_length, 1, safe)
        return NestedSequenceBatch(
            data=data, num_subseq=valid.sum(1, dtype=torch.int32),
            sub_length=torch.where(valid, sub_len, torch.zeros_like(sub_len)))


@register_layer("kmax_seq_score")
class KmaxSeqScoreLayer(Layer):
    def forward(self, params, inputs, ctx):
        seq = _as_seq(self, inputs[0])
        return like(seq, sequence_ops.kmax_seq_score(
            seq, self.conf.attrs.get("beam_size", 1)))


@register_layer("maxid")
class MaxIdLayer(Layer):
    def forward(self, params, inputs, ctx):
        return like(inputs[0], sequence_ops.max_id(
            value_of(inputs[0]), self.conf.attrs.get("beam_size", 1)))


@register_layer("sampling_id")
class SamplingIdLayer(Layer):
    """One id a row drawn from the probabilities; the draws come from the
    layer's own generator (:meth:`ForwardContext.layer_rng`)."""

    def forward(self, params, inputs, ctx):
        probs = value_of(inputs[0])
        return like(inputs[0], embedding_ops.sampling_id(
            ctx.layer_rng(self.name, probs.device), probs))


@register_layer("eos_id")
class EosIdCheckLayer(Layer):
    """1.0 where the input id is ``eos_id`` (``EosIdCheckLayer``)."""

    def forward(self, params, inputs, ctx):
        ids = value_of(inputs[0])
        return like(inputs[0], (ids == self.conf.attrs["eos_id"]).to(
            torch.float32))


@register_layer("get_output")
class GetOutputLayer(Layer):
    """The input as it is (``GetOutputLayer``; a layer has one output
    here)."""

    def forward(self, params, inputs, ctx):
        return inputs[0]


@register_layer("gather_agent")
class GatherAgentLayer(Layer):
    """Recurrent-group plumbing the group's loop does itself; standalone,
    the identity."""

    def forward(self, params, inputs, ctx):
        return inputs[0]


@register_layer("scatter_agent")
class ScatterAgentLayer(Layer):
    def forward(self, params, inputs, ctx):
        return inputs[0]


@register_layer("row_conv")
class RowConvLayer(Layer):
    """Lookahead row convolution (``RowConvLayer.cpp``): ``out[t] =
    Σ_{i<ctx} in[t+i] · W[i]`` per feature within each sequence, W
    ``[context_length, size]``."""

    def param_specs(self):
        ctx_len = self.conf.attrs.get("context_length", 1)
        return [self._weight_spec(0, (ctx_len, self.conf.size),
                                  initial_smart=True)]

    def forward(self, params, inputs, ctx):
        seq = _as_seq(self, inputs[0])
        w = params[self.weight_name(0)]
        x = seq.masked_data(0.0)
        out = torch.zeros_like(x)
        t = x.shape[1]
        for i in range(w.shape[0]):
            shifted = torch.cat([x[:, i:], x.new_zeros(
                (x.shape[0], min(i, t)) + tuple(x.shape[2:]))], 1)
            out = out + shifted * w[i]
        return self.finalize(seq.with_data(out), ctx)
