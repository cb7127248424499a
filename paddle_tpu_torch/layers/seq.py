"""Sequence layers the ported slices use (counterpart of
``paddle_tpu/layers/seq.py``): ``seqlastins``, ``average`` and
``expand``, over level-1 sequences (nested sequences and strided pooling
are not ported)."""

from __future__ import annotations

from ..core.sequence import SequenceBatch, value_of
from ..ops import sequence_ops
from ..utils import enforce
from .base import Layer, register_layer


def _as_seq(layer: Layer, x) -> SequenceBatch:
    enforce(isinstance(x, SequenceBatch),
            f"layer {layer.name!r} requires a sequence input")
    return x


@register_layer("seqlastins")
class SequenceLastInstanceLayer(Layer):
    """Each sequence's value at its last valid step ``[B, D]`` (step 0
    for an empty sequence).  Strided pooling is not ported."""

    def forward(self, params, inputs, ctx):
        seq = _as_seq(self, inputs[0])
        enforce(self.conf.attrs.get("stride", -1) <= 0,
                f"layer {self.name!r}: strided seqlastins is not ported")
        return self.finalize(seq.last_valid())


@register_layer("average")
class AverageLayer(Layer):
    """Pooling over the valid timesteps ``[B, D]`` by ``average_strategy``
    (``average`` or ``sum``).  Strided pooling is not ported."""

    def forward(self, params, inputs, ctx):
        seq = _as_seq(self, inputs[0])
        enforce(self.conf.attrs.get("stride", -1) <= 0,
                f"layer {self.name!r}: strided pooling is not ported")
        strategy = self.conf.attrs.get("average_strategy", "average")
        enforce(strategy in ("average", "sum"),
                f"layer {self.name!r}: average_strategy {strategy!r} is not "
                "ported")
        return self.finalize(sequence_ops.sequence_pool(seq, strategy))


@register_layer("expand")
class ExpandLayer(Layer):
    """The first input's rows ``[B, D]`` broadcast over the time axis of
    the second (a sequence); no activation, as in the JAX package."""

    def forward(self, params, inputs, ctx):
        return sequence_ops.seq_expand(value_of(inputs[0]),
                                       _as_seq(self, inputs[1]))
