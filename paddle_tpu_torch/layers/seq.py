"""Sequence layers this slice uses (counterpart of
``paddle_tpu/layers/seq.py``): ``seqlastins``."""

from __future__ import annotations

from ..core.sequence import SequenceBatch
from ..utils import enforce
from .base import Layer, register_layer


@register_layer("seqlastins")
class SequenceLastInstanceLayer(Layer):
    """Each sequence's value at its last valid step ``[B, D]`` (step 0
    for an empty sequence).  Strided pooling is not ported."""

    def forward(self, params, inputs, ctx):
        seq = inputs[0]
        enforce(isinstance(seq, SequenceBatch),
                "layer requires a sequence input")
        enforce(self.conf.attrs.get("stride", -1) <= 0,
                f"layer {self.name!r}: strided seqlastins is not ported")
        return self.finalize(seq.last_valid())
