"""Cost layers this slice uses (counterpart of
``paddle_tpu/layers/cost.py``): ``multi-class-cross-entropy``.

A cost layer outputs per-example cost ``[B, 1]``; the network reduces
cost-layer outputs to the scalar objective.
"""

from __future__ import annotations

from ..core.sequence import SequenceBatch, value_of
from ..ops import loss_ops
from ..utils import enforce
from .base import Layer, register_layer


@register_layer("multi-class-cross-entropy")
class CrossEntropyCost(Layer):
    """CE of a softmax fc's logits (the fused path); the probability-space
    path, per-example weights and per-timestep costs are not ported."""

    is_cost = True
    #: set by the network just before ``forward`` from the producer's
    #: '.logits' sub-output
    logits_value = None

    def forward(self, params, inputs, ctx):
        logits, self.logits_value = self.logits_value, None
        enforce(logits is not None and len(inputs) == 2
                and not isinstance(logits, SequenceBatch),
                f"layer {self.name!r}: only the cost of a softmax fc's "
                "logits, unweighted, is ported")
        z = value_of(logits)
        label = value_of(inputs[1]).reshape(z.shape[:-1])
        cost = loss_ops.softmax_ce_fused(z, label)
        return (cost * self.conf.attrs.get("coeff", 1.0)).reshape(-1, 1)
