"""Cost layers the ported slices use (counterpart of
``paddle_tpu/layers/cost.py``): ``multi-class-cross-entropy``.

A cost layer outputs the per-example cost ``[N, 1]``: N = B for a
per-sequence or dense label, N = B·T for a sequence of predictions, with
the padded steps' cost 0 and the rows keeping the sequence's lengths
(``_per_example`` → ``core.sequence.like``).  The network sums a cost
layer's output and divides by N, so the objective of a sequence cost is
the sum over valid tokens divided by B·T, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..core.sequence import SequenceBatch, like, value_of
from ..ops import loss_ops
from ..utils import enforce
from .base import Layer, register_layer


def _masked_flatten_seq(x, label):
    """A sequence input flattened to ``[B·T, ...]`` rows with its length
    mask ``[B·T]``; a dense input as it is, mask None."""
    if isinstance(x, SequenceBatch):
        v = x.data
        b, t = v.shape[:2]
        lab = value_of(label)
        if lab.dim() >= 2 and tuple(lab.shape[:2]) == (b, t):
            lab = lab.reshape((b * t,) + tuple(lab.shape[2:]))
        return (v.reshape((b * t,) + tuple(v.shape[2:])), lab,
                x.mask(torch.float32).reshape(b * t))
    return value_of(x), value_of(label), None


@register_layer("multi-class-cross-entropy")
class CrossEntropyCost(Layer):
    """CE of a softmax fc's logits (the fused path, when the network hands
    the producer's ``.logits`` sub-output over) or of its probabilities;
    a sequence of predictions is masked by its lengths.  Per-example
    weights are not ported."""

    is_cost = True
    #: set by the network just before ``forward`` from the producer's
    #: '.logits' sub-output (None: the probability path)
    logits_value = None

    def forward(self, params, inputs, ctx):
        logits, self.logits_value = self.logits_value, None
        enforce(len(inputs) == 2,
                f"layer {self.name!r}: a weighted cost is not ported")
        if logits is not None:
            # fused logits path on the native [B(, T), V] layout
            z = value_of(logits)
            label = value_of(inputs[1]).reshape(z.shape[:-1])
            mask = logits.mask(torch.float32).reshape(-1) \
                if isinstance(logits, SequenceBatch) else None
            cost = loss_ops.softmax_ce_fused(z, label).reshape(-1)
        else:
            x, label, mask = _masked_flatten_seq(inputs[0], inputs[1])
            cost = loss_ops.cross_entropy(x, label.reshape(-1))
        if mask is not None:
            cost = cost * mask
        cost = cost * self.conf.attrs.get("coeff", 1.0)
        return like(inputs[0], cost.reshape(-1, 1))
