"""Cost layers (counterpart of ``paddle_tpu/layers/cost.py``; type
strings kept: ``multi-class-cross-entropy``,
``multi_class_cross_entropy_with_selfnorm``,
``soft_binary_class_cross_entropy``, ``square_error`` / ``mse`` /
``regression_cost``, ``rank-cost``, ``lambda_cost``,
``multi_binary_label_cross_entropy``, ``huber_regression``,
``huber_classification``, ``smooth_l1``, ``sum_cost``; the sequence
costs ``crf``, ``ctc`` / ``warp_ctc``; ``crf_decoding`` and
``cross_entropy_over_beam``, which the JAX package does not mark as
costs either).

A cost layer outputs the per-example cost ``[N, 1]``: N = B for a
per-sequence or dense label, N = B·T for a sequence of predictions, with
the padded steps' cost 0 and the rows keeping the sequence's lengths
(``_per_example`` → ``core.sequence.like``).  Where the JAX layer takes
them (``_CostBase.weighted``), an optional third input weighs each
example and ``coeff`` scales the cost.  The network sums a cost layer's
output and divides by N, so the objective of a sequence cost is the sum
over valid tokens divided by B·T, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..core.sequence import SequenceBatch, like, value_of
from ..ops import crf_ops, loss_ops
from ..utils import enforce
from .base import Layer, register_layer


def _per_example(out, template):
    return like(template, out.reshape(-1, 1))


class _CostBase(Layer):
    is_cost = True

    def weighted(self, cost, inputs):
        """The optional per-example weight (third input) and ``coeff``."""
        if len(inputs) > 2 and inputs[2] is not None:
            cost = cost * value_of(inputs[2]).reshape(-1)
        return cost * self.conf.attrs.get("coeff", 1.0)


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
class CrossEntropyCost(_CostBase):
    """CE of a softmax fc's logits (the fused path, when the network hands
    the producer's ``.logits`` sub-output over) or of its probabilities;
    a sequence of predictions is masked by its lengths."""

    #: set by the network just before ``forward`` from the producer's
    #: '.logits' sub-output (None: the probability path)
    logits_value = None

    def forward(self, params, inputs, ctx):
        logits, self.logits_value = self.logits_value, None
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
        return _per_example(self.weighted(cost, inputs), inputs[0])


@register_layer("multi_class_cross_entropy_with_selfnorm")
class CrossEntropySelfNormCost(_CostBase):
    """CE + alpha · log(Z)² self-normalisation (``CostLayer.cpp``)."""

    def forward(self, params, inputs, ctx):
        x, label, mask = _masked_flatten_seq(inputs[0], inputs[1])
        logz = torch.log(torch.sum(x, dim=-1) + 1e-8)
        cost = loss_ops.cross_entropy(x, label.reshape(-1)) + \
            self.conf.attrs.get("softmax_selfnorm_alpha", 0.1) \
            * torch.square(logz)
        if mask is not None:
            cost = cost * mask
        return _per_example(self.weighted(cost, inputs), inputs[0])


@register_layer("soft_binary_class_cross_entropy")
class SoftBinaryCrossEntropyCost(_CostBase):
    def forward(self, params, inputs, ctx):
        label = value_of(inputs[1])
        p = torch.clamp(value_of(inputs[0]), 1e-8, 1 - 1e-8)
        cost = -torch.sum(label * torch.log(p)
                          + (1 - label) * torch.log1p(-p), dim=-1)
        return _per_example(self.weighted(cost, inputs), inputs[0])


@register_layer("square_error", "mse", "regression_cost")
class SquareErrorCost(_CostBase):
    def forward(self, params, inputs, ctx):
        x, label, mask = _masked_flatten_seq(inputs[0], inputs[1])
        cost = loss_ops.square_error(x, label)
        if mask is not None:
            cost = cost * mask
        return _per_example(self.weighted(cost, inputs), inputs[0])


@register_layer("rank-cost")
class RankingCost(_CostBase):
    """Its third input is the label, so ``coeff`` alone scales it."""

    def forward(self, params, inputs, ctx):
        cost = loss_ops.rank_loss(value_of(inputs[0]), value_of(inputs[1]),
                                  value_of(inputs[2]))
        return _per_example(cost * self.conf.attrs.get("coeff", 1.0),
                            inputs[0])


@register_layer("lambda_cost")
class LambdaCost(_CostBase):
    """LambdaRank over each sequence (a query's list); neither weight nor
    ``coeff``, as the JAX layer."""

    def forward(self, params, inputs, ctx):
        scores = inputs[0]
        enforce(isinstance(scores, SequenceBatch),
                "lambda_cost needs sequences")
        s = scores.data
        g = value_of(inputs[1])
        cost = loss_ops.lambda_cost(
            s[..., 0] if s.dim() == 3 else s,
            g[..., 0] if g.dim() == 3 else g,
            scores.mask(), self.conf.attrs.get("NDCG_num", 5))
        return _per_example(cost, inputs[0])


@register_layer("multi_binary_label_cross_entropy")
class MultiBinaryLabelCrossEntropyCost(_CostBase):
    def forward(self, params, inputs, ctx):
        cost = loss_ops.multi_binary_label_cross_entropy(
            value_of(inputs[0]), value_of(inputs[1]))
        return _per_example(self.weighted(cost, inputs), inputs[0])


@register_layer("huber_regression")
class HuberRegressionCost(_CostBase):
    def forward(self, params, inputs, ctx):
        cost = loss_ops.huber_loss(value_of(inputs[0]), value_of(inputs[1]),
                                   self.conf.attrs.get("delta", 1.0))
        return _per_example(self.weighted(cost, inputs), inputs[0])


@register_layer("huber_classification")
class HuberClassificationCost(_CostBase):
    def forward(self, params, inputs, ctx):
        cost = loss_ops.huber_classification_cost(
            value_of(inputs[0]), value_of(inputs[1]))
        return _per_example(self.weighted(cost, inputs), inputs[0])


@register_layer("smooth_l1")
class SmoothL1Cost(_CostBase):
    def forward(self, params, inputs, ctx):
        cost = loss_ops.smooth_l1_loss(value_of(inputs[0]),
                                       value_of(inputs[1]))
        return _per_example(self.weighted(cost, inputs), inputs[0])


@register_layer("sum_cost")
class SumCost(_CostBase):
    """The sum of each row; neither weight nor ``coeff``, as the JAX
    layer."""

    def forward(self, params, inputs, ctx):
        x = value_of(inputs[0])
        return _per_example(torch.sum(x.reshape(x.shape[0], -1), dim=-1),
                            inputs[0])


@register_layer("crf")
class CRFCost(_CostBase):
    """Linear-chain CRF negative log-likelihood (``CRFLayer``): inputs
    the emissions (a sequence), the tags (a sequence, or an array with
    the emissions' lengths) and an optional per-sequence weight; weight
    ``[N+2, N]``.  One cost a sequence, with the emissions' lengths."""

    def param_specs(self):
        n = self.conf.size
        return [self._weight_spec(0, (n + 2, n), initial_std=0.01)]

    def forward(self, params, inputs, ctx):
        emissions, labels = inputs[0], inputs[1]
        enforce(isinstance(emissions, SequenceBatch), "crf needs sequences")
        lab = labels if isinstance(labels, SequenceBatch) else \
            SequenceBatch(data=value_of(labels), length=emissions.length)
        cost = crf_ops.crf_nll(emissions, lab, params[self.weight_name(0)])
        return _per_example(self.weighted(cost, inputs), emissions)


@register_layer("crf_decoding")
class CRFDecodingLayer(Layer):
    """Viterbi decoding (``CRFDecodingLayer``): the best tags, int32
    ``[B, T]``; given the tags as a second input, 1.0 where the decoded
    tag differs from them (0 past each length) instead."""

    def param_specs(self):
        n = self.conf.size
        return [self._weight_spec(0, (n + 2, n), initial_std=0.01)]

    def forward(self, params, inputs, ctx):
        decoded = crf_ops.crf_decode(inputs[0], params[self.weight_name(0)])
        if len(inputs) > 1:
            lab = value_of(inputs[1])
            err = (decoded.data != lab[..., :decoded.data.shape[1]]).to(
                torch.float32)
            return SequenceBatch(data=err * decoded.mask(),
                                 length=decoded.length)
        return decoded


@register_layer("ctc", "warp_ctc")
class CTCCost(_CostBase):
    """CTC (``CTCLayer`` / ``WarpCTCLayer``) of sequence logits against a
    label sequence; ``blank`` and ``norm_by_times`` attributes.  Neither
    weight nor ``coeff``, as the JAX layer."""

    def forward(self, params, inputs, ctx):
        logits, labels = inputs[0], inputs[1]
        enforce(isinstance(logits, SequenceBatch)
                and isinstance(labels, SequenceBatch),
                "ctc needs sequence logits and labels")
        cost = crf_ops.ctc_loss(
            logits, labels, blank=self.conf.attrs.get("blank", 0),
            norm_by_times=self.conf.attrs.get("norm_by_times", False))
        return _per_example(cost, logits)


@register_layer("cross_entropy_over_beam")
class CrossEntropyOverBeamCost(Layer):
    """Globally normalised beam cross-entropy (``CrossEntropyOverBeam``):
    inputs in triples, one an expansion — accumulated path scores ``[B,
    K]``, candidate ids ``[B, K]``, the gold id ``[B]``.  Following the
    gold id through the expansions: at the first where it leaves the
    beam, the cost is −log softmax at gold over that beam with the gold
    path appended as an extra path (its score the last one it had in the
    beam), frozen there; a gold that survives to the last expansion costs
    −log softmax at its slot of the final beam.  ``[B, 1]``.  Not a cost
    layer in the JAX package's sense (``is_cost``), nor here."""

    def forward(self, params, inputs, ctx):
        enforce(len(inputs) % 3 == 0,
                "cross_entropy_over_beam takes (scores, ids, gold) triples")
        triples = [(value_of(inputs[i]).to(torch.float32),
                    value_of(inputs[i + 1]), value_of(inputs[i + 2]))
                   for i in range(0, len(inputs), 3)]
        scores = triples[0][0]
        b = scores.shape[0]
        alive = torch.ones((b,), dtype=torch.bool, device=scores.device)
        frozen = scores.new_zeros((b,))
        gold_score = scores.new_zeros((b,))
        for scores, ids, gold in triples:
            hit = ids == gold.reshape(b).to(ids.dtype)[:, None]
            in_beam = torch.any(hit, dim=1)
            here = torch.sum(torch.where(hit, scores, 0.0), dim=1)
            gold_score = torch.where(alive & in_beam, here, gold_score)
            ext = torch.cat([scores, gold_score[:, None]], 1)
            drop = -(gold_score - torch.logsumexp(ext, dim=1))
            frozen = torch.where(alive & ~in_beam, drop, frozen)
            alive = alive & in_beam
        final = -(gold_score - torch.logsumexp(scores, dim=1))
        return torch.where(alive, final, frozen)[:, None]
