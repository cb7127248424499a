"""Loss and cost ops (counterpart of ``paddle_tpu/ops/loss_ops.py``): the
reference's cost layers (``paddle/gserver/layers/CostLayer.cpp``) and
loss ops (``cross_entropy_op``, ``softmax_with_cross_entropy``,
``sigmoid_cross_entropy_with_logits``, ``smooth_l1_loss``,
``huber_loss``, ``modified_huber_loss``, ``rank_loss``,
``margin_rank_loss``, ``squared_l2_distance``, ``squared_l2_norm``,
``l1_norm``).

All return per-example losses; reduction is the network's job.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op


@register_op("cross_entropy")
def cross_entropy(p: torch.Tensor, label: torch.Tensor,
                  soft_label: bool = False, eps: float = 1e-8
                  ) -> torch.Tensor:
    """CE on probabilities (reference ``cross_entropy_op``): p ``[N, C]``,
    label int ids ``[N]`` or soft labels ``[N, C]``; ``-log(clip(p,
    eps, 1))`` in fp32."""
    logp = torch.log(torch.clamp(p.float(), eps, 1.0))
    if soft_label:
        return -torch.sum(label * logp, dim=-1)
    return -torch.gather(logp, -1, label.reshape(-1, 1).long())[:, 0]


@register_op("softmax_with_cross_entropy", "classification_cost")
def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               soft_label: bool = False) -> torch.Tensor:
    """Stable log-softmax CE from logits (``softmax_with_cross_entropy_op``)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if soft_label:
        return -torch.sum(label * logp, dim=-1)
    return -torch.gather(logp, -1, label.reshape(-1, 1).long())[:, 0]


class _SoftmaxCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label):
        z = logits.float()
        lse = torch.logsumexp(z, dim=-1)
        lab = label.long()[..., None]
        gold = torch.gather(z, -1, lab)[..., 0]
        ctx.save_for_backward(logits, lab, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, dce):
        logits, lab, lse = ctx.saved_tensors
        # p recomputed from the saved logits; one read + one write
        p = torch.exp(logits.float() - lse[..., None])
        onehot = torch.zeros_like(p).scatter_(-1, lab, 1.0)
        return ((p - onehot) * dce[..., None]).to(logits.dtype), None


def softmax_ce_fused(logits: torch.Tensor, label: torch.Tensor
                     ) -> torch.Tensor:
    """Hard-label softmax CE from logits [..., V] and int labels [...],
    per row, with the hand-fused backward ``dz = (softmax(z) − onehot) ·
    dce`` of the reference's custom VJP."""
    return _SoftmaxCE.apply(logits, label)


@register_op("multi_binary_label_cross_entropy")
def multi_binary_label_cross_entropy(p, labels, eps: float = 1e-8):
    """CE with several binary labels per example (``CostLayer.cpp``
    MultiBinaryLabelCrossEntropy): labels dense ``[B, C]`` of 0/1."""
    p = torch.clamp(p, eps, 1.0 - eps)
    return -torch.sum(labels * torch.log(p)
                      + (1 - labels) * torch.log1p(-p), dim=-1)


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(x, label):
    """Stable elementwise sigmoid CE (``sigmoid_cross_entropy_with_logits_op``)."""
    return torch.clamp(x, min=0) - x * label \
        + torch.log1p(torch.exp(-torch.abs(x)))


@register_op("square_error", "sum_of_squares", "mse_cost")
def square_error(x, label):
    """Sum-of-squares cost (``SumOfSquaresCostLayer``): 0.5 · ||x − y||²."""
    d = x - label
    return 0.5 * torch.sum(torch.square(d).reshape(d.shape[0], -1), dim=-1)


@register_op("squared_l2_distance")
def squared_l2_distance(x, y):
    d = (x - y).reshape(x.shape[0], -1)
    return torch.sum(torch.square(d), dim=-1)


@register_op("squared_l2_norm")
def squared_l2_norm(x):
    return torch.sum(torch.square(x))


@register_op("l1_norm")
def l1_norm(x):
    return torch.sum(torch.abs(x))


@register_op("smooth_l1_loss", "smooth_l1")
def smooth_l1_loss(x, y, sigma: float = 1.0):
    """Smooth-L1 (``smooth_l1_loss_op.cc``): sigma-scaled Huber, summed
    per row."""
    s2 = sigma * sigma
    d = torch.abs(x - y)
    per = torch.where(d < 1.0 / s2, 0.5 * s2 * torch.square(d), d - 0.5 / s2)
    return torch.sum(per.reshape(per.shape[0], -1), dim=-1)


@register_op("huber_loss", "huber_regression_cost")
def huber_loss(x, y, delta: float = 1.0):
    d = torch.abs(y - x)
    per = torch.where(d <= delta, 0.5 * torch.square(d),
                      delta * (d - 0.5 * delta))
    return torch.sum(per.reshape(per.shape[0], -1), dim=-1)


@register_op("huber_classification_cost")
def huber_classification_cost(x, label):
    """Huber two-class cost (``HuberTwoClassification``): labels {0, 1} →
    {−1, 1}."""
    y = 2.0 * label.reshape(-1).to(x.dtype) - 1.0
    a = x.reshape(-1) * y
    return torch.where(a < -1.0, -4.0 * a,
                       torch.where(a < 1.0, torch.square(1.0 - a), 0.0))


@register_op("modified_huber_loss")
def modified_huber_loss(x, label):
    y = 2.0 * label.reshape(-1).to(x.dtype) - 1.0
    a = x.reshape(-1) * y
    return torch.where(a < -1.0, -4.0 * a,
                       torch.square(torch.clamp(1.0 - a, min=0.0)))


@register_op("rank_loss", "rank_cost")
def rank_loss(left, right, label):
    """Pairwise rank cost (``RankingCost``, ``rank_loss_op.cc``): CE of
    sigmoid(left − right) against a label in [0, 1]; the output keeps
    left's shape, as the op's InferShape."""
    o = left - right
    lab = label.to(o.dtype).reshape(o.shape)
    return torch.clamp(o, min=0) - o * lab \
        + torch.log1p(torch.exp(-torch.abs(o)))


@register_op("margin_rank_loss")
def margin_rank_loss(x1, x2, label, margin: float = 0.0):
    """max(0, −label·(x1 − x2) + margin) (``margin_rank_loss_op.cc``);
    the output keeps x1's shape."""
    o = x1 - x2
    return torch.clamp(-label.to(o.dtype).reshape(o.shape) * o + margin,
                       min=0.0)


@register_op("lambda_cost")
def lambda_cost(scores, gains, mask, ndcg_num: int = 5):
    """LambdaRank cost over padded query lists (``LambdaCost`` layer).

    scores / gains / mask ``[B, L]``.  Returns ``[B]``: per list a
    surrogate whose gradient in the scores is the NDCG-weighted pairwise
    lambda.  The ideal DCG takes the first ``ndcg_num`` gains in
    descending order of the valid ones (padded entries sort last)."""
    valid = mask > 0
    order = torch.argsort(torch.where(valid, -gains, float("inf")), dim=-1,
                          stable=True)
    sorted_g = torch.gather(gains, -1, order)
    pos = torch.arange(gains.shape[-1], device=gains.device,
                       dtype=gains.dtype)
    disc = 1.0 / torch.log2(pos + 2.0)
    take = pos < ndcg_num
    max_dcg = torch.sum(torch.where(take, (2.0 ** sorted_g - 1.0) * disc,
                                    0.0), dim=-1)
    inv_max = torch.where(max_dcg > 0, 1.0 / max_dcg, 0.0)
    sdiff = scores[:, :, None] - scores[:, None, :]
    pair = (gains[:, :, None] > gains[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    dg = (2.0 ** gains[:, :, None] - 2.0 ** gains[:, None, :]) \
        * inv_max[:, None, None]
    # surrogate whose d/ds matches lambda = |dNDCG| * sigmoid'(sdiff)
    surrogate = torch.abs(dg) * torch.log1p(torch.exp(-sdiff))
    return torch.sum(torch.where(pair, surrogate, 0.0), dim=(1, 2))


@register_op("cross_entropy_over_beam")
def cross_entropy_over_beam(beam_scores, gold_in_beam_mask):
    """CE over per-step beam candidates (``CrossEntropyOverBeam``):
    beam_scores ``[B, K]``, gold mask ``[B, K]``."""
    logp = F.log_softmax(beam_scores, dim=-1)
    return -torch.sum(gold_in_beam_mask * logp, dim=-1)
