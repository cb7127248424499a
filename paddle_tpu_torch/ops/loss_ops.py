"""Loss ops this slice uses (counterpart of ``paddle_tpu/ops/loss_ops.py``).

All return per-example losses; reduction is the network's job.
"""

from __future__ import annotations

import torch


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


def cross_entropy(p: torch.Tensor, label: torch.Tensor,
                  eps: float = 1e-8) -> torch.Tensor:
    """CE on probabilities ``[N, C]`` with int labels ``[N]`` (reference
    ``cross_entropy_op``): ``-log(clip(p[label], eps, 1))`` in fp32."""
    logp = torch.log(torch.clamp(p.float(), eps, 1.0))
    return -torch.gather(logp, -1, label.reshape(-1, 1).long())[:, 0]


def softmax_ce_fused(logits: torch.Tensor, label: torch.Tensor
                     ) -> torch.Tensor:
    """Hard-label softmax CE from logits [..., V] and int labels [...],
    per row, with the hand-fused backward ``dz = (softmax(z) − onehot) ·
    dce`` of the reference's custom VJP."""
    return _SoftmaxCE.apply(logits, label)
