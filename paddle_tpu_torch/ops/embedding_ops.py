"""Embedding and sampled-output ops (counterpart of
``paddle_tpu/ops/embedding_ops.py``): the table lookup, the
noise-contrastive cost (``NCELayer``), the hierarchical sigmoid
(``HierarchicalSigmoidLayer`` with ``MatrixBitCode``'s codes), the
selective fully-connected product (``SelectiveFullyConnectedLayer``) and
sampling one id a row (``SamplingIdLayer``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.dtypes import record_op_precision
from .math_ops import matmul
from .registry import register_op


@register_op("lookup_table", "embedding")
def lookup_table(table: torch.Tensor, ids: torch.Tensor,
                 padding_idx: Optional[int] = None) -> torch.Tensor:
    """table [V, D], ids [...] int → [..., D].

    ``padding_idx`` rows read as zeros (and pass no gradient to the
    table).  Ids outside [0, V) read as zeros too, as the reference's
    fill-mode gather does, rather than faulting on the card.

    The gather is ``F.embedding``, whose table gradient on the card sums
    each row's duplicates in a fixed order, so a step's result does not
    vary from run to run (``index_select``'s backward adds them with
    atomics, in whatever order they land)."""
    record_op_precision("lookup_table")
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < table.shape[0])
    if padding_idx is not None:
        valid &= ids != padding_idx
    out = F.embedding(torch.where(valid, ids, 0), table)
    return out * valid[..., None].to(out.dtype)


def _softplus_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of ``sigmoid(logits)`` against ``target``,
    in the JAX package's stable form ``max(z, 0) - z·y + log1p(e^-|z|)``."""
    return torch.clamp(logits, min=0) - logits * target \
        + torch.log1p(torch.exp(-torch.abs(logits)))


@register_op("nce")
def nce_loss(x, labels, w, b, sample_ids, sample_probs,
             num_true: int = 1) -> torch.Tensor:
    """Noise-contrastive estimation cost ``[B]`` (``NCELayer``): binary
    cross-entropy of the true class against 1 and of each drawn negative
    against 0.  x ``[B, D]``, labels ``[B]``, w ``[V, D]``, b ``[V]``,
    sample_ids ``[B, S]`` drawn by the caller; ``sample_probs`` and
    ``num_true`` are taken for the reference's signature and unused, as
    in the JAX function."""
    def logits_for(ids):
        ids = ids.to(torch.int64)
        return torch.einsum("bd,bkd->bk", x, w[ids]) + b[ids]

    pos = logits_for(labels.reshape(-1, 1))
    neg = logits_for(sample_ids)
    return _softplus_ce(pos, torch.ones_like(pos))[:, 0] \
        + torch.sum(_softplus_ce(neg, torch.zeros_like(neg)), dim=-1)


def _bit_codes(labels: torch.Tensor, num_classes: int, depth: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's bit codes (``MatrixBitCode.cpp``): code(c) = c +
    num_classes, halved until 1; at each level the inner node is
    code/2 − 1 and the bit code & 1 → (nodes, bits, valid), each
    ``[B, depth]``."""
    code = labels.to(torch.int64) + num_classes
    nodes, bits, valid = [], [], []
    for _ in range(depth):
        nodes.append(code // 2 - 1)
        bits.append(code & 1)
        valid.append(code > 1)
        code = code // 2
    return (torch.stack(nodes, -1), torch.stack(bits, -1),
            torch.stack(valid, -1))


@register_op("hsigmoid")
def hierarchical_sigmoid(x, labels, w, bias, num_classes: int
                         ) -> torch.Tensor:
    """Hierarchical sigmoid cost ``[B]`` (``HierarchicalSigmoidLayer``):
    the sum over the label's path of the binary cross-entropy at each
    inner node, against its bit.  x ``[B, D]``, w ``[num_classes-1, D]``,
    bias ``[num_classes-1]``."""
    depth = max(1, int(num_classes - 1).bit_length())
    nodes, bits, valid = _bit_codes(labels, num_classes, depth)
    nodes = torch.clamp(nodes, 0, w.shape[0] - 1)
    logits = torch.einsum("bd,btd->bt", x, w[nodes]) + bias[nodes]
    ce = _softplus_ce(logits, bits.to(logits.dtype))
    return torch.sum(torch.where(valid, ce, torch.zeros_like(ce)), dim=-1)


@register_op("selective_fc")
def selective_fc(x, w, bias, select_ids: Optional[torch.Tensor] = None,
                 act: str = "softmax") -> torch.Tensor:
    """Selective fully-connected product: the output columns of
    ``select_ids`` ``[B, K]`` only (``[B, K]``), then the activation;
    without ``select_ids`` a plain fc (through ``math_ops.matmul``).
    w ``[D, V]``."""
    from .activations import get_activation

    if select_ids is None:
        out = matmul(x, w)
        if bias is not None:
            out = out + bias
        return get_activation(act)(out)
    sel = select_ids.to(torch.int64)
    wk = torch.movedim(w[:, sel], 1, 0)                   # [B, D, K]
    out = torch.einsum("bd,bdk->bk", x, wk)
    if bias is not None:
        out = out + bias[sel]
    return get_activation(act)(out)


@register_op("sampling_id")
def sampling_id(gen: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """One id a row of ``probs`` ``[..., V]`` drawn from ``gen`` (int32):
    Gumbel-max over ``log(clip(p, 1e-20, 1))``, the law of
    ``jax.random.categorical`` on those logits; the draws are the
    generator's own."""
    logits = torch.log(torch.clamp(probs, 1e-20, 1.0))
    u = torch.rand(logits.shape, generator=gen, dtype=logits.dtype,
                   device=logits.device)
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
