"""Sequence ops over padded :class:`SequenceBatch` (counterpart of
``paddle_tpu/ops/sequence_ops.py``, the two the seq2seq slice uses):
masked pooling over time and broadcasting rows across time."""

from __future__ import annotations

import torch

from ..core.sequence import SequenceBatch
from ..utils import PaddleTpuError


def sequence_pool(seq: SequenceBatch, pool_type: str = "average"
                  ) -> torch.Tensor:
    """Pool ``[B, T, D]`` over the valid timesteps → ``[B, D]``: ``sum``,
    or ``average`` (the sum over max(length, 1)).  Other pool types are
    not ported."""
    x = seq.data
    mask = seq.mask(x.dtype)
    mask = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
    total = torch.sum(x * mask, dim=1)
    if pool_type == "sum":
        return total
    if pool_type in ("average", "avg", "mean"):
        denom = torch.clamp(seq.length.to(x.dtype), min=1.0)
        return total / denom.reshape((-1,) + (1,) * (x.dim() - 2))
    raise PaddleTpuError(f"pool type {pool_type!r} is not ported; have "
                         "'sum', 'average'")


def seq_expand(x: torch.Tensor, like: SequenceBatch) -> SequenceBatch:
    """Broadcast per-sequence rows ``[B, D]`` across the time axis of
    ``like`` → ``[B, T, D]`` (``ExpandLayer`` non-seq→seq mode), as a
    view."""
    t = like.max_len
    data = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    return SequenceBatch(data=data, length=like.length)
