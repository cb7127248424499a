"""Sequence ops over padded :class:`SequenceBatch` (counterpart of
``paddle_tpu/ops/sequence_ops.py``, the three the ported layers use):
masked pooling over time, broadcasting rows across time and the context
window of a ``mixed`` layer's context projection."""

from __future__ import annotations

from typing import Optional

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


def context_projection(seq: SequenceBatch, context_start: int,
                       context_length: int,
                       padding_weights: Optional[torch.Tensor] = None
                       ) -> SequenceBatch:
    """A sliding window of neighbour rows concatenated at each timestep →
    ``[B, T, context_length * D]`` (``ContextProjection``).  Rows outside
    the sequence are zeros, or, with ``padding_weights`` ``[begin_pad +
    end_pad, D]``, the trainable padding rows: row ``begin_pad + off``
    before the start, row ``begin_pad + overflow - 1`` past the end of a
    valid step's window."""
    b, t, d = seq.data.shape
    begin_pad = max(0, -context_start)
    t_idx = torch.arange(t, dtype=torch.int64, device=seq.data.device)[None]
    length = seq.length.to(torch.int64)[:, None]
    cols = []
    for k in range(context_length):
        off = context_start + k
        rolled = torch.roll(seq.data, -off, dims=1)
        src = t_idx + off
        valid = (src >= 0) & (src < length)
        col = torch.where(valid[..., None], rolled, 0.0)
        if padding_weights is not None:
            if off < 0:
                col = torch.where((src < 0)[..., None],
                                  padding_weights[begin_pad + off], col)
            elif off > 0:
                overflow = torch.clamp(src - length, 0, off)
                pad_idx = torch.clamp(begin_pad + overflow - 1, 0,
                                      padding_weights.shape[0] - 1)
                use_pad = (src >= length) & (t_idx < length)
                col = torch.where(use_pad[..., None],
                                  padding_weights[pad_idx], col)
        cols.append(col)
    return SequenceBatch(data=torch.cat(cols, dim=-1), length=seq.length)
