"""Embedding lookup (counterpart of ``paddle_tpu/ops/embedding_ops.py``,
``lookup_table`` only)."""

from __future__ import annotations

from typing import Optional

import torch


def lookup_table(table: torch.Tensor, ids: torch.Tensor,
                 padding_idx: Optional[int] = None) -> torch.Tensor:
    """table [V, D], ids [...] int → [..., D].

    ``padding_idx`` rows read as zeros (and pass no gradient to the
    table).  Ids outside [0, V) read as zeros too, as the reference's
    fill-mode gather does, rather than faulting on the card."""
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < table.shape[0])
    if padding_idx is not None:
        valid &= ids != padding_idx
    out = table.index_select(0, torch.where(valid, ids, 0).reshape(-1))
    out = out.reshape(*ids.shape, table.shape[1])
    return out * valid[..., None].to(out.dtype)
