"""Embedding lookup (counterpart of ``paddle_tpu/ops/embedding_ops.py``,
``lookup_table`` only)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < table.shape[0])
    if padding_idx is not None:
        valid &= ids != padding_idx
    out = F.embedding(torch.where(valid, ids, 0), table)
    return out * valid[..., None].to(out.dtype)
