"""EOS freezing for generation (counterpart of
``paddle_tpu/layers/beam_search.py``; only the part serving uses)."""

from __future__ import annotations

import torch

#: Cost of every non-EOS continuation of a frozen row.  Not attention's
#: -1e30: this is the reference's own constant, kept for equal logits.
NEG_INF = -1e9


def eos_frozen_logits(logp: torch.Tensor, alive: torch.Tensor,
                      eos_id: int) -> torch.Tensor:
    """Freeze finished rows: a row whose ``alive`` flag dropped may only
    continue with EOS at zero cost.  ``logp`` is ``[..., V]``, ``alive``
    its leading shape (bool).  Finished or padded decode slots thus
    sample EOS deterministically, never garbage from an inactive row."""
    eos_only = torch.full((logp.shape[-1],), NEG_INF, dtype=logp.dtype,
                          device=logp.device)
    eos_only[eos_id] = 0.0
    return torch.where(alive[..., None], logp, eos_only)
