"""Variable-length sequences as a padded batch (counterpart of
``paddle_tpu/core/sequence.py``; level 1 only).

A :class:`SequenceBatch` is ``data[B, T, ...]`` plus int ``length[B]``;
masks are derived from the lengths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class SequenceBatch:
    """Padded batch of variable-length sequences.

    data:   [B, T, ...] padded values (padding contents are arbitrary).
    length: [B] int valid lengths, 0 <= length <= T.
    """

    data: torch.Tensor
    length: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.data.shape[1]

    def bool_mask(self) -> torch.Tensor:
        t = torch.arange(self.max_len, dtype=torch.int32,
                         device=self.length.device)
        return t[None, :] < self.length.to(torch.int32)[:, None]

    def mask(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, T] 1.0 where valid."""
        return self.bool_mask().to(dtype)

    def with_data(self, data: torch.Tensor) -> "SequenceBatch":
        return SequenceBatch(data=data, length=self.length)

    def last_valid(self) -> torch.Tensor:
        """[B, ...] value at position length-1 of each sequence (position
        0 for an empty one)."""
        idx = torch.clamp(self.length.to(torch.int64) - 1, min=0)
        idx = idx.reshape(-1, 1, *(1,) * (self.data.dim() - 2))
        idx = idx.expand(-1, 1, *self.data.shape[2:])
        return torch.gather(self.data, 1, idx).squeeze(1)

    def to(self, device: Optional[Union[str, torch.device]]) -> "SequenceBatch":
        return SequenceBatch(data=self.data.to(device),
                             length=self.length.to(device))


def value_of(x):
    return x.data if isinstance(x, SequenceBatch) else x


def like(template, data: torch.Tensor):
    """Re-wrap ``data`` with the sequence metadata of ``template``."""
    if isinstance(template, SequenceBatch):
        return SequenceBatch(data=data, length=template.length)
    return data
