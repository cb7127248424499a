"""Variable-length sequences as a padded batch (counterpart of
``paddle_tpu/core/sequence.py``; level 1 only: the nested batch and
``pad_nested_batch`` wait for queue A4c).

A :class:`SequenceBatch` is ``data[B, T, ...]`` plus int ``length[B]``;
masks are derived from the lengths.  :func:`pad_batch` builds one on
the host (CPU tensors) from ragged numpy rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
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


# ---------------------------------------------------------------- host side

def bucket_length(n: int, buckets: Optional[Sequence[int]] = None,
                  multiple: int = 8) -> int:
    """Round a max-length up to a bucket (the first of ``buckets`` that
    holds it, else their largest), or to a multiple of ``multiple``."""
    if buckets:
        for b in sorted(buckets):
            if n <= b:
                return b
        return max(buckets)
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def pad_batch(seqs: Sequence[np.ndarray], max_len: Optional[int] = None,
              dtype=None, pad_value: float = 0,
              buckets: Optional[Sequence[int]] = None) -> SequenceBatch:
    """Pad a ragged list of [t_i, ...] arrays into a SequenceBatch of CPU
    tensors: T is ``max_len``, else :func:`bucket_length` of the longest
    row; longer rows are cut to T."""
    seqs = [np.asarray(s) for s in seqs]
    lengths = np.array([s.shape[0] for s in seqs], dtype=np.int32)
    t = max_len or bucket_length(int(lengths.max(initial=1)), buckets)
    trailing = seqs[0].shape[1:] if seqs else ()
    dtype = dtype or (seqs[0].dtype if seqs else np.float32)
    out = np.full((len(seqs), t) + trailing, pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        n = min(s.shape[0], t)
        out[i, :n] = s[:n]
    return SequenceBatch(data=torch.from_numpy(out),
                         length=torch.from_numpy(np.minimum(lengths, t)))
