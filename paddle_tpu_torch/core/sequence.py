"""Variable-length and nested sequences as padded batches (counterpart
of ``paddle_tpu/core/sequence.py``).

A :class:`SequenceBatch` is ``data[B, T, ...]`` plus int ``length[B]``;
a :class:`NestedSequenceBatch` (LoD level 2) is ``data[B, S, T, ...]``
plus ``num_subseq[B]`` and ``sub_length[B, S]``.  Masks are derived from
the lengths.  :func:`pad_batch` and :func:`pad_nested_batch` build them
on the host (CPU tensors) from ragged numpy rows; :func:`lod_to_lengths`,
:func:`lengths_to_lod`, :func:`flat_to_padded` and
:func:`padded_to_flat` translate to and from the reference's flat
matrix with start offsets (``Argument.h``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils import enforce


@dataclasses.dataclass(frozen=True)
class SequenceBatch:
    """Padded batch of variable-length sequences.

    data:   [B, T, ...] padded values (padding contents are arbitrary).
    length: [B] int valid lengths, 0 <= length <= T.
    """

    data: torch.Tensor
    length: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

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

    def masked_data(self, fill: float = 0.0) -> torch.Tensor:
        """``data`` with the padded steps set to ``fill``."""
        m = self.bool_mask()
        m = m.reshape(m.shape + (1,) * (self.data.dim() - 2))
        return torch.where(m, self.data, torch.as_tensor(
            fill, dtype=self.data.dtype, device=self.data.device))

    def total_tokens(self) -> torch.Tensor:
        return torch.sum(self.length)

    def with_data(self, data: torch.Tensor) -> "SequenceBatch":
        return SequenceBatch(data=data, length=self.length)

    def last_valid(self) -> torch.Tensor:
        """[B, ...] value at position length-1 of each sequence (position
        0 for an empty one)."""
        idx = torch.clamp(self.length.to(torch.int64) - 1, min=0)
        idx = idx.reshape(-1, 1, *(1,) * (self.data.dim() - 2))
        idx = idx.expand(-1, 1, *self.data.shape[2:])
        return torch.gather(self.data, 1, idx).squeeze(1)

    def first_valid(self) -> torch.Tensor:
        """[B, ...] value at position 0 of each sequence."""
        return self.data[:, 0]

    def to(self, device: Optional[Union[str, torch.device]]) -> "SequenceBatch":
        return SequenceBatch(data=self.data.to(device),
                             length=self.length.to(device))


@dataclasses.dataclass(frozen=True)
class NestedSequenceBatch:
    """Padded nested sequences (LoD level 2).

    data:       [B, S, T, ...]
    num_subseq: [B]    int valid subsequences per sequence.
    sub_length: [B, S] int valid tokens per subsequence.
    """

    data: torch.Tensor
    num_subseq: torch.Tensor
    sub_length: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    def subseq_mask(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, S] valid-subsequence mask."""
        s = torch.arange(self.data.shape[1], device=self.num_subseq.device)
        return (s[None, :] < self.num_subseq[:, None]).to(dtype)

    def token_mask(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, S, T] valid-token mask (0 in an invalid subsequence)."""
        t = torch.arange(self.data.shape[2], device=self.sub_length.device)
        tok = (t[None, None, :] < self.sub_length[:, :, None]).to(dtype)
        return tok * self.subseq_mask(dtype)[:, :, None]

    def flatten_to_subseq(self) -> SequenceBatch:
        """The inner level as a flat ``[B*S, T, ...]`` SequenceBatch (an
        invalid subsequence has length 0)."""
        b, s = self.data.shape[:2]
        data = self.data.reshape((b * s,) + tuple(self.data.shape[2:]))
        length = (self.sub_length
                  * self.subseq_mask(self.sub_length.dtype)).reshape(b * s)
        return SequenceBatch(data=data, length=length)

    def outer(self) -> SequenceBatch:
        """The outer level as a sequence of subsequence slots."""
        return SequenceBatch(data=self.data, length=self.num_subseq)

    def to(self, device: Optional[Union[str, torch.device]]
           ) -> "NestedSequenceBatch":
        return NestedSequenceBatch(data=self.data.to(device),
                                   num_subseq=self.num_subseq.to(device),
                                   sub_length=self.sub_length.to(device))


def value_of(x):
    return x.data if isinstance(x, (SequenceBatch, NestedSequenceBatch)) \
        else x


def like(template, data: torch.Tensor):
    """Re-wrap ``data`` with the sequence metadata of ``template``."""
    if isinstance(template, SequenceBatch):
        return SequenceBatch(data=data, length=template.length)
    if isinstance(template, NestedSequenceBatch):
        return NestedSequenceBatch(data=data,
                                   num_subseq=template.num_subseq,
                                   sub_length=template.sub_length)
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


def pad_nested_batch(seqs: Sequence[Sequence[np.ndarray]],
                     max_sub: Optional[int] = None,
                     max_len: Optional[int] = None,
                     dtype=None, pad_value: float = 0) -> NestedSequenceBatch:
    """Pad a list of lists of ``[t, ...]`` arrays into a
    NestedSequenceBatch of CPU tensors: S is ``max_sub``, else the most
    subsequences of a row (at least 1); T is ``max_len``, else
    :func:`bucket_length` of the longest subsequence.  Longer rows and
    subsequences are cut."""
    b = len(seqs)
    num_sub = np.array([len(s) for s in seqs], dtype=np.int32)
    s_dim = max_sub or max(1, int(num_sub.max(initial=1)))
    all_sub = [np.asarray(x) for seq in seqs for x in seq]
    t_dim = max_len or bucket_length(
        max((x.shape[0] for x in all_sub), default=1))
    trailing = all_sub[0].shape[1:] if all_sub else ()
    dtype = dtype or (all_sub[0].dtype if all_sub else np.float32)
    data = np.full((b, s_dim, t_dim) + trailing, pad_value, dtype=dtype)
    sub_len = np.zeros((b, s_dim), dtype=np.int32)
    for i, seq in enumerate(seqs):
        for j, x in enumerate(seq[:s_dim]):
            x = np.asarray(x)
            n = min(x.shape[0], t_dim)
            data[i, j, :n] = x[:n]
            sub_len[i, j] = n
    return NestedSequenceBatch(
        data=torch.from_numpy(data),
        num_subseq=torch.from_numpy(np.minimum(num_sub, s_dim)),
        sub_length=torch.from_numpy(sub_len))


def lod_to_lengths(offsets: Sequence[int]) -> np.ndarray:
    """The reference's start offsets ``[0, n1, n1+n2, ...]`` → lengths."""
    offs = np.asarray(offsets, dtype=np.int64)
    enforce(offs.ndim == 1 and offs[0] == 0, "LoD offsets must start at 0")
    return np.diff(offs).astype(np.int32)


def lengths_to_lod(lengths: Sequence[int]) -> np.ndarray:
    """Lengths → the reference's start offsets (``Argument.h``)."""
    return np.concatenate(
        [[0], np.cumsum(np.asarray(lengths, dtype=np.int64))])


def flat_to_padded(flat: np.ndarray, offsets: Sequence[int],
                   max_len: Optional[int] = None) -> SequenceBatch:
    """The reference's flat matrix with start offsets → a padded
    SequenceBatch."""
    lengths = lod_to_lengths(offsets)
    seqs = [flat[offsets[i]:offsets[i + 1]] for i in range(len(lengths))]
    return pad_batch(seqs, max_len=max_len)


def padded_to_flat(batch: SequenceBatch) -> Tuple[np.ndarray, np.ndarray]:
    """A padded SequenceBatch → (flat matrix, start offsets) on the
    host."""
    data = batch.data.detach().cpu().numpy()
    lengths = batch.length.detach().cpu().numpy()
    flat = np.concatenate([data[i, :lengths[i]] for i in range(len(lengths))]
                          ) if len(lengths) else \
        data.reshape((0,) + data.shape[2:])
    return flat, lengths_to_lod(lengths)
