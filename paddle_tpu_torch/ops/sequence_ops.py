"""Sequence ops over padded :class:`SequenceBatch` (counterpart of
``paddle_tpu/ops/sequence_ops.py``): masked pooling over time,
broadcasting rows across time, concatenating, slicing and reshaping
sequences, the context window of a context projection and of
``sequence_conv``, the top scores of a sequence (``kmax_seq_score``),
the best ids of a row (``max_id``), the first and last instances and the
lookahead row convolution.  Masks stand in for the reference's
per-sequence loops; shapes stay those of the padded batch."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.sequence import SequenceBatch
from ..utils import PaddleTpuError
from .math_ops import matmul, top_k
from .registry import register_op


def _per_row_roll(data: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Each row ``b`` of ``data`` ``[B, T, ...]`` rolled along time by
    ``shift[b]`` (``jnp.roll`` of each row: out[t] = in[(t − shift) mod
    T])."""
    b, t = data.shape[:2]
    src = (torch.arange(t, device=data.device)[None, :]
           - shift.to(torch.int64)[:, None]) % t
    src = src.reshape((b, t) + (1,) * (data.dim() - 2))
    return torch.gather(data, 1, src.expand(data.shape))


@register_op("sequence_pool")
def sequence_pool(seq: SequenceBatch, pool_type: str = "average"
                  ) -> torch.Tensor:
    """Pool ``[B, T, D]`` over the valid timesteps → ``[B, D]``:
    ``average`` (the sum over max(length, 1)), ``sum``, ``sqrt`` (the sum
    over sqrt(max(length, 1))), ``max`` (−inf for an empty sequence, as
    the JAX op gives), ``last`` and ``first`` (step 0 for an empty
    sequence)."""
    x = seq.data
    mask = seq.mask(x.dtype)
    mask = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
    denom = torch.clamp(seq.length.to(x.dtype), min=1.0)
    denom = denom.reshape((-1,) + (1,) * (x.dim() - 2))
    if pool_type in ("average", "avg", "mean"):
        return torch.sum(x * mask, dim=1) / denom
    if pool_type == "sum":
        return torch.sum(x * mask, dim=1)
    if pool_type == "sqrt":
        return torch.sum(x * mask, dim=1) / torch.sqrt(denom)
    if pool_type == "max":
        # an empty sequence pools to -inf, as the JAX op does: its
        # where(denom > 0, ...) tests max(length, 1), which is never 0
        return torch.amax(torch.where(mask > 0, x, torch.full_like(
            x, float("-inf"))), dim=1)
    if pool_type == "last":
        return seq.last_valid()
    if pool_type == "first":
        return seq.first_valid()
    raise PaddleTpuError(f"unknown pool type {pool_type!r}")


@register_op("seq_expand", "expand")
def seq_expand(x: torch.Tensor, like: SequenceBatch) -> SequenceBatch:
    """Broadcast per-sequence rows ``[B, D]`` across the time axis of
    ``like`` → ``[B, T, D]`` (``ExpandLayer`` non-seq→seq mode), as a
    view."""
    t = like.max_len
    data = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    return SequenceBatch(data=data, length=like.length)


@register_op("sequence_concat")
def sequence_concat(a: SequenceBatch, b: SequenceBatch) -> SequenceBatch:
    """Each pair of sequences concatenated in time
    (``SequenceConcatLayer``) → ``[B, Ta + Tb, ...]``: b's valid prefix
    right after a's, zeros past both."""
    ta, tb = a.max_len, b.max_len
    trail = tuple(a.data.shape[2:])
    pad_a = torch.cat([a.data, a.data.new_zeros((a.data.shape[0], tb)
                                                + trail)], 1)
    pad_b = torch.cat([b.data, b.data.new_zeros((b.data.shape[0], ta)
                                                + trail)], 1)
    shifted_b = _per_row_roll(pad_b, a.length)
    t_idx = torch.arange(ta + tb, device=a.data.device)[None, :]
    la, lb = a.length[:, None], b.length[:, None]
    in_a = (t_idx < la).reshape((-1, ta + tb) + (1,) * len(trail))
    in_b = ((t_idx >= la) & (t_idx < la + lb)).reshape(in_a.shape)
    data = torch.where(in_a, pad_a, torch.where(
        in_b, shifted_b, torch.zeros((), dtype=pad_a.dtype,
                                     device=pad_a.device)))
    return SequenceBatch(data=data, length=a.length + b.length)


@register_op("sequence_slice")
def sequence_slice(seq: SequenceBatch, offset, length) -> SequenceBatch:
    """Each sequence's steps ``[offset, offset + length)``
    (``SequenceSliceLayer``): offset and length ``[B]`` (or scalars);
    the length is cut at the sequence's end and at 0.  T stays."""
    b = seq.data.shape[0]
    dev = seq.data.device
    offset = torch.as_tensor(offset, device=dev).to(torch.int32).expand(b)
    length = torch.as_tensor(length, device=dev).to(torch.int32).expand(b)
    length = torch.minimum(length, seq.length.to(torch.int32) - offset)
    return SequenceBatch(data=_per_row_roll(seq.data, -offset),
                         length=torch.clamp(length, min=0))


@register_op("sequence_reshape")
def sequence_reshape(seq: SequenceBatch, new_dim: int) -> SequenceBatch:
    """``[B, T, D]`` → ``[B, T·D/new_dim, new_dim]`` with the valid counts
    rescaled (``SequenceReshapeLayer``; a valid length must divide
    evenly, as the reference requires)."""
    b, t, d = seq.data.shape
    return SequenceBatch(data=seq.data.reshape(b, t * d // new_dim, new_dim),
                         length=seq.length * d // new_dim)


@register_op("context_projection")
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


@register_op("sequence_conv")
def sequence_conv(seq: SequenceBatch, w, context_start: int,
                  context_length: int) -> SequenceBatch:
    """The context window projected by w ``[context_length · D, Dout]``
    (``sequence_conv_op``), through ``math_ops.matmul``."""
    ctx = context_projection(seq, context_start, context_length)
    return SequenceBatch(data=matmul(ctx.data, w), length=seq.length)


@register_op("kmax_seq_score")
def kmax_seq_score(scores: SequenceBatch, beam_size: int) -> torch.Tensor:
    """Positions of the ``beam_size`` best scores within each sequence
    (``KmaxSeqScoreLayer``) → ``[B, beam_size]`` int32, −1 at the places
    past the sequence's length; the lower position first among equal
    scores (``lax.top_k``'s order)."""
    s = scores.data
    if s.dim() == 3:
        s = s[..., 0]
    masked = torch.where(scores.bool_mask(), s, torch.full_like(
        s, float("-inf")))
    idx = top_k(masked, beam_size)[1]
    k_in_range = torch.arange(beam_size, device=s.device)[None, :] \
        < scores.length[:, None]
    return torch.where(k_in_range, idx, torch.full_like(idx, -1))


@register_op("max_id")
def max_id(x: torch.Tensor, beam_size: int = 1) -> torch.Tensor:
    """Each row's best id (``MaxIdLayer``), the first of equal maxima;
    with ``beam_size`` > 1 the ``beam_size`` best, in ``lax.top_k``'s
    order (int32)."""
    if beam_size == 1:
        return torch.argmax(x, dim=-1).to(torch.int32)
    return top_k(x, beam_size)[1]


@register_op("sub_seq")
def sub_seq(seq: SequenceBatch, offsets, sizes) -> SequenceBatch:
    """:func:`sequence_slice` with explicit offsets and sizes
    (``SubSequenceLayer``)."""
    return sequence_slice(seq, offsets, sizes)


@register_op("sequence_last_instance")
def sequence_last_instance(seq: SequenceBatch) -> torch.Tensor:
    return seq.last_valid()


@register_op("sequence_first_instance")
def sequence_first_instance(seq: SequenceBatch) -> torch.Tensor:
    return seq.first_valid()


@register_op("row_conv")
def row_conv(seq: SequenceBatch, w) -> SequenceBatch:
    """Lookahead row convolution (``RowConvLayer`` / ``row_conv`` op):
    w ``[future_context, D]``; out[t] = Σ_k w[k] · x[t + k] over the
    steps t + k inside the sequence."""
    acc = torch.zeros_like(seq.data)
    t_idx = torch.arange(seq.max_len, device=seq.data.device)[None, :]
    for i in range(w.shape[0]):
        rolled = torch.roll(seq.data, -i, dims=1)
        valid = (t_idx + i) < seq.length[:, None]
        acc = acc + torch.where(valid[..., None], rolled * w[i],
                                torch.zeros((), dtype=acc.dtype,
                                            device=acc.device))
    return SequenceBatch(data=acc, length=seq.length)
