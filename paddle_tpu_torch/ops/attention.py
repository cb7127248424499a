"""Attention for the serving path (counterpart of
``paddle_tpu/ops/pallas_attention.py``).

Two kernels, each a hand-written CUDA C++ kernel for ``sm_90a`` with a
plain PyTorch version beside it:

- :func:`flash_attention_packed` — packed causal prefill
  (``csrc/flash_packed_fwd.cu``; plain version :func:`_dense_forward`);
- :func:`paged_decode_attention` — decode over the paged KV pool
  (``csrc/paged_decode.cu``; plain version :func:`paged_decode_reference`).

A wrapper checks device, dtype, shape and contiguity first.  A tensor on
the CPU then takes the plain version; a CUDA tensor launches the kernel
or raises — there is no fallback.  Each wrapper counts its kernel
launches in a plain integer attribute (``flash_attention_packed.launches``,
``paged_decode_attention.launches``), added to only where the kernel is
launched.

Layouts are the JAX package's: q, k, v ``[B, T, H, D]``; lse ``[B, H, T]``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..utils import enforce
from . import _build

NEG_INF = -1e30


# ------------------------------------------------------------ plain versions
def _mask_scores(s: torch.Tensor, causal: bool, segments: torch.Tensor
                 ) -> torch.Tensor:
    """Apply the causal and packed-segment masks to ``[B, H, Tq, Tk]``
    scores: a query sees keys of its own segment id (``-1`` = padding
    sees nothing), at or before its position when ``causal``."""
    tq, tk = s.shape[-2], s.shape[-1]
    if causal:
        keep = (torch.arange(tq, device=s.device)[:, None]
                >= torch.arange(tk, device=s.device)[None, :])
        s = s.masked_fill(~keep[None, None], NEG_INF)
    sq = segments[:, None, :, None]
    sk = segments[:, None, None, :]
    return s.masked_fill(~((sq == sk) & (sq >= 0)), NEG_INF)


def _dense_forward(q, k, v, causal, segments
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain masked attention with the kernel's ``(out, lse)`` contract;
    a fully-masked query row emits zeros and lse ``NEG_INF / 2``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = _mask_scores(s, causal, segments)
    m_safe = torch.clamp(s.amax(dim=-1), min=NEG_INF / 2)
    l = torch.exp(s - m_safe[..., None]).sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = m_safe + torch.log(l_safe)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def segments_from_lengths(lengths: torch.Tensor, batch: int, t: int
                          ) -> torch.Tensor:
    """Per-token segment ids for a padded ``[B, T]`` batch flattened to
    one packed ``[1, B·T]`` row: valid tokens of row i get id ``i``,
    padding gets ``-1``."""
    dev = lengths.device
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    row = torch.arange(batch, dtype=torch.int32, device=dev)[:, None]
    seg = torch.where(pos < lengths.to(torch.int32)[:, None], row,
                      torch.full_like(row, -1))
    return seg.reshape(1, batch * t)


def paged_decode_reference(q, k_pages, v_pages, page_indices, lengths
                           ) -> torch.Tensor:
    """Plain version of :func:`paged_decode_attention`: gather each row's
    pages into a contiguous ``[B, max_pages·page, H, D]`` cache and run
    dense attention with the ragged causal tail (query r of a row sits
    at position ``length - Tq + r``)."""
    b, t_q, h, d = q.shape
    page = k_pages.shape[1]
    n_max = page_indices.shape[1]
    idx = page_indices.reshape(-1).long()
    gk = k_pages[idx].reshape(b, n_max * page, h, d)
    gv = v_pages[idx].reshape(b, n_max * page, h, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), gk.float()) \
        / math.sqrt(d)
    dev = q.device
    ki = torch.arange(n_max * page, dtype=torch.int32, device=dev)
    qpos = (lengths.to(torch.int32)[:, None] - t_q
            + torch.arange(t_q, dtype=torch.int32, device=dev)[None, :])
    valid = ki[None, None, :] <= qpos[:, :, None]             # [B,Tq,K]
    s = s.masked_fill(~valid[:, None], NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    return torch.einsum("bhqk,bkhd->bqhd", p, gv.float()).to(q.dtype)


def kv_write_index(page_indices, start_positions, counts, t_n: int,
                   page: int, n_pages: int) -> torch.Tensor:
    """The scatter index of :func:`paged_kv_write`: int64 ``[2, N]``,
    row 0 the destination token slot in the flattened ``[P·page]`` pool,
    row 1 the source token in the flattened ``[B·Tn]`` new tokens, for
    the N tokens that are written.

    Tokens at or past a row's count (prompt padding; inactive slots with
    ``counts == 0``) are dropped — never clamped, since an out-of-range
    index is a device-side assert on CUDA.  Tokens at negative positions
    or past the page table are dropped too (the JAX version clamps the
    latter onto the table's last page; callers never write there).  The
    arithmetic runs on ``page_indices``' device: the model keeps this
    metadata on the CPU, builds the index once per step and copies it to
    the card once for all layers.
    """
    b, n_max = page_indices.shape
    enforce(tuple(start_positions.shape) == (b,)
            and tuple(counts.shape) == (b,),
            f"paged_kv_write batch mismatch: page_indices "
            f"{tuple(page_indices.shape)}, start_positions "
            f"{tuple(start_positions.shape)}, counts "
            f"{tuple(counts.shape)}")
    meta = page_indices.device
    j = torch.arange(t_n, dtype=torch.int64, device=meta)[None, :]
    pos = start_positions.to(torch.int64)[:, None] + j            # [B, Tn]
    slot = pos // page
    valid = (j < counts.to(torch.int64)[:, None]) & (pos >= 0) \
        & (slot < n_max)
    phys = torch.gather(page_indices.to(torch.int64), 1,
                        slot.clamp(0, n_max - 1))
    valid &= (phys >= 0) & (phys < n_pages)
    dest = (phys * page + pos % page)[valid]
    src = torch.nonzero(valid.reshape(-1)).reshape(-1)
    return torch.stack([dest, src])


def paged_kv_scatter(k_pages, v_pages, k_new, v_new, index
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ``k_new`` / ``v_new`` ``[B, Tn, H, D]`` into the pools
    ``[P, page, H, D]`` IN PLACE at ``index`` (from
    :func:`kv_write_index`, on the pools' device)."""
    n_pages, page, h, d = k_pages.shape
    b, t_n = k_new.shape[0], k_new.shape[1]
    enforce(v_new.shape == k_new.shape,
            f"k_new/v_new shapes differ: {tuple(k_new.shape)} vs "
            f"{tuple(v_new.shape)}")
    enforce(v_pages.shape == k_pages.shape,
            "k_pages and v_pages shapes differ")
    dest, src = index[0], index[1]
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        pool.view(n_pages * page, h, d).index_put_(
            (dest,), new.reshape(b * t_n, h, d).index_select(0, src)
            .to(pool.dtype))
    return k_pages, v_pages


def paged_kv_write(k_pages, v_pages, k_new, v_new, page_indices,
                   start_positions, counts) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Scatter new K/V tokens into their rows' physical pages, IN PLACE.

    - ``k_pages`` / ``v_pages``: ``[P, page, H, D]`` pools (views into a
      per-layer pool are updated in place);
    - ``k_new`` / ``v_new``: ``[B, Tn, H, D]`` each row's newest tokens;
    - ``page_indices``: int ``[B, max_pages]``; ``start_positions``: int
      ``[B]`` position of each row's first new token; ``counts``: int
      ``[B]`` valid new tokens per row.

    Which tokens are dropped is set out in :func:`kv_write_index`.  The
    JAX version returns new pools and relies on buffer donation to alias
    them; here the pools are updated in place, which stands in for that
    donation, and are returned too.
    """
    n_pages, page = k_pages.shape[0], k_pages.shape[1]
    enforce(page_indices.shape[0] == k_new.shape[0],
            f"paged_kv_write batch mismatch: page_indices "
            f"{tuple(page_indices.shape)} vs k_new {tuple(k_new.shape)}")
    index = kv_write_index(page_indices, start_positions, counts,
                           k_new.shape[1], page, n_pages)
    return paged_kv_scatter(k_pages, v_pages, k_new, v_new,
                            index.to(k_pages.device))


# ------------------------------------------------------------------ wrappers
def _check_float(name: str, t: torch.Tensor, ndim: int) -> None:
    enforce(isinstance(t, torch.Tensor) and t.dim() == ndim,
            f"{name}: expected a {ndim}-D tensor, got "
            f"{getattr(t, 'shape', type(t))}")
    enforce(t.dtype == torch.float32,
            f"{name}: expected float32, got {t.dtype}")
    enforce(t.is_contiguous(), f"{name}: expected a contiguous tensor")


def _check_int(name: str, t: torch.Tensor, shape) -> None:
    enforce(isinstance(t, torch.Tensor) and tuple(t.shape) == tuple(shape),
            f"{name}: expected shape {tuple(shape)}, got "
            f"{getattr(t, 'shape', type(t))}")
    enforce(t.dtype == torch.int32, f"{name}: expected int32, got {t.dtype}")
    enforce(t.is_contiguous(), f"{name}: expected a contiguous tensor")


def _kernel_ready(tensors, d: int) -> bool:
    """True when the tensors are on CUDA (launch the kernel), False when
    all lie on the CPU (plain version); raises on anything else."""
    devs = {t.device for t in tensors}
    enforce(len(devs) == 1, f"tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    enforce(dev.type == "cuda", f"unsupported device {dev}")
    enforce(d % 4 == 0 and d <= 256,
            f"CUDA kernel needs head dim % 4 == 0 and <= 256, got {d}")
    enforce(all(t.data_ptr() % 16 == 0 for t in tensors),
            "CUDA kernel needs 16-byte aligned tensors")
    return True


def flash_attention_packed(q, k, v, segments, causal: bool = False,
                           slot: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed (ragged-batch) attention: tokens attend only within their
    segment; returns ``(out [B, T, H, D], lse [B, H, T])`` in fp32.

    ``segments``: int32 ``[B, T]`` per-token segment ids, ``-1`` marking
    padding (which emits zeros).  ``causal`` applies along the packed
    axis.  ``slot`` is accepted for the JAX signature; the result is
    defined by segment equality plus the causal diagonal alone.
    """
    del slot
    _check_float("q", q, 4)
    b, t, h, d = q.shape
    for name, x in (("k", k), ("v", v)):
        _check_float(name, x, 4)
        enforce(x.shape == q.shape,
                f"{name} shape {tuple(x.shape)} != q {tuple(q.shape)}")
    _check_int("segments", segments, (b, t))
    if not _kernel_ready((q, k, v, segments), d):
        return _dense_forward(q, k, v, causal, segments)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    fn = _build.kernel("flash_packed_fwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), segments.data_ptr(),
             out.data_ptr(), lse.data_ptr(), b, t, h, d, int(bool(causal)),
             1.0 / math.sqrt(d), torch.cuda.current_stream(q.device)
             .cuda_stream)
    enforce(err == 0, f"flash_packed_fwd launch failed (cudaError {err})")
    flash_attention_packed.launches += 1
    return out, lse


flash_attention_packed.launches = 0


def paged_decode_attention(q, k_pages, v_pages, page_indices, lengths
                           ) -> torch.Tensor:
    """Decode-step attention over a block-paged KV cache.

    - ``q``: ``[B, Tq, H, D]`` each row's newest ``Tq`` tokens (Tq >= 1);
    - ``k_pages`` / ``v_pages``: ``[P, page, H, D]`` shared page pools;
    - ``page_indices``: int32 ``[B, max_pages]`` per-row page table
      (entries past the row's used pages are never read);
    - ``lengths``: int32 ``[B]`` valid cached tokens per row, the current
      step's K/V included: query r sits at ``length - Tq + r``.

    Returns ``[B, Tq, H, D]``; a query with no visible key gives zeros.
    """
    _check_float("q", q, 4)
    b, t_q, h, d = q.shape
    enforce(t_q >= 1, "paged_decode_attention needs Tq >= 1")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check_float(name, x, 4)
    n_pages, page, hp, dp = k_pages.shape
    enforce(hp == h and dp == d,
            f"page pool heads/dim {hp}/{dp} != query {h}/{d}")
    enforce(v_pages.shape == k_pages.shape,
            f"k_pages and v_pages shapes differ: {tuple(k_pages.shape)} vs "
            f"{tuple(v_pages.shape)}")
    enforce(page_indices.dim() == 2,
            f"page_indices: expected [B, max_pages], got "
            f"{tuple(page_indices.shape)}")
    _check_int("page_indices", page_indices, (b, page_indices.shape[1]))
    _check_int("lengths", lengths, (b,))
    if not _kernel_ready((q, k_pages, v_pages, page_indices, lengths), d):
        return paged_decode_reference(q, k_pages, v_pages, page_indices,
                                      lengths)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _build.kernel("paged_decode_fwd")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_indices.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, t_q, h, d, n_pages, page, page_indices.shape[1],
             1.0 / math.sqrt(d),
             torch.cuda.current_stream(q.device).cuda_stream)
    enforce(err == 0, f"paged_decode_fwd launch failed (cudaError {err})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

#: Every kernel wrapper of this module (for counters and reports).
KERNEL_WRAPPERS = (flash_attention_packed, paged_decode_attention)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
