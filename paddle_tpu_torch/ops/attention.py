"""Attention ops (counterpart of ``paddle_tpu/ops/pallas_attention.py``).

Training: :func:`flash_attention` (padded rows with key lengths) and
:func:`flash_attention_packed` (segment ids) take the reference's
dispatch (:func:`_fa_forward`: the flags ``--flash_kernel`` and
``--flash_block_sparse``, the Mosaic tiling gate) and its gradient rules
(:class:`_FlashAttention`).  The block-sparse path runs three
hand-written CUDA C++ kernels for ``sm_90a``, each with a plain PyTorch
version beside it:

- :func:`flash_fwd` — kernel 1, training form (``csrc/flash_fwd.cu``;
  plain version :func:`_dense_forward`);
- :func:`flash_bwd_dq` — kernel 3 (``csrc/flash_bwd_dq.cu``);
- :func:`flash_bwd_dkv` — kernel 4 (``csrc/flash_bwd_dkv.cu``; plain
  version of both :func:`_dense_grads`).

The legacy full grid (``--flash_block_sparse=false``, padded rows) runs
the same three main loops instantiated as the reference's full grid
without windows: the forward (kernel 2) bounds each q tile's keys in the
kernel (key length, causal diagonal) and loads only those; the backward
kernels load every key (or query) tile and compute only the live ones:
:func:`flash_fwd_legacy` (kernel 2), :func:`flash_bwd_dq_legacy`
(kernel 5) and :func:`flash_bwd_dkv_legacy` (kernel 6), with the same
plain versions.  The dense path (flash off, an untileable shape, packed
under ``--flash_block_sparse=false``) is the plain composition on every
device.  Every decision is counted in :data:`attention_dispatch_total`
with the reference's ``(path, reason)`` labels.

Serving: :func:`prefill_attention_packed` — packed causal fp32 prefill
(``csrc/flash_packed_fwd.cu``: a CTA a tile of 16 queries and a head,
its keys' K and V rows staged once in shared memory, each query's keys
split over the CTA's 8 warps; plain version :func:`_dense_forward`),
behind the same decisions and labels (:func:`_fa_path`) — and
:func:`paged_decode_attention` — decode over the paged KV pool
(``csrc/paged_decode.cu``; plain version :func:`paged_decode_reference`).

A wrapper checks device, dtype, shape and layout first.  A tensor on the
CPU then takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback.  Each wrapper counts its kernel launches
in a plain integer attribute (``flash_fwd.launches`` and so on), added
to only where the kernel is launched.

Layouts are the JAX package's: q, k, v ``[B, T, H, D]``; lse and delta
``[B, H, T]``.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..observe import counter
from ..utils import FLAGS, enforce, get_logger, warn_once
from . import _build

NEG_INF = -1e30
#: Rows of the training kernels' outer tile and the unit of their
#: block-sparse windows (``kRows`` in ``csrc/flash_common.cuh``).
KERNEL_TILE = 64
#: Head dims the training kernels are compiled for.
KERNEL_HEAD_DIMS = (32, 64, 128)

_log = get_logger("ops.attention")

#: ``(path, reason)`` → count: the labels of the JAX package's
#: ``attention_dispatch_total`` counter (which counts once per traced
#: call; this one once per call).
attention_dispatch_total: "collections.Counter" = collections.Counter()


def record_attention_dispatch(path: str, reason: str = "") -> None:
    """Count one attention lowering decision; ``reason`` is set when a
    flash-capable call took a fallback, with the same labels the
    one-time fallback warnings use; also ticks the registry's
    ``attention_dispatch_total{path,reason}``."""
    attention_dispatch_total[(path, reason)] += 1
    counter(
        "attention_dispatch_total",
        "attention lowering decisions by path (trace-time; reason "
        "labels match the one-time fallback warnings)",
    ).inc(path=path, reason=reason)


def _warn_dense_fallback(reason: str, tq: int, tk: int, bq: int,
                         bk: int) -> None:
    warn_once(
        f"flash_attention_dense_fallback:{reason}:{tq}x{tk}",
        "flash_attention: dense fallback taken for Tq=%d Tk=%d (blocks "
        "%d/%d): %s", tq, tk, bq, bk, reason, logger=_log)


def _choose_block(t: int, want: int) -> int:
    b = min(want, t)
    while t % b:
        b //= 2
    return max(b, 1)


def _tiling_ok(tq: int, tk: int, bq: int, bk: int) -> bool:
    """The reference's block constraints (the lse block's last dim a
    multiple of 128 or the whole Tq; the k/v block a multiple of 8 or
    the whole Tk), held on every device so the port takes the
    reference's path at every shape."""
    ok_q = bq % 128 == 0 or bq == tq
    ok_k = bk % 8 == 0 or bk == tk
    return ok_q and ok_k


def packed_tileable(t_total: int, block_q: int, block_k: int) -> bool:
    """Would a packed (flattened, self-attention) layout of ``t_total``
    tokens take the flash path?  The layer checks this first and reverts
    an untileable flatten to the padded per-row lowering."""
    bq = _choose_block(t_total, block_q)
    bk = _choose_block(t_total, block_k)
    return _tiling_ok(t_total, t_total, bq, bk)


# ------------------------------------------------------------ plain versions
def _mask_scores(s: torch.Tensor, causal: bool,
                 lengths: Optional[torch.Tensor] = None,
                 segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the causal, key-length and packed-segment masks to
    ``[B, H, Tq, Tk]`` scores: a query sees keys before its row's length,
    at or before its position when ``causal``, and (packed) of its own
    segment id (``-1`` = padding sees nothing)."""
    tq, tk = s.shape[-2], s.shape[-1]
    dev = s.device
    if causal:
        keep = (torch.arange(tq, device=dev)[:, None]
                >= torch.arange(tk, device=dev)[None, :])
        s = s.masked_fill(~keep[None, None], NEG_INF)
    if lengths is not None:
        valid = torch.arange(tk, device=dev)[None, :] < lengths[:, None]
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    if segments is not None:
        sq = segments[:, None, :, None]
        sk = segments[:, None, None, :]
        s = s.masked_fill(~((sq == sk) & (sq >= 0)), NEG_INF)
    return s


def _scores(q, k, lengths, causal, segments) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return _mask_scores(s, causal, lengths, segments)


def _dense_forward(q, k, v, lengths, causal, segments=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain masked attention with the kernels' ``(out, lse)`` contract,
    in f32 from the inputs' values: out in q's dtype, lse f32; a
    fully-masked query row emits zeros and lse ``NEG_INF / 2``."""
    s = _scores(q, k, lengths, causal, segments)
    m_safe = torch.clamp(s.amax(dim=-1), min=NEG_INF / 2)
    l = torch.exp(s - m_safe[..., None]).sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = m_safe + torch.log(l_safe)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The softmax backward's row term ``Σ_d dO·O``, f32 ``[B, H, T]``
    (the reference's ``_bwd_residual_streams``)."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(), out.float()) \
        .contiguous()


def _dense_grads(q, k, v, do, lse, delta, lengths, causal, segments=None,
                 want: str = "all"):
    """Plain version of the backward kernels: p rebuilt from ``lse`` with
    the forward's masks, ds = p·(dO·vᵀ − delta); ``want`` "dq" gives dq,
    "dkv" gives (dk, dv), "all" (dq, dk, dv), each in its input's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    dof = do.float()
    p = torch.exp(_scores(q, k, lengths, causal, segments) - lse[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
              - delta[..., None])
    out = []
    if want in ("dq", "all"):
        out.append((torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
                    * scale).to(q.dtype))
    if want in ("dkv", "all"):
        out.append((torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
                    * scale).to(k.dtype))
        out.append(torch.einsum("bhqk,bqhd->bkhd", p, dof).to(v.dtype))
    return out[0] if want == "dq" else tuple(out)


def _dense_backward(q, k, v, lengths, out, lse, do, causal, segments=None):
    """The dense path's backward (the reference's ``_dense_backward``):
    the exact composition the kill switches and untileable shapes take."""
    return _dense_grads(q, k, v, do, lse, _delta(out, do), lengths, causal,
                        segments)


# ------------------------------------------------------ block-sparse windows
def _segment_windows(segments: torch.Tensor, tile: int = KERNEL_TILE
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)`` int32 ``[B, n]``: for each tile of ``tile`` tokens the
    tiles ``[lo, hi)`` whose valid segment range meets its own (the
    reference's ``_segment_windows``, exclusive hi; a tile with no valid
    token gets an empty window).  The axis is padded with ``-1`` to whole
    tiles.  The relation is symmetric, so one pair serves the q-major
    and the k-major walks of packed self-attention."""
    b, t = segments.shape
    n = -(-t // tile)
    seg = F.pad(segments, (0, n * tile - t), value=-1) \
        .reshape(b, n, tile)
    big = 2 ** 30
    valid = seg >= 0
    lo_id = torch.where(valid, seg, big).amin(dim=2)            # [B, n]
    hi_id = torch.where(valid, seg, -big).amax(dim=2)
    live = (hi_id[:, None, :] >= lo_id[:, :, None]) \
        & (lo_id[:, None, :] <= hi_id[:, :, None])              # [B, n, n]
    idx = torch.arange(n, dtype=torch.int32, device=segments.device)
    lo = torch.where(live, idx, n).amin(dim=2)
    hi = torch.where(live, idx, -1).amax(dim=2) + 1
    return lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous()


def tile_windows(lengths: Optional[torch.Tensor],
                 segments: Optional[torch.Tensor], b: int, tq: int, tk: int,
                 device) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """The kernels' live windows, in units of :data:`KERNEL_TILE` rows:
    ``((lo_q, hi_q), (lo_k, hi_k))`` int32, ``[B, ceil(Tq/64)]`` key
    tiles per q tile (kernels 1 and 3) and ``[B, ceil(Tk/64)]`` q tiles
    per key tile (kernel 4), exclusive hi.  Padded rows: key tiles below
    the row's length, and every q tile for a key tile that starts below
    it (the reference's ``_length_windows`` and its k-major liveness);
    packed: :func:`_segment_windows`.  The causal diagonal is applied in
    the kernels."""
    if segments is not None:
        win = _segment_windows(segments)
        return win, win
    n_q, n_k = -(-tq // KERNEL_TILE), -(-tk // KERNEL_TILE)
    if lengths is None:
        lens = torch.full((b,), tk, dtype=torch.int32, device=device)
    else:
        lens = lengths.to(torch.int32).clamp(0, tk)
    hi_q = ((lens + KERNEL_TILE - 1) // KERNEL_TILE)[:, None] \
        .expand(b, n_q).contiguous()
    starts = torch.arange(n_k, dtype=torch.int32, device=device) \
        * KERNEL_TILE
    hi_k = (starts[None, :] < lens[:, None]).to(torch.int32) * n_q
    return ((torch.zeros((b, n_q), dtype=torch.int32, device=device), hi_q),
            (torch.zeros((b, n_k), dtype=torch.int32, device=device), hi_k))


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


def _on_cuda(tensors) -> bool:
    """True when the (non-None) tensors are on CUDA (launch the kernel),
    False when all lie on the CPU (plain version); raises on anything
    else."""
    devs = {t.device for t in tensors if t is not None}
    enforce(len(devs) == 1, f"tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    enforce(dev.type == "cuda", f"unsupported device {dev}")
    return True


def _kernel_ready(tensors, d: int) -> bool:
    """:func:`_on_cuda`, raising on CUDA for what the serving kernels do
    not take."""
    if not _on_cuda(tensors):
        return False
    enforce(d % 4 == 0 and d <= 256,
            f"CUDA kernel needs head dim % 4 == 0 and <= 256, got {d}")
    enforce(all(t.data_ptr() % 16 == 0 for t in tensors),
            "CUDA kernel needs 16-byte aligned tensors")
    return True


def prefill_attention_packed(q, k, v, segments, causal: bool = False,
                             slot: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serving's packed (ragged-batch) fp32 prefill: tokens attend only
    within their segment; returns ``(out [B, T, H, D], lse [B, H, T])``
    in fp32.

    ``segments``: int32 ``[B, T]`` per-token segment ids, ``-1`` marking
    padding (which emits zeros).  ``causal`` applies along the packed
    axis.  The call takes the reference's decision (:func:`_fa_path`:
    the flags, the tiling gate at the reference's default blocks of 512,
    the ``slot`` hint's label): the block-sparse decision runs kernel 1
    in its serving form, every other the plain composition.

    The kernel gives each tile of 16 queries and each head one CTA: it
    scans the row's ids once for the tile's windows (a query's keys are
    those of its segment id from the id's first token, up to the query
    when causal), stages the windows' K and V rows in shared memory, and
    splits each query's keys over its 8 warps (key ``lo + w + 8 i`` to
    warp ``w``, ``lo`` the window's first key), 4 lanes of 8 dims a
    query at D 32, with an online softmax a key at a time; the warps'
    states meet in warp order.  A query's arithmetic depends only on its
    own keys, so a prompt gives the same bits alone as in a pack.
    """
    _check_float("q", q, 4)
    b, t, h, d = q.shape
    for name, x in (("k", k), ("v", v)):
        _check_float(name, x, 4)
        enforce(x.shape == q.shape,
                f"{name} shape {tuple(x.shape)} != q {tuple(q.shape)}")
    _check_int("segments", segments, (b, t))
    if (_fa_path(t, t, True, 512, 512, slot) != "sparse"
            or not _kernel_ready((q, k, v, segments), d)):
        return _dense_forward(q, k, v, None, causal, segments)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    _launch("flash_packed_fwd", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), segments.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, d, int(bool(causal)),
            1.0 / math.sqrt(d))
    prefill_attention_packed.launches += 1
    return out, lse


prefill_attention_packed.launches = 0


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


# ------------------------------------------------------- training wrappers
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _check_qkv(q, k, v) -> Tuple[int, int, int, int, int]:
    """(B, Tq, Tk, H, D) of ``q [B, Tq, H, D]``, ``k``/``v [B, Tk, H, D]``,
    all bf16 or all fp32 alike."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        enforce(isinstance(x, torch.Tensor) and x.dim() == 4,
                f"{name}: expected [B, T, H, D], got "
                f"{tuple(getattr(x, 'shape', ()))}")
        enforce(x.dtype in _DTYPE_CODE,
                f"{name}: expected bfloat16 or float32, got {x.dtype}")
    enforce(k.dtype == q.dtype and v.dtype == q.dtype,
            f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    b, tq, h, d = q.shape
    enforce(k.shape == v.shape and k.shape[0] == b and k.shape[2:] == (h, d),
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}")
    return b, tq, k.shape[1], h, d


def _check_rows(name: str, x, shape, dtype) -> None:
    enforce(isinstance(x, torch.Tensor) and tuple(x.shape) == tuple(shape)
            and x.dtype == dtype,
            f"{name}: expected {dtype} {tuple(shape)}, got "
            f"{getattr(x, 'dtype', type(x))} {tuple(getattr(x, 'shape', ()))}")


def _on_card(tensors, d: int) -> bool:
    """:func:`_on_cuda`, raising on CUDA for what the flash kernels do not
    take (:func:`_check_card`)."""
    if not _on_cuda(tensors):
        return False
    _check_card([x for x in tensors if x is not None], d)
    return True


def _check_card(tensors, d: int) -> None:
    """Raise on what the flash kernels do not take: a head dim they are
    not built for, or a tensor off 16-byte alignment."""
    enforce(d in KERNEL_HEAD_DIMS,
            f"the flash kernels take head dim {KERNEL_HEAD_DIMS}, got {d}")
    enforce(all(x.data_ptr() % 16 == 0 for x in tensors),
            "the flash kernels need 16-byte aligned tensors")


def _strides(name: str, x: torch.Tensor) -> Tuple[int, int]:
    """(batch, token) strides of a ``[B, T, H, D]`` operand whose heads'
    D values are contiguous and D apart — the kernels read q/k/v views of
    a packed projection in place — with rows at 16-byte multiples."""
    b, t, h, d = x.shape
    enforce(x.stride(3) == 1 and (h == 1 or x.stride(2) == d),
            f"{name}: expected contiguous heads, strides {x.stride()}")
    unit = 16 // x.element_size()
    sb = x.stride(0) if b > 1 else 0
    st = x.stride(1) if t > 1 else 0
    enforce(sb % unit == 0 and st % unit == 0,
            f"{name}: batch/token strides {sb}/{st} not 16-byte multiples")
    return sb, st


def _int_arg(name: str, x: Optional[torch.Tensor], shape) -> None:
    if x is not None:
        _check_int(name, x, shape)


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _launch(symbol: str, device, *args) -> None:
    """Launch ``symbol`` on the current stream of ``device``; raise if
    the launch is refused."""
    err = _build.kernel(symbol)(
        *args, torch.cuda.current_stream(device).cuda_stream)
    enforce(err == 0, f"{symbol} launch failed (cudaError {err})")


def _is_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _windows(win, lengths, segments, b, tq, tk, device, which: int):
    """The caller's window pair, or the call's own (:func:`tile_windows`)."""
    if win is None:
        win = tile_windows(lengths, segments, b, tq, tk, device)[which]
    n = -(-(tq if which == 0 else tk) // KERNEL_TILE)
    for name, x in zip(("win_lo", "win_hi"), win):
        _check_int(name, x, (b, n))
    return win


def _common_args(q, k, v, lengths, segments, causal):
    b, tq, tk, h, d = _check_qkv(q, k, v)
    enforce(not causal or tq == tk,
            f"causal attention needs Tq == Tk, got {tq}/{tk}")
    enforce(segments is None or tq == tk,
            f"packed attention needs Tq == Tk, got {tq}/{tk}")
    _int_arg("lengths", lengths, (b,))
    _int_arg("segments", segments, (b, tk))
    return b, tq, tk, h, d


def flash_fwd(q, k, v, lengths=None, segments=None, causal: bool = False,
              windows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1, training form (``csrc/flash_fwd.cu``): ``(out [B, Tq, H,
    D] in q's dtype, lse [B, H, Tq] f32)`` over the live key tiles.

    ``lengths`` int32 ``[B]`` valid keys per row (None: all), or
    ``segments`` int32 ``[B, T]`` packed segment ids (self-attention);
    ``windows`` the q-major pair of :func:`tile_windows` (computed here
    when None).  Plain version: :func:`_dense_forward`."""
    b, tq, tk, h, d = _common_args(q, k, v, lengths, segments, causal)
    if not _on_card((q, k, v, lengths, segments), d):
        return _dense_forward(q, k, v, lengths, causal, segments)
    lo, hi = _windows(windows, lengths, segments, b, tq, tk, q.device, 0)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch("flash_fwd", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(lengths),
            _ptr(segments), lo.data_ptr(), hi.data_ptr(), b, tq, tk, h, d,
            _DTYPE_CODE[q.dtype], *_strides("q", q), *_strides("k", k),
            *_strides("v", v), int(bool(causal)), 1.0 / math.sqrt(d))
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _bwd_args(q, k, v, do, lse, delta, lengths, segments, causal):
    b, tq, tk, h, d = _common_args(q, k, v, lengths, segments, causal)
    _check_rows("do", do, (b, tq, h, d), q.dtype)
    _check_rows("lse", lse, (b, h, tq), torch.float32)
    _check_rows("delta", delta, (b, h, tq), torch.float32)
    enforce(lse.is_contiguous() and delta.is_contiguous(),
            "lse/delta: expected contiguous tensors")
    return b, tq, tk, h, d


def flash_bwd_dq(q, k, v, do, lse, delta, lengths=None, segments=None,
                 causal: bool = False, windows=None) -> torch.Tensor:
    """Kernel 3 (``csrc/flash_bwd_dq.cu``): dq ``[B, Tq, H, D]`` in q's
    dtype from the forward's ``lse`` and ``delta`` (:func:`_delta`), over
    the same live key tiles as :func:`flash_fwd`.  Plain version:
    :func:`_dense_grads`."""
    b, tq, tk, h, d = _bwd_args(q, k, v, do, lse, delta, lengths, segments,
                                causal)
    if not _on_card((q, k, v, do, lse, delta, lengths, segments), d):
        return _dense_grads(q, k, v, do, lse, delta, lengths, causal,
                            segments, want="dq")
    lo, hi = _windows(windows, lengths, segments, b, tq, tk, q.device, 0)
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    _launch("flash_bwd_dq", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), _ptr(lengths), _ptr(segments), lo.data_ptr(),
            hi.data_ptr(), b, tq, tk, h, d, _DTYPE_CODE[q.dtype],
            *_strides("q", q), *_strides("k", k), *_strides("v", v),
            *_strides("do", do), int(bool(causal)), 1.0 / math.sqrt(d))
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, lengths=None, segments=None,
                  causal: bool = False, windows=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4 (``csrc/flash_bwd_dkv.cu``): ``(dk, dv) [B, Tk, H, D]`` in
    k's and v's dtype over each key tile's live q tiles (``windows``: the
    k-major pair of :func:`tile_windows`).  Plain version:
    :func:`_dense_grads`."""
    b, tq, tk, h, d = _bwd_args(q, k, v, do, lse, delta, lengths, segments,
                                causal)
    if not _on_card((q, k, v, do, lse, delta, lengths, segments), d):
        return _dense_grads(q, k, v, do, lse, delta, lengths, causal,
                            segments, want="dkv")
    lo, hi = _windows(windows, lengths, segments, b, tq, tk, q.device, 1)
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, tk, h, d), dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    _launch("flash_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _ptr(lengths), _ptr(segments),
            lo.data_ptr(), hi.data_ptr(), b, tq, tk, h, d,
            _DTYPE_CODE[q.dtype], *_strides("q", q), *_strides("k", k),
            *_strides("v", v), *_strides("do", do), int(bool(causal)),
            1.0 / math.sqrt(d))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_fwd_legacy(q, k, v, lengths=None, causal: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2, the legacy full grid (``flash_fwd_legacy`` in
    ``csrc/flash_fwd.cu``): :func:`flash_fwd`'s result for padded rows;
    no windows: each q tile's live keys (key length, causal diagonal) are
    bounded in the kernel, and only those are loaded.  Plain version:
    :func:`_dense_forward`."""
    b, tq, tk, h, d = _common_args(q, k, v, lengths, None, causal)
    if not _on_card((q, k, v, lengths), d):
        return _dense_forward(q, k, v, lengths, causal)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch("flash_fwd_legacy", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(lengths), b,
            tq, tk, h, d, _DTYPE_CODE[q.dtype], *_strides("q", q),
            *_strides("k", k), *_strides("v", v), int(bool(causal)),
            1.0 / math.sqrt(d))
    flash_fwd_legacy.launches += 1
    return out, lse


flash_fwd_legacy.launches = 0


def flash_bwd_dq_legacy(q, k, v, do, lse, delta, lengths=None,
                        causal: bool = False) -> torch.Tensor:
    """Kernel 5, the legacy grid's dq (``flash_bwd_dq_legacy`` in
    ``csrc/flash_bwd_dq.cu``).  Plain version: :func:`_dense_grads`."""
    b, tq, tk, h, d = _bwd_args(q, k, v, do, lse, delta, lengths, None,
                                causal)
    if not _on_card((q, k, v, do, lse, delta, lengths), d):
        return _dense_grads(q, k, v, do, lse, delta, lengths, causal,
                            want="dq")
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    _launch("flash_bwd_dq_legacy", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), _ptr(lengths), b, tq, tk, h, d,
            _DTYPE_CODE[q.dtype], *_strides("q", q), *_strides("k", k),
            *_strides("v", v), *_strides("do", do), int(bool(causal)),
            1.0 / math.sqrt(d))
    flash_bwd_dq_legacy.launches += 1
    return dq


flash_bwd_dq_legacy.launches = 0


def flash_bwd_dkv_legacy(q, k, v, do, lse, delta, lengths=None,
                         causal: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 6, the legacy grid's dk and dv (``flash_bwd_dkv_legacy`` in
    ``csrc/flash_bwd_dkv.cu``): every q tile loaded for each key tile,
    the live ones computed.  Plain version: :func:`_dense_grads`."""
    b, tq, tk, h, d = _bwd_args(q, k, v, do, lse, delta, lengths, None,
                                causal)
    if not _on_card((q, k, v, do, lse, delta, lengths), d):
        return _dense_grads(q, k, v, do, lse, delta, lengths, causal,
                            want="dkv")
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, tk, h, d), dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    _launch("flash_bwd_dkv_legacy", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _ptr(lengths), b, tq, tk, h, d,
            _DTYPE_CODE[q.dtype], *_strides("q", q), *_strides("k", k),
            *_strides("v", v), *_strides("do", do), int(bool(causal)),
            1.0 / math.sqrt(d))
    flash_bwd_dkv_legacy.launches += 1
    return dk, dv


flash_bwd_dkv_legacy.launches = 0


# ------------------------------------------------------ dispatch, autograd
def _fa_path(tq: int, tk: int, packed: bool, block_q: int, block_k: int,
             slot: int = 0) -> str:
    """The reference's ``_fa_forward`` decision order, recorded in
    :data:`attention_dispatch_total` with its label → ``"dense"`` (flash
    off; an untileable shape, with the one-time warning; packed under
    ``--flash_block_sparse=false``), ``"sparse"`` (``block_sparse``, or
    ``packed`` with the slot-hint warning) or ``"legacy"`` (the full
    grid).  ``block_q``/``block_k`` matter only through this gate: the
    kernels use their own tiles."""
    bq = _choose_block(tq, block_q)
    bk = _choose_block(tk, block_k)
    if not FLAGS.get("flash_kernel"):
        record_attention_dispatch("dense", "kill_switch:flash_kernel")
        return "dense"
    if not _tiling_ok(tq, tk, bq, bk):
        reason = "untileable shape (lse/kv block constraints)"
        record_attention_dispatch("dense", reason)
        _warn_dense_fallback(reason, tq, tk, bq, bk)
        return "dense"
    if FLAGS.get("flash_block_sparse"):
        reason = ""
        if packed and slot and (slot % bq or slot % bk):
            reason = "slot hint unusable (blocks straddle slots)"
            warn_once(
                f"flash_attention_packed_slot:{slot}:{bq}x{bk}",
                "flash_attention_packed: slot hint %d unusable with blocks "
                "%d/%d (not whole blocks per slot)", slot, bq, bk,
                logger=_log)
        record_attention_dispatch("packed" if packed else "block_sparse",
                                  reason)
        return "sparse"
    if packed:
        record_attention_dispatch(
            "dense", "kill_switch:flash_block_sparse(packed)")
        return "dense"
    record_attention_dispatch("legacy_grid",
                              "kill_switch:flash_block_sparse")
    return "legacy"


def _fa_forward(q, k, v, lengths, causal, block_q, block_k, segments=None,
                slot=0):
    """:func:`_fa_path`'s decision run → ``(out, lse, path, windows)``:
    dense → the plain composition; sparse → kernel 1; legacy → the
    legacy grid (kernel 2)."""
    b, tq, tk, h, d = _check_qkv(q, k, v)
    enforce(not causal or tq == tk,
            f"causal attention needs Tq == Tk, got {tq}/{tk}")
    packed = segments is not None
    enforce(not packed or tq == tk, "packed attention is self-attention: "
            f"one segment table, Tq == Tk, got {tq}/{tk}")
    path = _fa_path(tq, tk, packed, block_q, block_k, slot)
    if path == "dense":
        return (*_dense_forward(q, k, v, lengths, causal, segments),
                "dense", None)
    if path == "sparse":
        windows = tile_windows(lengths, segments, b, tq, tk, q.device) \
            if _is_cuda(q) else (None, None)
        return (*flash_fwd(q, k, v, lengths, segments, causal, windows[0]),
                "sparse", windows)
    return (*flash_fwd_legacy(q, k, v, lengths, causal), "legacy", None)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` rules: the forward runs the
    dispatch and saves ``(q, k, v, lengths | segments, out, lse)``; the
    backward takes the forward's path — kernels 3 then 4 on the
    block-sparse path, 5 then 6 on the legacy grid, the plain dense
    backward on the dense path."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, segments, causal, block_q, block_k,
                slot):
        out, lse, path, windows = _fa_forward(
            q, k, v, lengths, causal, block_q, block_k, segments, slot)
        ctx.save_for_backward(q, k, v, lengths, segments, out, lse)
        ctx.path, ctx.windows, ctx.causal = path, windows, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, segments, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or do.stride(-2) != do.shape[-1]:
            do = do.contiguous()
        if ctx.path == "sparse":
            delta = _delta(out, do)
            dq = flash_bwd_dq(q, k, v, do, lse, delta, lengths, segments,
                              ctx.causal, ctx.windows[0])
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, lengths,
                                   segments, ctx.causal, ctx.windows[1])
        elif ctx.path == "legacy":
            delta = _delta(out, do)
            dq = flash_bwd_dq_legacy(q, k, v, do, lse, delta, lengths,
                                     ctx.causal)
            dk, dv = flash_bwd_dkv_legacy(q, k, v, do, lse, delta, lengths,
                                          ctx.causal)
        else:
            dq, dk, dv = _dense_backward(q, k, v, lengths, out, lse, do,
                                         ctx.causal, segments)
        return dq, dk, dv, None, None, None, None, None, None


def _as_index(x: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return x.to(device=device, dtype=torch.int32).contiguous()


def flash_attention(q, k, v, lengths=None, causal: bool = False,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v without a ``[T, T]`` score matrix in memory.

    q ``[B, Tq, H, D]``, k and v ``[B, Tk, H, D]`` (bf16 or fp32 alike);
    returns ``[B, Tq, H, D]`` in q's dtype.  ``lengths``: optional int
    ``[B]`` valid key lengths — keys at or past the length are masked out
    of the softmax, and (block-sparse path) key tiles wholly past it are
    neither loaded nor visited."""
    return _FlashAttention.apply(q, k, v, _as_index(lengths, q.device), None,
                                 bool(causal), int(block_q), int(block_k), 0)


def flash_attention_packed(q, k, v, segments, causal: bool = False,
                           block_q: int = 512, block_k: int = 512,
                           slot: int = 0) -> torch.Tensor:
    """Packed (ragged-batch) attention: tokens attend only within their
    segment.

    q, k, v ``[B, T_total, H, D]``; ``segments`` int ``[B, T_total]``
    per-token ids, non-decreasing over valid tokens with ``-1`` marking
    padding (the packing contract).  Padding tokens give zero output and
    zero gradients; ``causal`` applies along the packed axis.  ``slot``
    (the reference's static slot width) enters only the dispatch labels:
    the kernels' windows come from the segment ids themselves."""
    return _FlashAttention.apply(q, k, v, None,
                                 _as_index(segments, q.device),
                                 bool(causal), int(block_q), int(block_k),
                                 int(slot))


#: Every kernel wrapper of this module (for counters and reports).
KERNEL_WRAPPERS = (prefill_attention_packed, paged_decode_attention,
                   flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_fwd_legacy,
                   flash_bwd_dq_legacy, flash_bwd_dkv_legacy)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
