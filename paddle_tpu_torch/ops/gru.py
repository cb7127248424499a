"""Fused GRU sequence (counterpart of ``paddle_tpu/ops/pallas_gru.py``:
its single-block tier and its hidden-blocked tier).

Hand-written CUDA C++ kernels for ``sm_90a``, each a whole time loop of
one GRU direction in one launch, except the last (an ordinary product):

- single-block tier, H <= 512 (``"fused"``): :func:`gru_fwd`
  (``csrc/gru_fwd.cu``, kernel 13; plain version
  :func:`gru_fwd_reference`) writes the kept state sequence H and the
  gate residue (u, r, c); :func:`gru_bwd` (``csrc/gru_bwd.cu``, kernel
  14; plain version :func:`gru_bwd_reference`) gives dxw, dW_gates,
  dW_cand and dh0;
- hidden-blocked tier, 512 < H (``"fused_blocked"``):
  :func:`gru_fwd_blocked` (``csrc/gru_fwd_blocked.cu``, kernel 15;
  plain :func:`gru_fwd_blocked_reference`), :func:`gru_bwd_blocked`
  (``csrc/gru_bwd_blocked.cu``, kernel 16; plain
  :func:`gru_bwd_blocked_reference`: dxw, dh0 and r·h_prev, no dW) and
  :func:`gru_dw_blocked` (``csrc/gru_dw_blocked.cu``, kernel 17; plain
  :func:`gru_dw_blocked_reference`: dW_gates, dW_cand).

Kernel 13 runs each group of :data:`CLUSTER_ROWS` batch rows in one
thread-block cluster of ceil(H / :data:`UNITS`) CTAs (no grid barrier):
each CTA keeps its units' columns of both weights resident as bf16
hi/lo planes and takes the whole K of both step products on wgmma, the
group's h_{t-1} and r·h_{t-1} handed between the cluster's CTAs through
distributed shared memory; every row enters every step's products (the
residue of a padded step is computed from the kept state).  Kernels
14-16 are persistent cooperative launches that run their two step
products on the LSTM's tensor-core step loop (``csrc/lstm_wg.cuh``:
bf16 hi/lo planes they write themselves, each step's in compacted row
order, tiles of 128 rows x 128 columns x one K slice summed in order by
the (row, unit) pairs, four grid barriers a step): the forward's gates
= h_{t-1} @ w_gates and candidate (r·h_{t-1}) @ w_cand (K slices from
:func:`fwd_blocked_slices`), the backward's drh = dc_pre_t @ w_candᵀ and
the carry's dg_t @ w_gatesᵀ (:func:`bwd_slices`,
:func:`bwd_blocked_slices`).  Kernels 14 and 16 are one kernel template
(``csrc/gru_wg.cuh``); kernel 14 adds dW_gates and dW_cand after its
time loop, and kernel 17 computes them for the blocked tier, both on
the tensor-core dW tile (``csrc/dw_wg.cuh``).  Their products take only
the rows valid at each step (a padded step keeps h, the blocked forward
writes its residue as 0, and its dxw is exact zeros).  Every
tensor-core product takes its f32 operands as hi + lo bf16, three
passes, each 64-deep chunk's sums added in f32.

Gate layout (u, r, c), w_gates ``[H, 2H]`` (u | r), w_cand ``[H, H]``;
the reset gate applies before the candidate product: c = tanh(x_c +
(r·h) @ w_cand), h' = u·h + (1−u)·c, and a padded step keeps h.

:class:`_GruCore` and :class:`_GruCoreBlocked` (``torch.autograd.
Function``) launch the forward kernel in their forward and the backward
kernel(s) in their backward, as ``pallas_gru._gru_core`` /
``_gru_core_blocked`` do with their custom VJPs;
:func:`gru_fused_sequence` and :func:`gru_fused_sequence_blocked` are
the public functions.

Layouts are batch-major throughout (xw / gates / dxw ``[B, T, 3H]``,
states ``[B, T, H]``, mask ``[B, T]``), so no time-major copy is made
and the JAX tier's block-gate permutation is not carried over.  A
wrapper checks dtype (fp32 only), shape and contiguity first.  CPU
tensors then take the plain version; CUDA tensors launch the kernel or
raise — a shape the kernel's tier does not serve (:func:`fused_tier`)
raises too, never falls back.  Each wrapper counts its launches in
``.launches``.

Precision: the kernels compute in fp32, whatever the policy (the
products of kernels 13-17 as three bf16 passes of the f32 operands' hi
and lo parts).  The public functions cast xw to fp32 before the kernels
(a bf16 xw converts exactly), so autograd returns dxw in xw's dtype, as
``_gru_core_bwd`` and ``_gru_core_blocked_bwd`` cast dxw to xw's dtype
(``pallas_gru.py:213,524``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import FLAGS, PaddleTpuError, enforce
from . import _build, export_ops
from .lstm import (CHUNK, MAX_DW_SPLIT, SM_COUNT, SMEM_BYTES, TILE_COLS,
                   TILE_ROWS, _RING_BYTES, _check, _launch, _on_card,
                   _plane_slices, _shifted, _sms)

#: Hidden units per CTA of the single-block forward (kernel 13: the 2U
#: gate columns are the 64 rows of one wgmma tile), and batch rows per
#: cluster (the tile's 16 columns).
UNITS, CLUSTER_ROWS = 32, 32
#: Largest H the single-block kernels take; above it, the blocked tier
#: (kernels 15-17).
MAX_HIDDEN = 512
#: Largest H of the blocked tier: the kernels count a row-step's 3H gate
#: columns and w_hh's 3H^2 elements in 32-bit ints.
MAX_BLOCKED_HIDDEN = 26754
# kernel 13's shared memory per 64-wide chunk of K, in bytes: its units'
# gate planes (hi, lo: 64 rows x 128 bytes each) and the cluster's buffer
# (32 rows, hi and lo); and per two chunks, its candidate hi planes (32
# rows each)
_FWD_CHUNK_BYTES, _FWD_CAND_BYTES = 2 * 8192 + 2 * 4096, 8192
# the blocked tier's shared memory, in floats: kernels 15 and 16 run on
# the tensor-core step loop's ring (csrc/lstm_wg.cuh), kernel 17 on the
# dW tile's (csrc/dw_wg.cuh), each 1 KB of alignment and 3 stages of four
# 16 KB bf16 planes, whatever B and H
_BLOCKED_FLOATS = (_RING_BYTES // 4, (1024 + 3 * 4 * 64 * 128 * 2) // 4)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(b: int, h: int) -> Tuple[int, int]:
    """Dynamic shared memory of the single-block (forward, backward)
    kernels, in bytes: kernel 13's arithmetic (``csrc/gru_fwd.cu``: 1 KB
    of alignment, then per 64-wide chunk of K its units' gate planes and
    the cluster's buffer, per two chunks its candidate hi planes, any b)
    and kernel 14's ring (``csrc/gru_wg.cuh`` on ``csrc/lstm_wg.cuh``, any
    b and h)."""
    nch = -(-h // CHUNK)
    return (1024 + nch * _FWD_CHUNK_BYTES + -(-nch // 2) * _FWD_CAND_BYTES,
            _RING_BYTES)


def fwd_blocked_slices(b: int, h: int, sms: int = SM_COUNT
                       ) -> Tuple[int, int]:
    """K slices of kernel 15's two step products at (b, h), on
    ``lstm._plane_slices``' rule: the gates (K = h, 128-column blocks of
    64 units' u and r) and the candidate (K = h, 128-unit blocks) (at B
    128, H 1024 on 132 SMs: 16 column blocks x 8 slices of 2 chunks, 128
    tiles, and 8 x 8 slices of 2, 64 tiles)."""
    rows, chunks = -(-b // TILE_ROWS), -(-h // CHUNK)
    return (_plane_slices(chunks, rows * -(-h // (TILE_COLS // 2)), sms),
            _plane_slices(chunks, rows * -(-h // TILE_COLS), sms))


def bwd_blocked_slices(b: int, h: int, sms: int = SM_COUNT
                       ) -> Tuple[int, int]:
    """K slices of kernel 16's two step products at (b, h), on
    ``lstm._plane_slices``' rule: drh (K = h) and the carry's pull-back
    (K = 2h), both in 128-unit column blocks (at B 128, H 1024 on 132
    SMs: 8 unit blocks x 8 slices of 2 chunks, 64 tiles, and 8 x 16
    slices of 2, 128 tiles)."""
    blocks = -(-b // TILE_ROWS) * -(-h // TILE_COLS)
    return (_plane_slices(-(-h // CHUNK), blocks, sms),
            _plane_slices(-(-2 * h // CHUNK), blocks, sms))


def bwd_slices(b: int, h: int, sms: int = SM_COUNT) -> Tuple[int, int]:
    """K slices of kernel 14's two step products at (b, h): the rule of
    :func:`bwd_blocked_slices` down to one chunk a slice -- at h <= 512
    the products have few 128-unit column blocks (4 at H 512), and
    one-chunk slices keep more SMs on the tiles (at B 128, H 512 on 132
    SMs: drh 4 unit blocks x 8 slices of 1 chunk, 32 tiles, and the carry
    4 x 16, 64 tiles)."""
    blocks = -(-b // TILE_ROWS) * -(-h // TILE_COLS)
    return (_plane_slices(-(-h // CHUNK), blocks, sms, 1),
            _plane_slices(-(-2 * h // CHUNK), blocks, sms, 1))


def bwd_dw_splits(h: int, sms: int = SM_COUNT) -> int:
    """Splits of kernel 14's dW row list: as many as keep its 128 x 128
    output tiles of [h, 2h] and [h, h] times the splits within one CTA an
    SM, at most MAX_DW_SPLIT (at H 512 on 132 SMs: 48 tiles x 2)."""
    tiles = -(-h // 128) * (-(-2 * h // 128) + -(-h // 128))
    return max(1, min(MAX_DW_SPLIT, sms // tiles))


def fused_tier(b: int, h: int, sms: int = SM_COUNT) -> Optional[str]:
    """Which kernels serve (b, h) on a card with ``sms`` SMs:

    - ``"fused"``: 1 <= h <= 512, both kernels' shared memory within one
      block's limit (kernel 13's clusters of ceil(h / 32) <= 16 CTAs run
      in waves when the card holds fewer at once; kernel 14 takes one
      CTA an SM; any b and any SM count);
    - ``"fused_blocked"``: 512 < h <= MAX_BLOCKED_HIDDEN under
      ``--fused_rnn_hblock`` (default on).  The blocked kernels stride
      over their tiles with as many CTAs as are co-resident, so any B
      and any SM count serve; each kernel's shared memory (at most
      193 KB) is within one block's limit;
    - ``None`` otherwise.  No tiling gate in either tier: which shapes
      reach the kernels from ``gru_sequence`` is the reference's rule
      (``recurrent_ops.dispatch_tier``)."""
    if b < 1 or h < 1:
        return None
    if h <= MAX_HIDDEN:
        return "fused" if max(smem_bytes(b, h)) <= SMEM_BYTES else None
    if not FLAGS.get("fused_rnn_hblock") or h > MAX_BLOCKED_HIDDEN \
            or sms < 1 or 4 * max(_BLOCKED_FLOATS) > SMEM_BYTES:
        return None
    return "fused_blocked"


# ------------------------------------------------------------ plain versions
def gru_fwd_reference(xw, mask, w_gates, w_cand, h0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`gru_fwd`: the step loop of
    ``pallas_gru._fwd_kernel``, batch-major."""
    b, t, hd3 = xw.shape
    hd = hd3 // 3
    h_prev = h0
    hs, gs = [], []
    for s in range(t):
        x = xw[:, s]
        g = h_prev @ w_gates
        u = torch.sigmoid(x[:, :hd] + g[:, :hd])
        r = torch.sigmoid(x[:, hd:2 * hd] + g[:, hd:])
        c = torch.tanh(x[:, 2 * hd:] + (r * h_prev) @ w_cand)
        h_new = u * h_prev + (1.0 - u) * c
        m = mask[:, s, None]
        h_prev = m * h_new + (1.0 - m) * h_prev
        hs.append(h_prev)
        gs.append(torch.cat([u, r, c], dim=-1))
    return torch.stack(hs, 1), torch.stack(gs, 1)


def gru_fwd_blocked_reference(xw, mask, w_gates, w_cand, h0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`gru_fwd_blocked`: :func:`gru_fwd_reference`
    with the residue (u, r, c) of padded steps written as 0 (the kernel
    skips their products; the backward's masked split never reads them).
    At valid steps H and the residue are ``pallas_gru._fwd_call_blocked``'s,
    in the batch-major (u | r | c) layout."""
    hseq, gates = gru_fwd_reference(xw, mask, w_gates, w_cand, h0)
    return hseq, gates * (mask != 0).to(gates.dtype)[..., None]


def gru_bwd_blocked_reference(gates, hseq, h0, mask, w_gates, w_cand, dy):
    """Plain version of :func:`gru_bwd_blocked`: the reversed step loop of
    ``pallas_gru._bwd_kernel_blocked``; dy joins the carry before the
    masked split → (dxw ``[B, T, 3H]`` = du_pre | dr_pre | dc_pre, dh0,
    rh ``[B, T, H]`` = r·h_prev, which dW_cand takes)."""
    b, t, hd3 = gates.shape
    hd = hd3 // 3
    h_prev_seq = _shifted(hseq, h0)
    dh_c = torch.zeros_like(h0)
    dxw = torch.empty_like(gates)
    for s in range(t - 1, -1, -1):
        g = gates[:, s]
        u, r, c = g[:, :hd], g[:, hd:2 * hd], g[:, 2 * hd:]
        h_prev = h_prev_seq[:, s]
        m = mask[:, s, None]
        dh_tot = dy[:, s] + dh_c
        dh_new = m * dh_tot
        du_pre = dh_new * (h_prev - c) * u * (1.0 - u)
        dc_pre = dh_new * (1.0 - u) * (1.0 - c * c)
        drh = dc_pre @ w_cand.t()
        dr_pre = drh * h_prev * r * (1.0 - r)
        dg = torch.cat([du_pre, dr_pre], dim=-1)
        dh_prev = dh_new * u + drh * r + dg @ w_gates.t()
        dh_c = (1.0 - m) * dh_tot + dh_prev
        dxw[:, s] = torch.cat([dg, dc_pre], dim=-1)
    return dxw, dh_c, gates[..., hd:2 * hd] * h_prev_seq


def gru_dw_blocked_reference(hseq, h0, rh, dxw, mask
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`gru_dw_blocked`: dW_gates = sum over the
    valid (b, t) of h_{t-1}[b]^T dg_t[b] and dW_cand = sum of
    rh_t[b]^T dc_pre_t[b], one summed product each (the rows of
    ``pallas_gru._dw_kernel_blocked``'s T loop)."""
    hd = h0.shape[-1]
    keep = (mask != 0).to(hseq.dtype)[..., None]
    h_prev = (_shifted(hseq, h0) * keep).reshape(-1, hd)
    d = dxw.reshape(-1, 3 * hd)
    return (h_prev.t() @ d[:, :2 * hd],
            (rh * keep).reshape(-1, hd).t() @ d[:, 2 * hd:])


def gru_bwd_reference(gates, hseq, h0, mask, w_gates, w_cand, dy):
    """Plain version of :func:`gru_bwd`: the reversed step loop of
    ``pallas_gru._bwd_kernel``; dy joins the carry before the masked
    split.  The weight gradients are one summed product each over the
    valid (b, t) after the loop (a padded step's dgates are exact zeros)
    → (dxw, dw_gates, dw_cand, dh0)."""
    dxw, dh0, rh = gru_bwd_blocked_reference(gates, hseq, h0, mask,
                                             w_gates, w_cand, dy)
    return (dxw, *gru_dw_blocked_reference(hseq, h0, rh, dxw, mask), dh0)


# ------------------------------------------------------------------ wrappers
def _check_gates(name: str, x) -> Tuple[int, int, int]:
    enforce(isinstance(x, torch.Tensor) and x.dim() == 3
            and x.shape[-1] % 3 == 0,
            f"{name}: expected [B, T, 3H], got "
            f"{tuple(getattr(x, 'shape', ()))}")
    b, t, hd3 = x.shape
    return b, t, hd3 // 3


def _tier_on_card(b: int, h: int, dev: torch.device, want: str) -> None:
    """Raise unless ``fused_tier`` gives ``want`` for (b, h) on ``dev``."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else SM_COUNT
    if fused_tier(b, h, sms) != want:
        raise PaddleTpuError(
            f"the {want!r} GRU kernels do not serve batch={b} hidden={h} "
            f"(fused: hidden <= {MAX_HIDDEN}, shared memory <= "
            f"{SMEM_BYTES} B; fused_blocked: "
            f"{MAX_HIDDEN} < hidden <= {MAX_BLOCKED_HIDDEN} with "
            "--fused_rnn_hblock on)")


def _check_fwd(xw, mask, w_gates, w_cand, h0) -> Tuple[int, int, int]:
    b, t, hd = _check_gates("xw", xw)
    for name, x, shape in (("xw", xw, (b, t, 3 * hd)), ("mask", mask, (b, t)),
                           ("w_gates", w_gates, (hd, 2 * hd)),
                           ("w_cand", w_cand, (hd, hd)), ("h0", h0, (b, hd))):
        _check(name, x, shape)
    return b, t, hd


def _check_bwd(gates, hseq, h0, mask, w_gates, w_cand, dy
               ) -> Tuple[int, int, int]:
    b, t, hd = _check_gates("gates", gates)
    for name, x, shape in (("gates", gates, (b, t, 3 * hd)),
                           ("hseq", hseq, (b, t, hd)), ("h0", h0, (b, hd)),
                           ("mask", mask, (b, t)),
                           ("w_gates", w_gates, (hd, 2 * hd)),
                           ("w_cand", w_cand, (hd, hd)),
                           ("dy", dy, (b, t, hd))):
        _check(name, x, shape)
    return b, t, hd


def gru_fwd(xw, mask, w_gates, w_cand, h0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward time loop (kernel 13): xw ``[B, T, 3H]`` (input projection
    and bias applied), mask ``[B, T]`` float, w_gates ``[H, 2H]``,
    w_cand ``[H, H]``, h0 ``[B, H]`` → (H ``[B, T, H]`` kept states,
    gates ``[B, T, 3H]`` = u, r, c)."""
    export_ops.refuse_export("kernel 13 (gru_fwd)")
    b, t, hd = _check_fwd(xw, mask, w_gates, w_cand, h0)
    args = (xw, mask, w_gates, w_cand, h0)
    if not _on_card(args):
        return gru_fwd_reference(*args)
    _tier_on_card(b, hd, xw.device, "fused")
    hseq = torch.empty((b, t, hd), dtype=torch.float32, device=xw.device)
    gates = torch.empty_like(xw)
    if xw.numel() == 0:
        return hseq, gates
    _launch("gru_fwd", [x.data_ptr() for x in args + (hseq, gates)],
            (b, t, hd), xw.device)
    gru_fwd.launches += 1
    return hseq, gates


gru_fwd.launches = 0


def _bwd_scratch(h0, t, n_c, n_g):
    """Scratch of the BPTT kernels 14 and 16 at h0's batch and width: the
    local share of the carry and drh·r per (row, unit); a product's sums
    by K slice; each step's row ranks and counts; the hi and lo bf16
    planes of w_cand, w_gates (pitch kc, kg = H, 2H rounded up to 64)
    and of a step's dc_pre and dg = (du_pre | dr_pre)."""
    (b, hd), dev = h0.shape, h0.device
    kc, kg = _round_up(hd, CHUNK), _round_up(2 * hd, CHUNK)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    return (torch.empty_like(h0), torch.empty_like(h0),
            torch.empty((max(n_c, n_g), b, hd), dtype=torch.float32,
                        device=dev),
            torch.empty(t * b + t, dtype=torch.int32, device=dev),
            torch.empty((2, hd, kc), **bf16), torch.empty((2, hd, kg), **bf16),
            torch.empty((2, b, kc), **bf16), torch.empty((2, b, kg), **bf16))


def gru_bwd(gates, hseq, h0, mask, w_gates, w_cand, dy):
    """BPTT over the forward's residuals (kernel 14): gates ``[B, T,
    3H]``, H ``[B, T, H]``, h0, mask, w_gates, w_cand as in
    :func:`gru_fwd`, dy ``[B, T, H]`` the cotangent on H → (dxw ``[B,
    T, 3H]``, dw_gates ``[H, 2H]``, dw_cand ``[H, H]``, dh0 ``[B, H]``)."""
    b, t, hd = _check_bwd(gates, hseq, h0, mask, w_gates, w_cand, dy)
    args = (gates, hseq, h0, mask, w_gates, w_cand, dy)
    if not _on_card(args):
        return gru_bwd_reference(*args)
    dev = gates.device
    _tier_on_card(b, hd, dev, "fused")
    enforce(b * t < 2 ** 31, "the GRU backward counts B*T in int32")
    dxw = torch.empty_like(gates)
    dwg = torch.empty_like(w_gates)
    dwc = torch.empty_like(w_cand)
    dh0 = torch.empty_like(h0)
    if gates.numel() == 0:
        return dxw, dwg.zero_(), dwc.zero_(), dh0.zero_()
    n_c, n_g = bwd_slices(b, hd, _sms(dev))
    n_split = bwd_dw_splits(hd, _sms(dev))
    # scratch: r * h_prev of every step (dW_cand's rows) and kernel 16's
    # (_bwd_scratch); the valid rows' list; one [H, 3H] dW sum per split
    # of the list
    rh = torch.empty_like(hseq)
    dhl, drr, part, rank, *planes = _bwd_scratch(h0, t, n_c, n_g)
    rows = torch.empty(b * t, dtype=torch.int32, device=dev)
    dw_part = torch.empty((n_split if n_split > 1 else 0, hd, 3 * hd),
                          dtype=torch.float32, device=dev)
    _launch("gru_bwd",
            [x.data_ptr() for x in args + (dxw, dwg, dwc, dh0, rh, dhl, drr,
                                           part, rank, rows, *planes,
                                           dw_part)],
            (b, t, hd, n_c, n_g, n_split), dev)
    gru_bwd.launches += 1
    return dxw, dwg, dwc, dh0


gru_bwd.launches = 0


def gru_fwd_blocked(xw, mask, w_gates, w_cand, h0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked-tier forward (kernel 15), the contract of :func:`gru_fwd`
    except that the residue of padded steps is 0; its plain version is
    :func:`gru_fwd_blocked_reference`."""
    export_ops.refuse_export("kernel 15 (gru_fwd_blocked)")
    b, t, hd = _check_fwd(xw, mask, w_gates, w_cand, h0)
    args = (xw, mask, w_gates, w_cand, h0)
    if not _on_card(args):
        return gru_fwd_blocked_reference(*args)
    _tier_on_card(b, hd, xw.device, "fused_blocked")
    enforce(b * t < 2 ** 31, "the blocked GRU kernels count B*T in int32")
    hseq = torch.empty((b, t, hd), dtype=torch.float32, device=xw.device)
    gates = torch.empty_like(xw)
    if xw.numel() == 0:
        return hseq, gates
    dev = xw.device
    s_g, s_c = fwd_blocked_slices(b, hd, _sms(dev))
    kp, n_g = _round_up(hd, CHUNK), 2 * _round_up(hd, TILE_COLS // 2)
    # scratch: a product's sums by K slice (the gates' n_g columns, unit
    # block x gate x unit, or the candidate's hd); each step's row ranks
    # and counts; the hi and lo bf16 planes (pitch kp) of w_gates' and
    # w_cand's transposes and of a step's h_prev and r * h_prev
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    part = torch.empty(max(s_g * n_g, s_c * hd) * b, dtype=torch.float32,
                       device=dev)
    rank = torch.empty(t * b + t, dtype=torch.int32, device=dev)
    wgpl = torch.empty((2, n_g, kp), **bf16)
    wcpl = torch.empty((2, hd, kp), **bf16)
    hpl = torch.empty((2, b, kp), **bf16)
    rpl = torch.empty((2, b, kp), **bf16)
    _launch("gru_fwd_blocked",
            [x.data_ptr() for x in args + (hseq, gates, part, rank, wgpl,
                                           wcpl, hpl, rpl)],
            (b, t, hd, s_g, s_c), dev)
    gru_fwd_blocked.launches += 1
    return hseq, gates


gru_fwd_blocked.launches = 0


def gru_bwd_blocked(gates, hseq, h0, mask, w_gates, w_cand, dy
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked-tier BPTT without dW (kernel 16): the inputs of
    :func:`gru_bwd` → (dxw ``[B, T, 3H]``, dh0 ``[B, H]``, rh ``[B, T,
    H]`` = r·h_prev of every step, for :func:`gru_dw_blocked`)."""
    b, t, hd = _check_bwd(gates, hseq, h0, mask, w_gates, w_cand, dy)
    args = (gates, hseq, h0, mask, w_gates, w_cand, dy)
    if not _on_card(args):
        return gru_bwd_blocked_reference(*args)
    _tier_on_card(b, hd, gates.device, "fused_blocked")
    enforce(b * t < 2 ** 31, "the blocked GRU kernels count B*T in int32")
    dxw = torch.empty_like(gates)
    dh0 = torch.empty_like(h0)
    rh = torch.empty_like(hseq)
    if gates.numel() == 0:
        return dxw, dh0.zero_(), rh
    dev = gates.device
    n_c, n_g = bwd_blocked_slices(b, hd, _sms(dev))
    scratch = _bwd_scratch(h0, t, n_c, n_g)
    _launch("gru_bwd_blocked",
            [x.data_ptr() for x in args + (dxw, dh0, rh) + scratch],
            (b, t, hd, n_c, n_g), dev)
    gru_bwd_blocked.launches += 1
    return dxw, dh0, rh


gru_bwd_blocked.launches = 0


def gru_dw_blocked(hseq, h0, rh, dxw, mask
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked-tier weight gradients (kernel 17): H ``[B, T, H]``, h0
    ``[B, H]``, rh ``[B, T, H]``, dxw ``[B, T, 3H]`` and mask ``[B, T]``
    → (dW_gates ``[H, 2H]`` = sum over the valid (b, t) of h_{t-1}^T dg,
    dW_cand ``[H, H]`` = sum of rh^T dc_pre).  The backward writes exact
    zeros into dxw at padded steps, so this is the sum over all (b, t)
    there; the kernel skips those rows."""
    b, t, hd = _check_gates("dxw", dxw)
    for name, x, shape in (("hseq", hseq, (b, t, hd)), ("h0", h0, (b, hd)),
                           ("rh", rh, (b, t, hd)),
                           ("dxw", dxw, (b, t, 3 * hd)),
                           ("mask", mask, (b, t))):
        _check(name, x, shape)
    args = (hseq, h0, rh, dxw, mask)
    if not _on_card(args):
        return gru_dw_blocked_reference(*args)
    _tier_on_card(b, hd, dxw.device, "fused_blocked")
    enforce(b * t < 2 ** 31, "the blocked GRU kernels count B*T in int32")
    # both gradients in one buffer: dW_gates [H, 2H], then dW_cand [H, H]
    dw = torch.empty(3 * hd * hd, dtype=torch.float32, device=dxw.device)
    dwg, dwc = dw[:2 * hd * hd].view(hd, 2 * hd), dw[2 * hd * hd:].view(hd, hd)
    if dxw.numel() == 0:
        return dwg.zero_(), dwc.zero_()
    # the valid rows' list (and its length), and one [H, 3H] sum per split
    # of that list when the kernel splits it
    n_split = _build.kernel("gru_dw_blocked_splits")(b, t, hd)
    enforce(n_split > 0, "gru_dw_blocked: the occupancy query failed")
    rows = torch.empty(b * t + 1, dtype=torch.int32, device=dxw.device)
    part = torch.empty((n_split if n_split > 1 else 0) * 3 * hd * hd,
                       dtype=torch.float32, device=dxw.device)
    _launch("gru_dw_blocked",
            [x.data_ptr() for x in args + (rows, part, dw)],
            (b, t, hd, n_split), dxw.device)
    gru_dw_blocked.launches += 1
    return dwg, dwc


gru_dw_blocked.launches = 0

#: Every kernel wrapper of this module (for counters and reports).
KERNEL_WRAPPERS = (gru_fwd, gru_bwd, gru_fwd_blocked, gru_bwd_blocked,
                   gru_dw_blocked)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


# -------------------------------------------------------------- autograd
class _GruCore(torch.autograd.Function):
    """Kept-state sequence H of one direction; the residual is (gates, H)
    plus the inputs, and the backward shifts H one step with h0
    prepended (inside the kernel), as ``pallas_gru._gru_core`` does."""

    @staticmethod
    def forward(ctx, xw, mask, w_gates, w_cand, h0):
        hseq, gates = gru_fwd(xw, mask, w_gates, w_cand, h0)
        ctx.save_for_backward(gates, hseq, h0, mask, w_gates, w_cand)
        return hseq

    @staticmethod
    def backward(ctx, dh):
        gates, hseq, h0, mask, w_gates, w_cand = ctx.saved_tensors
        dxw, dwg, dwc, dh0 = gru_bwd(gates, hseq, h0, mask, w_gates, w_cand,
                                     dh.contiguous())
        return dxw, None, dwg, dwc, dh0


class _GruCoreBlocked(torch.autograd.Function):
    """The blocked tier's core, the contract of :class:`_GruCore`: the
    forward launches kernel 15; the backward launches kernel 16 (dxw,
    dh0 and r·h_prev), then kernel 17 (dW_gates, dW_cand), as
    ``pallas_gru._gru_core_blocked`` does."""

    @staticmethod
    def forward(ctx, xw, mask, w_gates, w_cand, h0):
        hseq, gates = gru_fwd_blocked(xw, mask, w_gates, w_cand, h0)
        ctx.save_for_backward(gates, hseq, h0, mask, w_gates, w_cand)
        return hseq

    @staticmethod
    def backward(ctx, dh):
        gates, hseq, h0, mask, w_gates, w_cand = ctx.saved_tensors
        dxw, dh0, rh = gru_bwd_blocked(gates, hseq, h0, mask, w_gates,
                                       w_cand, dh.contiguous())
        dwg, dwc = gru_dw_blocked(hseq, h0, rh, dxw, mask)
        return dxw, None, dwg, dwc, dh0


def _fused_sequence(core, xw, mask, w_gates, w_cand, h0):
    b, _, hd3 = xw.shape
    f32 = torch.float32
    h0 = torch.zeros((b, hd3 // 3), dtype=f32, device=xw.device) \
        if h0 is None else h0.to(f32)
    m = mask.to(f32)
    hseq = core.apply(xw.to(f32), m, w_gates.to(f32).contiguous(),
                      w_cand.to(f32).contiguous(), h0.contiguous())
    return hseq * m[..., None], hseq[:, -1]


def gru_fused_sequence(xw, mask, w_gates, w_cand, h0):
    """Batch-major contract of ``pallas_gru.gru_fused_sequence``: xw
    ``[B, T, 3H]`` pre-projected (+ bias), mask ``[B, T]``; returns (y
    ``[B, T, H]`` masked hidden outputs, final_h ``[B, H]`` the kept
    state after the last step) in fp32, whatever the inputs' float dtype
    (callers cast per their policy).  ``h0`` defaults to zeros."""
    return _fused_sequence(_GruCore, xw, mask, w_gates, w_cand, h0)


def gru_fused_sequence_blocked(xw, mask, w_gates, w_cand, h0):
    """The blocked tier's entry, the contract of
    :func:`gru_fused_sequence` (``pallas_gru.gru_fused_sequence_blocked``)."""
    return _fused_sequence(_GruCoreBlocked, xw, mask, w_gates, w_cand, h0)
