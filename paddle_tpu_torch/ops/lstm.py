"""Fused LSTM sequence (counterpart of ``paddle_tpu/ops/pallas_lstm.py``:
its single-block tier and its hidden-blocked tier).

Hand-written CUDA C++ kernels for ``sm_90a``, each a whole time loop of
one LSTM direction in one persistent cooperative launch, except the
last (an ordinary product):

- single-block tier, H <= 512 (``"fused"``):
  :func:`lstm_fwd` (``csrc/lstm_fwd.cu``; plain version
  :func:`lstm_fwd_reference`) writes the kept state sequences H, C and
  the activated gates, on a grid of U hidden units a CTA, each holding
  its gate columns of w_hh in shared memory, one grid barrier a step;
  :func:`lstm_bwd` (``csrc/lstm_bwd.cu``; plain
  :func:`lstm_bwd_reference`) gives dxw, dW_hh, the peephole grads,
  dh0, dc0 in one launch, on the blocked backward's tensor-core step loop
  (``csrc/lstm_wg.cuh``) and, after it, the dW tile (``csrc/dw_wg.cuh``);
- hidden-blocked tier, 512 < H (``"fused_blocked"``):
  :func:`lstm_fwd_blocked` (``csrc/lstm_fwd_blocked.cu``; plain
  :func:`lstm_fwd_blocked_reference`), :func:`lstm_bwd_blocked`
  (``csrc/lstm_bwd_blocked.cu``; plain
  :func:`lstm_bwd_blocked_reference`: dxw, dh0, dc0, no dW) and
  :func:`lstm_dw_blocked` (``csrc/lstm_dw_blocked.cu``; plain
  :func:`lstm_dw_blocked_reference`); the peephole grads are plain
  reductions over dxw (:func:`peephole_grads`), as in the TPU tier.
  Forward and backward walk tiles with a persistent cooperative grid,
  two grid barriers a step.  Their products take only the rows valid at
  each step (a padded step keeps its state; its dgates are exact zeros,
  and the forward writes its gates as 0).

The step products of kernels 8-11 (the forwards' h_{t-1} @ w_hh, the
backwards' pull-back dgates_t @ w_hh^T) and the dW products (9, 12) run
on the tensor cores with their f32 operands as hi + lo bf16 (three
passes, each 64-deep chunk's sums added in f32): the step products over
bf16 planes the kernels write themselves (w_hh's once, each step's h or
dgates), for 9-11 in compacted row order, cut into K slices
(:func:`fwd_blocked_slices`, :func:`bwd_blocked_slices`) summed in
order, for 8 whole K per CTA against its own columns of w_hh held in
shared memory; the dW products over the listed valid rows, split when
their tiles would leave a round of CTAs mostly idle.

:class:`_LstmCore` and :class:`_LstmCoreBlocked` (``torch.autograd.
Function``) launch the forward kernel in their forward and the backward
kernel(s) in their backward, as ``_lstm_core`` / ``_lstm_core_blocked``
do with their custom VJPs; :func:`lstm_fused_sequence` and
:func:`lstm_fused_sequence_blocked` are the public functions.

Layouts are batch-major throughout (xw / gates ``[B, T, 4H]``, states
``[B, T, H]``, mask ``[B, T]``), so no time-major copy is made; checks
are ``[3, H]`` (rows i, f, o); w_hh stays ``[H, 4H]`` gate-major (the
JAX tier's block-gate permutation is not carried over; the blocked
forward orders its own planes of w_hh's transpose).  A wrapper
checks dtype (fp32 only), shape and contiguity first.  CPU tensors then
take the plain version; CUDA tensors launch the kernel or raise — a
shape the kernel's tier does not serve (:func:`fused_tier`) raises too,
never falls back.  Each wrapper counts its launches in ``.launches``.

Precision: the kernels compute in fp32, whatever the policy (the
tensor-core products as three bf16 passes of the f32 operands' hi and lo
parts).  The public functions cast their inputs to fp32 before the kernels (a bf16
xw converts exactly), so autograd returns dxw in xw's dtype, as the JAX
kernels read xw in its dtype, compute the gates in f32 and cast dxw
back (``pallas_lstm.py:422,677``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import FLAGS, PaddleTpuError, enforce
from . import _build

#: Hopper resources the tiers are computed from (H100 SXM): SMs, and the
#: shared memory one block may use.
SM_COUNT = 132
SMEM_BYTES = 232448
#: Hidden units per CTA the single-block forward is built for (its 4U
#: gate columns are rows of one 16-wide wgmma tile).
UNITS = (1, 2, 4)
#: Largest H the single-block kernels take; above it, the blocked tier.
MAX_HIDDEN = 512
#: Largest H of the blocked tier: the kernels count a row-step's 4H gate
#: columns and w_hh's 4H^2 elements in 32-bit ints.
MAX_BLOCKED_HIDDEN = 23170
# the single-block forward's shared memory (csrc/lstm_fwd.cu), in bytes:
# 1 KB of alignment, w_hh's 16 gate columns as hi and lo planes of at
# most 8 chunks (2 KB each), a ring of 4 stages of A's hi and lo planes
# (16 KB each) and the sums of 128 rows x 17 floats; then the h and c
# carries, 2 x B x U floats
_FWD_FIXED_BYTES = 1024 + 2 * 8 * 2048 + 4 * 2 * 16384 + 4 * 128 * 17
# the tensor-core kernels' ring (9-11: csrc/lstm_wg.cuh; 9's and 12's dW
# tile, csrc/dw_wg.cuh, reuses it), in bytes: 3 stages of four 16 KB bf16
# planes and 1 KB for their alignment, whatever B and H
_RING_BYTES = 1024 + 3 * 4 * 16384
#: The step products' tiles (csrc/lstm_wg.cuh): 128 compacted rows x 128
#: columns x one slice of K in chunks of 64.  The forward's columns are
#: 4 gates x 32 units a tile.
TILE_ROWS, TILE_COLS, CHUNK = 128, 128, 64
#: Splits of kernel 9's dW row list at most (csrc/dw_wg.cuh's kMaxSplit).
MAX_DW_SPLIT = 4


def _plane_slices(chunks: int, blocks: int, sms: int, least: int = 2) -> int:
    """K slices of a step product with ``blocks`` (row, column) blocks:
    as many as keep all its tiles within one CTA an SM, each slice
    ceil(chunks / slices) chunks of 64 but at least ``least`` where K
    has them (two by default: a one-chunk slice's sums cost the pairs
    more than its tile saves, where the tiles already fill the card),
    none empty."""
    per = -(-chunks // max(1, min(chunks, sms // blocks)))
    return -(-chunks // max(per, min(least, chunks)))


def bwd_blocked_slices(b: int, h: int, sms: int = SM_COUNT) -> int:
    """K slices of the backward's pull-back (kernels 9 and 11) at (b, h):
    K = 4h, 128-unit column blocks (at B 128, H 1280 on 132 SMs: 10 unit
    blocks x 12 slices of 7 chunks; at H 512, 4 x 16 of 2)."""
    return _plane_slices(-(-4 * h // CHUNK),
                         -(-b // TILE_ROWS) * -(-h // TILE_COLS), sms)


def fwd_blocked_slices(b: int, h: int, sms: int = SM_COUNT) -> int:
    """K slices of the blocked forward's step product (kernel 10) at (b,
    h): K = h, column blocks of 32 units x 4 gates (at B 128, H 1280 on
    132 SMs: 40 column blocks x 3 slices of 7 chunks; at H 2048, 64 x 2
    of 16)."""
    return _plane_slices(-(-h // CHUNK),
                         -(-b // TILE_ROWS) * -(-h // (TILE_COLS // 4)), sms)


def bwd_dw_splits(h: int, sms: int = SM_COUNT) -> int:
    """Splits of kernel 9's dW row list: as many as keep its 128 x 128
    output tiles of [h, 4h] times the splits within one CTA an SM, at
    most MAX_DW_SPLIT (at H 512 on 132 SMs: 64 tiles x 2)."""
    tiles = -(-h // 128) * -(-4 * h // 128)
    return max(1, min(MAX_DW_SPLIT, sms // tiles))


def units_per_cta(h: int, sms: int = SM_COUNT) -> Optional[int]:
    """Smallest U whose grid of ceil(h / U) CTAs fits one per SM."""
    for u in UNITS:
        if -(-h // u) <= sms:
            return u
    return None


def smem_bytes(b: int, h: int, u: int) -> Tuple[int, int]:
    """Dynamic shared memory of the single-block (forward, backward)
    kernels, in bytes — the arithmetic of ``csrc/lstm_fwd.cu`` (U units a
    CTA, their h and c carries for every row) and of the backward's ring
    (``csrc/lstm_wg.cuh``, any b and h)."""
    return _FWD_FIXED_BYTES + 8 * b * u, _RING_BYTES


def fused_tier(b: int, h: int, sms: int = SM_COUNT) -> Optional[str]:
    """Which kernels serve (b, h) on a card with ``sms`` SMs:

    - ``"fused"``: 1 <= h <= 512, a grid of ceil(h / U) CTAs at most one
      per SM, both kernels' shared memory within one block's limit;
    - ``"fused_blocked"``: 512 < h <= MAX_BLOCKED_HIDDEN under
      ``--fused_rnn_hblock`` (default on).  The blocked kernels stride
      over their tiles with as many CTAs as are co-resident, so any B
      and any SM count serve; each kernel's shared memory (193 KB) is
      within one block's limit;
    - ``None`` otherwise.  No tiling gate in either tier."""
    if b < 1 or h < 1:
        return None
    if h <= MAX_HIDDEN:
        u = units_per_cta(h, sms)
        if u is None or max(smem_bytes(b, h, u)) > SMEM_BYTES:
            return None
        return "fused"
    if not FLAGS.get("fused_rnn_hblock") or h > MAX_BLOCKED_HIDDEN \
            or sms < 1 or _RING_BYTES > SMEM_BYTES:
        return None
    return "fused_blocked"


# ------------------------------------------------------------ plain versions
def lstm_fwd_reference(xw, mask, w_hh, checks, h0, c0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`lstm_fwd`: the step loop of
    ``pallas_lstm._fwd_kernel``, batch-major."""
    b, t, hd4 = xw.shape
    hd = hd4 // 4
    h_prev, c_prev = h0, c0
    hs, cs, gs = [], [], []
    for s in range(t):
        g = xw[:, s] + h_prev @ w_hh
        i = torch.sigmoid(g[:, :hd] + c_prev * checks[0])
        f = torch.sigmoid(g[:, hd:2 * hd] + c_prev * checks[1])
        gg = torch.tanh(g[:, 2 * hd:3 * hd])
        c = f * c_prev + i * gg
        o = torch.sigmoid(g[:, 3 * hd:] + c * checks[2])
        h = o * torch.tanh(c)
        m = mask[:, s, None]
        h_prev = m * h + (1.0 - m) * h_prev
        c_prev = m * c + (1.0 - m) * c_prev
        hs.append(h_prev)
        cs.append(c_prev)
        gs.append(torch.cat([i, f, gg, o], dim=-1))
    return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(gs, 1)


def lstm_fwd_blocked_reference(xw, mask, w_hh, checks, h0, c0
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain version of :func:`lstm_fwd_blocked`: :func:`lstm_fwd_reference`
    with the gates of padded steps written as 0 (the kernel skips their
    products; the backward's masked split never reads them)."""
    hseq, cseq, gates = lstm_fwd_reference(xw, mask, w_hh, checks, h0, c0)
    return hseq, cseq, gates * (mask != 0).to(gates.dtype)[..., None]


def lstm_bwd_blocked_reference(gates, cseq, c0, mask, w_hh, checks, dy,
                               dyc):
    """Plain version of :func:`lstm_bwd_blocked`: the reversed step loop
    of ``pallas_lstm._bwd_kernel_blocked``.  dy/dyc (the cotangents on H
    and C) join the carries before the masked split; the (1-m) share
    passes both carries to earlier steps.  Returns (dxw, dh0, dc0)."""
    b, t, hd4 = gates.shape
    hd = hd4 // 4
    dh_c = torch.zeros_like(c0)
    dc_c = torch.zeros_like(c0)
    dxw = torch.empty_like(gates)
    for s in range(t - 1, -1, -1):
        g = gates[:, s]
        g_i, g_f = g[:, :hd], g[:, hd:2 * hd]
        g_g, g_o = g[:, 2 * hd:3 * hd], g[:, 3 * hd:]
        c_prev = cseq[:, s - 1] if s > 0 else c0
        c = cseq[:, s]
        m = mask[:, s, None]
        tanh_c = torch.tanh(c)
        dh_tot = dy[:, s] + dh_c
        dc_tot = dyc[:, s] + dc_c
        dh = m * dh_tot
        do_pre = dh * tanh_c * g_o * (1.0 - g_o)
        dc = m * dc_tot + dh * g_o * (1.0 - tanh_c * tanh_c) \
            + do_pre * checks[2]
        di_pre = dc * g_g * g_i * (1.0 - g_i)
        df_pre = dc * c_prev * g_f * (1.0 - g_f)
        dg_pre = dc * g_i * (1.0 - g_g * g_g)
        dgates = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=-1)
        dh_c = (1.0 - m) * dh_tot + dgates @ w_hh.t()
        dc_c = (1.0 - m) * dc_tot + dc * g_f + di_pre * checks[0] \
            + df_pre * checks[1]
        dxw[:, s] = dgates
    return dxw, dh_c, dc_c


def _shifted(seq: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """The sequence one step back, ``first`` at t = 0 ([B, T, H])."""
    return torch.cat([first[:, None], seq[:, :-1]], dim=1)


def lstm_dw_blocked_reference(hseq, h0, dxw, mask) -> torch.Tensor:
    """Plain version of :func:`lstm_dw_blocked`: dW_hh = sum over the
    valid (b, t) of h_{t-1}[b]^T dgates_t[b], one summed product."""
    hd = h0.shape[-1]
    h_prev = _shifted(hseq, h0) * (mask != 0).to(hseq.dtype)[..., None]
    return h_prev.reshape(-1, hd).t() @ dxw.reshape(-1, 4 * hd)


def peephole_grads(dxw, cseq, c0) -> torch.Tensor:
    """Gradients of the checks ``[3, H]`` from the dgates residue dxw:
    i and f against c_{t-1}, o against c_t (``pallas_lstm.py:666-676``)."""
    hd = c0.shape[-1]
    c_prev = _shifted(cseq, c0)
    return torch.stack([(dxw[..., :hd] * c_prev).sum((0, 1)),
                        (dxw[..., hd:2 * hd] * c_prev).sum((0, 1)),
                        (dxw[..., 3 * hd:] * cseq).sum((0, 1))])


def lstm_bwd_reference(gates, hseq, cseq, h0, c0, mask, w_hh, checks, dy,
                       dyc):
    """Plain version of :func:`lstm_bwd`: the reversed step loop of
    ``pallas_lstm._bwd_kernel`` → (dxw, dW_hh, dchecks, dh0, dc0)."""
    dxw, dh0, dc0 = lstm_bwd_blocked_reference(gates, cseq, c0, mask, w_hh,
                                               checks, dy, dyc)
    return (dxw, lstm_dw_blocked_reference(hseq, h0, dxw, mask),
            peephole_grads(dxw, cseq, c0), dh0, dc0)


# ------------------------------------------------------------------ wrappers
def _check(name: str, x: torch.Tensor, shape) -> None:
    enforce(isinstance(x, torch.Tensor) and tuple(x.shape) == tuple(shape),
            f"{name}: expected shape {tuple(shape)}, got "
            f"{tuple(getattr(x, 'shape', ()))}")
    enforce(x.dtype == torch.float32,
            f"{name}: expected float32, got {x.dtype}")
    enforce(x.is_contiguous(), f"{name}: expected a contiguous tensor")


def _on_card(tensors) -> bool:
    """True when the tensors are on CUDA (launch the kernel), False when
    all lie on the CPU (plain version); raises on anything else."""
    devs = {x.device for x in tensors}
    enforce(len(devs) == 1, f"tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    enforce(dev.type == "cuda", f"unsupported device {dev}")
    # the kernels stream rows with 16-byte asynchronous copies
    enforce(all(x.data_ptr() % 16 == 0 for x in tensors),
            "the fused LSTM/GRU kernels need 16-byte aligned tensors")
    return True


def _sms(dev: torch.device) -> int:
    """SMs of ``dev`` (a card), or of the H100 the tiers assume."""
    return torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else SM_COUNT


def _tier_on_card(b: int, h: int, dev: torch.device, want: str) -> None:
    """Raise unless ``fused_tier`` gives ``want`` for (b, h) on ``dev``."""
    if fused_tier(b, h, _sms(dev)) != want:
        raise PaddleTpuError(
            f"the {want!r} LSTM kernels do not serve batch={b} hidden={h} "
            f"(fused: hidden <= {MAX_HIDDEN}, shared memory <= "
            f"{SMEM_BYTES} B; fused_blocked: {MAX_HIDDEN} < hidden <= "
            f"{MAX_BLOCKED_HIDDEN} with --fused_rnn_hblock on)")


def _launch(symbol: str, ptrs, ints, dev) -> None:
    fn = _build.kernel(symbol)
    err = fn(*ptrs, *ints, torch.cuda.current_stream(dev).cuda_stream)
    if err == -1:
        raise PaddleTpuError(f"{symbol}: the cooperative grid cannot be "
                             "resident on this card")
    enforce(err == 0, f"{symbol} launch failed (cudaError {err})")


def _check_xw(name: str, xw) -> Tuple[int, int, int, int]:
    enforce(isinstance(xw, torch.Tensor) and xw.dim() == 3
            and xw.shape[-1] % 4 == 0,
            f"{name}: expected [B, T, 4H], got "
            f"{tuple(getattr(xw, 'shape', ()))}")
    b, t, hd4 = xw.shape
    return b, t, hd4, hd4 // 4


def _check_fwd(xw, mask, w_hh, checks, h0, c0):
    b, t, hd4, hd = _check_xw("xw", xw)
    for name, x, shape in (("xw", xw, (b, t, hd4)), ("mask", mask, (b, t)),
                           ("w_hh", w_hh, (hd, hd4)),
                           ("checks", checks, (3, hd)), ("h0", h0, (b, hd)),
                           ("c0", c0, (b, hd))):
        _check(name, x, shape)
    return b, t, hd


def lstm_fwd(xw, mask, w_hh, checks, h0, c0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward time loop: xw ``[B, T, 4H]`` (input projection and gate
    bias applied), mask ``[B, T]`` float, w_hh ``[H, 4H]``, checks
    ``[3, H]``, h0/c0 ``[B, H]`` → (H, C ``[B, T, H]`` kept states,
    gates ``[B, T, 4H]`` activated i, f, g, o)."""
    b, t, hd = _check_fwd(xw, mask, w_hh, checks, h0, c0)
    args = (xw, mask, w_hh, checks, h0, c0)
    if not _on_card(args):
        return lstm_fwd_reference(*args)
    _tier_on_card(b, hd, xw.device, "fused")
    dev = xw.device
    u = units_per_cta(hd, _sms(dev))
    hseq = torch.empty((b, t, hd), dtype=torch.float32, device=dev)
    cseq = torch.empty_like(hseq)
    gates = torch.empty_like(xw)
    if xw.numel() == 0:
        return hseq, cseq, gates
    # scratch: h's hi and lo bf16 planes (pitch kp), two buffers by step
    # parity
    kp = -(-hd // CHUNK) * CHUNK
    apl = torch.empty((2, 2, b, kp), dtype=torch.bfloat16, device=dev)
    _launch("lstm_fwd",
            [x.data_ptr() for x in args + (hseq, cseq, gates, apl)],
            (b, t, hd, u), dev)
    lstm_fwd.launches += 1
    return hseq, cseq, gates


lstm_fwd.launches = 0


def lstm_bwd(gates, hseq, cseq, h0, c0, mask, w_hh, checks, dy, dyc):
    """BPTT over the forward's residuals: gates ``[B, T, 4H]``, H and C
    ``[B, T, H]``, h0/c0, mask, w_hh, checks as in :func:`lstm_fwd`, and
    dy/dyc ``[B, T, H]`` the cotangents on H and C → (dxw ``[B, T, 4H]``,
    dw_hh ``[H, 4H]``, dchecks ``[3, H]``, dh0, dc0 ``[B, H]``)."""
    b, t, hd4, hd = _check_xw("gates", gates)
    for name, x, shape in (("gates", gates, (b, t, hd4)),
                           ("hseq", hseq, (b, t, hd)),
                           ("cseq", cseq, (b, t, hd)), ("h0", h0, (b, hd)),
                           ("c0", c0, (b, hd)), ("mask", mask, (b, t)),
                           ("w_hh", w_hh, (hd, hd4)),
                           ("checks", checks, (3, hd)),
                           ("dy", dy, (b, t, hd)), ("dyc", dyc, (b, t, hd))):
        _check(name, x, shape)
    args = (gates, hseq, cseq, h0, c0, mask, w_hh, checks, dy, dyc)
    if not _on_card(args):
        return lstm_bwd_reference(*args)
    dev = gates.device
    _tier_on_card(b, hd, dev, "fused")
    enforce(b * t < 2 ** 31, "the LSTM backward counts B*T in int32")
    dxw = torch.empty_like(gates)
    dw = torch.empty_like(w_hh)
    dck = torch.empty_like(checks)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    if gates.numel() == 0:
        return dxw, dw.zero_(), dck.zero_(), dh0.zero_(), dc0.zero_()
    n_sl = bwd_blocked_slices(b, hd, _sms(dev))
    n_split = bwd_dw_splits(hd, _sms(dev))
    kp = -(-4 * hd // CHUNK) * CHUNK
    # scratch: (1-m) dh_tot, the dc carry and the peephole products per
    # (row, unit); the pull-back's sums by K slice; each step's row ranks
    # and counts; the valid rows' list; w_hh's and a step's dgates' hi and
    # lo bf16 planes (pitch kp); one [H, 4H] dW sum per split of the list
    f32 = dict(dtype=torch.float32, device=dev)
    dhp, dcc = torch.empty_like(c0), torch.empty_like(c0)
    ckp = torch.empty((3, b, hd), **f32)
    part = torch.empty((n_sl, b, hd), **f32)
    rank = torch.empty(t * b + t, dtype=torch.int32, device=dev)
    rows = torch.empty(b * t, dtype=torch.int32, device=dev)
    wpl = torch.empty((2, hd, kp), dtype=torch.bfloat16, device=dev)
    apl = torch.empty((2, b, kp), dtype=torch.bfloat16, device=dev)
    dw_part = torch.empty((n_split if n_split > 1 else 0, hd, hd4), **f32)
    _launch("lstm_bwd",
            [x.data_ptr() for x in args + (dxw, dw, dck, dh0, dc0, dhp, dcc,
                                           ckp, part, rank, rows, wpl, apl,
                                           dw_part)],
            (b, t, hd, n_sl, n_split), dev)
    lstm_bwd.launches += 1
    return dxw, dw, dck, dh0, dc0


lstm_bwd.launches = 0


def lstm_fwd_blocked(xw, mask, w_hh, checks, h0, c0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked-tier forward (kernel 10), the contract of
    :func:`lstm_fwd` except that the gates of padded steps are 0; its
    plain version is :func:`lstm_fwd_blocked_reference`."""
    b, t, hd = _check_fwd(xw, mask, w_hh, checks, h0, c0)
    args = (xw, mask, w_hh, checks, h0, c0)
    if not _on_card(args):
        return lstm_fwd_blocked_reference(*args)
    _tier_on_card(b, hd, xw.device, "fused_blocked")
    enforce(b * t < 2 ** 31, "the blocked LSTM kernels count B*T in int32")
    dev = xw.device
    hseq = torch.empty((b, t, hd), dtype=torch.float32, device=dev)
    cseq = torch.empty_like(hseq)
    gates = torch.empty_like(xw)
    if xw.numel() == 0:
        return hseq, cseq, gates
    n_sl = fwd_blocked_slices(b, hd, _sms(dev))
    kp = -(-hd // CHUNK) * CHUNK
    n_cols = 4 * -(-hd // (TILE_COLS // 4)) * (TILE_COLS // 4)
    # scratch: the step product's sums by K slice (n_cols columns, unit
    # block x gate x unit); each step's row ranks and counts; the hi and
    # lo bf16 planes (pitch kp) of w_hh's transpose and of a step's h
    part = torch.empty((n_sl, b, n_cols), dtype=torch.float32, device=dev)
    rank = torch.empty(t * b + t, dtype=torch.int32, device=dev)
    wpl = torch.empty((2, n_cols, kp), dtype=torch.bfloat16, device=dev)
    apl = torch.empty((2, b, kp), dtype=torch.bfloat16, device=dev)
    _launch("lstm_fwd_blocked",
            [x.data_ptr() for x in args + (hseq, cseq, gates, part, rank,
                                           wpl, apl)], (b, t, hd, n_sl), dev)
    lstm_fwd_blocked.launches += 1
    return hseq, cseq, gates


lstm_fwd_blocked.launches = 0


def lstm_bwd_blocked(gates, cseq, c0, mask, w_hh, checks, dy, dyc
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked-tier BPTT without dW (kernel 11): gates ``[B, T, 4H]``, C
    ``[B, T, H]``, c0 ``[B, H]``, mask, w_hh, checks as in
    :func:`lstm_fwd`, dy/dyc ``[B, T, H]`` the cotangents on H and C →
    (dxw ``[B, T, 4H]``, dh0, dc0 ``[B, H]``)."""
    b, t, hd4, hd = _check_xw("gates", gates)
    for name, x, shape in (("gates", gates, (b, t, hd4)),
                           ("cseq", cseq, (b, t, hd)), ("c0", c0, (b, hd)),
                           ("mask", mask, (b, t)),
                           ("w_hh", w_hh, (hd, hd4)),
                           ("checks", checks, (3, hd)),
                           ("dy", dy, (b, t, hd)), ("dyc", dyc, (b, t, hd))):
        _check(name, x, shape)
    args = (gates, cseq, c0, mask, w_hh, checks, dy, dyc)
    if not _on_card(args):
        return lstm_bwd_blocked_reference(*args)
    _tier_on_card(b, hd, gates.device, "fused_blocked")
    enforce(b * t < 2 ** 31, "the blocked LSTM kernels count B*T in int32")
    dxw = torch.empty_like(gates)
    dh0 = torch.empty_like(c0)
    dc0 = torch.empty_like(c0)
    if gates.numel() == 0:
        return dxw, dh0.zero_(), dc0.zero_()
    dev = gates.device
    n_sl = bwd_blocked_slices(b, hd, _sms(dev))
    kp = -(-4 * hd // CHUNK) * CHUNK
    # scratch: (1-m) dh_tot and the dc carry per (row, unit); the
    # pull-back's sums by K slice; each step's row ranks and counts;
    # w_hh's and a step's dgates' hi and lo bf16 planes (pitch kp)
    dhp = torch.empty_like(c0)
    dcc = torch.empty_like(c0)
    part = torch.empty((n_sl, b, hd), dtype=torch.float32, device=dev)
    rank = torch.empty(t * b + t, dtype=torch.int32, device=dev)
    wpl = torch.empty((2, hd, kp), dtype=torch.bfloat16, device=dev)
    apl = torch.empty((2, b, kp), dtype=torch.bfloat16, device=dev)
    _launch("lstm_bwd_blocked",
            [x.data_ptr() for x in args + (dxw, dh0, dc0, dhp, dcc, part,
                                           rank, wpl, apl)],
            (b, t, hd, n_sl), dev)
    lstm_bwd_blocked.launches += 1
    return dxw, dh0, dc0


lstm_bwd_blocked.launches = 0


def lstm_dw_blocked(hseq, h0, dxw, mask) -> torch.Tensor:
    """Blocked-tier weight gradient (kernel 12): H ``[B, T, H]``, h0
    ``[B, H]``, dxw ``[B, T, 4H]`` and mask ``[B, T]`` → dW_hh ``[H, 4H]``
    = sum over the valid (b, t) of h_{t-1}[b]^T dxw[b, t] (the backward
    writes exact zeros into dxw at padded steps, so this is the sum over
    all (b, t) there; the kernel skips those rows)."""
    b, t, hd4, hd = _check_xw("dxw", dxw)
    for name, x, shape in (("hseq", hseq, (b, t, hd)), ("h0", h0, (b, hd)),
                           ("dxw", dxw, (b, t, hd4)), ("mask", mask, (b, t))):
        _check(name, x, shape)
    args = (hseq, h0, dxw, mask)
    if not _on_card(args):
        return lstm_dw_blocked_reference(*args)
    _tier_on_card(b, hd, dxw.device, "fused_blocked")
    enforce(b * t < 2 ** 31, "the blocked LSTM kernels count B*T in int32")
    dw = torch.empty((hd, hd4), dtype=torch.float32, device=dxw.device)
    if dxw.numel() == 0:
        return dw.zero_()
    # the valid rows' list (and its length), and one [H, 4H] sum per
    # split of that list when the kernel splits it
    n_split = _build.kernel("lstm_dw_blocked_splits")(b, t, hd)
    enforce(n_split > 0, "lstm_dw_blocked: the occupancy query failed")
    rows = torch.empty(b * t + 1, dtype=torch.int32, device=dxw.device)
    part = torch.empty((n_split if n_split > 1 else 0, hd, hd4),
                       dtype=torch.float32, device=dxw.device)
    _launch("lstm_dw_blocked",
            [x.data_ptr() for x in args + (rows, part, dw)],
            (b, t, hd, n_split), dxw.device)
    lstm_dw_blocked.launches += 1
    return dw


lstm_dw_blocked.launches = 0

#: Every kernel wrapper of this module (for counters and reports).
KERNEL_WRAPPERS = (lstm_fwd, lstm_bwd, lstm_fwd_blocked, lstm_bwd_blocked,
                   lstm_dw_blocked)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


# -------------------------------------------------------------- autograd
class _LstmCore(torch.autograd.Function):
    """Kept-state sequences (H, C) of one direction; the residual is
    (gates, H, C) plus the inputs, and the backward shifts the states
    one step with h0/c0 prepended (inside the kernel), as
    ``pallas_lstm._lstm_core`` does."""

    @staticmethod
    def forward(ctx, xw, mask, w_hh, checks, h0, c0):
        hseq, cseq, gates = lstm_fwd(xw, mask, w_hh, checks, h0, c0)
        ctx.save_for_backward(gates, hseq, cseq, h0, c0, mask, w_hh, checks)
        return hseq, cseq

    @staticmethod
    def backward(ctx, dh, dc):
        gates, hseq, cseq, h0, c0, mask, w_hh, checks = ctx.saved_tensors
        dh = torch.zeros_like(hseq) if dh is None else dh.contiguous()
        dc = torch.zeros_like(cseq) if dc is None else dc.contiguous()
        dxw, dw, dck, dh0, dc0 = lstm_bwd(gates, hseq, cseq, h0, c0, mask,
                                          w_hh, checks, dh, dc)
        return dxw, None, dw, dck, dh0, dc0


class _LstmCoreBlocked(torch.autograd.Function):
    """The blocked tier's core, the contract of :class:`_LstmCore`: the
    forward launches kernel 10; the backward launches kernel 11 (dxw,
    dh0, dc0), then kernel 12 (dW_hh over dxw), and reduces the peephole
    grads from dxw, as ``pallas_lstm._lstm_core_blocked`` does."""

    @staticmethod
    def forward(ctx, xw, mask, w_hh, checks, h0, c0):
        hseq, cseq, gates = lstm_fwd_blocked(xw, mask, w_hh, checks, h0, c0)
        ctx.save_for_backward(gates, hseq, cseq, h0, c0, mask, w_hh, checks)
        return hseq, cseq

    @staticmethod
    def backward(ctx, dh, dc):
        gates, hseq, cseq, h0, c0, mask, w_hh, checks = ctx.saved_tensors
        dh = torch.zeros_like(hseq) if dh is None else dh.contiguous()
        dc = torch.zeros_like(cseq) if dc is None else dc.contiguous()
        dxw, dh0, dc0 = lstm_bwd_blocked(gates, cseq, c0, mask, w_hh, checks,
                                         dh, dc)
        dw = lstm_dw_blocked(hseq, h0, dxw, mask)
        return dxw, None, dw, peephole_grads(dxw, cseq, c0), dh0, dc0


def _fused_sequence(core, xw, mask, w_hh, check_i, check_f, check_o, h0, c0):
    b, _, hd4 = xw.shape
    hd = hd4 // 4
    f32 = torch.float32
    zeros = torch.zeros(hd, dtype=f32, device=xw.device)
    rows = [check_i.to(f32), check_f.to(f32)] if check_i is not None \
        else [zeros, zeros]
    rows.append(check_o.to(f32) if check_o is not None else zeros)
    checks = torch.stack(rows)
    h0 = torch.zeros((b, hd), dtype=f32, device=xw.device) if h0 is None \
        else h0.to(f32)
    c0 = torch.zeros((b, hd), dtype=f32, device=xw.device) if c0 is None \
        else c0.to(f32)
    m = mask.to(f32)
    hseq, cseq = core.apply(xw.to(f32), m, w_hh.to(f32), checks, h0, c0)
    y = hseq * m[..., None]
    cy = cseq * m[..., None]
    return y, cy, hseq[:, -1], cseq[:, -1]


def lstm_fused_sequence(xw, mask, w_hh, check_i, check_f, check_o, h0, c0):
    """Batch-major contract of ``pallas_lstm.lstm_fused_sequence``: xw
    ``[B, T, 4H]`` pre-projected (+ gate bias), mask ``[B, T]``; returns
    (y ``[B, T, H]`` masked hidden outputs, cy ``[B, T, H]`` masked cell
    outputs, final_h, final_c ``[B, H]``) in fp32, whatever the inputs'
    float dtype (callers cast per their policy).

    ``check_i`` and ``check_f`` are given together or not at all,
    ``check_o`` on its own; absent peepholes are zeros and get no
    gradient.  ``h0``/``c0`` default to zeros."""
    return _fused_sequence(_LstmCore, xw, mask, w_hh, check_i, check_f,
                           check_o, h0, c0)


def lstm_fused_sequence_blocked(xw, mask, w_hh, check_i, check_f, check_o,
                                h0, c0):
    """The blocked tier's entry, the contract of
    :func:`lstm_fused_sequence` (``pallas_lstm.
    lstm_fused_sequence_blocked``)."""
    return _fused_sequence(_LstmCoreBlocked, xw, mask, w_hh, check_i,
                           check_f, check_o, h0, c0)
