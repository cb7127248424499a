"""Fused LSTM sequence (counterpart of ``paddle_tpu/ops/pallas_lstm.py``,
its single-block tier).

Two hand-written CUDA C++ kernels for ``sm_90a``, each a whole time loop
of one LSTM direction in one persistent cooperative launch:

- :func:`lstm_fwd` — forward (``csrc/lstm_fwd.cu``; plain version
  :func:`lstm_fwd_reference`): writes the kept state sequences H, C and
  the activated gates;
- :func:`lstm_bwd` — BPTT (``csrc/lstm_bwd.cu``; plain version
  :func:`lstm_bwd_reference`): dxw, dW_hh, the peephole grads, dh0, dc0.

:class:`_LstmCore` (a ``torch.autograd.Function``) launches the first
in its forward and the second in its backward, as ``_lstm_core`` does
with its custom VJP; :func:`lstm_fused_sequence` is the public function.

Layouts are batch-major throughout (xw / gates ``[B, T, 4H]``, states
``[B, T, H]``, mask ``[B, T]``), so no time-major copy is made; checks
are ``[3, H]`` (rows i, f, o).  A wrapper checks dtype (fp32 only),
shape and contiguity first.  CPU tensors then take the plain version;
CUDA tensors launch the kernel or raise — a shape the kernel does not
serve (:func:`fused_tier`) raises too, never falls back.  Each wrapper
counts its launches in ``.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import PaddleTpuError, enforce
from . import _build

#: Hopper resources the tier is computed from (H100 SXM): SMs, and the
#: shared memory one block may use.
SM_COUNT = 132
SMEM_BYTES = 232448
#: Hidden units per CTA the kernels are built for (4U gate columns must
#: divide the 256-thread block).
UNITS = (1, 2, 4)
#: Largest H the single-block kernels take; the hidden-blocked tier
#: (pallas_lstm.py kernels 10-12) is not ported yet.
MAX_HIDDEN = 512
# shared-memory pieces of csrc/lstm_common.cuh and the kernels, in floats
_TILE_FLOATS, _RED_FLOATS, _DW_FLOATS = 3 * 128 * 68, 8 * 128 * 4, 3 * 32 * 200

def units_per_cta(h: int, sms: int = SM_COUNT) -> Optional[int]:
    """Smallest U whose grid of ceil(h / U) CTAs fits one per SM."""
    for u in UNITS:
        if -(-h // u) <= sms:
            return u
    return None


def smem_bytes(b: int, h: int, u: int) -> Tuple[int, int]:
    """Dynamic shared memory of (forward, backward) kernel, in bytes —
    the arithmetic of ``csrc/lstm_common.cuh``."""
    n = 4 * u
    fwd = -(-h // 64) * 64 * n + _TILE_FLOATS + _RED_FLOATS + b * n + 2 * b * u
    bwd = n * -(-h // 4) * 4 + n * -(-b // 8) * 8 + 8 * b * u + _DW_FLOATS
    return 4 * fwd, 4 * bwd


def fused_tier(b: int, h: int, sms: int = SM_COUNT) -> Optional[str]:
    """``"fused"`` when the ported kernels serve (b, h) on a card with
    ``sms`` SMs: 1 <= h <= 512, a grid of ceil(h / U) CTAs at most one
    per SM, and both kernels' shared memory within one block's limit.
    Any B and H up to that: no tiling gate.  ``None`` otherwise."""
    if b < 1 or h < 1 or h > MAX_HIDDEN:
        return None
    u = units_per_cta(h, sms)
    if u is None or max(smem_bytes(b, h, u)) > SMEM_BYTES:
        return None
    return "fused"


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


def lstm_bwd_reference(gates, hseq, cseq, h0, c0, mask, w_hh, checks, dy,
                       dyc):
    """Plain version of :func:`lstm_bwd`: the reversed step loop of
    ``pallas_lstm._bwd_kernel``.  dy/dyc (the cotangents on H and C) join
    the carries before the masked split; the (1-m) share passes both
    carries to earlier steps."""
    b, t, hd4 = gates.shape
    hd = hd4 // 4
    dh_c = torch.zeros_like(h0)
    dc_c = torch.zeros_like(c0)
    dw = torch.zeros_like(w_hh)
    dck = torch.zeros_like(checks)
    dxw = torch.empty_like(gates)
    for s in range(t - 1, -1, -1):
        g = gates[:, s]
        g_i, g_f = g[:, :hd], g[:, hd:2 * hd]
        g_g, g_o = g[:, 2 * hd:3 * hd], g[:, 3 * hd:]
        h_prev = hseq[:, s - 1] if s > 0 else h0
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
        dw = dw + h_prev.t() @ dgates
        dck = dck + torch.stack([(di_pre * c_prev).sum(0),
                                 (df_pre * c_prev).sum(0),
                                 (do_pre * c).sum(0)])
        dxw[:, s] = dgates
    return dxw, dw, dck, dh_c, dc_c


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
            "the LSTM kernels need 16-byte aligned tensors")
    return True


def _units_on_card(b: int, h: int, dev: torch.device) -> int:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else SM_COUNT
    if fused_tier(b, h, sms) is None:
        raise PaddleTpuError(
            f"the fused LSTM kernels do not serve batch={b} hidden={h} "
            f"(hidden <= {MAX_HIDDEN}, shared memory <= {SMEM_BYTES} B); "
            "the hidden-blocked tier (pallas_lstm.py kernels 10-12) is "
            "not ported yet")
    return units_per_cta(h, sms)


def _launch(symbol: str, ptrs, ints, dev) -> None:
    fn = _build.kernel(symbol)
    err = fn(*ptrs, *ints, torch.cuda.current_stream(dev).cuda_stream)
    if err == -1:
        raise PaddleTpuError(f"{symbol}: the cooperative grid of "
                             f"{-(-ints[2] // ints[3])} CTAs cannot be "
                             "resident on this card")
    enforce(err == 0, f"{symbol} launch failed (cudaError {err})")


def lstm_fwd(xw, mask, w_hh, checks, h0, c0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward time loop: xw ``[B, T, 4H]`` (input projection and gate
    bias applied), mask ``[B, T]`` float, w_hh ``[H, 4H]``, checks
    ``[3, H]``, h0/c0 ``[B, H]`` → (H, C ``[B, T, H]`` kept states,
    gates ``[B, T, 4H]`` activated i, f, g, o)."""
    enforce(isinstance(xw, torch.Tensor) and xw.dim() == 3
            and xw.shape[-1] % 4 == 0,
            f"xw: expected [B, T, 4H], got {tuple(getattr(xw, 'shape', ()))}")
    b, t, hd4 = xw.shape
    hd = hd4 // 4
    for name, x, shape in (("xw", xw, (b, t, hd4)), ("mask", mask, (b, t)),
                           ("w_hh", w_hh, (hd, hd4)),
                           ("checks", checks, (3, hd)), ("h0", h0, (b, hd)),
                           ("c0", c0, (b, hd))):
        _check(name, x, shape)
    args = (xw, mask, w_hh, checks, h0, c0)
    if not _on_card(args):
        return lstm_fwd_reference(*args)
    u = _units_on_card(b, hd, xw.device)
    hseq = torch.empty((b, t, hd), dtype=torch.float32, device=xw.device)
    cseq = torch.empty_like(hseq)
    gates = torch.empty_like(xw)
    if xw.numel() == 0:
        return hseq, cseq, gates
    _launch("lstm_fwd", [x.data_ptr() for x in args + (hseq, cseq, gates)],
            (b, t, hd, u), xw.device)
    lstm_fwd.launches += 1
    return hseq, cseq, gates


lstm_fwd.launches = 0


def lstm_bwd(gates, hseq, cseq, h0, c0, mask, w_hh, checks, dy, dyc):
    """BPTT over the forward's residuals: gates ``[B, T, 4H]``, H and C
    ``[B, T, H]``, h0/c0, mask, w_hh, checks as in :func:`lstm_fwd`, and
    dy/dyc ``[B, T, H]`` the cotangents on H and C → (dxw ``[B, T, 4H]``,
    dw_hh ``[H, 4H]``, dchecks ``[3, H]``, dh0, dc0 ``[B, H]``)."""
    enforce(isinstance(gates, torch.Tensor) and gates.dim() == 3
            and gates.shape[-1] % 4 == 0,
            f"gates: expected [B, T, 4H], got "
            f"{tuple(getattr(gates, 'shape', ()))}")
    b, t, hd4 = gates.shape
    hd = hd4 // 4
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
    u = _units_on_card(b, hd, gates.device)
    dxw = torch.empty_like(gates)
    dw = torch.empty_like(w_hh)
    dck = torch.empty_like(checks)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    if gates.numel() == 0:
        return dxw, dw.zero_(), dck.zero_(), dh0.zero_(), dc0.zero_()
    # double-buffered per-CTA partials of the recurrent pull-back
    pbuf = torch.empty(2 * -(-hd // u) * b * (-(-hd // 4) * 4),
                       dtype=torch.float32, device=gates.device)
    _launch("lstm_bwd",
            [x.data_ptr() for x in args + (dxw, dw, dck, dh0, dc0, pbuf)],
            (b, t, hd, u), gates.device)
    lstm_bwd.launches += 1
    return dxw, dw, dck, dh0, dc0


lstm_bwd.launches = 0

#: Every kernel wrapper of this module (for counters and reports).
KERNEL_WRAPPERS = (lstm_fwd, lstm_bwd)


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


def lstm_fused_sequence(xw, mask, w_hh, check_i, check_f, check_o, h0, c0):
    """Batch-major contract of ``pallas_lstm.lstm_fused_sequence``: xw
    ``[B, T, 4H]`` pre-projected (+ gate bias), mask ``[B, T]``; returns
    (y ``[B, T, H]`` masked hidden outputs, cy ``[B, T, H]`` masked cell
    outputs, final_h, final_c ``[B, H]``) in fp32.

    ``check_i`` and ``check_f`` are given together or not at all,
    ``check_o`` on its own; absent peepholes are zeros and get no
    gradient.  ``h0``/``c0`` default to zeros."""
    b, _, hd4 = xw.shape
    hd = hd4 // 4
    zeros = torch.zeros(hd, dtype=torch.float32, device=xw.device)
    rows = [check_i, check_f] if check_i is not None else [zeros, zeros]
    rows.append(check_o if check_o is not None else zeros)
    checks = torch.stack(rows)
    if h0 is None:
        h0 = torch.zeros((b, hd), dtype=torch.float32, device=xw.device)
    if c0 is None:
        c0 = torch.zeros((b, hd), dtype=torch.float32, device=xw.device)
    m = mask.to(torch.float32)
    hseq, cseq = _LstmCore.apply(xw, m, w_hh, checks, h0, c0)
    y = hseq * m[..., None]
    cy = cseq * m[..., None]
    return y, cy, hseq[:, -1], cseq[:, -1]
