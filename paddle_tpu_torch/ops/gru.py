"""Fused GRU sequence (counterpart of ``paddle_tpu/ops/pallas_gru.py``:
its single-block tier).

Hand-written CUDA C++ kernels for ``sm_90a``, each a whole time loop of
one GRU direction in one persistent cooperative launch (the design of
the LSTM's ``csrc/lstm_fwd.cu`` / ``lstm_bwd.cu``, sharing
``csrc/lstm_common.cuh``):

- :func:`gru_fwd` (``csrc/gru_fwd.cu``, kernel 13; plain version
  :func:`gru_fwd_reference`) writes the kept state sequence H and the
  gate residue (u, r, c);
- :func:`gru_bwd` (``csrc/gru_bwd.cu``, kernel 14; plain version
  :func:`gru_bwd_reference`) gives dxw, dW_gates, dW_cand and dh0.

Gate layout (u, r, c), w_gates ``[H, 2H]`` (u | r), w_cand ``[H, H]``;
the reset gate applies before the candidate product: c = tanh(x_c +
(r·h) @ w_cand), h' = u·h + (1−u)·c, and a padded step keeps h.

:class:`_GruCore` (``torch.autograd.Function``) launches the forward
kernel in its forward and the backward kernel in its backward, as
``pallas_gru._gru_core`` does with its custom VJP;
:func:`gru_fused_sequence` is the public function.  The hidden-blocked
tier (kernels 15–17, 512 < H) is not ported: on a CUDA tensor such a
shape raises; CPU tensors take the plain versions at any H.

Layouts are batch-major throughout (xw / gates / dxw ``[B, T, 3H]``,
states ``[B, T, H]``, mask ``[B, T]``), so no time-major copy is made.
A wrapper checks dtype (fp32 only), shape and contiguity first.  CPU
tensors then take the plain version; CUDA tensors launch the kernel or
raise.  Each wrapper counts its launches in ``.launches``.

Precision: the kernels compute in fp32, whatever the policy.
:func:`gru_fused_sequence` casts xw to fp32 before the kernel (a bf16
xw converts exactly), so autograd returns dxw in xw's dtype, as
``_gru_core_bwd`` casts dxw to xw's dtype (``pallas_gru.py:213``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import FLAGS, PaddleTpuError, enforce
from .lstm import SM_COUNT, SMEM_BYTES, _check, _launch, _on_card, _shifted

#: Hidden units per CTA (its 2U gate and U candidate columns feed the
#: register-blocked products of ``csrc/lstm_common.cuh``, which take a
#: multiple of 4 columns).
UNITS = 4
#: Largest H the single-block kernels take; above it, the blocked tier
#: (kernels 15-17, not ported).
MAX_HIDDEN = 512
# shared-memory pieces of csrc/lstm_common.cuh, in floats: three staged
# [128, 68] tiles and the k-group partial sums
_TILE_FLOATS, _RED_FLOATS = 3 * 128 * 68, 8 * 128 * 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(b: int, h: int) -> Tuple[int, int]:
    """Dynamic shared memory of the (forward, backward) kernels, in
    bytes — the arithmetic of ``csrc/gru_fwd.cu`` / ``gru_bwd.cu``."""
    u = UNITS
    fwd = _round_up(h, 64) * 3 * u + _TILE_FLOATS + _RED_FLOATS + 3 * b * u
    bwd = (_round_up(h, 64) + _round_up(2 * h, 64)) * u + _TILE_FLOATS \
        + _RED_FLOATS + 3 * b * u
    return 4 * fwd, 4 * bwd


def fused_tier(b: int, h: int, sms: int = SM_COUNT) -> Optional[str]:
    """Which kernels serve (b, h) on a card with ``sms`` SMs:

    - ``"fused"``: 1 <= h <= 512, a grid of ceil(h / 4) CTAs at most one
      per SM, both kernels' shared memory within one block's limit;
    - ``"fused_blocked"``: 512 < h under ``--fused_rnn_hblock`` (default
      on) — the JAX package's hidden-blocked tier, kernels 15-17, which
      the port has not written yet (its wrappers raise on CUDA);
    - ``None`` otherwise.  No tiling gate."""
    if b < 1 or h < 1:
        return None
    if h <= MAX_HIDDEN:
        if -(-h // UNITS) > sms or max(smem_bytes(b, h)) > SMEM_BYTES:
            return None
        return "fused"
    return "fused_blocked" if FLAGS.get("fused_rnn_hblock") else None


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


def gru_bwd_reference(gates, hseq, h0, mask, w_gates, w_cand, dy):
    """Plain version of :func:`gru_bwd`: the reversed step loop of
    ``pallas_gru._bwd_kernel``; dy joins the carry before the masked
    split.  The weight gradients are one summed product each over all
    (b, t) after the loop (a padded step's dgates are exact zeros) →
    (dxw, dw_gates, dw_cand, dh0)."""
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
    rows = h_prev_seq.reshape(-1, hd)
    r_all = gates[..., hd:2 * hd].reshape(-1, hd)
    dxw2 = dxw.reshape(-1, 3 * hd)
    return (dxw, rows.t() @ dxw2[:, :2 * hd],
            (r_all * rows).t() @ dxw2[:, 2 * hd:], dh_c)


# ------------------------------------------------------------------ wrappers
def _check_gates(name: str, x) -> Tuple[int, int, int]:
    enforce(isinstance(x, torch.Tensor) and x.dim() == 3
            and x.shape[-1] % 3 == 0,
            f"{name}: expected [B, T, 3H], got "
            f"{tuple(getattr(x, 'shape', ()))}")
    b, t, hd3 = x.shape
    return b, t, hd3 // 3


def _tier_on_card(b: int, h: int, dev: torch.device) -> None:
    """Raise unless the single-block kernels serve (b, h) on ``dev``."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else SM_COUNT
    tier = fused_tier(b, h, sms)
    if tier == "fused_blocked":
        raise PaddleTpuError(
            f"GRU hidden={h} > {MAX_HIDDEN} needs the hidden-blocked tier "
            "(kernels 15-17: pallas_gru._fwd_kernel_blocked, "
            "_bwd_kernel_blocked, _dw_kernel_blocked), which is not yet "
            "ported; set --fused_rnn_hblock=false for the per-step scan")
    if tier != "fused":
        raise PaddleTpuError(
            f"the fused GRU kernels do not serve batch={b} hidden={h} "
            f"(hidden <= {MAX_HIDDEN}, ceil(hidden / {UNITS}) <= {sms} "
            f"CTAs, shared memory <= {SMEM_BYTES} B)")


def gru_fwd(xw, mask, w_gates, w_cand, h0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward time loop (kernel 13): xw ``[B, T, 3H]`` (input projection
    and bias applied), mask ``[B, T]`` float, w_gates ``[H, 2H]``,
    w_cand ``[H, H]``, h0 ``[B, H]`` → (H ``[B, T, H]`` kept states,
    gates ``[B, T, 3H]`` = u, r, c)."""
    b, t, hd = _check_gates("xw", xw)
    for name, x, shape in (("xw", xw, (b, t, 3 * hd)), ("mask", mask, (b, t)),
                           ("w_gates", w_gates, (hd, 2 * hd)),
                           ("w_cand", w_cand, (hd, hd)), ("h0", h0, (b, hd))):
        _check(name, x, shape)
    args = (xw, mask, w_gates, w_cand, h0)
    if not _on_card(args):
        return gru_fwd_reference(*args)
    _tier_on_card(b, hd, xw.device)
    hseq = torch.empty((b, t, hd), dtype=torch.float32, device=xw.device)
    gates = torch.empty_like(xw)
    if xw.numel() == 0:
        return hseq, gates
    rh = torch.empty_like(h0)          # r * h_prev of the step
    _launch("gru_fwd", [x.data_ptr() for x in args + (hseq, gates, rh)],
            (b, t, hd), xw.device)
    gru_fwd.launches += 1
    return hseq, gates


gru_fwd.launches = 0


def gru_bwd(gates, hseq, h0, mask, w_gates, w_cand, dy):
    """BPTT over the forward's residuals (kernel 14): gates ``[B, T,
    3H]``, H ``[B, T, H]``, h0, mask, w_gates, w_cand as in
    :func:`gru_fwd`, dy ``[B, T, H]`` the cotangent on H → (dxw ``[B,
    T, 3H]``, dw_gates ``[H, 2H]``, dw_cand ``[H, H]``, dh0 ``[B, H]``)."""
    b, t, hd = _check_gates("gates", gates)
    for name, x, shape in (("gates", gates, (b, t, 3 * hd)),
                           ("hseq", hseq, (b, t, hd)), ("h0", h0, (b, hd)),
                           ("mask", mask, (b, t)),
                           ("w_gates", w_gates, (hd, 2 * hd)),
                           ("w_cand", w_cand, (hd, hd)),
                           ("dy", dy, (b, t, hd))):
        _check(name, x, shape)
    args = (gates, hseq, h0, mask, w_gates, w_cand, dy)
    if not _on_card(args):
        return gru_bwd_reference(*args)
    _tier_on_card(b, hd, gates.device)
    dxw = torch.empty_like(gates)
    dwg = torch.empty_like(w_gates)
    dwc = torch.empty_like(w_cand)
    dh0 = torch.empty_like(h0)
    if gates.numel() == 0:
        return dxw, dwg.zero_(), dwc.zero_(), dh0.zero_()
    rh = torch.empty_like(hseq)        # r * h_prev of every step, for dW
    _launch("gru_bwd",
            [x.data_ptr() for x in args + (dxw, dwg, dwc, dh0, rh)],
            (b, t, hd), gates.device)
    gru_bwd.launches += 1
    return dxw, dwg, dwc, dh0


gru_bwd.launches = 0

#: Every kernel wrapper of this module (for counters and reports).
KERNEL_WRAPPERS = (gru_fwd, gru_bwd)


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


def gru_fused_sequence(xw, mask, w_gates, w_cand, h0):
    """Batch-major contract of ``pallas_gru.gru_fused_sequence``: xw
    ``[B, T, 3H]`` pre-projected (+ bias), mask ``[B, T]``; returns (y
    ``[B, T, H]`` masked hidden outputs, final_h ``[B, H]`` the kept
    state after the last step) in fp32, whatever the inputs' float dtype
    (callers cast per their policy).  ``h0`` defaults to zeros."""
    b, _, hd3 = xw.shape
    f32 = torch.float32
    h0 = torch.zeros((b, hd3 // 3), dtype=f32, device=xw.device) \
        if h0 is None else h0.to(f32)
    m = mask.to(f32)
    hseq = _GruCore.apply(xw.to(f32), m, w_gates.to(f32).contiguous(),
                          w_cand.to(f32).contiguous(), h0.contiguous())
    return hseq * m[..., None], hseq[:, -1]
