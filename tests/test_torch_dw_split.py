"""The numbers of the tensor-core dW tile (kernels 17 and 12), modelled
on the CPU.

Kernel 17 (``paddle_tpu_torch/csrc/gru_dw_blocked.cu`` on the tile of
``csrc/dw_wg.cuh``) sums dW_gates = Σ h_prevᵀ·dg and dW_cand =
Σ (r·h_prev)ᵀ·dc_pre over the valid (b, t) rows on bf16 tensor cores: each
f32 operand is carried as hi = bf16(x) and lo = bf16(x - hi), and each
product as hi·hi + hi·lo + lo·hi (three passes).  Here the same split
feeds products summed in float64, so only the split's rounding is
measured, against the port's plain version (``gru_dw_blocked_reference``)
and the reference's kernel (``pallas_gru._dw_call_blocked``, in
interpret mode), with ``chip_smoke.py``'s phase-3f gradient tolerance
(``GRU_GRAD_ATOL`` + ``GRU_GRAD_RTOL`` of max|ref|): the split must stay
within 0.75 of it, and a single bf16 rounding of both operands must miss
it.  The card adds the tensor cores' own f32 accumulation over a chunk
of 64 rows, which phase 3f and phase 5 measure.

Cases: H 136 and 520 (partial 128-wide tiles), H 514 (H % 4 != 0, the
tile's scalar staging on the card), masked rows with lengths 0, 1 and T,
inputs from a numpy seed.  The reference's kernel takes one
block of all H columns (``hb = H``), where its gate blocks are the
identity permutation.

Kernel 12 (``csrc/lstm_dw_blocked.cu``, the LSTM's dW_hh = Σ
h_prevᵀ·dgates on the same tile) is modelled more closely: each chunk of
64 listed rows is summed in float64 and rounded to f32 (the tensor cores'
accumulator, drained), the chunks added in f32 in order within each split
of the row list, and the splits in split order (``reduce_splits_kernel``),
against ``lstm_dw_blocked_reference`` and ``pallas_lstm._dw_call_blocked``
with phase 3c's tolerance (``LSTM_GRAD_ATOL`` + ``LSTM_GRAD_RTOL`` of
max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (GRU_GRAD_ATOL, GRU_GRAD_RTOL, LSTM_GRAD_ATOL,
                        LSTM_GRAD_RTOL, grad_errors)
from paddle_tpu.ops import pallas_gru, pallas_lstm
from paddle_tpu_torch.ops import gru as G
from paddle_tpu_torch.ops import lstm as L

assert (GRU_GRAD_ATOL, GRU_GRAD_RTOL) == (3e-5, 3e-4)
assert (LSTM_GRAD_ATOL, LSTM_GRAD_RTOL) == (1e-5, 1e-4)

CASES = {"H136": (8, 6, 136, (6, 0, 1, 6, 3, 1, 5, 2)),
         "H520": (6, 5, 520, (5, 0, 1, 5, 2, 4)),
         "H136-full": (4, 7, 136, (7, 7, 7, 7)),
         "scalar-H514": (5, 6, 514, (6, 0, 1, 6, 3))}


def _inputs(b, t, h, lens, seed):
    """hseq, h0, rh [B, T, H] / [B, H], dxw [B, T, 3H] (exact zeros at
    padded steps, as the backward writes them) and the mask."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)
    return {"hseq": f(b, t, h, sc=0.5), "h0": f(b, h, sc=0.5),
            "rh": f(b, t, h, sc=0.5),
            "dxw": f(b, t, 3 * h) * mask[..., None], "mask": mask}


def _split(x):
    hi = x.to(torch.bfloat16)
    return hi.double(), (x - hi.float()).to(torch.bfloat16).double()


def _products(a, b, passes):
    """aᵀ·b over the rows, a [n, K] and b [n, C] f32, as the tile's
    products summed in float64: three passes of the split, or one of a
    single rounding of both."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah.t() @ bh
    return ah.t() @ bh + ah.t() @ bl + al.t() @ bh


def _model(x, passes):
    """Kernel 17's two gradients: the valid rows listed in (b, t) order,
    h_prev (h0 at t = 0) and r·h_prev against dg and dc_pre."""
    t_in = {k: torch.from_numpy(v) for k, v in x.items()}
    hseq, h0, rh, dxw = (t_in[k] for k in ("hseq", "h0", "rh", "dxw"))
    h = h0.shape[-1]
    h_prev = torch.cat([h0[:, None], hseq[:, :-1]], 1)
    valid = t_in["mask"] != 0
    dg, dc = dxw[..., :2 * h][valid], dxw[..., 2 * h:][valid]
    return (_products(h_prev[valid], dg, passes),
            _products(rh[valid], dc, passes))


def _jax_dw(x):
    """``pallas_gru._dw_call_blocked`` (interpret mode on the CPU), time-
    major, one block of H columns."""
    h = x["h0"].shape[-1]
    tm = lambda a: jnp.moveaxis(jnp.asarray(a), 1, 0)  # noqa: E731
    keep = x["mask"][..., None]
    h_prev = np.concatenate([x["h0"][:, None], x["hseq"][:, :-1]], 1)
    dwg, dwc = pallas_gru._dw_call_blocked(
        tm(h_prev * keep), tm(x["rh"] * keep), tm(x["dxw"][..., :2 * h]),
        tm(x["dxw"][..., 2 * h:]), hb=h)
    return torch.from_numpy(np.array(dwg)), torch.from_numpy(np.array(dwc))


@pytest.mark.parametrize("case", sorted(CASES))
def test_dw_split_meets_phase_3f_tolerance(case):
    b, t, h, lens = CASES[case]
    x = _inputs(b, t, h, lens, seed=sorted(CASES).index(case))
    t_in = {k: torch.from_numpy(v) for k, v in x.items()}
    port = G.gru_dw_blocked_reference(t_in["hseq"], t_in["h0"], t_in["rh"],
                                      t_in["dxw"], t_in["mask"])
    three, once = _model(x, 3), _model(x, 1)
    for name, ref in (("port", port), ("pallas", _jax_dw(x))):
        want = dict(enumerate(ref))
        _, ratio = grad_errors(dict(enumerate(three)), want, GRU_GRAD_ATOL,
                               GRU_GRAD_RTOL)
        assert ratio <= 0.75, (name, ratio)
        _, ratio_once = grad_errors(dict(enumerate(once)), want,
                                    GRU_GRAD_ATOL, GRU_GRAD_RTOL)
        assert ratio_once > 1.0, (name, ratio_once)


def test_dw_model_skips_padded_rows():
    """The tile sums only the listed valid rows, as the plain version
    masks them: junk in r·h_prev and dxw at padded steps changes neither
    the modelled sums nor the port's plain version."""
    b, t, h, lens = CASES["H136"]
    x = _inputs(b, t, h, lens, seed=7)
    y = {k: v.copy() for k, v in x.items()}
    pad = x["mask"] == 0
    y["rh"][pad] += 3.0
    y["dxw"][pad] += 5.0
    for a, c in zip(_model(x, 3), _model(y, 3)):
        assert torch.equal(a, c)
    t_x = {k: torch.from_numpy(v) for k, v in x.items()}
    t_y = {k: torch.from_numpy(v) for k, v in y.items()}
    args = ("hseq", "h0", "rh", "dxw", "mask")
    for a, c in zip(G.gru_dw_blocked_reference(*(t_x[k] for k in args)),
                    G.gru_dw_blocked_reference(*(t_y[k] for k in args))):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


# ------------------------------------------------------------- kernel 12
LSTM_CASES = {"H136": (8, 6, 136, (6, 0, 1, 6, 3, 1, 5, 2)),
              "H520": (6, 5, 520, (5, 0, 1, 5, 2, 4)),
              "H136-long": (12, 11, 136, (11, 0, 1, 11, 7, 11, 3, 9, 11, 2,
                                          11, 5))}


def _lstm_inputs(b, t, h, lens, seed):
    """hseq [B, T, H], h0 [B, H], dxw [B, T, 4H] (exact zeros at padded
    steps, as the backward writes them) and the mask."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)
    return {"hseq": f(b, t, h, sc=0.5), "h0": f(b, h, sc=0.5),
            "dxw": f(b, t, 4 * h) * mask[..., None], "mask": mask}


def _lstm_model(x, passes, n_split):
    """Kernel 12: the valid rows listed in (b, t) order, chunks of 64
    rows (each summed in float64, then rounded to f32), added in f32
    within each split of the chunks, the splits added in split order."""
    t_in = {k: torch.from_numpy(v) for k, v in x.items()}
    hseq, h0, dxw = t_in["hseq"], t_in["h0"], t_in["dxw"]
    h = h0.shape[-1]
    valid = t_in["mask"] != 0
    a = torch.cat([h0[:, None], hseq[:, :-1]], 1)[valid]
    g = dxw[valid]
    nch = -(-a.shape[0] // 64)
    total = torch.zeros(h, 4 * h)
    for split in range(n_split):
        tot = torch.zeros(h, 4 * h)
        for ch in range(nch * split // n_split, nch * (split + 1) // n_split):
            rows = slice(64 * ch, 64 * ch + 64)
            tot = tot + _products(a[rows], g[rows], passes).float()
        total = tot if split == 0 else total + tot
    return total


def _jax_lstm_dw(x):
    """``pallas_lstm._dw_call_blocked`` (interpret mode on the CPU), time-
    major, one block of H columns (the gate-block layout is then the
    natural one)."""
    h = x["h0"].shape[-1]
    keep = x["mask"][..., None]
    h_prev = np.concatenate([x["h0"][:, None], x["hseq"][:, :-1]], 1)
    dw = pallas_lstm._dw_call_blocked(
        jnp.moveaxis(jnp.asarray(h_prev * keep), 1, 0),
        jnp.moveaxis(jnp.asarray(x["dxw"]), 1, 0), hb=h)
    return torch.from_numpy(np.array(dw))


@pytest.mark.parametrize("n_split", [1, 4])
@pytest.mark.parametrize("case", sorted(LSTM_CASES))
def test_lstm_dw_split_meets_phase_3c_tolerance(case, n_split):
    b, t, h, lens = LSTM_CASES[case]
    x = _lstm_inputs(b, t, h, lens, seed=10 + sorted(LSTM_CASES).index(case))
    t_in = {k: torch.from_numpy(v) for k, v in x.items()}
    port = L.lstm_dw_blocked_reference(t_in["hseq"], t_in["h0"],
                                       t_in["dxw"], t_in["mask"])
    three = _lstm_model(x, 3, n_split)
    once = _lstm_model(x, 1, n_split)
    for name, ref in (("port", port), ("pallas", _jax_lstm_dw(x))):
        _, ratio = grad_errors({0: three}, {0: ref}, LSTM_GRAD_ATOL,
                               LSTM_GRAD_RTOL)
        assert ratio <= 0.75, (name, ratio)
        _, ratio_once = grad_errors({0: once}, {0: ref}, LSTM_GRAD_ATOL,
                                    LSTM_GRAD_RTOL)
        assert ratio_once > 1.0, (name, ratio_once)
