"""The numbers of kernels 11 and 9's tensor-core products, modelled on the
CPU.

Kernel 11 (``paddle_tpu_torch/csrc/lstm_bwd_blocked.cu``, the blocked
LSTM's BPTT) multiplies each step's pull-back dh_prev = dgates_t @ w_hhᵀ
on bf16 tensor cores: each f32 operand is carried as hi = bf16(x) and
lo = bf16(x - hi), each product as hi·hi + hi·lo + lo·hi (three passes).
Each 64-wide K chunk's sums are drained from the accumulators into f32,
the chunks added in f32 within each K slice (``bwd_blocked_slices``), and
the slices added in order onto the (1 - m) carry of the valid rows.  Here
the whole reversed recurrence runs with that pull-back (each chunk summed
in float64, then rounded to f32), and dxw, dh0, dc0 are held against the
port's plain version (``lstm_bwd_blocked_reference``) and the reference's
kernel (``pallas_lstm._bwd_call_blocked``, interpret mode) with phase 3c's
gradient tolerance (``LSTM_GRAD_ATOL`` + ``LSTM_GRAD_RTOL`` of max|ref|):
the model must stay within 0.75 of it although the recurrence compounds
the split's error over T, and a single bf16 rounding of both operands
must miss it.  The card adds the tensor cores' own accumulation within a
chunk, which phases 3c and 5 measure.

B 8, H 256, T up to 40, lengths 0, 1 and T, inputs from a numpy seed (the
forward's residuals from the port's plain forward).  The reference's
kernel takes one block of all H columns (``hb = H``), where its gate
blocks are the natural order.

Kernel 9 (``csrc/lstm_bwd.cu``, the single-block BPTT for H <= 512) runs
the same step loop (``csrc/lstm_wg.cuh``) and, in the same launch, the
peephole grads (each (row, unit)'s products summed over the steps in
step order, then the rows in ascending order) and dW_hh on the
tensor-core dW tile (``csrc/dw_wg.cuh``): the valid rows listed by
descending t, then rank, chunks of 64 rows (each summed in float64, then
rounded to f32) added in f32 within each split of the list
(``bwd_dw_splits``), the splits in split order.  Its contract -- dxw,
dW_hh, dchecks, dh0, dc0 -- is held against ``lstm_bwd_reference`` and
the reference's ``pallas_lstm._bwd_call`` (interpret mode) with phase
3b's gradient tolerance (the same numbers as 3c's), at B 8, H 128 and
200, with the same lengths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LSTM_GRAD_ATOL, LSTM_GRAD_RTOL, grad_errors
from paddle_tpu.ops import pallas_lstm
from paddle_tpu_torch.ops import lstm as L

assert (LSTM_GRAD_ATOL, LSTM_GRAD_RTOL) == (1e-5, 1e-4)

B, H = 8, 256
CASES = {"T40": (40, (40, 0, 1, 40, 23, 40, 7, 31)),
         "T17": (17, (17, 17, 0, 9, 1, 17, 12, 3)),
         "T1": (1, (1, 0, 1, 1, 0, 1, 1, 1))}


def _inputs(t, lens, seed, h=H):
    """The backward's inputs as torch f32 tensors: the forward's residuals
    (gates, H, C) from the port's plain forward on random xw, w_hh,
    checks, h0, c0, and random cotangents dy, dyc."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * sc).astype(np.float32))
    mask = torch.from_numpy(
        (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(
            np.float32))
    xw, w = f(B, t, 4 * h, sc=0.3), f(h, 4 * h, sc=h ** -0.5)
    checks, h0, c0 = f(3, h, sc=0.1), f(B, h, sc=0.5), f(B, h, sc=0.5)
    hseq, cseq, gates = L.lstm_fwd_blocked_reference(xw, mask, w, checks,
                                                     h0, c0)
    return {"gates": gates, "hseq": hseq, "cseq": cseq, "h0": h0, "c0": c0,
            "mask": mask, "w_hh": w, "checks": checks, "dy": f(B, t, h),
            "dyc": f(B, t, h)}


def _split(x):
    hi = x.to(torch.bfloat16)
    return hi.double(), (x - hi.float()).to(torch.bfloat16).double()


def _pullback(dg, w, passes):
    """dg @ wᵀ ([n, 4H] x [H, 4H]ᵀ, f32 in) as the kernel sums it: per K
    slice, per 64-wide chunk the three passes (or one pass of a single
    rounding) in float64 rounded to f32, chunks added in f32.  Returns
    the slices' sums in slice order."""
    k = dg.shape[1]
    dh, dl = _split(dg)
    wh, wl = _split(w)
    chunks = -(-k // 64)
    per = -(-chunks // L.bwd_blocked_slices(B, w.shape[0]))
    parts = []
    for c0 in range(0, chunks, per):
        tot = torch.zeros(dg.shape[0], w.shape[0])
        for c in range(c0, min(chunks, c0 + per)):
            ks = slice(64 * c, 64 * c + 64)
            p = dh[:, ks] @ wh[:, ks].t()
            if passes == 3:
                p = p + dh[:, ks] @ wl[:, ks].t() + dl[:, ks] @ wh[:, ks].t()
            tot = tot + p.float()
        parts.append(tot)
    return parts


def _model(x, passes):
    """``lstm_bwd_blocked_reference``'s loop with the kernel's pull-back:
    dh = (1 - m) dh_tot, then each slice added in order at the rows valid
    at the step.  Returns (dxw, dh0, dc0)."""
    gates, cseq, c0, mask = x["gates"], x["cseq"], x["c0"], x["mask"]
    checks, dy, dyc = x["checks"], x["dy"], x["dyc"]
    t, H = gates.shape[1], c0.shape[1]
    dh_c, dc_c = torch.zeros_like(c0), torch.zeros_like(c0)
    dxw = torch.empty_like(gates)
    for s in range(t - 1, -1, -1):
        g = gates[:, s]
        g_i, g_f = g[:, :H], g[:, H:2 * H]
        g_g, g_o = g[:, 2 * H:3 * H], g[:, 3 * H:]
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
        dh_c = (1.0 - m) * dh_tot
        valid = mask[:, s] != 0
        if valid.any():
            acc = dh_c[valid]
            for part in _pullback(dgates[valid], x["w_hh"], passes):
                acc = acc + part
            dh_c[valid] = acc
        dc_c = (1.0 - m) * dc_tot + dc * g_f + di_pre * checks[0] \
            + df_pre * checks[1]
        dxw[:, s] = dgates
    return dxw, dh_c, dc_c


def _jax_bwd(x):
    """``pallas_lstm._bwd_call_blocked`` (interpret mode on the CPU),
    time-major, one block of H columns."""
    tm = lambda a: jnp.moveaxis(jnp.asarray(a.numpy()), 1, 0)  # noqa
    c_prev = torch.cat([x["c0"][:, None], x["cseq"][:, :-1]], 1)
    checks = np.zeros((8, H), np.float32)
    checks[:3] = x["checks"].numpy()
    dxw, dh0, dc0 = pallas_lstm._bwd_call_blocked(
        tm(x["gates"]), tm(c_prev), tm(x["cseq"]),
        jnp.asarray(x["mask"].numpy().T[:, None, :]),
        jnp.asarray(x["w_hh"].numpy()), jnp.asarray(checks), tm(x["dy"]),
        tm(x["dyc"]), hb=H)
    return (torch.from_numpy(np.array(jnp.moveaxis(dxw, 0, 1))),
            torch.from_numpy(np.array(dh0)), torch.from_numpy(np.array(dc0)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_split_meets_phase_3c_tolerance(case):
    t, lens = CASES[case]
    x = _inputs(t, lens, seed=sorted(CASES).index(case))
    port = L.lstm_bwd_blocked_reference(
        *(x[k] for k in ("gates", "cseq", "c0", "mask", "w_hh", "checks",
                         "dy", "dyc")))
    three = dict(enumerate(_model(x, 3)))
    once = dict(enumerate(_model(x, 1)))
    for name, ref in (("port", port), ("pallas", _jax_bwd(x))):
        want = dict(enumerate(ref))
        _, ratio = grad_errors(three, want, LSTM_GRAD_ATOL, LSTM_GRAD_RTOL)
        assert ratio <= 0.75, (name, ratio)
        _, ratio_once = grad_errors(once, want, LSTM_GRAD_ATOL,
                                    LSTM_GRAD_RTOL)
        assert ratio_once > 1.0, (name, ratio_once)


def test_bwd_model_slices_at_the_bench_shape():
    """The pull-back's K slices: at B 128, H 1280 on 132 SMs, 10 unit
    blocks x 12 slices of 7 chunks (120 tiles); at H 2048, 16 x 8 of 16;
    every slice non-empty, the tiles within one CTA an SM."""
    assert L.bwd_blocked_slices(128, 1280, 132) == 12
    assert L.bwd_blocked_slices(128, 2048, 132) == 8
    for b, h in ((8, 256), (200, 700), (3, 642), (128, 1280), (4096, 640)):
        chunks = -(-4 * h // 64)
        s = L.bwd_blocked_slices(b, h, 132)
        per = -(-chunks // s)
        assert 1 <= s <= chunks and (s - 1) * per < chunks
        blocks = -(-b // 128) * -(-h // 128)
        assert blocks * s <= max(132, blocks)


# -------------------------------------------------------------- kernel 9
SINGLE = {"H128-T40": (128, "T40"), "H128-T17": (128, "T17"),
          "H128-T1": (128, "T1"), "H200-T40": (200, "T40")}


def _single_model(x, passes):
    """Kernel 9's (dxw, dW_hh, dchecks, dh0, dc0): the recurrence of
    :func:`_model`, then the peephole products of each (row, unit) summed
    over the steps (descending t, f32) and over the rows (ascending b),
    and dW_hh over the rows listed by descending t, then ascending b (the
    rank), in chunks of 64 as kernel 12's model sums them."""
    dxw, dh0, dc0 = _model(x, passes)
    h0, hseq, cseq, c0 = x["h0"], x["hseq"], x["cseq"], x["c0"]
    mask = x["mask"]
    t, h = dxw.shape[1], h0.shape[1]
    h_prev = torch.cat([h0[:, None], hseq[:, :-1]], 1)
    c_prev = torch.cat([c0[:, None], cseq[:, :-1]], 1)
    ckp = None
    for s in range(t - 1, -1, -1):
        g = dxw[:, s]
        v = torch.stack([g[:, :h] * c_prev[:, s], g[:, h:2 * h] * c_prev[:, s],
                         g[:, 3 * h:] * cseq[:, s]])
        ckp = v if ckp is None else ckp + v
    dck = ckp[:, 0]
    for b in range(1, B):
        dck = dck + ckp[:, b]
    listed = [(b, s) for s in range(t - 1, -1, -1) for b in range(B)
              if mask[b, s] != 0]
    a = torch.stack([h_prev[b, s] for b, s in listed]) if listed \
        else torch.zeros(0, h)
    g = torch.stack([dxw[b, s] for b, s in listed]) if listed \
        else torch.zeros(0, 4 * h)
    n_split = L.bwd_dw_splits(h)
    nch = -(-a.shape[0] // 64)
    dw = torch.zeros(h, 4 * h)
    for split in range(n_split):
        tot = torch.zeros(h, 4 * h)
        for ch in range(nch * split // n_split, nch * (split + 1) // n_split):
            rows = slice(64 * ch, 64 * ch + 64)
            ah, al = _split(a[rows])
            gh, gl = _split(g[rows])
            p = ah.t() @ gh
            if passes == 3:
                p = p + ah.t() @ gl + al.t() @ gh
            tot = tot + p.float()
        dw = tot if split == 0 else dw + tot
    return dxw, dw, dck, dh0, dc0


def _jax_single(x):
    """``pallas_lstm._bwd_call`` (interpret mode on the CPU), time-major:
    (dxw, dW_hh, dchecks, dh0, dc0)."""
    tm = lambda a: jnp.moveaxis(jnp.asarray(a.numpy()), 1, 0)  # noqa
    h = x["c0"].shape[1]
    h_prev = torch.cat([x["h0"][:, None], x["hseq"][:, :-1]], 1)
    c_prev = torch.cat([x["c0"][:, None], x["cseq"][:, :-1]], 1)
    checks = np.zeros((8, h), np.float32)
    checks[:3] = x["checks"].numpy()
    dxw, dw, dck, dh0, dc0 = pallas_lstm._bwd_call(
        tm(x["gates"]), tm(h_prev), tm(c_prev), tm(x["cseq"]),
        jnp.asarray(x["mask"].numpy().T[:, None, :]),
        jnp.asarray(x["w_hh"].numpy()), jnp.asarray(checks), tm(x["dy"]),
        tm(x["dyc"]))
    back = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return (back(jnp.moveaxis(dxw, 0, 1)), back(dw), back(dck[:3]),
            back(dh0), back(dc0))


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_single_block_split_meets_phase_3b_tolerance(case):
    h, lens_case = SINGLE[case]
    t, lens = CASES[lens_case]
    x = _inputs(t, lens, seed=20 + sorted(SINGLE).index(case), h=h)
    port = L.lstm_bwd_reference(
        *(x[k] for k in ("gates", "hseq", "cseq", "h0", "c0", "mask",
                         "w_hh", "checks", "dy", "dyc")))
    three = dict(enumerate(_single_model(x, 3)))
    once = dict(enumerate(_single_model(x, 1)))
    for name, ref in (("port", port), ("pallas", _jax_single(x))):
        want = dict(enumerate(ref))
        _, ratio = grad_errors(three, want, LSTM_GRAD_ATOL, LSTM_GRAD_RTOL)
        assert ratio <= 0.75, (name, ratio)
        _, ratio_once = grad_errors(once, want, LSTM_GRAD_ATOL,
                                    LSTM_GRAD_RTOL)
        assert ratio_once > 1.0, (name, ratio_once)


def test_single_block_plan_at_the_bench_shape():
    """Kernel 9 at B 128, H 512 on 132 SMs: 4 unit blocks x 16 slices of
    two chunks (64 tiles) for the pull-back, 64 dW tiles x 2 splits; a
    slice takes two chunks wherever K has them."""
    assert L.bwd_blocked_slices(128, 512, 132) == 16
    for b, h in ((8, 128), (200, 50), (3, 64), (128, 512)):
        chunks = -(-4 * h // 64)
        s = L.bwd_blocked_slices(b, h, 132)
        assert -(-chunks // s) >= min(2, chunks)
    assert L.bwd_dw_splits(512, 132) == 2
    assert L.bwd_dw_splits(128, 132) == L.MAX_DW_SPLIT
    for h in (1, 50, 64, 96, 200, 512):
        tiles = -(-h // 128) * -(-4 * h // 128)
        s = L.bwd_dw_splits(h, 132)
        assert 1 <= s <= L.MAX_DW_SPLIT and (s == 1 or tiles * s <= 132)
