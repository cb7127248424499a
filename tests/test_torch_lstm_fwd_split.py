"""The numbers of kernel 10's tensor-core step product, modelled on the CPU.

Kernel 10 (``paddle_tpu_torch/csrc/lstm_fwd_blocked.cu``, the blocked
LSTM's forward, on the step loop of ``csrc/lstm_wg.cuh``) multiplies each
step's gates = h_{t-1} @ w_hh on bf16 tensor cores: each f32 operand is
carried as hi = bf16(x) and lo = bf16(x - hi), each product as hi·hi +
hi·lo + lo·hi (three passes).  Each 64-wide K chunk's sums are drained
from the accumulators into f32, the chunks added in f32 within each K
slice (``fwd_blocked_slices``), and xw_t plus the slices added in order
for the rows valid at the step.  Here the whole forward recurrence runs
with that product (each chunk summed in float64, then rounded to f32),
and H, C and the gates are held against the port's plain version
(``lstm_fwd_blocked_reference``) and the reference's kernel
(``pallas_lstm._fwd_call_blocked``, interpret mode; its gates at the
valid steps, since the port writes a padded step's gates as 0) with
phase 3c's forward tolerance (``LSTM_ATOL``): the model must stay within
0.75 of it although the recurrence compounds the split's error over T,
and a single bf16 rounding of both operands must miss it.  The card adds
the tensor cores' own accumulation within a chunk, which phases 3c and 5
measure.

B 8, H 256, T up to 40, lengths 0, 1 and T, inputs from a numpy seed;
one case with the mask reversed in time (the padded steps first, as
``lstm_sequence(reverse=True)`` hands the kernel a flipped mask), where a
row starts valid after padded steps and its kept h0 must reach the
product.  The reference's kernel takes one block of all H columns
(``hb = H``), where its gate blocks are the natural order.

Kernel 8 (``csrc/lstm_fwd.cu``, the single-block forward for H <= 512)
runs the same three-pass product with the whole of K in one CTA: each
CTA holds its units' gate columns of w_hh as hi/lo planes and sums every
64-wide chunk of h_{t-1} @ w_hh in f32, for every row at every step (a
padded step's gates are part of its contract, from the kept state).
Its model is held against ``lstm_fwd_reference`` and the reference's
``pallas_lstm._fwd_call`` (interpret mode) at B 8, H 128 and 200 with
the same lengths and a reversed mask, within 0.75 of ``LSTM_ATOL``; a
single rounding must miss it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LSTM_ATOL
from paddle_tpu.ops import pallas_lstm
from paddle_tpu_torch.ops import lstm as L

assert LSTM_ATOL == 1e-4

B, H = 8, 256
CASES = {"T40": (40, (40, 0, 1, 40, 23, 40, 7, 31), False),
         "T17": (17, (17, 17, 0, 9, 1, 17, 12, 3), False),
         "T1": (1, (1, 0, 1, 1, 0, 1, 1, 1), False),
         "T40-reversed": (40, (40, 0, 1, 40, 23, 40, 7, 31), True)}


def _inputs(t, lens, reverse, seed, h=H):
    """xw, mask, w_hh, checks, h0, c0 as torch f32 tensors."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * sc).astype(np.float32))
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)
    if reverse:
        mask = mask[:, ::-1].copy()
    return {"xw": f(B, t, 4 * h, sc=0.3), "mask": torch.from_numpy(mask),
            "w_hh": f(h, 4 * h, sc=h ** -0.5), "checks": f(3, h, sc=0.1),
            "h0": f(B, h, sc=0.5), "c0": f(B, h, sc=0.5)}


def _split(x):
    hi = x.to(torch.bfloat16)
    return hi.double(), (x - hi.float()).to(torch.bfloat16).double()


def _product(h, w, passes):
    """h @ w ([n, H] x [H, 4H], f32 in) as the kernel sums it: per K
    slice, per 64-wide chunk the three passes (or one pass of a single
    rounding) in float64 rounded to f32, chunks added in f32.  Returns
    the slices' sums in slice order."""
    hh, hl = _split(h)
    wh, wl = _split(w)
    chunks = -(-H // 64)
    per = -(-chunks // L.fwd_blocked_slices(B, H))
    parts = []
    for c0 in range(0, chunks, per):
        tot = torch.zeros(h.shape[0], w.shape[1])
        for c in range(c0, min(chunks, c0 + per)):
            ks = slice(64 * c, 64 * c + 64)
            p = hh[:, ks] @ wh[ks]
            if passes == 3:
                p = p + hh[:, ks] @ wl[ks] + hl[:, ks] @ wh[ks]
            tot = tot + p.float()
        parts.append(tot)
    return parts


def _model(x, passes):
    """``lstm_fwd_blocked_reference``'s loop with the kernel's product:
    at the rows valid at the step, xw_t plus each slice in order, then
    the gate math; padded rows keep h and c and get zero gates.  Returns
    (H, C, gates)."""
    xw, mask, checks = x["xw"], x["mask"], x["checks"]
    h_prev, c_prev = x["h0"], x["c0"]
    hs, cs, gs = [], [], []
    for s in range(xw.shape[1]):
        valid = mask[:, s] != 0
        h, c = h_prev.clone(), c_prev.clone()
        gates = torch.zeros(B, 4 * H)
        if valid.any():
            pre = xw[valid, s]
            for part in _product(h_prev[valid], x["w_hh"], passes):
                pre = pre + part
            cp = c_prev[valid]
            i = torch.sigmoid(pre[:, :H] + cp * checks[0])
            f = torch.sigmoid(pre[:, H:2 * H] + cp * checks[1])
            gg = torch.tanh(pre[:, 2 * H:3 * H])
            cn = f * cp + i * gg
            o = torch.sigmoid(pre[:, 3 * H:] + cn * checks[2])
            hn = o * torch.tanh(cn)
            m = mask[valid, s, None]
            h[valid] = m * hn + (1.0 - m) * h_prev[valid]
            c[valid] = m * cn + (1.0 - m) * cp
            gates[valid] = torch.cat([i, f, gg, o], dim=-1)
        hs.append(h)
        cs.append(c)
        gs.append(gates)
        h_prev, c_prev = h, c
    return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(gs, 1)


def _jax_fwd(x):
    """``pallas_lstm._fwd_call_blocked`` (interpret mode on the CPU),
    time-major, one block of H columns; its gates zeroed at the padded
    steps as the port's contract writes them."""
    tm = lambda a: jnp.moveaxis(jnp.asarray(a.numpy()), 1, 0)  # noqa
    checks = np.zeros((8, H), np.float32)
    checks[:3] = x["checks"].numpy()
    hseq, cseq, gates = pallas_lstm._fwd_call_blocked(
        tm(x["xw"]), jnp.asarray(x["mask"].numpy().T[:, None, :]),
        jnp.asarray(x["w_hh"].numpy()), jnp.asarray(checks),
        jnp.asarray(x["h0"].numpy()), jnp.asarray(x["c0"].numpy()), hb=H)
    back = lambda a: torch.from_numpy(  # noqa: E731
        np.array(jnp.moveaxis(a, 0, 1)))
    keep = (x["mask"] != 0).float()[..., None]
    return back(hseq), back(cseq), back(gates) * keep


def _err(got, want):
    return max((g - w).abs().max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_split_meets_phase_3c_tolerance(case):
    t, lens, reverse = CASES[case]
    x = _inputs(t, lens, reverse, seed=sorted(CASES).index(case))
    port = L.lstm_fwd_blocked_reference(
        *(x[k] for k in ("xw", "mask", "w_hh", "checks", "h0", "c0")))
    three, once = _model(x, 3), _model(x, 1)
    for name, ref in (("port", port), ("pallas", _jax_fwd(x))):
        assert _err(three, ref) <= 0.75 * LSTM_ATOL, (name, _err(three, ref))
        assert _err(once, ref) > LSTM_ATOL, (name, _err(once, ref))


def test_fwd_model_feeds_rows_valid_after_padded_steps():
    """In the reversed case a row padded at the first steps keeps h0 and
    c0 there and starts at its first valid step from them: the model's
    product reaches that row (its h_{t-1} is the kept state), and junk
    in xw at padded steps changes nothing."""
    t, lens, _ = CASES["T40-reversed"]
    x = _inputs(t, lens, True, seed=5)
    y = dict(x, xw=x["xw"] + 7.0 * (x["mask"] == 0).float()[..., None])
    for a, c in zip(_model(x, 3), _model(y, 3)):
        assert torch.equal(a, c)
    hseq, cseq, gates = _model(x, 3)
    b = 4                                       # length 23: 17 padded steps
    assert torch.equal(hseq[b, :17], x["h0"][b].expand(17, H))
    assert not gates[b, :17].any() and gates[b, 17:].all()
    assert (hseq[b, 17] - x["h0"][b]).abs().max() > 1e-3


def test_fwd_slices_at_the_bench_shape():
    """The step product's K slices: at B 128, H 1280 on 132 SMs, 40
    column blocks x 3 slices of 7 chunks (120 tiles); at H 2048, 64 x 2
    of 16 (128 tiles); every slice non-empty, the tiles within one CTA
    an SM."""
    assert L.fwd_blocked_slices(128, 1280, 132) == 3
    assert L.fwd_blocked_slices(128, 2048, 132) == 2
    for b, h in ((8, 256), (200, 700), (3, 642), (128, 1280), (4096, 640)):
        chunks = -(-h // 64)
        s = L.fwd_blocked_slices(b, h, 132)
        per = -(-chunks // s)
        assert 1 <= s <= chunks and (s - 1) * per < chunks
        blocks = -(-b // 128) * -(-h // 32)
        assert blocks * s <= max(132, blocks)


# -------------------------------------------------------------- kernel 8
SINGLE = {"H128-T40": (128, "T40"), "H128-T17": (128, "T17"),
          "H128-T1": (128, "T1"), "H200-T40-reversed": (200, "T40-reversed")}


def _whole_k(h, w, passes):
    """h @ w ([n, H] x [H, 4H], f32 in) as kernel 8 sums it: per 64-wide
    chunk the three passes (or one pass of a single rounding) in float64
    rounded to f32, the chunks added in f32 over the whole of K."""
    hh, hl = _split(h)
    wh, wl = _split(w)
    tot = torch.zeros(h.shape[0], w.shape[1])
    for c in range(-(-h.shape[1] // 64)):
        ks = slice(64 * c, 64 * c + 64)
        p = hh[:, ks] @ wh[ks]
        if passes == 3:
            p = p + hh[:, ks] @ wl[ks] + hl[:, ks] @ wh[ks]
        tot = tot + p.float()
    return tot


def _single_model(x, passes):
    """``lstm_fwd_reference``'s loop with kernel 8's product (every row,
    xw_t plus the whole-K sum): returns (H, C, gates)."""
    xw, mask, checks = x["xw"], x["mask"], x["checks"]
    h = xw.shape[-1] // 4
    h_prev, c_prev = x["h0"], x["c0"]
    hs, cs, gs = [], [], []
    for s in range(xw.shape[1]):
        pre = xw[:, s] + _whole_k(h_prev, x["w_hh"], passes)
        i = torch.sigmoid(pre[:, :h] + c_prev * checks[0])
        f = torch.sigmoid(pre[:, h:2 * h] + c_prev * checks[1])
        gg = torch.tanh(pre[:, 2 * h:3 * h])
        cn = f * c_prev + i * gg
        o = torch.sigmoid(pre[:, 3 * h:] + cn * checks[2])
        hn = o * torch.tanh(cn)
        m = mask[:, s, None]
        h_prev = m * hn + (1.0 - m) * h_prev
        c_prev = m * cn + (1.0 - m) * c_prev
        hs.append(h_prev)
        cs.append(c_prev)
        gs.append(torch.cat([i, f, gg, o], dim=-1))
    return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(gs, 1)


def _jax_single(x):
    """``pallas_lstm._fwd_call`` (interpret mode on the CPU), time-major."""
    tm = lambda a: jnp.moveaxis(jnp.asarray(a.numpy()), 1, 0)  # noqa
    h = x["h0"].shape[1]
    checks = np.zeros((8, h), np.float32)
    checks[:3] = x["checks"].numpy()
    out = pallas_lstm._fwd_call(
        tm(x["xw"]), jnp.asarray(x["mask"].numpy().T[:, None, :]),
        jnp.asarray(x["w_hh"].numpy()), jnp.asarray(checks),
        jnp.asarray(x["h0"].numpy()), jnp.asarray(x["c0"].numpy()))
    return tuple(torch.from_numpy(np.array(jnp.moveaxis(a, 0, 1)))
                 for a in out)


def _single_inputs(h, lens_case, seed):
    t, lens, reverse = CASES[lens_case]
    return _inputs(t, lens, reverse, seed, h)


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_single_block_fwd_meets_phase_3b_tolerance(case):
    h, lens_case = SINGLE[case]
    x = _single_inputs(h, lens_case, seed=30 + sorted(SINGLE).index(case))
    port = L.lstm_fwd_reference(
        *(x[k] for k in ("xw", "mask", "w_hh", "checks", "h0", "c0")))
    three, once = _single_model(x, 3), _single_model(x, 1)
    for name, ref in (("port", port), ("pallas", _jax_single(x))):
        assert _err(three, ref) <= 0.75 * LSTM_ATOL, (name, _err(three, ref))
        assert _err(once, ref) > LSTM_ATOL, (name, _err(once, ref))


def test_single_block_fwd_computes_padded_steps_gates():
    """Kernel 8's contract writes the gates of padded steps too, from the
    kept state (``lstm_fwd_reference``), unlike kernel 10's: the model's
    gates at the padded steps of the reversed case are those of the
    reference, and nonzero."""
    x = _single_inputs(128, "T40-reversed", seed=7)
    port = L.lstm_fwd_reference(
        *(x[k] for k in ("xw", "mask", "w_hh", "checks", "h0", "c0")))
    gates = _single_model(x, 3)[2]
    pad = x["mask"] == 0
    assert pad.any() and gates[pad].abs().min() > 0
    assert (gates[pad] - port[2][pad]).abs().max() <= 0.75 * LSTM_ATOL


def test_single_block_fwd_plan_at_the_bench_shape():
    """Kernel 8 at B 128, H 512 on 132 SMs: 128 CTAs of 4 units (16 gate
    columns, the rows of one m64n16 wgmma tile), the whole K of 8 chunks
    in each, one block of 128 rows; its shared memory (w_hh's columns as
    32 KB of planes, the 128 KB ring, the sums, the carries of 128 rows)
    within one block's limit, and at B 8192 beyond it (no tier)."""
    u = L.units_per_cta(512, 132)
    assert u == 4 and -(-512 // u) == 128 <= 132
    assert -(-512 // 64) == 8 and 4 * u == 16
    fwd, _ = L.smem_bytes(128, 512, u)
    assert fwd == 1024 + 32768 + 131072 + 8704 + 2 * 128 * 4 * 4
    assert fwd <= L.SMEM_BYTES < L.smem_bytes(8192, 512, u)[0]
    assert L.fused_tier(128, 512, 132) == "fused"
    assert L.fused_tier(8192, 512, 132) is None
