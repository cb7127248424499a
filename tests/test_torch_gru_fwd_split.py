"""The numbers of kernels 15 and 13's tensor-core products, modelled on
the CPU.

Kernel 15 (``paddle_tpu_torch/csrc/gru_fwd_blocked.cu``, the blocked
GRU's forward, on the step loop of ``csrc/lstm_wg.cuh``) multiplies each
step's two products on bf16 tensor cores: the gates g = h_{t-1} @
w_gates and the candidate's (r·h_{t-1}) @ w_cand (both K = H).  Each f32
operand is carried as hi = bf16(x) and lo = bf16(x - hi), each product
as hi·hi + hi·lo + lo·hi (three passes); each 64-wide K chunk's sums are
drained from the accumulators into f32, the chunks added in f32 within
each K slice (``gru.fwd_blocked_slices``), and the (row, unit) pairs add
the slices in order, then xw_t's value, at the rows valid at the step.
Here the whole forward recurrence runs with both products (each chunk
summed in float64, then rounded to f32), and H and the residue (u, r, c)
are held against the port's plain version (``gru_fwd_blocked_reference``)
and the reference's kernel (``pallas_gru._fwd_call_blocked``, interpret
mode, one block of all H columns, where its gate blocks are the natural
order; its residue at the valid steps, since the port writes a padded
step's as 0) with phase 3f's forward tolerance (``GRU_ATOL``, absolute):
the model must stay within 0.3 of it (it reads 0.18-0.24 here, about
as much at T 1 as at T 30: the recurrence does not compound the split's
error), and a single bf16 rounding of both operands must miss it by far
(99-111 times the tolerance).  The three passes leave
the dropped lo·lo term and lo's own rounding, 2^-18 of each product
term, so the forward's error cannot reach 0.1 of an absolute 2e-5 at
these widths; the card adds the tensor cores' own accumulation within a
chunk, which phases 3f and 5 measure.

B 8, H 256, T 1, 12 and 30, lengths 0, 1 and T, inputs from a numpy seed;
one case with the mask reversed in time (the padded steps first, as
``gru_sequence(reverse=True)`` hands the kernel a flipped mask), where a
row starts valid after padded steps and its kept h0 must reach the
products.

Kernel 13 (``csrc/gru_fwd.cu``, the single-block forward for H <= 512)
runs the same three-pass products with the whole of K in one CTA of a
cluster (each chunk drained in order, one slice), for every row at every
step: a padded step's residue u, r, c is computed from the kept state,
as ``pallas_gru._fwd_kernel`` computes it.  Its model is held against
``gru_fwd_reference`` and ``pallas_gru._fwd_call`` (interpret mode) over
the whole residue, padded steps included, at B 8, H 256 and 512 with the
same lengths and the reversed mask, within 0.3 of ``GRU_ATOL``; a single
rounding must miss it by more than ten times.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GRU_ATOL
from paddle_tpu.ops import pallas_gru
from paddle_tpu_torch.ops import gru as G

assert GRU_ATOL == 2e-5

B, H = 8, 256
CASES = {"T30": (30, (30, 0, 1, 30, 17, 30, 7, 23), False),
         "T12": (12, (12, 12, 0, 9, 1, 12, 5, 3), False),
         "T1": (1, (1, 0, 1, 1, 0, 1, 1, 1), False),
         "T30-reversed": (30, (30, 0, 1, 30, 17, 30, 7, 23), True)}


def _inputs(t, lens, reverse, seed, h=H):
    """xw, mask, w_gates, w_cand, h0 as torch f32 tensors."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * sc).astype(np.float32))
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)
    if reverse:
        mask = mask[:, ::-1].copy()
    return {"xw": f(B, t, 3 * h, sc=0.5), "mask": torch.from_numpy(mask),
            "w_gates": f(h, 2 * h, sc=h ** -0.5),
            "w_cand": f(h, h, sc=h ** -0.5), "h0": f(B, h, sc=0.5)}


def _split(x):
    hi = x.to(torch.bfloat16)
    return hi.double(), (x - hi.float()).to(torch.bfloat16).double()


def _product(a, w, passes, n_slices):
    """a @ w ([n, K] x [K, cols], f32 in) as the kernel sums it: per K
    slice of ceil(chunks / n_slices) chunks, per 64-wide chunk the three
    passes (or one pass of a single rounding) in float64 rounded to f32,
    chunks added in f32; the pairs add the slices in order from 0."""
    k = a.shape[1]
    ah, al = _split(a)
    wh, wl = _split(w)
    chunks = -(-k // 64)
    per = -(-chunks // n_slices)
    out = torch.zeros(a.shape[0], w.shape[1])
    for c0 in range(0, chunks, per):
        tot = torch.zeros(a.shape[0], w.shape[1])
        for c in range(c0, min(chunks, c0 + per)):
            ks = slice(64 * c, 64 * c + 64)
            p = ah[:, ks] @ wh[ks]
            if passes == 3:
                p = p + ah[:, ks] @ wl[ks] + al[:, ks] @ wh[ks]
            tot = tot + p.float()
        out = out + tot
    return out


def _model(x, passes):
    """``gru_fwd_blocked_reference``'s loop with the kernel's products:
    at the rows valid at the step, x plus the slices' sum, then the gate
    math; padded rows keep h and get a zero residue.  Returns (H,
    gates)."""
    xw, mask = x["xw"], x["mask"]
    s_g, s_c = G.fwd_blocked_slices(B, H)
    h_prev = x["h0"]
    hs, gs = [], []
    for s in range(xw.shape[1]):
        valid = mask[:, s] != 0
        h = h_prev.clone()
        gates = torch.zeros(B, 3 * H)
        if valid.any():
            xv, hv = xw[valid, s], h_prev[valid]
            g = _product(hv, x["w_gates"], passes, s_g)
            u = torch.sigmoid(xv[:, :H] + g[:, :H])
            r = torch.sigmoid(xv[:, H:2 * H] + g[:, H:])
            c = torch.tanh(xv[:, 2 * H:]
                           + _product(r * hv, x["w_cand"], passes, s_c))
            h_new = u * hv + (1.0 - u) * c
            m = mask[valid, s, None]
            h[valid] = m * h_new + (1.0 - m) * hv
            gates[valid] = torch.cat([u, r, c], dim=-1)
        hs.append(h)
        gs.append(gates)
        h_prev = h
    return torch.stack(hs, 1), torch.stack(gs, 1)


def _jax_fwd(x):
    """``pallas_gru._fwd_call_blocked`` (interpret mode on the CPU),
    time-major, one block of H columns; its residue zeroed at the padded
    steps as the port's contract writes it."""
    tm = lambda a: jnp.moveaxis(jnp.asarray(a.numpy()), 1, 0)  # noqa
    xw = tm(x["xw"])
    j_h, j_ur, j_c = pallas_gru._fwd_call_blocked(
        xw[..., :2 * H], xw[..., 2 * H:],
        jnp.asarray(x["mask"].numpy().T[:, None, :]),
        jnp.asarray(x["w_gates"].numpy()), jnp.asarray(x["w_cand"].numpy()),
        jnp.asarray(x["h0"].numpy()), hb=H)
    back = lambda a: torch.from_numpy(  # noqa: E731
        np.array(jnp.moveaxis(a, 0, 1)))
    keep = (x["mask"] != 0).float()[..., None]
    return back(j_h), torch.cat([back(j_ur), back(j_c)], -1) * keep


def _err(got, want):
    return max((g - w).abs().max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_split_meets_phase_3f_tolerance(case):
    t, lens, reverse = CASES[case]
    x = _inputs(t, lens, reverse, seed=50 + sorted(CASES).index(case))
    port = G.gru_fwd_blocked_reference(
        *(x[k] for k in ("xw", "mask", "w_gates", "w_cand", "h0")))
    three, once = _model(x, 3), _model(x, 1)
    for name, ref in (("port", port), ("pallas", _jax_fwd(x))):
        assert _err(three, ref) <= 0.3 * GRU_ATOL, (name, _err(three, ref))
        assert _err(once, ref) > 10 * GRU_ATOL, (name, _err(once, ref))


def test_fwd_model_writes_no_residue_at_padded_steps():
    """In the reversed case row 4 (length 17) is padded at steps 0-12: it
    keeps h0 there with a zero residue, and starts at step 13 from h0
    (the model's products reach that row); junk in xw at padded steps
    changes nothing."""
    t, lens, _ = CASES["T30-reversed"]
    x = _inputs(t, lens, True, seed=5)
    y = dict(x, xw=x["xw"] + 7.0 * (x["mask"] == 0).float()[..., None])
    for a, c in zip(_model(x, 3), _model(y, 3)):
        assert torch.equal(a, c)
    hseq, gates = _model(x, 3)
    b = 4
    pad = x["mask"][b] == 0
    assert pad[:13].all() and not pad[13:].any()
    assert torch.equal(hseq[b, :13], x["h0"][b].expand(13, H))
    assert not gates[b, :13].any() and gates[b, 13:].all()
    assert (hseq[b, 13] - x["h0"][b]).abs().max() > 1e-3
    assert not gates[x["mask"] == 0].any()


def test_fwd_slices_at_the_bench_shape():
    """Kernel 15's plans: at B 128, H 1024 on 132 SMs, the gates (K = H,
    16 column blocks of 64 units' u and r) 8 slices of 2 chunks (128
    tiles) and the candidate (8 unit blocks) 8 slices of 2 (64 tiles);
    every slice non-empty, at least two chunks where K has them, the
    tiles within one CTA an SM."""
    assert G.fwd_blocked_slices(128, 1024, 132) == (8, 8)
    for b, h in ((8, 256), (128, 1024), (16, 520), (5, 514), (3, 640),
                 (128, 2048), (4096, 640)):
        chunks = -(-h // 64)
        rows = -(-b // 128)
        for s, cb in zip(G.fwd_blocked_slices(b, h, 132),
                         (-(-h // 64), -(-h // 128))):
            per = -(-chunks // s)
            assert 1 <= s <= chunks and (s - 1) * per < chunks
            assert per >= min(2, chunks)
            assert rows * cb * s <= max(132, rows * cb)


# ------------------------------------------------------------- kernel 13
K13_CASES = {f"H{h}-{name}": (h,) + case for h in (256, 512)
             for name, case in CASES.items()}


def _model13(x, passes):
    """``gru_fwd_reference``'s loop with kernel 13's products: every row
    at every step, x plus the whole K's sum (one slice, chunks drained in
    order), then the gate math and the masked keep.  Returns (H,
    gates)."""
    xw, mask, h_prev = x["xw"], x["mask"], x["h0"]
    h = h_prev.shape[1]
    hs, gs = [], []
    for s in range(xw.shape[1]):
        xs = xw[:, s]
        g = _product(h_prev, x["w_gates"], passes, 1)
        u = torch.sigmoid(xs[:, :h] + g[:, :h])
        r = torch.sigmoid(xs[:, h:2 * h] + g[:, h:])
        c = torch.tanh(xs[:, 2 * h:]
                       + _product(r * h_prev, x["w_cand"], passes, 1))
        h_new = u * h_prev + (1.0 - u) * c
        m = mask[:, s, None]
        h_prev = m * h_new + (1.0 - m) * h_prev
        hs.append(h_prev)
        gs.append(torch.cat([u, r, c], dim=-1))
    return torch.stack(hs, 1), torch.stack(gs, 1)


def _jax_fwd13(x):
    """``pallas_gru._fwd_call`` (interpret mode on the CPU), time-major:
    the residue of every step."""
    tm = lambda a: jnp.moveaxis(jnp.asarray(a.numpy()), 1, 0)  # noqa
    j_h, j_g = pallas_gru._fwd_call(
        tm(x["xw"]), jnp.asarray(x["mask"].numpy().T[:, None, :]),
        jnp.asarray(x["w_gates"].numpy()), jnp.asarray(x["w_cand"].numpy()),
        jnp.asarray(x["h0"].numpy()))
    back = lambda a: torch.from_numpy(  # noqa: E731
        np.array(jnp.moveaxis(a, 0, 1)))
    return back(j_h), back(j_g)


@pytest.mark.parametrize("case", sorted(K13_CASES))
def test_kernel13_split_meets_phase_3e_tolerance(case):
    h, t, lens, reverse = K13_CASES[case]
    x = _inputs(t, lens, reverse, seed=70 + sorted(K13_CASES).index(case),
                h=h)
    port = G.gru_fwd_reference(
        *(x[k] for k in ("xw", "mask", "w_gates", "w_cand", "h0")))
    three, once = _model13(x, 3), _model13(x, 1)
    pad = x["mask"] == 0
    for name, ref in (("port", port), ("pallas", _jax_fwd13(x))):
        assert _err(three, ref) <= 0.3 * GRU_ATOL, (name, _err(three, ref))
        assert _err(once, ref) > 10 * GRU_ATOL, (name, _err(once, ref))
        if pad.any():   # the residue of a padded step: the kept state's
            e = (three[1][pad] - ref[1][pad]).abs().max().item()
            assert e <= 0.3 * GRU_ATOL and ref[1][pad].abs().min() > 0
