"""The numbers of kernels 16's and 14's tensor-core products, modelled on
the CPU (kernel 14, the same kernel template with dW, at the end).

Kernel 16 (``paddle_tpu_torch/csrc/gru_bwd_blocked.cu``, the blocked
GRU's BPTT, on the step loop of ``csrc/lstm_wg.cuh``) multiplies each
step's two pull-backs on bf16 tensor cores: drh = dc_pre_t @ w_candᵀ (K
= H) and the carry's dg_t @ w_gatesᵀ (K = 2H, dg = du_pre | dr_pre).
Each f32 operand is carried as hi = bf16(x) and lo = bf16(x - hi), each
product as hi·hi + hi·lo + lo·hi (three passes); each 64-wide K chunk's
sums are drained from the accumulators into f32, the chunks added in f32
within each K slice (``gru.bwd_blocked_slices``), and the (row, unit)
pairs add the slices in order: drh from 0, the carry from (1 - m) dh_tot
+ dh_new u, then drh r, at the rows valid at the step.  Here the whole
reversed recurrence runs with both products (each chunk summed in
float64, then rounded to f32), and dxw, dh0 and rh = r h_{t-1} are held
against the port's plain version (``gru_bwd_blocked_reference``) and the
reference's kernel (``pallas_gru._bwd_call_blocked``, interpret mode,
one block of all H columns, where its gate blocks are the natural order)
with phase 3f's gradient tolerance (``GRU_GRAD_ATOL`` + ``GRU_GRAD_RTOL``
of max|ref|, through ``grad_errors``): the model must stay within 0.75 of
it although the recurrence compounds the split's error over T, and a
single bf16 rounding of both operands must miss it.  The card adds the
tensor cores' own accumulation within a chunk, which phases 3f and 5
measure.

B 8, H 256, T 1, 12 and 30, lengths 0, 1 and T, inputs from a numpy seed
(the forward's residue from the port's plain blocked forward, whose
padded steps are zeros); one case with the mask reversed in time (the
padded steps first, as ``gru_sequence(reverse=True)`` hands the kernel a
flipped mask), where a row padded at t but valid at t - 1 carries (1 -
m) dh_tot into an earlier product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GRU_GRAD_ATOL, GRU_GRAD_RTOL, grad_errors
from paddle_tpu.ops import pallas_gru
from paddle_tpu_torch.ops import gru as G

assert (GRU_GRAD_ATOL, GRU_GRAD_RTOL) == (3e-5, 3e-4)

B, H = 8, 256
CASES = {"T30": (30, (30, 0, 1, 30, 17, 30, 7, 23), False),
         "T12": (12, (12, 12, 0, 9, 1, 12, 5, 3), False),
         "T1": (1, (1, 0, 1, 1, 0, 1, 1, 1), False),
         "T30-reversed": (30, (30, 0, 1, 30, 17, 30, 7, 23), True)}


def _inputs(t, lens, reverse, seed, h=H, fwd=G.gru_fwd_blocked_reference):
    """The backward's inputs as torch f32 tensors: the residue (gates, H)
    of the port's plain blocked forward (or ``fwd``) on random xw,
    w_gates, w_cand, h0, and a random cotangent dy."""
    H = h  # noqa: N806
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * sc).astype(np.float32))
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)
    if reverse:
        mask = mask[:, ::-1].copy()
    mask = torch.from_numpy(mask)
    xw, wg = f(B, t, 3 * H, sc=0.5), f(H, 2 * H, sc=H ** -0.5)
    wc, h0 = f(H, H, sc=H ** -0.5), f(B, H, sc=0.5)
    hseq, gates = fwd(xw, mask, wg, wc, h0)
    return {"gates": gates, "hseq": hseq, "h0": h0, "mask": mask,
            "w_gates": wg, "w_cand": wc, "dy": f(B, t, H)}


def _split(x):
    hi = x.to(torch.bfloat16)
    return hi.double(), (x - hi.float()).to(torch.bfloat16).double()


def _pullback(a, w, passes, n_slices):
    """a @ wᵀ ([n, K] x [units, K]ᵀ, f32 in) as the kernel sums it: per K
    slice of ceil(chunks / n_slices) chunks, per 64-wide chunk the three
    passes (or one pass of a single rounding) in float64 rounded to f32,
    chunks added in f32.  Returns the slices' sums in slice order."""
    k = a.shape[1]
    ah, al = _split(a)
    wh, wl = _split(w)
    chunks = -(-k // 64)
    per = -(-chunks // n_slices)
    parts = []
    for c0 in range(0, chunks, per):
        tot = torch.zeros(a.shape[0], w.shape[0])
        for c in range(c0, min(chunks, c0 + per)):
            ks = slice(64 * c, 64 * c + 64)
            p = ah[:, ks] @ wh[:, ks].t()
            if passes == 3:
                p = p + ah[:, ks] @ wl[:, ks].t() + al[:, ks] @ wh[:, ks].t()
            tot = tot + p.float()
        parts.append(tot)
    return parts


def _model(x, passes, plan=G.bwd_blocked_slices):
    """``gru_bwd_blocked_reference``'s loop with the kernel's products and
    sums, K slices from ``plan``.  Returns (dxw, dh0, rh)."""
    gates, hseq, h0, mask, dy = (x[k] for k in ("gates", "hseq", "h0",
                                                "mask", "dy"))
    t, H = gates.shape[1], h0.shape[1]  # noqa: N806
    s_cand, s_gates = plan(B, H)
    h_prev_seq = torch.cat([h0[:, None], hseq[:, :-1]], 1)
    dh_c = torch.zeros_like(h0)
    dxw = torch.empty_like(gates)
    for s in range(t - 1, -1, -1):
        g = gates[:, s]
        u, r, c = g[:, :H], g[:, H:2 * H], g[:, 2 * H:]
        h_prev = h_prev_seq[:, s]
        m = mask[:, s, None]
        dh_tot = dy[:, s] + dh_c
        dh_new = m * dh_tot
        du = dh_new * (h_prev - c) * u * (1.0 - u)
        dc = dh_new * (1.0 - u) * (1.0 - c * c)
        dhl = (1.0 - m) * dh_tot + dh_new * u
        valid = mask[:, s] != 0
        drh = torch.zeros_like(h0)
        if valid.any():
            acc = drh[valid]
            for part in _pullback(dc[valid], x["w_cand"], passes, s_cand):
                acc = acc + part
            drh[valid] = acc
        dr = drh * h_prev * r * (1.0 - r)
        dg = torch.cat([du, dr], dim=-1)
        dh_c = dhl.clone()
        if valid.any():
            acc = dhl[valid] + (drh * r)[valid]
            for part in _pullback(dg[valid], x["w_gates"], passes, s_gates):
                acc = acc + part
            dh_c[valid] = acc
        dxw[:, s] = torch.cat([dg, dc], dim=-1)
    return dxw, dh_c, gates[..., H:2 * H] * h_prev_seq


def _jax_bwd(x):
    """``pallas_gru._bwd_call_blocked`` (interpret mode on the CPU),
    time-major, one block of H columns: (dxw, dh0, rh)."""
    tm = lambda a: jnp.moveaxis(jnp.asarray(a.numpy()), 1, 0)  # noqa
    gates, hseq, h0 = x["gates"], x["hseq"], x["h0"]
    h_prev = torch.cat([h0[:, None], hseq[:, :-1]], 1)
    dxur, dxc, dh0 = pallas_gru._bwd_call_blocked(
        tm(gates[..., :2 * H]), tm(gates[..., 2 * H:]), tm(h_prev),
        jnp.asarray(x["mask"].numpy().T[:, None, :]),
        jnp.asarray(x["w_gates"].numpy()), jnp.asarray(x["w_cand"].numpy()),
        tm(x["dy"]), hb=H)
    back = lambda a: torch.from_numpy(  # noqa: E731
        np.array(jnp.moveaxis(a, 0, 1)))
    return (torch.cat([back(dxur), back(dxc)], -1),
            torch.from_numpy(np.array(dh0)), gates[..., H:2 * H] * h_prev)


def _ratios(x):
    """(three-pass, single-rounding) worst error / tolerance against the
    port's plain version and the reference's kernel."""
    port = G.gru_bwd_blocked_reference(
        *(x[k] for k in ("gates", "hseq", "h0", "mask", "w_gates",
                         "w_cand", "dy")))
    three = dict(enumerate(_model(x, 3)))
    once = dict(enumerate(_model(x, 1)))
    out = {}
    for name, ref in (("port", port), ("pallas", _jax_bwd(x))):
        want = dict(enumerate(ref))
        out[name] = tuple(grad_errors(got, want, GRU_GRAD_ATOL,
                                      GRU_GRAD_RTOL)[1]
                          for got in (three, once))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_split_meets_phase_3f_tolerance(case):
    t, lens, reverse = CASES[case]
    x = _inputs(t, lens, reverse, seed=40 + sorted(CASES).index(case))
    for name, (ratio, ratio_once) in _ratios(x).items():
        assert ratio <= 0.75, (name, ratio)
        assert ratio_once > 1.0, (name, ratio_once)


def test_bwd_model_passes_the_carry_through_padded_steps():
    """In the reversed case row 4 (length 17) is padded at steps 0-12: it
    enters no product there and its dxw there is exact zeros, while dy at
    a padded step still joins the carry (the reference's rule), which
    passes through as (1 - m) dh_tot: one more in dy[4, 0] is one more in
    dh0[4], and changes no dxw."""
    t, lens, _ = CASES["T30-reversed"]
    x = _inputs(t, lens, True, seed=5)
    dxw, dh0, _ = _model(x, 3)
    b = 4
    pad = x["mask"][b] == 0
    assert pad[:13].all() and not pad[13:].any()
    assert not dxw[b, :13].any() and dxw[b, 13:].abs().amax(-1).min() > 0
    y = dict(x, dy=x["dy"].clone())
    y["dy"][b, 0] += 1.0
    dxw_y, dh0_y, _ = _model(y, 3)
    assert torch.equal(dxw_y, dxw)
    assert torch.allclose(dh0_y[b] - dh0[b], torch.ones(H), atol=1e-6)


def test_bwd_slices_at_the_bench_shape():
    """Kernel 16's plans: at B 128, H 1024 on 132 SMs, drh (K = H) 8 unit
    blocks x 8 slices of 2 chunks (64 tiles) and the carry (K = 2H) 8 x
    16 slices of 2 (128 tiles); every slice non-empty, at least two
    chunks where K has them, the tiles within one CTA an SM."""
    assert G.bwd_blocked_slices(128, 1024, 132) == (8, 16)
    for b, h in ((8, 256), (128, 1024), (16, 520), (5, 514), (3, 640),
                 (128, 2048), (4096, 640)):
        blocks = -(-b // 128) * -(-h // 128)
        for s, k in zip(G.bwd_blocked_slices(b, h, 132), (h, 2 * h)):
            chunks = -(-k // 64)
            per = -(-chunks // s)
            assert 1 <= s <= chunks and (s - 1) * per < chunks
            assert per >= min(2, chunks)
            assert blocks * s <= max(132, blocks)


# -------------------------------------------------------------- kernel 14
# Kernel 14 (``csrc/gru_bwd.cu``, the single-block BPTT for H <= 512) is
# kernel 16's kernel template with dW: the same recurrence and products
# (K slices from ``bwd_slices``: one chunk each), then dW_gates =
# Σ h_prevᵀ·dg and dW_cand = Σ (r·h_prev)ᵀ·dc_pre on the dW tile over
# the valid rows phase A lists (by descending t, then ascending b): each
# chunk of 64 listed rows summed in float64 and rounded to f32 (the
# accumulator, drained), the chunks added in f32 within each of
# ``bwd_dw_splits`` splits of the list, the splits in split order.  Its inputs are kernel 13's residue (every
# step's, padded ones too).  Its model is held against the port's
# ``gru_bwd_reference`` and the reference's ``pallas_gru._bwd_call``
# (interpret mode) at B 8, H 128 and 200 with the lengths above and a
# reversed mask, within 0.1 of phase 3e's gradient tolerance (the same
# ``GRU_GRAD_ATOL`` + ``GRU_GRAD_RTOL`` of max|ref|; it reads 0.028-0.046);
# a single rounding must miss it (11.6-15.4 times).
SINGLE = {"H128-T30": (128, "T30"), "H128-T12": (128, "T12"),
          "H128-T1": (128, "T1"), "H200-T30-reversed": (200, "T30-reversed")}


def _single_inputs(case, seed):
    h, lens_case = SINGLE[case]
    t, lens, reverse = CASES[lens_case]
    return _inputs(t, lens, reverse, seed, h, G.gru_fwd_reference)


def _dw(a, g, passes, n_split):
    """Σ over the listed rows of aᵀ·g (a [n, K], g [n, C] f32) as the dW
    tile sums it, by split of the list, chunk and pass."""
    ah, al = _split(a)
    gh, gl = _split(g)
    nch = -(-a.shape[0] // 64)
    out = None
    for sp in range(n_split):
        tot = torch.zeros(a.shape[1], g.shape[1])
        for ch in range(nch * sp // n_split, nch * (sp + 1) // n_split):
            rs = slice(64 * ch, 64 * ch + 64)
            p = ah[rs].t() @ gh[rs]
            if passes == 3:
                p = p + ah[rs].t() @ gl[rs] + al[rs].t() @ gh[rs]
            tot = tot + p.float()
        out = tot if out is None else out + tot
    return out


def _single_model(x, passes):
    """Kernel 14: kernel 16's recurrence, then both dW sums over the
    listed rows.  Returns (dxw, dW_gates, dW_cand, dh0)."""
    dxw, dh0, rh = _model(x, passes, G.bwd_slices)
    h = x["h0"].shape[1]
    mask, t = x["mask"], dxw.shape[1]
    listed = [(b, s) for s in range(t - 1, -1, -1) for b in range(B)
              if mask[b, s] != 0]
    bs, ss = [b for b, _ in listed], [s for _, s in listed]
    h_prev = torch.cat([x["h0"][:, None], x["hseq"][:, :-1]], 1)
    d = dxw[bs, ss]
    n_split = G.bwd_dw_splits(h)
    return (dxw, _dw(h_prev[bs, ss], d[:, :2 * h], passes, n_split),
            _dw(rh[bs, ss], d[:, 2 * h:], passes, n_split), dh0)


def _jax_single(x):
    """``pallas_gru._bwd_call`` (interpret mode on the CPU), time-major:
    (dxw, dW_gates, dW_cand, dh0)."""
    tm = lambda a: jnp.moveaxis(jnp.asarray(a.numpy()), 1, 0)  # noqa
    h_prev = torch.cat([x["h0"][:, None], x["hseq"][:, :-1]], 1)
    dxw, dwg, dwc, dh0 = pallas_gru._bwd_call(
        tm(x["gates"]), tm(h_prev),
        jnp.asarray(x["mask"].numpy().T[:, None, :]),
        jnp.asarray(x["w_gates"].numpy()), jnp.asarray(x["w_cand"].numpy()),
        tm(x["dy"]))
    return (torch.from_numpy(np.array(jnp.moveaxis(dxw, 0, 1))),
            *(torch.from_numpy(np.array(a)) for a in (dwg, dwc, dh0)))


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_single_block_bwd_meets_phase_3e_tolerance(case):
    x = _single_inputs(case, seed=60 + sorted(SINGLE).index(case))
    port = G.gru_bwd_reference(
        *(x[k] for k in ("gates", "hseq", "h0", "mask", "w_gates",
                         "w_cand", "dy")))
    three = dict(enumerate(_single_model(x, 3)))
    once = dict(enumerate(_single_model(x, 1)))
    for name, ref in (("port", port), ("pallas", _jax_single(x))):
        want = dict(enumerate(ref))
        ratio = grad_errors(three, want, GRU_GRAD_ATOL, GRU_GRAD_RTOL)[1]
        ratio_once = grad_errors(once, want, GRU_GRAD_ATOL,
                                 GRU_GRAD_RTOL)[1]
        assert ratio <= 0.1, (name, ratio)
        assert ratio_once > 1.0, (name, ratio_once)


def test_single_block_bwd_lists_each_valid_row_once():
    """Kernel 14's dW takes each valid (b, t) row once and no padded row:
    the reversed case's listed rows are the mask's valid ones; a padded
    step's dxw is exact zeros (so its h_prev and rh would add nothing),
    and with a huge junk rh at the padded steps the model's dW_cand does
    not move."""
    case = "H200-T30-reversed"
    x = _single_inputs(case, seed=9)
    dxw, dwg, dwc, _ = _single_model(x, 3)
    pad = x["mask"] == 0
    assert pad.any() and not dxw[pad].any()
    h = x["h0"].shape[1]
    junk = dict(x, gates=x["gates"].clone())
    junk["gates"][..., h:2 * h][pad] = 1e30   # r at padded steps: rh junk
    _, dwg_j, dwc_j, _ = _single_model(junk, 3)
    assert torch.equal(dwg, dwg_j) and torch.equal(dwc, dwc_j)


def test_single_block_bwd_plan_at_the_bench_shape():
    """Kernel 14 at B 128, H 512 on 132 SMs: drh 4 unit blocks x 8 slices
    of 1 chunk (32 tiles), the carry 4 x 16 of 1 (64 tiles), the dW's 48
    output tiles ([512, 1024] and [512, 512] in 128 x 128) x 2 splits of
    the row list; every slice non-empty, the tiles within one CTA an
    SM."""
    assert G.bwd_slices(128, 512, 132) == (8, 16)
    for b, h in ((8, 128), (8, 200), (128, 512), (1024, 512), (3, 50)):
        blocks = -(-b // 128) * -(-h // 128)
        for s, k in zip(G.bwd_slices(b, h, 132), (h, 2 * h)):
            chunks = -(-k // 64)
            assert 1 <= s <= chunks and (s - 1) * -(-chunks // s) < chunks
            assert blocks * s <= max(132, blocks)
    assert G.bwd_dw_splits(512, 132) == 2
    assert G.bwd_dw_splits(128, 132) == G.MAX_DW_SPLIT
