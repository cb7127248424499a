"""The numbers of the flash backward's tensor-core loops (kernels 3 and 4,
and 5 and 6 on the same loops), modelled on the CPU.

The loops (``paddle_tpu_torch/csrc/flash_bwd_dq.cu``, ``flash_bwd_dkv.cu``
on ``flash_wg.cuh``) rebuild S and dP from bf16 operands (exact products
summed in f32), form P = exp(S·scale − lse) and dS = P·(dP − delta) in
f32, and feed the f32 tile P or dS to the bf16 tensor cores as hi =
bf16(x) and lo = bf16(x − hi): two products a tile, summed into f32
accumulators tile after tile in the loop's order -- dq over the key
tiles of a query row, dk and dv over the query tiles of a key tile.
Here each tile's two products are summed exactly (float64) and added to
an f32 accumulator, so the split's rounding and the f32 accumulation are
what is measured, against the f32 plain version (``_dense_grads`` on the
bf16 values) with ``chip_smoke.py``'s phase-3g bf16 tolerance (one bf16
ulp plus ``FLASH_BF16_RTOL`` of max|ref|): every output must stay within
0.75 of it.  The card adds the tensor cores' own f32 sums and
ex2.approx, which phase 3g measures.  A single bf16 rounding of P and dS
(hi only) must read more than 10x worse on the f32 accumulators: that is
why the loops take two products.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import FLASH_BF16_RTOL
from paddle_tpu_torch.ops import attention as A

assert FLASH_BF16_RTOL == 1e-3

F64 = torch.float64
TILE = 64        # the wgmma loops' inner tile (keys for dq, queries for dkv)


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _case(b, tq, tk, h, d, seed, lengths=None, packed=None):
    """bf16 q, dO [B, Tq, H, D], k, v [B, Tk, H, D] from a numpy seed (q·k
    / sqrt(D) ~ N(0, 1)), key lengths or packed segment ids."""
    rng = np.random.default_rng(seed)

    def rnd(t):
        return torch.from_numpy(rng.standard_normal((b, t, h, d))
                                .astype(np.float32)).to(torch.bfloat16)
    q, k, v, do = rnd(tq), rnd(tk), rnd(tk), rnd(tq)
    ln = seg = None
    if lengths is not None:
        ln = torch.tensor(lengths, dtype=torch.int32)
    if packed is not None:
        seg = A.segments_from_lengths(torch.tensor(packed, dtype=torch.int32),
                                      len(packed), tq // len(packed))
    return q, k, v, do, ln, seg


def _tile_sums(f, x, dim, tile):
    """Σ over tiles of ``tile`` along ``dim`` (the reduction) of the
    tile's product f_tile · x_tile, each summed exactly and added in f32
    in ascending tile order.  f [B, H, M, N] (reduction N), x [B, N, H,
    D] → [B, M, H, D] f32."""
    acc = None
    for t0 in range(0, f.shape[-1], tile):
        part = torch.einsum("bhmn,bnhd->bmhd", f[..., t0:t0 + tile].to(F64),
                            x[:, t0:t0 + tile].to(F64)).float()
        acc = part if acc is None else acc + part
    return acc


def _model(q, k, v, do, lse, delta, lengths, causal, segments, split=True,
           dkv_tile=TILE):
    """The loops' f32 accumulators × scale (dq, dk, dv) before the output
    cast: S and dP exact then f32, P and dS in f32, each fed as hi + lo
    (``split``) or hi alone."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(F64), k.to(F64)).float()
    keep = A._mask_scores(torch.zeros_like(s), causal, lengths,
                          segments) == 0
    p = torch.where(keep, torch.exp(s * scale - lse[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(F64), v.to(F64)).float()
    ds = p * (dp - delta[..., None])

    def fed(x):
        hi, lo = _split(x)
        return (hi, lo) if split else (hi,)

    def prod(f, x, tile, transpose):
        out = 0.0
        for part in fed(f.transpose(-1, -2) if transpose else f):
            out = out + _tile_sums(part, x, -1, tile)
        return out

    dq = prod(ds, k, TILE, False) * scale
    dk = prod(ds, q, dkv_tile, True) * scale
    dv = prod(p, do, dkv_tile, True)
    return dq, dk, dv


def _ratio(got, ref):
    """Worst error of bf16 ``got`` against f32 ``ref`` over phase 3g's
    bf16 tolerance (``chip_smoke.flash_error``'s formula)."""
    a, r = got.float(), ref.float()
    top = torch.maximum(a.abs(), r.abs())
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 8)
    tol = ulp + FLASH_BF16_RTOL * r.abs().max().item()
    return ((a - r).abs() / tol).max().item()


def _reference(q, k, v, do, lengths, causal, segments):
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    out, lse = A._dense_forward(qf, kf, vf, lengths, causal, segments)
    delta = A._delta(out, dof)
    grads = A._dense_grads(qf, kf, vf, dof, lse, delta, lengths, causal,
                           segments)
    return lse, delta, grads


# (label, B, Tq, Tk, H, causal, key lengths, packed rows' lengths): phase
# 3g's kinds of case at small sizes
CASES = [("padded", 2, 256, 256, 2, False, [256, 93], None),
         ("causal", 2, 200, 200, 2, True, [200, 77], None),
         ("cross", 2, 96, 300, 2, False, [300, 141], None),
         ("packed", 1, 3 * 96, 3 * 96, 2, False, None, [96, 0, 50]),
         ("packed causal", 1, 2 * 128, 2 * 128, 2, True, None, [128, 65])]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_backward_within_phase_3g_tolerance(case, d):
    """Kernels 3 and 4's outputs, modelled with the hi + lo split of P
    and dS, within 0.75 of phase 3g's bf16 tolerance of the f32 plain
    version; the hi-only model reads more than 10x worse on the f32
    accumulators."""
    label, b, tq, tk, h, causal, lengths, packed = case
    q, k, v, do, ln, seg = _case(b, tq, tk, h, d, 7 + d, lengths, packed)
    lse, delta, ref = _reference(q, k, v, do, ln, causal, seg)
    # kernel 4 at D 128 keeps the mma.sync loop: 32-query tiles
    dkv_tile = 32 if d == 128 else TILE
    acc = _model(q, k, v, do, lse, delta, ln, causal, seg,
                 dkv_tile=dkv_tile)
    ratios = [_ratio(x.to(torch.bfloat16), r) for x, r in zip(acc, ref)]
    assert max(ratios) <= 0.75, (label, d, ratios)
    hi_only = _model(q, k, v, do, lse, delta, ln, causal, seg, split=False,
                     dkv_tile=dkv_tile)
    for name, x, y, r in zip(("dq", "dk", "dv"), acc, hi_only, ref):
        top = r.abs().max().item()
        e_split = (x - r).abs().max().item() / top
        e_hi = (y - r).abs().max().item() / top
        assert e_hi > 10 * e_split, (label, d, name, e_split, e_hi)


def test_masked_rows_and_keys_are_exact_zeros():
    """The model zeroes what the masks leave nothing to, as phase 3g's
    ``masked_zeros`` demands of the kernels: dk, dv of keys at or past
    the length, dq of a row with no key, every gradient at packed
    padding."""
    q, k, v, do, ln, _ = _case(3, 100, 100, 2, 64, 3, [100, 37, 0])
    lse, delta, _ = _reference(q, k, v, do, ln, True, None)
    dq, dk, dv = _model(q, k, v, do, lse, delta, ln, True, None)
    assert (dq[2] == 0).all()
    for x in (dk, dv):
        assert (x[1, 37:] == 0).all() and (x[2] == 0).all()
    q, k, v, do, _, seg = _case(1, 3 * 64, 3 * 64, 2, 32, 4, None,
                                [64, 0, 20])
    lse, delta, _ = _reference(q, k, v, do, None, False, seg)
    pad = seg[0] < 0
    for x in _model(q, k, v, do, lse, delta, None, False, seg):
        assert (x[0, pad] == 0).all()
