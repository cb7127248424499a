"""The numbers of kernel 1's serving form, modelled on the CPU.

Kernel 1's serving form (``paddle_tpu_torch/csrc/flash_packed_fwd.cu``,
the packed causal fp32 prefill) splits each query's keys over ``PARTS``
warps: part p takes the keys lo + p, lo + p + PARTS, ... of the query's
window (lo: the first token of the row with the query's segment id; the
window ends at the query when causal, at the id's last token otherwise;
keys in it with another id are masked), one key at a time, in order.  In
a part the query sits on ``LANES`` lanes of ``DPL`` dims (its q
pre-scaled by ``scale * log2(e)``, its output accumulator; a lane holds
the same dims of 2 queries, which changes nothing of a query's
arithmetic): the score is each lane's DPL products in order, then a
butterfly over the lanes; the softmax is online with a reference max
that moves only when a score passes it by more than ``SLACK`` (log2
units), rescaling the normaliser and the accumulator; p = 2^(s - m) is
added to the normaliser and p * v into the accumulator (an fma a dim).
The parts meet in part order: each weighted by 2^(m_p - max m), their
normalisers and accumulators summed from part 0 on; the output is the
sum times one reciprocal of the normaliser.  Here that order
runs in fp32 with numpy, vectorised over a row's queries, and is held
against the reference's kernel (``pallas_attention._fa_forward`` on the
block-sparse path, interpret mode, as ``tests/test_torch_attention.py``
runs it) and the port's plain version within phase 3's ``ATOL``.  Each
prompt's out and lse alone (B 1, at its own bucket of 16 tokens) are the
same bits as its rows inside a pack of 8: a query's arithmetic depends
only on its own keys, never on the tile, the chunk of staged rows or the
pack.

Cases: H 8 with D 32 and 36 (a lane with half its dims past D), slots
16, 48 and 96 (the serving pack of 8 prompts), a zero-length row, a
non-causal case, and phase 3's general segments (irregular runs with
padding between, not slot-aligned); inputs from a numpy seed.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATOL
from paddle_tpu.ops import pallas_attention as jpa
from paddle_tpu_torch.ops import attention as ta

assert ATOL == 2e-5

F32 = np.float32
NEG_INF = F32(-1e30)
SLACK = F32(8.0)
LOG2E, LN2 = F32(1.4426950408889634), F32(0.6931471805599453)
HEADS = 8
#: dims a lane, queries a lane group, key parts (warps) a query, as the
#: launcher picks them at every head dim
DPL, GROUP_QUERIES, PARTS = 8, 2, 8
SOURCE = (Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
          / "flash_packed_fwd.cu")


def _lanes(d):
    return 4 if d <= 32 else 8 if d <= 64 else 16 if d <= 128 else 32


def test_model_follows_the_kernel_layout():
    src = SOURCE.read_text()
    assert re.search(r"constexpr float kSlack = 8\.f;", src)
    for name, value in (("kDpl", DPL), ("kR", GROUP_QUERIES),
                        ("kW", PARTS)):
        assert re.search(rf"constexpr int {name} = {value};", src)
    for bound, lanes in ((32, 4), (64, 8), (128, 16)):
        assert re.search(rf"if \(D <= {bound}\)\s+return \(int\)launch<"
                         rf"{lanes}>", src)
    assert re.search(r"\n  return \(int\)launch<32>", src)


def _fma(a, b, c):
    """fmaf: the exact product plus c, rounded once (in float64, then to
    float32: the same as one rounding but for rare double-rounding
    ties)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


def _windows(seg_row, causal):
    """Each query's first key and last key (causal: itself), -1 / -2
    for padding."""
    t = seg_row.size
    lo = np.full(t, -1, np.int64)
    hi = np.full(t, -2, np.int64)
    for s in np.unique(seg_row[seg_row >= 0]):
        at = np.nonzero(seg_row == s)[0]
        lo[at] = at[0]
        hi[at] = at if causal else at[-1]
    return lo, hi


def _model(q, k, v, seg, causal, parts=PARTS):
    """Kernel 1's serving order in fp32: ``(out [B, T, H, D], lse [B, H,
    T])``."""
    b_, t, h_, d = q.shape
    lanes = _lanes(d)
    width = DPL * lanes
    qs = F32(F32(1.0 / math.sqrt(d)) * LOG2E)
    pad = ((0, 0), (0, 0), (0, 0), (0, width - d))
    qr = np.pad((q * qs).astype(F32), pad)
    kp, vp = np.pad(k, pad), np.pad(v, pad)
    out = np.zeros_like(q)
    lse = np.zeros((b_, h_, t), F32)
    lane = np.arange(lanes)
    with np.errstate(over="ignore", invalid="ignore"):   # masked keys
        _rows(qr, kp, vp, seg, causal, parts, lanes, out, lse, lane)
    return out, lse


def _rows(qr, kp, vp, seg, causal, parts, lanes, out, lse, lane):
    b_, t, h_, width = qr.shape
    d = out.shape[-1]
    for b in range(b_):
        sid = seg[b]
        lo, hi = _windows(sid, causal)
        n_max = int((hi - lo + 1).max()) if t else 0
        for h in range(h_):
            qh = qr[b, :, h].reshape(t, lanes, DPL)
            m = np.full((parts, t), NEG_INF, F32)
            ls = np.zeros((parts, t), F32)
            acc = np.zeros((parts, t, width), F32)
            for i in range(-(-n_max // parts)):
                for p in range(parts):
                    j = lo + p + parts * i
                    jj = np.clip(j, 0, t - 1)
                    ok = (sid >= 0) & (j <= hi) & (sid[jj] == sid)
                    kk = kp[b, jj, h].reshape(t, lanes, DPL)
                    x = (qh[..., 0] * kk[..., 0]).astype(F32)
                    for dd in range(1, DPL):                 # d order
                        x = _fma(qh[..., dd], kk[..., dd], x)
                    for o in range(int(math.log2(lanes))):    # butterfly
                        x = (x + x[:, lane ^ (1 << o)]).astype(F32)
                    s = x[:, 0]
                    big = ok & (s > (m[p] + SLACK).astype(F32))
                    alpha = np.exp2((m[p] - s).astype(F32)).astype(F32)
                    ls[p] = np.where(big, (ls[p] * alpha).astype(F32), ls[p])
                    acc[p] = np.where(big[:, None],
                                      (acc[p] * alpha[:, None]).astype(F32),
                                      acc[p])
                    m[p] = np.where(big, s, m[p])
                    pv = np.exp2((s - m[p]).astype(F32)).astype(F32)
                    ls[p] = np.where(ok, (ls[p] + pv).astype(F32), ls[p])
                    acc[p] = np.where(ok[:, None],
                                      _fma(pv[:, None], vp[b, jj, h], acc[p]),
                                      acc[p])
            mm = m.max(axis=0)                # the parts, in part order
            ll = np.zeros(t, F32)
            aa = np.zeros((t, width), F32)
            for p in range(parts):
                f = np.exp2((m[p] - mm).astype(F32)).astype(F32)
                ll = (ll + (ls[p] * f).astype(F32)).astype(F32)
                aa = (aa + (acc[p] * f[:, None]).astype(F32)).astype(F32)
            l_safe = np.where(ll == 0, F32(1), ll)
            inv = (F32(1) / l_safe).astype(F32)      # one reciprocal
            out[b, :, h] = (aa[:, :d] * inv[:, None]).astype(F32)
            lse[b, h] = np.where(
                ll == 0, F32(0.5) * NEG_INF,
                ((mm + np.log2(l_safe).astype(F32)).astype(F32) * LN2))


def _pack(lengths, slot, d, seed):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q, k, v = (rng.standard_normal((1, b * slot, HEADS, d)).astype(F32)
               for _ in range(3))
    seg = ta.segments_from_lengths(torch.tensor(lengths, dtype=torch.int32),
                                   b, slot).numpy()
    return q, k, v, seg


def _general_segments(d, seed):
    """Phase 3's general segments: irregular runs of 1-29 tokens from
    token 3 on, 0-2 padding tokens between them, T 144."""
    rng = np.random.default_rng(seed)
    seg = np.full((1, 144), -1, np.int32)
    pos, sid = 3, 0
    while pos < 140:
        n = int(rng.integers(1, 30))
        seg[0, pos:pos + n] = sid
        pos += n + int(rng.integers(0, 3))
        sid += 1
    q, k, v = (rng.standard_normal((1, 144, HEADS, d)).astype(F32)
               for _ in range(3))
    return q, k, v, seg


#: the serving pack's prompt lengths (16-96, phase 3's mixed case) and a
#: zero-length row
MIXED = [58, 17, 96, 33, 71, 16, 90, 0]
CASES = [
    ("slot16", [11], 16, True, 32),
    ("slot48", [48, 0, 17], 48, True, 32),
    ("slot48_noncausal", [48, 0, 17], 48, False, 32),
    ("slot96_pack8", MIXED, 96, True, 32),
    ("slot48_d36", [48, 0, 17], 48, True, 36),
    ("slot96_pack8_d36", MIXED, 96, True, 36),
]


def _check_against_references(q, k, v, seg, causal, slot, got, got_lse):
    valid = seg[0] >= 0
    want, want_lse = jpa._fa_forward(
        *(jnp.asarray(x) for x in (q, k, v)), None, causal, 512, 512,
        segments=jnp.asarray(seg), slot=slot)
    assert np.abs(got - np.asarray(want)).max() <= ATOL
    assert np.abs(got_lse - np.asarray(want_lse))[:, :, valid].max() <= ATOL
    plain, plain_lse = ta._dense_forward(
        *(torch.from_numpy(x) for x in (q, k, v)), None, causal,
        torch.from_numpy(seg))
    assert np.abs(got - plain.numpy()).max() <= ATOL
    assert np.abs(got_lse - plain_lse.numpy())[:, :, valid].max() <= ATOL
    assert not got[0, ~valid].any()          # padding emits exact zeros


@pytest.mark.parametrize("name,lengths,slot,causal,d", CASES,
                         ids=[c[0] for c in CASES])
def test_model_meets_phase_3_tolerance_and_is_batch_invariant(
        name, lengths, slot, causal, d):
    q, k, v, seg = _pack(lengths, slot, d, seed=len(name) * d + slot)
    got, got_lse = _model(q, k, v, seg, causal)
    _check_against_references(q, k, v, seg, causal, slot, got, got_lse)
    # each prompt alone at its own bucket: the same bits as in the pack
    for i, n in enumerate(lengths):
        if n == 0:
            continue
        bucket = -(-n // 16) * 16
        rows = slice(i * slot, i * slot + bucket)
        alone_seg = ta.segments_from_lengths(
            torch.tensor([n], dtype=torch.int32), 1, bucket).numpy()
        out, lse = _model(q[:, rows], k[:, rows], v[:, rows], alone_seg,
                          causal)
        assert np.array_equal(out[0, :n], got[0, i * slot:i * slot + n])
        assert np.array_equal(lse[0, :, :n],
                              got_lse[0, :, i * slot:i * slot + n])


def test_model_on_general_segments():
    q, k, v, seg = _general_segments(32, seed=5)
    got, got_lse = _model(q, k, v, seg, True)
    _check_against_references(q, k, v, seg, True, 0, got, got_lse)


@pytest.mark.parametrize("causal", [True, False])
def test_key_parts_change_the_bits_within_tolerance(causal):
    """Eight key parts give other bits than one part (every key in one
    chain), within ATOL of them and of the references; alone == in the
    pack holds for both."""
    lengths, slot = [48, 0, 17], 48
    q, k, v, seg = _pack(lengths, slot, 32, seed=11)
    parts, _ = _model(q, k, v, seg, causal)
    one, one_lse = _model(q, k, v, seg, causal, parts=1)
    assert not np.array_equal(one, parts)
    assert np.abs(one - parts).max() <= ATOL
    _check_against_references(q, k, v, seg, causal, slot, one, one_lse)
    alone_seg = ta.segments_from_lengths(
        torch.tensor([17], dtype=torch.int32), 1, 32).numpy()
    rows = slice(2 * slot, 2 * slot + 32)
    out, lse = _model(q[:, rows], k[:, rows], v[:, rows], alone_seg, causal,
                      parts=1)
    assert np.array_equal(out[0, :17], one[0, 2 * slot:2 * slot + 17])
    assert np.array_equal(lse[0, :, :17], one_lse[0, :, 2 * slot:2 * slot + 17])


def test_scores_past_the_slack_rescale():
    """A score 4 above the reference max adds p = 2^4 without a rescale,
    one 20 above rescales the normaliser and the accumulator: both meet
    the plain version."""
    q = np.zeros((1, 3, 1, 32), F32)
    q[0, :, 0, 0] = 1.0
    k = np.zeros_like(q)
    d_scale = math.sqrt(32) / float(LOG2E)   # score 1 in log2 units
    k[0, :, 0, 0] = [0.0, 4.0 * d_scale, 20.0 * d_scale]
    v = np.random.default_rng(0).standard_normal(q.shape).astype(F32)
    seg = np.zeros((1, 3), np.int32)
    out, lse = _model(q, k, v, seg, True)
    plain, plain_lse = ta._dense_forward(
        *(torch.from_numpy(x) for x in (q, k, v)), None, True,
        torch.from_numpy(seg))
    assert np.abs(out - plain.numpy()).max() <= ATOL
    assert np.abs(lse - plain_lse.numpy()).max() <= ATOL
