"""The numbers of kernel 7's split over warps, modelled on the CPU.

Kernel 7 (``paddle_tpu_torch/csrc/paged_decode.cu``, serving's paged
decode) splits each (row, head, query)'s keys across the ``WARPS`` warps
of its block: warp w takes the spans of 32 key positions w, w + WARPS,
w + 2 WARPS, ... (one key a lane), keeps its own online-softmax state
over them (the running max, the normaliser summed by a butterfly over
the lanes, the accumulator folding a span's V rows in key order), and
the block combines the warps' states in warp order, each rescaled to the
largest max, then normalises once.  Here that order runs in fp32 with
numpy, vectorised over the batch the way a batch would hand it to the
kernel (every row walks the batch's spans; spans past a row's own keys
fold nothing), and is held against the reference's kernel
(``pallas_attention.paged_decode_attention``, interpret mode, as
``tests/test_torch_attention.py`` runs it) and the port's plain version
within phase 3's ``ATOL``.  Each row's output is the same bits alone (B
1) as inside the batch of 8 with other lengths: the spans, their warps
and the combine depend only on the row's own length.

Lengths 0, 1, 31, 32, 33, 511 and -1 (a query with no key: exact zeros),
Tq 1 and 4, head dims 32 and 36 (a ragged last float4 of lanes), page 16;
inputs from a numpy seed.
"""

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

#: warps a block and key positions a span, as csrc/paged_decode.cu has them
WARPS, SPAN = 4, 32
NEG_INF = np.float32(-1e30)
LENGTHS = (0, 1, 31, 32, 33, 511, -1, 100)
PAGE, MAX_PAGES, HEADS = 16, 32, 2


def test_model_follows_the_kernel_constants():
    src = (Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
           / "paged_decode.cu").read_text()
    assert re.search(rf"constexpr int kWarps = {WARPS};", src)
    assert re.search(rf"constexpr int kSpan = {SPAN};", src)


def _inputs(t_q, d, seed):
    """q, k/v pools, page tables and lengths (numpy) for LENGTHS."""
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    n_pages = 1 + sum(max(-(-ln // PAGE), 1) for ln in LENGTHS)
    q = rng.standard_normal((b, t_q, HEADS, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_pages, PAGE, HEADS, d)).astype(
        np.float32) for _ in range(2))
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((b, MAX_PAGES), np.int32)
    used = 0
    for i, ln in enumerate(LENGTHS):
        need = max(-(-ln // PAGE), 1)
        tables[i, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, tables, np.asarray(LENGTHS, np.int32)


def _butterfly(x):
    """warp_sum over the last axis (32 lanes): x += x[lane ^ o] for o =
    16, 8, 4, 2, 1; every lane ends with lane 0's value."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = (x + x[..., lane ^ o]).astype(np.float32)
    return x[..., 0]


def _model(q, kp, vp, tables, lengths):
    """Kernel 7's order in fp32 over a batch: [B, Tq, H, D]."""
    b, t_q, h, d = q.shape
    f32 = np.float32
    scale = f32(1.0 / np.sqrt(d))
    out = np.zeros_like(q)
    qs = (q * scale).astype(f32)
    n_keys = np.maximum(lengths[:, None] - t_q + np.arange(t_q)[None] + 1,
                        0)                                    # [B, Tq]
    n_spans = -(-int(n_keys.max()) // SPAN) if n_keys.size else 0
    lane = np.arange(SPAN)
    states = []
    for w in range(WARPS):
        m = np.full((b, t_q, h), NEG_INF, f32)
        l = np.zeros((b, t_q, h), f32)
        acc = np.zeros((b, t_q, h, d), f32)
        for sp in range(w, n_spans, WARPS):
            key = sp * SPAN + lane                           # [32]
            slot = np.minimum(key // PAGE, MAX_PAGES - 1)
            valid = (key[None, None] < n_keys[..., None]) \
                & (key[None, None] // PAGE < MAX_PAGES)      # [B, Tq, 32]
            phys = tables[:, slot]                           # [B, 32]
            rows = phys * PAGE + key[None] % PAGE
            kr = kp.reshape(-1, h, d)[rows]                  # [B, 32, H, D]
            vr = vp.reshape(-1, h, d)[rows]
            s = np.zeros((b, t_q, h, SPAN), f32)
            for i in range(d):                                # d order
                s = (s + qs[:, :, :, i, None]
                     * kr[:, None, :, :, i].transpose(0, 1, 3, 2)).astype(f32)
            s = np.where(valid[:, :, None], s, NEG_INF)
            m_new = np.maximum(m, s.max(-1))
            m_base = np.maximum(m_new, f32(0.5) * NEG_INF)
            p = np.where(valid[:, :, None],
                         np.exp(s - m_base[..., None]), f32(0)).astype(f32)
            alpha = np.exp(m - m_base).astype(f32)
            m = m_new
            l = (l * alpha + _butterfly(p)).astype(f32)
            acc = (acc * alpha[..., None]).astype(f32)
            for j in range(SPAN):                             # key order
                acc = (acc + p[..., j, None]
                       * vr[:, None, j, :, :]).astype(f32)
        states.append((np.maximum(m, f32(0.5) * NEG_INF), l, acc))
    mb = np.maximum.reduce([st[0] for st in states])
    l_tot = np.zeros_like(mb)
    a_tot = np.zeros_like(out)
    for base, l, acc in states:                               # warp order
        f = np.exp(base - mb).astype(f32)
        l_tot = (l_tot + l * f).astype(f32)
        a_tot = (a_tot + acc * f[..., None]).astype(f32)
    out = a_tot / np.where(l_tot == 0, f32(1), l_tot)[..., None]
    return out.astype(f32)


@pytest.mark.parametrize("t_q,d", [(1, 32), (4, 32), (1, 36), (4, 36)])
def test_split_meets_phase_3_tolerance_and_is_batch_invariant(t_q, d):
    x = _inputs(t_q, d, seed=7 * t_q + d)
    got = _model(*x)
    want = np.asarray(jpa.paged_decode_attention(
        *(jnp.asarray(a) for a in x)))
    plain = ta.paged_decode_reference(
        *(torch.from_numpy(a) for a in x)).numpy()
    assert np.abs(got - want).max() <= ATOL
    assert np.abs(got - plain).max() <= ATOL
    q, kp, vp, tables, lengths = x
    for i, ln in enumerate(LENGTHS):
        alone = _model(q[i:i + 1], kp, vp, tables[i:i + 1],
                       lengths[i:i + 1])
        assert np.array_equal(alone[0], got[i]), ln
        dead = min(max(t_q - ln, 0), t_q)    # queries with no key
        assert not got[i, :dead].any()
    assert got[LENGTHS.index(511)].any()


def test_the_split_differs_from_one_warp_but_not_by_much():
    """At length 511 sixteen spans meet in the combine, four a warp: the
    split's bits are its own (one warp's order gives others), within ATOL
    of them."""
    global WARPS
    x = _inputs(1, 32, seed=3)
    split = _model(*x)
    WARPS, keep = 1, WARPS
    try:
        one = _model(*x)
    finally:
        WARPS = keep
    i = LENGTHS.index(511)
    assert not np.array_equal(split[i], one[i])
    assert np.abs(split - one).max() <= ATOL
