"""The port's serving attention (``paddle_tpu_torch.ops.attention``:
``prefill_attention_packed``, ``paged_decode_attention``, the KV writes)
against the JAX package's (``paddle_tpu.ops.pallas_attention``) on the
CPU; the training entry points are held in test_torch_flash_train.py.

Inputs come from a numpy seed and go through both.  The JAX side runs
as its own tests run it here (Pallas kernels in interpret mode); the
port runs on CPU tensors, so its wrappers take their plain versions.
Tolerance: fp32 with different summation orders, atol = rtol = 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_attention as jpa
from paddle_tpu_torch.ops import attention as ta

TOL = dict(atol=1e-5, rtol=1e-5)


def _packed_inputs(lengths, slot, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q, k, v = (rng.standard_normal((1, b * slot, h, d)).astype(np.float32)
               for _ in range(3))
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("lengths,slot", [([5, 0, 16], 16),
                                          ([16], 16),
                                          ([3, 8, 0, 1], 8)])
def test_segments_from_lengths_match_jax(lengths, slot):
    ln = np.asarray(lengths, np.int32)
    want = np.asarray(jpa.segments_from_lengths(jnp.asarray(ln), len(ln),
                                                slot))
    got = ta.segments_from_lengths(torch.from_numpy(ln), len(ln), slot)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lengths,slot", [([5, 0, 16], 16),
                                          ([7, 2], 8)])
def test_packed_attention_matches_jax(lengths, slot, causal):
    q, k, v, ln = _packed_inputs(lengths, slot)
    seg_j = jpa.segments_from_lengths(jnp.asarray(ln), len(ln), slot)
    want = np.asarray(jpa.flash_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_j,
        causal=causal, slot=slot))
    seg_t = ta.segments_from_lengths(torch.from_numpy(ln), len(ln), slot)
    out, lse = ta.prefill_attention_packed(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        seg_t, causal=causal, slot=slot)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    # padding (segment -1, incl. the zero-length row) emits exact zeros
    pad = seg_t[0].numpy() < 0
    assert np.all(out.numpy()[0, pad] == 0.0)
    # the lse the port keeps for the backward slice equals JAX's
    _, lse_j = jpa._dense_forward(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), None, causal, seg_j)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    assert lse.shape == (1, q.shape[2], q.shape[1])


def test_packed_attention_general_segments():
    """Segments need not come from lengths: irregular runs with padding
    between them give JAX's dense masked result."""
    rng = np.random.default_rng(4)
    seg = np.array([[-1, 0, 0, 0, -1, 1, 1, 2, 2, 2, 2, -1, 3, 3, -1, -1]],
                   np.int32)
    q, k, v = (rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
               for _ in range(3))
    want, want_lse = jpa._dense_forward(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), None, True,
                                        jnp.asarray(seg))
    out, lse = ta.prefill_attention_packed(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg),
        causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def _decode_inputs(t_q, lengths, seed=1, h=2, d=8, n_pages=12, page=4,
                   max_pages=4):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q = rng.standard_normal((b, t_q, h, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_pages, page, h, d)).astype(np.float32)
              for _ in range(2))
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((b, max_pages), np.int32)
    used = 0
    for i, ln in enumerate(lengths):
        need = max(-(-ln // page), 1)
        tables[i, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("t_q,lengths", [(1, [1, 5, 16, 9]),
                                         (1, [0, 3]),
                                         (3, [3, 2, 13, 1]),
                                         (3, [0, 16, 7])])
def test_paged_decode_matches_jax(t_q, lengths):
    q, kp, vp, tables, ln = _decode_inputs(t_q, lengths)
    want = np.asarray(jpa.paged_decode_attention(
        *(jnp.asarray(x) for x in (q, kp, vp, tables, ln))))
    got = ta.paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, kp, vp, tables, ln)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # rows with length < Tq: their leading queries see no key → zeros
    for i, n in enumerate(ln):
        dead = max(t_q - int(n), 0)
        assert np.all(got.numpy()[i, :dead] == 0.0)
    ref_j = np.asarray(jpa.paged_decode_reference(
        *(jnp.asarray(x) for x in (q, kp, vp, tables, ln))))
    ref_t = ta.paged_decode_reference(
        *(torch.from_numpy(x) for x in (q, kp, vp, tables, ln)))
    np.testing.assert_allclose(ref_t.numpy(), ref_j, **TOL)


@pytest.mark.parametrize("t_n,starts,counts", [
    (5, [0, 3, 0], [5, 2, 0]),           # prefill-style, an inactive row
    (1, [7, 0, 15], [1, 0, 1]),          # decode-style, counts = 0 slot
    (4, [-2, 2, 0], [4, 4, 4]),          # negative positions: dropped
])
def test_paged_kv_write_matches_jax(t_n, starts, counts):
    rng = np.random.default_rng(3)
    n_pages, page, h, d, b = 10, 4, 2, 8, 3
    kp, vp = (rng.standard_normal((n_pages, page, h, d)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((b, t_n, h, d)).astype(np.float32)
              for _ in range(2))
    tables = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 0]], np.int32)
    st, ct = np.asarray(starts, np.int32), np.asarray(counts, np.int32)
    kj, vj = jpa.paged_kv_write(*(jnp.asarray(x) for x in
                                  (kp, vp, kn, vn, tables, st, ct)))
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    rk, rv = ta.paged_kv_write(kt, vt, *(torch.from_numpy(x) for x in
                                         (kn, vn, tables, st, ct)))
    assert rk is kt and rv is vt           # updated in place
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
