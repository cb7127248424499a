"""The port's legacy attention grid (``--flash_block_sparse=false``:
``ops/attention.flash_fwd_legacy``, ``flash_bwd_dq_legacy``,
``flash_bwd_dkv_legacy``, kernels 2, 5 and 6) against the JAX package's
(``_fa_forward_grid`` / ``_fa_backward_pallas``) on the CPU.

Inputs come from a numpy seed and go through both.  The JAX side runs its
legacy Pallas kernels in interpret mode, as its own tests do; the port
runs on CPU tensors, so its wrappers take their plain versions.  Which
kernels a call on the card reaches is checked with the device test and
the launcher monkeypatched.

Tolerances (those of ``tests/test_torch_flash_train.py``): fp32 outputs
and lse within 2e-5, fp32 gradients within 1e-4 * max|ref|; bf16 outputs
and gradients within one bf16 ulp of the larger value plus 1e-2 *
max|ref|, lse within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention as jpa
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.ops import attention as ta
from paddle_tpu_torch.utils import FLAGS as TFLAGS

FLAG_NAMES = ("flash_kernel", "flash_block_sparse")
F32_ATOL, F32_GRAD_RTOL, BF16_RTOL = 2e-5, 1e-4, 1e-2


@pytest.fixture(autouse=True)
def _legacy_flags():
    saved = [(f, {k: f.get(k) for k in FLAG_NAMES})
             for f in (JFLAGS, TFLAGS)]
    for f in (JFLAGS, TFLAGS):
        f.set("flash_kernel", True)
        f.set("flash_block_sparse", False)
    yield
    for f, values in saved:
        for k, v in values.items():
            f.set(k, v)


def _inputs(b, tq, tk, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32) * 0.5
    k, v = (rng.randn(b, tk, h, d).astype(np.float32) * 0.5
            for _ in range(2))
    cot = rng.randn(b, tq, h, d).astype(np.float32)
    return q, k, v, cot


def _jax_run(q, k, v, cot, lengths, causal, bq, bk, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(x).astype(jd) for x in (q, k, v)]
    ln = jnp.asarray(lengths)
    fn = lambda *a: jpa.flash_attention(*a, ln, causal, bq, bk)  # noqa: E731
    _, lse = jpa._fa_forward(*args, ln, causal, bq, bk)
    out = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * cot),
                     argnums=(0, 1, 2))(*args)
    f32 = lambda x: np.asarray(x.astype(jnp.float32))       # noqa: E731
    return f32(out), np.asarray(lse), [f32(g) for g in grads]


def _port_run(q, k, v, cot, lengths, causal, bq, bk, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True)
          for x in (q, k, v)]
    ln = torch.from_numpy(lengths)
    ta.attention_dispatch_total.clear()
    out = ta.flash_attention(*ts, ln, causal, bq, bk)
    assert ta.attention_dispatch_total == {
        ("legacy_grid", "kill_switch:flash_block_sparse"): 1}
    _, lse, path, windows = ta._fa_forward(*(t.detach() for t in ts), ln,
                                           causal, bq, bk)
    assert path == "legacy" and windows is None
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == dtype
    return (out.detach().float().numpy(), lse.numpy(),
            [t.grad.float().numpy() for t in ts])


def _close(got, want, dtype, grad=False):
    if dtype == torch.bfloat16:
        top = np.maximum(np.abs(got), np.abs(want))
        ulp = np.ldexp(1.0, np.frexp(top)[1] - 8)
        tol = ulp + BF16_RTOL * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    elif grad:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=F32_GRAD_RTOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def _compare(case, dtype):
    want_out, want_lse, want_g = _jax_run(*case, dtype)
    out, lse, grads = _port_run(*case, dtype)
    _close(out, want_out, dtype)
    np.testing.assert_allclose(lse, want_lse, rtol=0,
                               atol=F32_ATOL if dtype == torch.float32
                               else 1e-4)
    for g, w in zip(grads, want_g):
        _close(g, w, dtype, grad=True)
    return out, lse, grads


# key lengths 0, 1 and < T, and one full row
LENGTHS = np.asarray([256, 1, 93, 0], np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_legacy_grid_matches_jax(causal, dtype):
    q, k, v, cot = _inputs(4, 256, 256, seed=1)
    out, lse, grads = _compare((q, k, v, cot, LENGTHS, causal, 128, 16),
                               dtype)
    # the zero-length row: zero output, lse NEG_INF / 2, zero dk/dv for
    # every key
    assert np.abs(out[3]).max() == 0.0
    assert np.all(lse[3] == np.float32(ta.NEG_INF / 2))
    assert np.abs(grads[1][3]).max() == 0.0 == np.abs(grads[2][3]).max()
    # keys at or past a row's length get no gradient
    assert np.abs(grads[1][1, 1:]).max() == 0.0
    assert np.abs(grads[2][2, 93:]).max() == 0.0


def test_legacy_cross_attention_matches_jax():
    """Tq 128 != Tk 256 (non-causal cross attention) with key lengths."""
    q, k, v, cot = _inputs(2, 128, 256, seed=2)
    _compare((q, k, v, cot, np.asarray([256, 70], np.int32), False, 128,
              16), torch.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_legacy_and_block_sparse_agree(causal):
    """The reference's ``test_block_sparse_matches_legacy_grid``: the
    kill switch is a perf knob, never a numerics knob — the port's
    legacy decision against its block-sparse one, and against JAX's
    block-sparse kernels."""
    q, k, v, cot = _inputs(2, 256, 256, seed=3)
    ln = np.asarray([256, 100], np.int32)
    legacy_out, _, legacy_g = _port_run(q, k, v, cot, ln, causal, 128, 16,
                                        torch.float32)
    for f in (JFLAGS, TFLAGS):
        f.set("flash_block_sparse", True)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ta.flash_attention(*ts, torch.from_numpy(ln), causal, 128, 16)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), legacy_out, rtol=1e-5,
                               atol=1e-6)
    for t, g in zip(ts, legacy_g):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-5)
    want_out, _, want_g = _jax_run(q, k, v, cot, ln, causal, 128, 16,
                                   torch.float32)
    _close(legacy_out, want_out, torch.float32)
    for g, w in zip(legacy_g, want_g):
        _close(g, w, torch.float32, grad=True)


def test_legacy_wrappers_alone_equal_their_plain_versions():
    """On CPU tensors each legacy wrapper is its plain version, launches
    nothing, and takes lengths None as every key valid."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 64, 64, seed=4))
    ta.reset_launch_counts()
    ln = torch.tensor([64, 64], dtype=torch.int32)
    out, lse = ta.flash_fwd_legacy(q, k, v, None, True)
    out2, lse2 = ta.flash_fwd_legacy(q, k, v, ln, True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, ref_lse = ta._dense_forward(q, k, v, ln, True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    delta = ta._delta(out, do)
    dq = ta.flash_bwd_dq_legacy(q, k, v, do, lse, delta, ln, True)
    dk, dv = ta.flash_bwd_dkv_legacy(q, k, v, do, lse, delta, ln, True)
    for got, want in zip((dq, dk, dv), ta._dense_grads(
            q, k, v, do, lse, delta, ln, True)):
        assert torch.equal(got, want)
    assert all(fn.launches == 0 for fn in ta.KERNEL_WRAPPERS)


def _spy_card(monkeypatch):
    launched = []
    monkeypatch.setattr(ta, "_on_card", lambda tensors, d: True)
    monkeypatch.setattr(ta, "_is_cuda", lambda x: True)
    monkeypatch.setattr(ta, "_launch", lambda symbol, device, *args:
                        launched.append((symbol, args)))
    ta.reset_launch_counts()
    ta.attention_dispatch_total.clear()
    return launched


def test_card_legacy_wrappers_read_strided_views(monkeypatch):
    """On the card the legacy grid passes the q/k/v views of one
    projection (token stride 3·H·D) and the key lengths, and no window
    or segment table."""
    launched = _spy_card(monkeypatch)
    qkv = torch.zeros(2, 128, 3 * 2 * 64, requires_grad=True)
    q, k, v = (x.reshape(2, 128, 2, 64) for x in qkv.split(128, dim=-1))
    ln = torch.tensor([128, 60], dtype=torch.int32)
    ta.flash_attention(q, k, v, ln, True).sum().backward()
    assert [s for s, _ in launched] == ["flash_fwd_legacy",
                                        "flash_bwd_dq_legacy",
                                        "flash_bwd_dkv_legacy"]
    fwd, dq, dkv = (args for _, args in launched)
    assert fwd[5] == ln.data_ptr() and len(fwd) == 20
    assert fwd[6:12] == (2, 128, 128, 2, 64, 1)   # B, Tq, Tk, H, D, fp32
    assert fwd[12:18] == (128 * 384, 384) * 3
    assert fwd[18] == 1 and fwd[19] == pytest.approx(1 / 8)
    assert dq[7] == ln.data_ptr() and dq[8:13] == (2, 128, 128, 2, 64)
    assert dkv[8] == ln.data_ptr() and dkv[9:14] == (2, 128, 128, 2, 64)
    assert ta.attention_dispatch_total == {
        ("legacy_grid", "kill_switch:flash_block_sparse"): 1}
    ta.reset_launch_counts()


def test_card_packed_under_legacy_flag_stays_dense(monkeypatch):
    """Packed input under ``--flash_block_sparse=false`` takes the dense
    composition, as in the reference: no kernel."""
    launched = _spy_card(monkeypatch)
    q = torch.zeros(1, 256, 2, 64, requires_grad=True)
    seg = ta.segments_from_lengths(torch.tensor([100, 128]), 2, 128)
    ta.flash_attention_packed(q, q, q, seg, True, 128, 128, 128) \
        .sum().backward()
    assert launched == []
    assert ta.attention_dispatch_total == {
        ("dense", "kill_switch:flash_block_sparse(packed)"): 1}
