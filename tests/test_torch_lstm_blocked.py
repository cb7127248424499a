"""The port's hidden-blocked LSTM tier (``paddle_tpu_torch.ops.lstm``,
kernels 10-12) against the JAX package's (``pallas_lstm``'s blocked
tier) on the CPU.

Inputs come from a numpy seed and go through both.  At H = 640, the
smallest width on the JAX blocked tier (as in
``tests/test_pallas_lstm_blocked.py``), the JAX side runs its blocked
Pallas kernels in interpret mode; the port runs on CPU tensors, so its
wrappers take their plain versions (``lstm_fwd_blocked_reference``,
``lstm_bwd_blocked_reference``, ``lstm_dw_blocked_reference``).  The
loss reads y, the cells and both final states, so every cotangent the
backward takes is non-zero.

Tolerances (fp32, different summation orders): atol 1e-5 on outputs;
1e-5 + 1e-4 * max|ref| on gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.ops import pallas_lstm
from paddle_tpu.ops import recurrent_ops as jro
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.ops import lstm as tl
from paddle_tpu_torch.ops import recurrent_ops as tro
from paddle_tpu_torch.utils import FLAGS as TFLAGS

OUT_ATOL = 1e-5
H = 640


def _grad_tol(ref):
    return 1e-5 + 1e-4 * float(np.abs(ref).max())


@pytest.fixture
def hblock_flag():
    """Both packages' --fused_rnn_hblock, restored after the test."""
    saved = JFLAGS.get("fused_rnn_hblock"), TFLAGS.get("fused_rnn_hblock")
    yield
    JFLAGS.set("fused_rnn_hblock", saved[0])
    TFLAGS.set("fused_rnn_hblock", saved[1])


def _inputs(b, t, lens, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    params = {"xw": f(b, t, 4 * H, sc=0.3), "w": f(H, 4 * H, sc=0.04),
              "ci": f(H, sc=0.1), "cf": f(H, sc=0.1), "co": f(H, sc=0.1),
              "h0": f(b, H, sc=0.5), "c0": f(b, H, sc=0.5)}
    cot = {"y": f(b, t, H), "cy": f(b, t, H), "h": f(b, H), "c": f(b, H)}
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None])
    return params, cot, mask.astype(np.float32)


def _peep(p, peep):
    return (p["ci"], p["cf"], p["co"]) if peep else (None, None, None)


def _names(peep, boot):
    return ["xw", "w"] + (["ci", "cf", "co"] if peep else []) \
        + (["h0", "c0"] if boot else [])


@functools.lru_cache(maxsize=None)
def _jax_blocked(b, t, lens, peep, boot, seed):
    params, cot, mask = _inputs(b, t, lens, seed)
    names = _names(peep, boot)

    def f(p):
        full = dict(params, **p)
        y, cy, fh, fc = pallas_lstm.lstm_fused_sequence_blocked(
            full["xw"], jnp.asarray(mask), full["w"], *_peep(full, peep),
            full["h0"] if boot else None, full["c0"] if boot else None)
        loss = (jnp.sum(y * cot["y"]) + jnp.sum(cy * cot["cy"])
                + jnp.sum(fh * cot["h"]) + jnp.sum(fc * cot["c"]))
        return loss, (y, cy, fh, fc)

    (_, outs), grads = jax.value_and_grad(f, has_aux=True)(
        {n: jnp.asarray(params[n]) for n in names})
    return ([np.asarray(o) for o in outs],
            {n: np.asarray(g) for n, g in grads.items()})


def _torch_blocked(b, t, lens, peep, boot, seed):
    params, cot, mask = _inputs(b, t, lens, seed)
    names = _names(peep, boot)
    p = {n: torch.from_numpy(v).requires_grad_(n in names)
         for n, v in params.items()}
    outs = tl.lstm_fused_sequence_blocked(
        p["xw"], torch.from_numpy(mask), p["w"], *_peep(p, peep),
        p["h0"] if boot else None, p["c0"] if boot else None)
    loss = sum((o * torch.from_numpy(cot[k])).sum()
               for o, k in zip(outs, ("y", "cy", "h", "c")))
    grads = torch.autograd.grad(loss, [p[n] for n in names])
    return ([o.detach().numpy() for o in outs],
            {n: g.numpy() for n, g in zip(names, grads)})


# (b, t, lengths, peepholes, boot state h0/c0); lengths 1 and T included
CASES = {
    "peep_boot": (8, 6, (6, 1, 4, 6, 2, 1, 5, 3), True, True),
    "no_peep_zero_boot": (4, 5, (5, 1, 3, 5), False, False),
    "one_step": (3, 1, (1, 1, 1), True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_sequence_matches_jax(case, hblock_flag):
    """Outputs, final states and the gradients of xw, w_hh, the
    peepholes and h0/c0: the port's blocked entry (plain versions of
    kernels 10-12) against ``pallas_lstm.lstm_fused_sequence_blocked``
    (its blocked kernels, interpret mode)."""
    b, t, lens, peep, boot = CASES[case]
    want_o, want_g = _jax_blocked(b, t, lens, peep, boot, 0)
    got_o, got_g = _torch_blocked(b, t, lens, peep, boot, 0)
    for name, g, w in zip(("y", "cells", "final_h", "final_c"), got_o,
                          want_o):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=OUT_ATOL, err_msg=name)
    assert set(got_g) == set(want_g)
    for name in want_g:
        np.testing.assert_allclose(got_g[name], want_g[name], rtol=0,
                                   atol=_grad_tol(want_g[name]),
                                   err_msg=name)


def test_blocked_reverse_through_lstm_sequence_matches_jax(hblock_flag):
    """``lstm_sequence(reverse=True)`` at H = 640 with a gate bias and
    peepholes: both packages dispatch to their blocked tier (B 8: the
    reference's rule sends B % 8 != 0 to the scan)."""
    b, t, lens = 8, 5, (5, 1, 3, 0, 4, 5, 2, 1)
    params, cot, _ = _inputs(b, t, lens, 3)
    bias = np.random.RandomState(4).randn(4 * H).astype(np.float32) * 0.1
    ln = np.asarray(lens, np.int32)

    def jf(xw, w, bi):
        out, final = jro.lstm_sequence(
            JSeq(xw, jnp.asarray(ln)), None, w, bi, *_peep(params, True),
            reverse=True)
        return (jnp.sum(out.data * cot["y"]) + jnp.sum(final.h * cot["h"])
                + jnp.sum(final.c * cot["c"]))

    want_l, want_g = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(params["xw"]), jnp.asarray(params["w"]),
        jnp.asarray(bias))
    tin = [torch.from_numpy(a).requires_grad_(True)
           for a in (params["xw"], params["w"], bias)]
    ck = [torch.from_numpy(params[k]) for k in ("ci", "cf", "co")]
    calls = []
    real = tro.lstm_fused_sequence_blocked
    tro_fn = lambda *a: (calls.append(1), real(*a))[1]  # noqa: E731
    orig, tro.lstm_fused_sequence_blocked = real, tro_fn
    try:
        out, final = tro.lstm_sequence(TSeq(tin[0], torch.from_numpy(ln)),
                                       None, tin[1], tin[2], *ck,
                                       reverse=True)
    finally:
        tro.lstm_fused_sequence_blocked = orig
    assert calls, "H = 640 must take the blocked tier"
    loss = ((out.data * torch.from_numpy(cot["y"])).sum()
            + (final.h * torch.from_numpy(cot["h"])).sum()
            + (final.c * torch.from_numpy(cot["c"])).sum())
    got_g = torch.autograd.grad(loss, tin)
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-5)
    for name, g, w in zip(("xw", "w_hh", "bias"), got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=_grad_tol(w),
                                   err_msg=name)


def test_blocked_plain_versions_match_autograd_through_scan():
    """Kernels 10-12's plain versions, called one by one as the autograd
    Function calls the kernels, against autograd through the per-step
    scan (the comparison chip_smoke.py makes on the card)."""
    b, t, lens = 3, 4, (4, 0, 2)
    params, cot, mask = _inputs(b, t, lens, 5)
    p = {n: torch.from_numpy(v).requires_grad_(True)
         for n, v in params.items()}
    m = torch.from_numpy(mask)
    y, cy, fh, fc = tro.lstm_scan(p["xw"], m, p["w"], p["ci"], p["cf"],
                                  p["co"], p["h0"], p["c0"])
    cots = [torch.from_numpy(cot[k]) for k in ("y", "cy", "h", "c")]
    loss = sum((o * c).sum() for o, c in zip((y, cy, fh, fc), cots))
    want = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    with torch.no_grad():
        checks = torch.stack([p["ci"], p["cf"], p["co"]])
        args = (p["xw"], m, p["w"], checks, p["h0"], p["c0"])
        hseq, cseq, gates = tl.lstm_fwd_blocked(*args)
        np.testing.assert_allclose((hseq * m[..., None]).numpy(),
                                   y.detach().numpy(), rtol=0, atol=OUT_ATOL)
        # the kernel skips the padded steps' products: their gates are 0
        assert not gates[m == 0].any() and gates[m != 0].all()
        # cotangents on the kept sequences: y and cy are masked, the
        # final states are the last step's kept states
        dy = cots[0] * m[..., None]
        dyc = cots[1] * m[..., None]
        dy[:, -1] += cots[2]
        dyc[:, -1] += cots[3]
        dxw, dh0, dc0 = tl.lstm_bwd_blocked(gates, cseq, p["c0"], m, p["w"],
                                            checks, dy, dyc)
        dw = tl.lstm_dw_blocked(hseq, p["h0"], dxw, m)
        dck = tl.peephole_grads(dxw, cseq, p["c0"])
    got = {"xw": dxw, "w": dw, "ci": dck[0], "cf": dck[1], "co": dck[2],
           "h0": dh0, "c0": dc0}
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=_grad_tol(w),
                                   err_msg=name)


def test_fused_tier_labels(hblock_flag):
    TFLAGS.set("fused_rnn_hblock", True)
    assert tl.fused_tier(128, 512) == "fused"
    assert tl.fused_tier(8, 128) == "fused"
    for h in (640, 1280, 2048):
        assert tl.fused_tier(128, h) == "fused_blocked", h
    # no tiling gate, any batch; past the widest H: no tier
    assert tl.fused_tier(7, 700) == "fused_blocked"
    assert tl.fused_tier(128, tl.MAX_BLOCKED_HIDDEN + 1) is None
    # the JAX package gives the same labels at its tiled shapes
    for b, h in ((128, 512), (8, 128), (128, 640), (128, 1280),
                 (128, 2048)):
        assert tl.fused_tier(b, h) == pallas_lstm.fused_tier(b, h), (b, h)


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_hblock_kill_switch(on, hblock_flag):
    """--fused_rnn_hblock in both packages: on, H = 640 takes the blocked
    tier; off, the per-step scan (the single-block tier is untouched
    either way), and the outputs agree with the JAX package's."""
    JFLAGS.set("fused_rnn_hblock", on)
    TFLAGS.set("fused_rnn_hblock", on)
    assert (tl.fused_tier(128, 640) == "fused_blocked") == on
    assert tl.fused_tier(128, 512) == "fused"
    b, t, lens = 8, 4, (4, 1, 3, 4, 2, 4, 1, 3)
    params, _, _ = _inputs(b, t, lens, 6)
    ln = np.asarray(lens, np.int32)
    want, _ = jro.lstm_sequence(JSeq(jnp.asarray(params["xw"]),
                                     jnp.asarray(ln)), None,
                                jnp.asarray(params["w"]))
    calls = []
    real = tro.lstm_fused_sequence_blocked
    tro.lstm_fused_sequence_blocked = \
        lambda *a: (calls.append(1), real(*a))[1]
    try:
        got, _ = tro.lstm_sequence(TSeq(torch.from_numpy(params["xw"]),
                                        torch.from_numpy(ln)), None,
                                   torch.from_numpy(params["w"]))
    finally:
        tro.lstm_fused_sequence_blocked = real
    assert bool(calls) == on
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=0, atol=OUT_ATOL)
