"""The port's LSTM (``paddle_tpu_torch.ops.recurrent_ops`` /
``ops.lstm``) against the JAX package's (``paddle_tpu.ops.recurrent_ops``)
on the CPU.

Inputs come from a numpy seed and go through both.  At B % 8 == 0 and
H % 128 == 0 the JAX side runs its fused Pallas kernels (8 and 9) in
interpret mode, as ``tests/test_pallas_lstm.py`` does; at the odd shape
(B = 5, H = 96) both packages scan (the reference's dispatch rule).  The
port runs on CPU tensors, so its kernel wrappers take their plain
versions (``lstm_fwd_reference`` / ``lstm_bwd_reference``).  The loss reads y, the cells and both final
states, so every cotangent the backward takes is non-zero.

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
from paddle_tpu.ops import recurrent_ops as jro
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.ops import recurrent_ops as tro
from paddle_tpu_torch.ops import lstm as tl

OUT_ATOL = 1e-5


def _grad_tol(ref):
    return 1e-5 + 1e-4 * float(np.abs(ref).max())


def _inputs(b, t, h, lens, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    params = {"xw": f(b, t, 4 * h, sc=0.3), "w": f(h, 4 * h, sc=0.08),
              "bias": f(4 * h, sc=0.1), "ci": f(h, sc=0.1),
              "cf": f(h, sc=0.1), "co": f(h, sc=0.1),
              "h0": f(b, h, sc=0.5), "c0": f(b, h, sc=0.5)}
    cot = {"y": f(b, t, h), "cy": f(b, t, h), "h": f(b, h), "c": f(b, h)}
    return params, cot, np.asarray(lens, np.int32)


def _peep(p, peep):
    if peep == "all":
        return p["ci"], p["cf"], p["co"]
    if peep == "o_only":
        return None, None, p["co"]
    return None, None, None


def _used(peep, boot):
    names = ["xw", "w", "bias"]
    names += {"all": ["ci", "cf", "co"], "o_only": ["co"], "none": []}[peep]
    return names + (["h0", "c0"] if boot else [])


@functools.lru_cache(maxsize=None)
def _jax_run(b, t, h, lens, seed, reverse, peep, boot, gate_act):
    params, cot, ln = _inputs(b, t, h, lens, seed)
    names = _used(peep, boot)

    def f(p):
        full = dict(params, **p)
        ci, cf, co = _peep(full, peep)
        out, final, cells = jro.lstm_sequence(
            JSeq(full["xw"], jnp.asarray(ln)), None, full["w"], full["bias"],
            ci, cf, co, h0=full["h0"] if boot else None,
            c0=full["c0"] if boot else None, reverse=reverse,
            gate_act=gate_act, return_cells=True)
        loss = (jnp.sum(out.data * cot["y"]) + jnp.sum(cells.data * cot["cy"])
                + jnp.sum(final.h * cot["h"]) + jnp.sum(final.c * cot["c"]))
        return loss, (out.data, cells.data, final.h, final.c)

    (_, outs), grads = jax.value_and_grad(f, has_aux=True)(
        {n: jnp.asarray(params[n]) for n in names})
    return ([np.asarray(o) for o in outs],
            {n: np.asarray(g) for n, g in grads.items()})


def _torch_run(b, t, h, lens, seed, reverse, peep, boot, gate_act,
               use_scan=False, use_fused=False):
    params, cot, ln = _inputs(b, t, h, lens, seed)
    names = _used(peep, boot)
    p = {n: torch.from_numpy(v).requires_grad_(n in names)
         for n, v in params.items()}
    ci, cf, co = _peep(p, peep)
    h0, c0 = (p["h0"], p["c0"]) if boot else (None, None)
    if use_scan or use_fused:
        # the plain scan, or the fused kernels' plain versions called
        # directly (any shape), with the fused path's contract (no
        # reversal)
        seq = TSeq(p["xw"], torch.from_numpy(ln))
        if use_fused:
            y, cy, fh, fc = tl.lstm_fused_sequence(
                p["xw"] + p["bias"], seq.mask(), p["w"], ci, cf, co, h0, c0)
        else:
            y, cy, fh, fc = tro.lstm_scan(p["xw"] + p["bias"], seq.mask(),
                                          p["w"], ci, cf, co, h0, c0,
                                          gate_act=gate_act)
    else:
        out, final, cells = tro.lstm_sequence(
            TSeq(p["xw"], torch.from_numpy(ln)), None, p["w"], p["bias"],
            ci, cf, co, h0=h0, c0=c0, reverse=reverse, gate_act=gate_act,
            return_cells=True)
        y, cy, fh, fc = out.data, cells.data, final.h, final.c
    loss = ((y * torch.from_numpy(cot["y"])).sum()
            + (cy * torch.from_numpy(cot["cy"])).sum()
            + (fh * torch.from_numpy(cot["h"])).sum()
            + (fc * torch.from_numpy(cot["c"])).sum())
    grads = torch.autograd.grad(loss, [p[n] for n in names])
    return ([x.detach().numpy() for x in (y, cy, fh, fc)],
            {n: g.numpy() for n, g in zip(names, grads)})


# (b, t, h, lengths, reverse, peepholes, boot state h0/c0)
CASES = {
    "fwd_peep_boot": (8, 12, 128, (12, 0, 7, 12, 3, 1, 9, 12), False, "all",
                      True),
    "reverse_peep_boot": (8, 12, 128, (12, 0, 7, 12, 3, 1, 9, 12), True,
                          "all", True),
    "no_peepholes": (8, 12, 128, (12, 5, 0, 12, 11, 2, 8, 6), False, "none",
                     True),
    "o_peephole_zero_boot": (8, 12, 128, (4, 12, 12, 0, 6, 10, 1, 12),
                             False, "o_only", False),
    "odd_shape_scan_ref": (5, 7, 96, (7, 0, 3, 7, 5), True, "all", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lstm_forward_matches_jax(case):
    b, t, h, lens, reverse, peep, boot = CASES[case]
    want, _ = _jax_run(b, t, h, lens, 0, reverse, peep, boot, "sigmoid")
    got, _ = _torch_run(b, t, h, lens, 0, reverse, peep, boot, "sigmoid")
    for name, g, w in zip(("y", "cells", "final_h", "final_c"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=OUT_ATOL,
                                   err_msg=name)
    # padding emits zeros; a zero-length row keeps its boot state
    ln = np.asarray(lens)
    pad = np.arange(t)[None, :] >= ln[:, None]
    assert np.all(got[0][pad] == 0) and np.all(got[1][pad] == 0)
    if boot and (ln == 0).any():
        params, _, _ = _inputs(b, t, h, lens, 0)
        row = int(np.argmax(ln == 0))
        np.testing.assert_array_equal(got[2][row], params["h0"][row])
        np.testing.assert_array_equal(got[3][row], params["c0"][row])


@pytest.mark.parametrize("case", sorted(CASES))
def test_lstm_gradients_match_jax(case):
    b, t, h, lens, reverse, peep, boot = CASES[case]
    _, want = _jax_run(b, t, h, lens, 0, reverse, peep, boot, "sigmoid")
    _, got = _torch_run(b, t, h, lens, 0, reverse, peep, boot, "sigmoid")
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=_grad_tol(want[name]),
                                   err_msg=name)


def test_non_default_activations_take_the_scan():
    """gate_act='tanh' is off the fused kernels on both sides."""
    args = (8, 6, 128, (6, 0, 3, 6, 2, 5, 1, 4), False, "all", True, "tanh")
    want_out, want_g = _jax_run(*args[:4], 1, *args[4:])
    got_out, got_g = _torch_run(*args[:4], 1, *args[4:])
    for g, w in zip(got_out, want_out):
        np.testing.assert_allclose(g, w, rtol=0, atol=OUT_ATOL)
    for name in want_g:
        np.testing.assert_allclose(got_g[name], want_g[name], rtol=0,
                                   atol=_grad_tol(want_g[name]))


@pytest.mark.parametrize("peep", ["all", "none"])
def test_fused_plain_versions_match_autograd_through_scan(peep):
    """The kernels' plain versions (explicit forward loop and BPTT) are
    held against autograd through the per-step scan — the comparison
    chip_smoke.py makes for the CUDA kernels on the card."""
    b, t, h, lens = 6, 9, 40, (9, 0, 4, 9, 1, 7)
    # an odd shape, off the reference's fused gate: the fused entry is
    # called directly (lstm_sequence would take the scan there)
    got_out, got_g = _torch_run(b, t, h, lens, 2, False, peep, True,
                                "sigmoid", use_fused=True)
    ref_out, ref_g = _torch_run(b, t, h, lens, 2, False, peep, True,
                                "sigmoid", use_scan=True)
    for g, w in zip(got_out, ref_out):
        np.testing.assert_allclose(g, w, rtol=0, atol=OUT_ATOL)
    for name in ref_g:
        np.testing.assert_allclose(got_g[name], ref_g[name], rtol=0,
                                   atol=_grad_tol(ref_g[name]), err_msg=name)
