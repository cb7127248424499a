"""The port's hidden-blocked GRU tier (``paddle_tpu_torch.ops.gru``,
kernels 15-17) and its RNN dispatch rule (``ops.recurrent_ops.
dispatch_tier``) against the JAX package's (``pallas_gru``'s blocked tier,
``recurrent_ops``) on the CPU.

Inputs come from a numpy seed and go through both.  At H = 640, the
smallest width on the JAX blocked tier (as in
``tests/test_pallas_lstm_blocked.py``), the JAX side runs its blocked
Pallas kernels in interpret mode; the port runs on CPU tensors, so its
wrappers take their plain versions (``gru_fwd_blocked_reference``,
``gru_bwd_blocked_reference``, ``gru_dw_blocked_reference``).  The JAX
kernels take u|r in their block-gate layout; the test translates with
``pallas_lstm._to_gate_blocks`` / ``_from_gate_blocks``.

Tolerances: fp32 (different summation orders) 2e-5 on outputs, and
rtol 3e-4 / atol 3e-5 on gradients (``tests/test_pallas_lstm_blocked.py``'s
own).  Under ``bench.py``'s flags (``use_bf16`` + ``bf16_activations``)
the sequence-level comparisons take ``tests/test_torch_gru.py``'s: outputs
within 1e-2, gradients within 1e-5 + 2e-2 * max|ref|.  At the C1 shapes,
where both packages now run the same bf16 scan under those flags, the
outputs are held within 2e-3, half a bf16 ulp at |h| in [0.5, 1) (measured
0: the same bits; the f32 kernels that ran there before were 3.9e-3 to
1.2e-2 away), and the gradients within the bench-flag tolerance above
(measured up to 1.55e-2 * max|ref|: both backward passes round to bf16
at other places).
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.ops import pallas_gru, pallas_lstm
from paddle_tpu.ops import recurrent_ops as jro
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.ops import gru as tg
from paddle_tpu_torch.ops import recurrent_ops as tro
from paddle_tpu_torch.utils import FLAGS as TFLAGS

H = 640
OUT_ATOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 3e-4, 3e-5
BF16_OUT_ATOL, BF16_GRAD_RTOL = 1e-2, 2e-2
C1_OUT_ATOL = 2e-3
FLAG_NAMES = ("use_bf16", "bf16_activations", "fused_rnn_hblock")


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = [(f, {k: f.get(k) for k in FLAG_NAMES})
             for f in (JFLAGS, TFLAGS)]
    yield
    for f, values in saved:
        for k, v in values.items():
            f.set(k, v)


def _set_both(**kw):
    for k, v in kw.items():
        JFLAGS.set(k, v)
        TFLAGS.set(k, v)


def _close(got, want, rtol, atol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


# ------------------------------------------------ kernel-level contracts
def _kernel_inputs(b, t, lens, seed, reverse):
    """xw, mask, w_gates, w_cand, h0 and the cotangent dy; ``reverse``
    flips the mask in time, the pattern ``gru_sequence(reverse=True)``
    hands the kernels (padding first)."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)
    if reverse:
        mask = mask[:, ::-1].copy()
    return {"xw": f(b, t, 3 * H, sc=0.5), "mask": mask,
            "wg": f(H, 2 * H, sc=H ** -0.5), "wc": f(H, H, sc=H ** -0.5),
            "h0": f(b, H, sc=0.5), "dy": f(b, t, H)}


KERNEL_CASES = {"varied": (8, 5, (5, 1, 3, 5, 2, 4, 1, 5), False),
                "reversed": (8, 5, (5, 1, 3, 5, 2, 4, 1, 5), True)}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_blocked_versions_match_pallas_kernels(case):
    """The three plain versions against ``_fwd_call_blocked`` /
    ``_bwd_call_blocked`` / ``_dw_call_blocked`` (time-major and
    block-gate there, batch-major here): H and the residue (u, r, c) at
    the valid steps (the port's residue of a padded step is 0), then dxw,
    dh0, dW_gates and dW_cand from the same residue."""
    b, t, lens, reverse = KERNEL_CASES[case]
    x = _kernel_inputs(b, t, lens, 0, reverse)
    tm = lambda a: jnp.moveaxis(jnp.asarray(a), 1, 0)  # noqa: E731
    bm = lambda a: np.moveaxis(np.asarray(a), 0, 1)    # noqa: E731
    xw_t = tm(x["xw"])
    jmask = tm(x["mask"])[:, None, :]
    wg_blk = pallas_lstm._to_gate_blocks(jnp.asarray(x["wg"]), H, 2)
    j_h, j_ur, j_c = pallas_gru._fwd_call_blocked(
        pallas_lstm._to_gate_blocks(xw_t[..., :2 * H], H, 2),
        xw_t[..., 2 * H:], jmask, wg_blk, jnp.asarray(x["wc"]),
        jnp.asarray(x["h0"]))
    j_gates = np.concatenate(
        [bm(pallas_lstm._from_gate_blocks(j_ur, H, 2)), bm(j_c)], -1)
    t_in = {k: torch.from_numpy(v) for k, v in x.items()}
    t_h, t_g = tg.gru_fwd_blocked(t_in["xw"], t_in["mask"], t_in["wg"],
                                  t_in["wc"], t_in["h0"])
    valid = x["mask"] != 0
    _close(t_h.numpy(), bm(j_h), 0, OUT_ATOL, "H")
    _close(t_g.numpy()[valid], j_gates[valid], 0, OUT_ATOL, "gates")
    assert not t_g.numpy()[~valid].any()

    # the backward from the JAX residue (the port's at the valid steps)
    h_prev = jnp.concatenate([jnp.asarray(x["h0"])[None], j_h[:-1]], 0)
    j_dxur, j_dxc, j_dh0 = pallas_gru._bwd_call_blocked(
        j_ur, j_c, h_prev, jmask, wg_blk, jnp.asarray(x["wc"]),
        tm(x["dy"]))
    gates = torch.from_numpy(j_gates * valid[..., None])
    hseq = torch.from_numpy(bm(j_h).copy())
    dxw, dh0, rh = tg.gru_bwd_blocked(gates, hseq, t_in["h0"], t_in["mask"],
                                      t_in["wg"], t_in["wc"], t_in["dy"])
    want_dxw = np.concatenate(
        [bm(pallas_lstm._from_gate_blocks(j_dxur, H, 2)), bm(j_dxc)], -1)
    _close(dxw.numpy(), want_dxw, GRAD_RTOL, GRAD_ATOL, "dxw")
    _close(dh0.numpy(), j_dh0, GRAD_RTOL, GRAD_ATOL, "dh0")
    r_seq = pallas_lstm._from_gate_blocks(j_ur, H, 2)[..., H:]
    _close(rh.numpy()[valid], bm(r_seq * h_prev)[valid], 0, OUT_ATOL, "rh")

    j_dwg, j_dwc = pallas_gru._dw_call_blocked(h_prev, r_seq * h_prev,
                                               j_dxur, j_dxc)
    dwg, dwc = tg.gru_dw_blocked(hseq, t_in["h0"], rh, dxw, t_in["mask"])
    _close(dwg.numpy(), pallas_lstm._from_gate_blocks(j_dwg, H, 2),
           GRAD_RTOL, GRAD_ATOL, "dW_gates")
    _close(dwc.numpy(), j_dwc, GRAD_RTOL, GRAD_ATOL, "dW_cand")


# ----------------------------------------------------- gru_sequence
def _seq_inputs(b, t, h, lens, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    params = {"xw": f(b, t, 3 * h, sc=0.5), "w": f(h, 3 * h, sc=0.04),
              "bias": f(3 * h, sc=0.1), "h0": f(b, h, sc=0.5)}
    cot = {"y": f(b, t, h), "h": f(b, h)}
    return params, cot, np.asarray(lens, np.int32)


@functools.lru_cache(maxsize=None)
def _jax_seq(b, t, h, lens, seed, reverse, bf16):
    _set_both(use_bf16=bf16, bf16_activations=bf16)
    params, cot, ln = _seq_inputs(b, t, h, lens, seed)

    def f(p):
        out, final = jro.gru_sequence(JSeq(p["xw"], jnp.asarray(ln)), None,
                                      p["w"], p["bias"], h0=p["h0"],
                                      reverse=reverse)
        y, fh = out.data.astype(jnp.float32), final.astype(jnp.float32)
        return jnp.sum(y * cot["y"]) + jnp.sum(fh * cot["h"]), (y, fh)

    (_, outs), grads = jax.value_and_grad(f, has_aux=True)(
        {n: jnp.asarray(v) for n, v in params.items()})
    return ([np.asarray(o) for o in outs],
            {n: np.asarray(g, np.float32) for n, g in grads.items()})


def _torch_seq(b, t, h, lens, seed, reverse, bf16):
    _set_both(use_bf16=bf16, bf16_activations=bf16)
    params, cot, ln = _seq_inputs(b, t, h, lens, seed)
    p = {n: torch.from_numpy(v).requires_grad_(True)
         for n, v in params.items()}
    out, final = tro.gru_sequence(TSeq(p["xw"], torch.from_numpy(ln)), None,
                                  p["w"], p["bias"], h0=p["h0"],
                                  reverse=reverse)
    y, fh = out.data.float(), final.float()
    loss = (y * torch.from_numpy(cot["y"])).sum() \
        + (fh * torch.from_numpy(cot["h"])).sum()
    grads = torch.autograd.grad(loss, list(p.values()))
    return ([y.detach().numpy(), fh.detach().numpy()],
            {n: g.float().numpy() for n, g in zip(p, grads)})


def _spy(monkeypatch):
    """Count the calls of each of ``gru_sequence``'s three routes."""
    calls = {"fused": 0, "fused_blocked": 0, "scan": 0}
    for name, mod, attr in (("fused", tg, "gru_fused_sequence"),
                            ("fused_blocked", tg,
                             "gru_fused_sequence_blocked"),
                            ("scan", tro, "gru_scan")):
        real = getattr(mod, attr)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(mod, attr, spy)
    return calls


SEQ = (8, 5, H, (5, 1, 3, 5, 2, 4, 1, 5))


@pytest.mark.parametrize("flags", ["fp32", "bench_bf16"])
@pytest.mark.parametrize("reverse", [False, True],
                         ids=["forward", "reversed"])
def test_blocked_gru_sequence_matches_jax(reverse, flags, monkeypatch):
    """``gru_sequence`` at H = 640 with a bias and h0: both packages take
    their blocked tier; outputs, final state and the gradients of xw,
    w_hh, bias and h0, in fp32 and under ``use_bf16`` +
    ``bf16_activations``."""
    bf16 = flags == "bench_bf16"
    want_o, want_g = _jax_seq(*SEQ, 0, reverse, bf16)
    calls = _spy(monkeypatch)
    got_o, got_g = _torch_seq(*SEQ, 0, reverse, bf16)
    assert calls == {"fused": 0, "fused_blocked": 1, "scan": 0}
    atol = BF16_OUT_ATOL if bf16 else OUT_ATOL
    for name, g, w in zip(("y", "final_h"), got_o, want_o):
        _close(g, w, 0, atol, name)
    assert set(got_g) == set(want_g)
    for name, w in want_g.items():
        if bf16:
            _close(got_g[name], w, 0,
                   1e-5 + BF16_GRAD_RTOL * float(np.abs(w).max()), name)
        else:
            _close(got_g[name], w, GRAD_RTOL, GRAD_ATOL, name)
    # padding emits zeros (at the original positions, either direction)
    pad = np.arange(SEQ[1])[None, :] >= np.asarray(SEQ[3])[:, None]
    assert np.all(got_o[0][pad] == 0)


@pytest.mark.parametrize("dims", [(3, 5, (5, 0, 2)),
                                  (8, 4, (4, 4, 1, 3, 2, 4, 4, 1))],
                         ids=["b3_zero_length", "b8"])
def test_gru_core_blocked_gradients_match_autograd_through_scan(dims):
    """``_GruCoreBlocked`` (the plain versions of kernels 15-17 through
    ``gru_fused_sequence_blocked``) against autograd through the per-step
    scan, fp32."""
    b, t, lens = dims
    params, cot, ln = _seq_inputs(b, t, H, lens, 3)
    res = []
    for fn in (tg.gru_fused_sequence_blocked, tro.gru_scan):
        p = {n: torch.from_numpy(v).requires_grad_(True)
             for n, v in params.items()}
        mask = TSeq(p["xw"], torch.from_numpy(ln)).mask()
        y, fh = fn(p["xw"] + p["bias"], mask, p["w"][:, :2 * H],
                   p["w"][:, 2 * H:], p["h0"])
        loss = (y * torch.from_numpy(cot["y"])).sum() \
            + (fh * torch.from_numpy(cot["h"])).sum()
        grads = torch.autograd.grad(loss, list(p.values()))
        res.append(([y.detach(), fh.detach()], dict(zip(p, grads))))
    (fo, fg), (so, sg) = res
    for g, w in zip(fo, so):
        _close(g.numpy(), w.numpy(), 0, OUT_ATOL, "outputs")
    for name, w in sg.items():
        _close(fg[name].numpy(), w.numpy(), GRAD_RTOL, GRAD_ATOL, name)


def test_blocked_wrappers_one_by_one_match_autograd_through_scan():
    """Kernels 15-17's plain versions, called one by one as the autograd
    Function calls the kernels, against autograd through the scan (the
    comparison chip_smoke.py makes on the card)."""
    b, t, lens = 4, 5, (5, 0, 2, 1)
    params, cot, ln = _seq_inputs(b, t, H, lens, 5)
    p = {n: torch.from_numpy(v).requires_grad_(True)
         for n, v in params.items() if n != "bias"}
    m = TSeq(p["xw"], torch.from_numpy(ln)).mask()
    wg, wc = p["w"][:, :2 * H], p["w"][:, 2 * H:]
    y, fh = tro.gru_scan(p["xw"], m, wg, wc, p["h0"])
    cy, ch = torch.from_numpy(cot["y"]), torch.from_numpy(cot["h"])
    want = dict(zip(p, torch.autograd.grad((y * cy).sum() + (fh * ch).sum(),
                                           list(p.values()))))
    with torch.no_grad():
        wg, wc = wg.contiguous(), wc.contiguous()
        hseq, gates = tg.gru_fwd_blocked(p["xw"], m, wg, wc, p["h0"])
        _close((hseq * m[..., None]).numpy(), y.detach().numpy(), 0,
               OUT_ATOL, "y")
        assert not gates[m == 0].any() and gates[m != 0].all()
        dy = cy * m[..., None]          # y is masked; final h is the
        dy[:, -1] += ch                 # last step's kept state
        dxw, dh0, rh = tg.gru_bwd_blocked(gates, hseq, p["h0"], m, wg, wc,
                                          dy)
        assert not dxw[m == 0].any()    # padded steps: exact zeros
        dwg, dwc = tg.gru_dw_blocked(hseq, p["h0"], rh, dxw, m)
    got = {"xw": dxw, "w": torch.cat([dwg, dwc], 1), "h0": dh0}
    for name, g in got.items():
        _close(g.numpy(), want[name].numpy(), GRAD_RTOL, GRAD_ATOL, name)


# ---------------------------------------------- C1: the dispatch rule
GRID_B = (1, 6, 8, 16, 128, 200, 512)
GRID_H = (40, 96, 128, 384, 512, 520, 640, 1024, 1280, 2048, 4096)


@pytest.mark.parametrize("hblock", [True, False], ids=["hblock", "no_hblock"])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_dispatch_rule_equals_the_reference(kind, hblock):
    """Path and reason of every (b, h) on a grid covering b % 8 != 0,
    h % 128 != 0, h <= 512, 512 < h within the VMEM cap and past it:
    ``dispatch_tier`` equals ``pallas_lstm.fused_tier`` /
    ``pallas_gru.fused_tier``, and ``_fallback_reason`` the reference's
    ``_fallback_reason``."""
    _set_both(fused_rnn_hblock=hblock)
    ref = pallas_gru.fused_tier if kind == "gru" else pallas_lstm.fused_tier
    n_gates = 3 if kind == "gru" else 4
    paths = set()
    for b in GRID_B:
        for h in GRID_H:
            want = ref(b, h)
            assert tro.dispatch_tier(b, h, n_gates) == want, (b, h)
            if want is None:
                assert tro._fallback_reason(b, h) == \
                    jro._fallback_reason(b, h), (b, h)
            paths.add(want)
    # the grid reaches every path of the rule
    assert paths == ({"fused", "fused_blocked", None} if hblock
                     else {"fused", None})


def test_dispatch_is_counted_with_the_reference_labels(monkeypatch):
    """Each call of ``gru_sequence`` / ``lstm_sequence`` counts its
    decision in ``rnn_dispatch_total`` under the reference's (kind, path,
    reason) labels, and a default-activation shape sent to the scan logs
    one warning per shape."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    tro._log.addHandler(handler)
    monkeypatch.setattr(tro, "rnn_dispatch_total", type(
        tro.rnn_dispatch_total)())
    try:
        rng = np.random.RandomState(0)
        for _ in range(2):
            for b, h, gate_act in ((6, 128, "sigmoid"), (8, 128, "sigmoid"),
                                   (8, 40, "tanh")):
                xw = torch.from_numpy(rng.randn(b, 3, 3 * h).astype(
                    np.float32))
                w = torch.from_numpy(rng.randn(h, 3 * h).astype(
                    np.float32) * 0.05)
                tro.gru_sequence(TSeq(xw, torch.full((b,), 3, dtype=torch.
                                                     int32)), None, w,
                                 gate_act=gate_act)
    finally:
        tro._log.removeHandler(handler)
    assert dict(tro.rnn_dispatch_total) == {
        ("gru", "scan", jro._fallback_reason(6, 128)): 2,
        ("gru", "fused", ""): 2,
        ("gru", "scan", "non-default activations"): 2}
    msgs = [r.getMessage() for r in records]
    assert len(msgs) == 1 and msgs[0].startswith(
        "fused_gru_fallback: scan path taken for batch=6 hidden=128")


def _c1_inputs(kind, b, t, h, seed=0):
    rng = np.random.RandomState(seed)
    g = 3 if kind == "gru" else 4
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    lens = np.asarray([t - (i % t) for i in range(b)], np.int32)
    params = {"xw": f(b, t, g * h, sc=0.5), "w": f(h, g * h, sc=0.08),
              "bias": f(g * h, sc=0.1), "h0": f(b, h, sc=0.5)}
    cot = {"y": f(b, t, h), "h": f(b, h)}
    return params, cot, lens


def _c1_jax(kind, params, cot, lens):
    def f(p):
        seq = JSeq(p["xw"], jnp.asarray(lens))
        fn = jro.gru_sequence if kind == "gru" else jro.lstm_sequence
        out, final = fn(seq, None, p["w"], p["bias"], h0=p["h0"])
        fh = final if kind == "gru" else final.h
        y, fh = out.data.astype(jnp.float32), fh.astype(jnp.float32)
        return jnp.sum(y * cot["y"]) + jnp.sum(fh * cot["h"]), (y, fh)

    (_, outs), grads = jax.value_and_grad(f, has_aux=True)(
        {n: jnp.asarray(v) for n, v in params.items()})
    return ([np.asarray(o) for o in outs],
            {n: np.asarray(g, np.float32) for n, g in grads.items()})


def _c1_torch(kind, params, cot, lens):
    p = {n: torch.from_numpy(v).requires_grad_(True)
         for n, v in params.items()}
    seq = TSeq(p["xw"], torch.from_numpy(lens))
    fn = tro.gru_sequence if kind == "gru" else tro.lstm_sequence
    out, final = fn(seq, None, p["w"], p["bias"], h0=p["h0"])
    fh = final if kind == "gru" else final.h
    y, fh = out.data.float(), fh.float()
    loss = (y * torch.from_numpy(cot["y"])).sum() \
        + (fh * torch.from_numpy(cot["h"])).sum()
    grads = torch.autograd.grad(loss, list(p.values()))
    return ([y.detach().numpy(), fh.detach().numpy()],
            {n: g.float().numpy() for n, g in zip(p, grads)})


# the C1 table's shapes: both packages run the scan at the first two
# (b % 8, or h % 128) and the fused kernels at none of them for h = 40
C1_CASES = [(kind, dims) for kind in ("gru", "lstm")
            for dims in ((6, 10, 128), (6, 9, 40), (8, 10, 40))]


@pytest.mark.parametrize("kind,dims", C1_CASES,
                         ids=[f"{k}-{'x'.join(map(str, d))}"
                              for k, d in C1_CASES])
def test_c1_shapes_match_jax_under_bench_flags(kind, dims):
    """Fault C1: at shapes off the reference's fused gate both packages
    now run the same bf16 scan under ``use_bf16`` + ``bf16_activations``:
    outputs and final state within C1_OUT_ATOL (the port's f32 kernels,
    which ran there before, were 3.9e-3 to 1.2e-2 away), gradients within
    1e-5 + 2e-2 * max|ref|."""
    _set_both(use_bf16=True, bf16_activations=True)
    b, t, h = dims
    assert tro.dispatch_tier(b, h, 3 if kind == "gru" else 4) is None
    params, cot, lens = _c1_inputs(kind, b, t, h)
    want_o, want_g = _c1_jax(kind, params, cot, lens)
    got_o, got_g = _c1_torch(kind, params, cot, lens)
    for name, g, w in zip(("y", "final_h"), got_o, want_o):
        _close(g, w, 0, C1_OUT_ATOL, name)
    for name, w in want_g.items():
        _close(got_g[name], w, 0,
               1e-5 + BF16_GRAD_RTOL * float(np.abs(w).max()), name)


def test_bf16_sigmoid_has_the_reference_roundings():
    """The port's sigmoid of a bf16 tensor gives ``jax.nn.sigmoid``'s bits
    (1 / (1 + exp(-x)), rounded after each op) and its gradient, g * (y *
    (1 - y)) in bf16; in fp32 it is ``torch.sigmoid``."""
    from paddle_tpu_torch.ops.activations import sigmoid
    rng = np.random.RandomState(7)
    x = jnp.asarray(rng.randn(4096).astype(np.float32) * 4).astype(
        jnp.bfloat16)
    g = jnp.asarray(rng.randn(4096).astype(np.float32)).astype(jnp.bfloat16)
    want_y, vjp = jax.vjp(jax.nn.sigmoid, x)
    want_dx, = vjp(g)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
    tx.requires_grad_(True)
    y = sigmoid(tx)
    dx, = torch.autograd.grad(y, tx, torch.from_numpy(
        np.asarray(g.astype(jnp.float32))).bfloat16())
    assert y.dtype == dx.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(want_y.astype(jnp.float32)))
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(want_dx.astype(jnp.float32)))
    x32 = torch.from_numpy(rng.randn(64).astype(np.float32))
    assert torch.equal(sigmoid(x32), torch.sigmoid(x32))
