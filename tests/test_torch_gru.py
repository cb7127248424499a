"""The port's GRU (``paddle_tpu_torch.ops.gru`` / ``ops.recurrent_ops``)
against the JAX package's (``paddle_tpu.ops.pallas_gru`` /
``paddle_tpu.ops.recurrent_ops``) on the CPU.

Inputs come from a numpy seed and go through both.  At B % 8 == 0 and
H % 128 == 0 the JAX side runs its fused Pallas kernels (13 and 14) in
interpret mode, as ``tests/test_pallas_gru.py`` does.  The port runs on
CPU tensors, so its kernel wrappers take their plain versions
(``gru_fwd_reference`` / ``gru_bwd_reference``).

Tolerances: fp32 (different summation orders) outputs atol 1e-5,
gradients 1e-5 + 1e-4 * max|ref|.  Under ``bench.py``'s flags
(``use_bf16`` + ``bf16_activations``) both packages round the projected
input, the outputs and dxw to bf16 at the same places but sum in other
orders: outputs within 1e-2 (2 bf16 ulps at |h| < 1), gradients within
2e-2 * max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.ops import pallas_gru as jpg
from paddle_tpu.ops import recurrent_ops as jro
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.ops import gru as tg
from paddle_tpu_torch.ops import recurrent_ops as tro
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from paddle_tpu_torch.utils import PaddleTpuError

OUT_ATOL = 1e-5
BF16_OUT_ATOL, BF16_GRAD_RTOL = 1e-2, 2e-2
FLAG_NAMES = ("use_bf16", "bf16_activations", "fused_rnn_hblock")


def _grad_tol(ref, rtol=1e-4):
    return 1e-5 + rtol * float(np.abs(ref).max())


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


def _kernel_inputs(b, t, h, lens, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)
    return {"xw": f(b, t, 3 * h, sc=0.5), "mask": mask,
            "wg": f(h, 2 * h, sc=h ** -0.5), "wc": f(h, h, sc=h ** -0.5),
            "h0": f(b, h, sc=0.5), "dy": f(b, t, h)}


# (b, t, h, lengths) of the kernel-level comparisons
KERNEL_CASES = {"varied": (8, 10, 128, (10, 0, 3, 10, 7, 1, 9, 5)),
                "full": (8, 10, 128, (10,) * 8)}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_versions_match_pallas_kernels(case):
    """gru_fwd_reference / gru_bwd_reference against ``_fwd_call`` /
    ``_bwd_call`` (time-major there, batch-major here): H, the gates,
    dxw, dW_gates, dW_cand and dh0, with a nonzero h0."""
    b, t, h, lens = KERNEL_CASES[case]
    x = _kernel_inputs(b, t, h, lens, 0)
    tm = lambda a: jnp.moveaxis(jnp.asarray(a), 1, 0)  # noqa: E731
    jmask = tm(x["mask"])[:, None, :]
    j_h, j_g = jpg._fwd_call(tm(x["xw"]), jmask, x["wg"], x["wc"], x["h0"])
    t_in = {k: torch.from_numpy(v) for k, v in x.items()}
    t_h, t_g = tg.gru_fwd(t_in["xw"], t_in["mask"], t_in["wg"], t_in["wc"],
                          t_in["h0"])
    for name, got, want in (("H", t_h, j_h), ("gates", t_g, j_g)):
        np.testing.assert_allclose(got.numpy(),
                                   np.moveaxis(np.asarray(want), 0, 1),
                                   rtol=0, atol=OUT_ATOL, err_msg=name)
    h_prev = jnp.concatenate([jnp.asarray(x["h0"])[None], j_h[:-1]], 0)
    want = jpg._bwd_call(j_g, h_prev, jmask, x["wg"], x["wc"], tm(x["dy"]))
    got = tg.gru_bwd(torch.from_numpy(np.moveaxis(np.asarray(j_g), 0, 1)
                                      .copy()),
                     torch.from_numpy(np.moveaxis(np.asarray(j_h), 0, 1)
                                      .copy()),
                     t_in["h0"], t_in["mask"], t_in["wg"], t_in["wc"],
                     t_in["dy"])
    for name, g, w in zip(("dxw", "dw_gates", "dw_cand", "dh0"), got, want):
        w = np.asarray(w)
        if name == "dxw":
            w = np.moveaxis(w, 0, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=_grad_tol(w),
                                   err_msg=name)


# ------------------------------------------------------ gru_sequence
def _seq_inputs(b, t, h, lens, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa
    params = {"xw": f(b, t, 3 * h, sc=0.5), "w": f(h, 3 * h, sc=0.08),
              "bias": f(3 * h, sc=0.1), "h0": f(b, h, sc=0.5)}
    cot = {"y": f(b, t, h), "h": f(b, h)}
    return params, cot, np.asarray(lens, np.int32)


def _jax_seq(b, t, h, lens, seed, reverse, gate_act="sigmoid"):
    params, cot, ln = _seq_inputs(b, t, h, lens, seed)

    def f(p):
        out, final = jro.gru_sequence(
            JSeq(p["xw"], jnp.asarray(ln)), None, p["w"], p["bias"],
            h0=p["h0"], reverse=reverse, gate_act=gate_act)
        y, fh = out.data.astype(jnp.float32), final.astype(jnp.float32)
        return jnp.sum(y * cot["y"]) + jnp.sum(fh * cot["h"]), (y, fh)

    (_, outs), grads = jax.value_and_grad(f, has_aux=True)(
        {n: jnp.asarray(v) for n, v in params.items()})
    return ([np.asarray(o) for o in outs],
            {n: np.asarray(g, np.float32) for n, g in grads.items()})


def _torch_seq(b, t, h, lens, seed, reverse, gate_act="sigmoid"):
    params, cot, ln = _seq_inputs(b, t, h, lens, seed)
    p = {n: torch.from_numpy(v).requires_grad_(True)
         for n, v in params.items()}
    out, final = tro.gru_sequence(TSeq(p["xw"], torch.from_numpy(ln)), None,
                                  p["w"], p["bias"], h0=p["h0"],
                                  reverse=reverse, gate_act=gate_act)
    y, fh = out.data.float(), final.float()
    loss = (y * torch.from_numpy(cot["y"])).sum() \
        + (fh * torch.from_numpy(cot["h"])).sum()
    grads = torch.autograd.grad(loss, list(p.values()))
    return ([y.detach().numpy(), fh.detach().numpy()],
            {n: g.float().numpy() for n, g in zip(p, grads)})


SEQ = (8, 10, 128, (10, 0, 3, 10, 7, 1, 9, 5))


@pytest.mark.parametrize("flags", ["fp32", "bench_bf16"])
@pytest.mark.parametrize("reverse", [False, True],
                         ids=["forward", "reversed"])
def test_gru_sequence_matches_jax(reverse, flags):
    """Outputs, final state and the gradients of xw, w_hh, bias and h0,
    in fp32 and under ``use_bf16`` + ``bf16_activations``."""
    bf16 = flags == "bench_bf16"
    _set_both(use_bf16=bf16, bf16_activations=bf16)
    want_o, want_g = _jax_seq(*SEQ, 0, reverse)
    got_o, got_g = _torch_seq(*SEQ, 0, reverse)
    atol = BF16_OUT_ATOL if bf16 else OUT_ATOL
    for name, g, w in zip(("y", "final_h"), got_o, want_o):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
    assert set(got_g) == set(want_g)
    for name, w in want_g.items():
        tol = _grad_tol(w, BF16_GRAD_RTOL if bf16 else 1e-4)
        np.testing.assert_allclose(got_g[name], w, rtol=0, atol=tol,
                                   err_msg=name)
    # padding emits zeros
    pad = np.arange(SEQ[1])[None, :] >= np.asarray(SEQ[3])[:, None]
    assert np.all(got_o[0][pad] == 0)


@pytest.mark.parametrize("dims", [(6, 9, 40, (9, 0, 4, 9, 1, 7)),
                                  (8, 5, 128, (5, 5, 1, 3, 2, 5, 4, 1))],
                         ids=["odd_shape", "bench_like"])
def test_gru_core_gradients_match_autograd_through_scan(dims):
    """``_GruCore`` (forward and BPTT plain versions, the kernels' contract)
    against autograd through the per-step scan, fp32."""
    b, t, h, lens = dims
    params, cot, ln = _seq_inputs(b, t, h, lens, 3)
    res = []
    for fused in (True, False):
        p = {n: torch.from_numpy(v).requires_grad_(True)
             for n, v in params.items()}
        mask = TSeq(p["xw"], torch.from_numpy(ln)).mask()
        fn = tg.gru_fused_sequence if fused else tro.gru_scan
        y, fh = fn(p["xw"] + p["bias"], mask, p["w"][:, :2 * h],
                   p["w"][:, 2 * h:], p["h0"])
        loss = (y * torch.from_numpy(cot["y"])).sum() \
            + (fh * torch.from_numpy(cot["h"])).sum()
        grads = torch.autograd.grad(loss, list(p.values()))
        res.append(([y.detach(), fh.detach()], dict(zip(p, grads))))
    (fo, fg), (so, sg) = res
    for g, w in zip(fo, so):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=OUT_ATOL)
    for name, w in sg.items():
        np.testing.assert_allclose(fg[name].numpy(), w.numpy(), rtol=0,
                                   atol=_grad_tol(w.numpy()), err_msg=name)


@pytest.mark.parametrize("flags", ["fp32", "bench_bf16"])
def test_gru_unit_matches_jax(flags):
    """One step (``gru_unit``) and its gradients, against the JAX op."""
    bf16 = flags == "bench_bf16"
    _set_both(use_bf16=bf16, bf16_activations=bf16)
    rng = np.random.RandomState(5)
    b, h = 6, 32
    x = (rng.randn(b, 3 * h) * 0.5).astype(np.float32)
    hp = (rng.randn(b, h) * 0.5).astype(np.float32)
    w = (rng.randn(h, 3 * h) * 0.2).astype(np.float32)
    cot = rng.randn(b, h).astype(np.float32)

    def jf(x, hp, w):
        return jnp.sum(jro.gru_unit(x, hp, w).astype(jnp.float32) * cot)

    want = jax.grad(jf, argnums=(0, 1, 2))(x, hp, w)
    want_out = np.asarray(jro.gru_unit(x, hp, w), np.float32)
    tx, th, tw = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, hp, w))
    out = tro.gru_unit(tx, th, tw)
    got = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(),
                              [tx, th, tw])
    np.testing.assert_allclose(out.detach().float().numpy(), want_out,
                               rtol=0, atol=BF16_OUT_ATOL if bf16
                               else OUT_ATOL)
    for name, g, wv in zip(("x", "h_prev", "w"), got, want):
        wv = np.asarray(wv, np.float32)
        np.testing.assert_allclose(
            g.float().numpy(), wv, rtol=0,
            atol=_grad_tol(wv, BF16_GRAD_RTOL if bf16 else 1e-4),
            err_msg=name)


# ------------------------------------------------------------ dispatch
def _spy(monkeypatch, name):
    """Count the calls of ``recurrent_ops``'s ``name`` route: ``fused``
    (kernels 13-14), ``blocked`` (kernels 15-17) or ``scan``."""
    calls = []
    mod, attr = {"fused": (tg, "gru_fused_sequence"),
                 "blocked": (tg, "gru_fused_sequence_blocked"),
                 "scan": (tro, "gru_scan")}[name]
    real = getattr(mod, attr)
    monkeypatch.setattr(mod, attr, lambda *a: calls.append(1) or real(*a))
    return calls


def _run_seq(h, gate_act="sigmoid", b=2):
    rng = np.random.RandomState(1)
    xw = torch.from_numpy((rng.randn(b, 3, 3 * h) * 0.3).astype(np.float32))
    w = torch.from_numpy((rng.randn(h, 3 * h) * 0.05).astype(np.float32))
    lens = torch.tensor([3, 1] * (b // 2), dtype=torch.int32)
    out, _ = tro.gru_sequence(TSeq(xw, lens), None, w, gate_act=gate_act)
    return out.data


def test_non_default_activations_take_the_scan(monkeypatch):
    """gate_act='tanh' is off the fused kernels in both packages, and the
    two scans agree."""
    fused, scan = _spy(monkeypatch, "fused"), _spy(monkeypatch, "scan")
    _run_seq(16, gate_act="tanh")
    assert (len(fused), len(scan)) == (0, 1)
    _set_both(use_bf16=False, bf16_activations=False)
    args = (8, 6, 128, (6, 0, 3, 6, 2, 5, 1, 4), 1, False, "tanh")
    want_o, want_g = _jax_seq(*args)
    got_o, got_g = _torch_seq(*args)
    for g, w in zip(got_o, want_o):
        np.testing.assert_allclose(g, w, rtol=0, atol=OUT_ATOL)
    for name, w in want_g.items():
        np.testing.assert_allclose(got_g[name], w, rtol=0,
                                   atol=_grad_tol(w), err_msg=name)


def test_hidden_beyond_512_on_cpu_takes_the_plain_versions(monkeypatch):
    """H > 512 follows the reference's rule: H 520 (off the 128-lane
    tiling) takes the scan in both packages; H 640 at B 8 under
    --fused_rnn_hblock takes the blocked tier, whose plain versions run on
    CPU tensors and agree with the scan."""
    fused, blocked, scan = (_spy(monkeypatch, n)
                            for n in ("fused", "blocked", "scan"))
    TFLAGS.set("fused_rnn_hblock", True)
    _run_seq(520, b=8)
    assert (len(fused), len(blocked), len(scan)) == (0, 0, 1)
    got = _run_seq(640, b=8)
    assert (len(fused), len(blocked), len(scan)) == (0, 1, 1)
    TFLAGS.set("fused_rnn_hblock", False)
    want = _run_seq(640, b=8)
    assert (len(fused), len(blocked), len(scan)) == (0, 1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=OUT_ATOL)


def test_hblock_off_takes_the_scan(monkeypatch):
    fused, blocked, scan = (_spy(monkeypatch, n)
                            for n in ("fused", "blocked", "scan"))
    TFLAGS.set("fused_rnn_hblock", False)
    _run_seq(128, b=8)
    _run_seq(640, b=8)
    # 128 fused, 640 the scan
    assert (len(fused), len(blocked), len(scan)) == (1, 0, 1)


def _fwd_inputs(b, t, h):
    x = _kernel_inputs(b, t, h, (t,) * b, 0)
    return [torch.from_numpy(x[k]) for k in ("xw", "mask", "wg", "wc", "h0")]


def test_card_path_raises_for_the_blocked_tier(monkeypatch):
    """On CUDA a kernel raises on a shape its tier does not serve, rather
    than looping on the card: the single-block forward at H 520, the
    blocked forward past its widest H (lowered here to 600), through
    ``gru_sequence`` too.  Any batch reaches the single-block forward
    (kernel 13's clusters of 16 rows run in waves): B 4096 at H 8
    launches it.  The device test is monkeypatched so the CPU reaches
    that branch."""
    monkeypatch.setattr(tg, "_on_card", lambda tensors: True)
    TFLAGS.set("fused_rnn_hblock", True)
    with pytest.raises(PaddleTpuError, match="do not serve"):
        tg.gru_fwd(*_fwd_inputs(2, 2, 520))
    launched = []
    monkeypatch.setattr(tg, "_launch", lambda sym, ptrs, ints, dev:
                        launched.append((sym, len(ptrs), ints)))
    tg.gru_fwd(*_fwd_inputs(4096, 1, 8))
    assert launched == [("gru_fwd", 7, (4096, 1, 8))]
    monkeypatch.setattr(tg, "MAX_BLOCKED_HIDDEN", 600)
    with pytest.raises(PaddleTpuError, match="do not serve"):
        tg.gru_fwd_blocked(*_fwd_inputs(2, 2, 640))
    with pytest.raises(PaddleTpuError, match="do not serve"):
        _run_seq(640, b=8)
    assert len(launched) == 1


def test_card_path_launches_kernels_15_16_17_in_order(monkeypatch):
    """A training step through ``gru_sequence`` at H 1024 on the card
    launches the blocked forward, then the blocked BPTT, then the
    blocked dW, once each, the forward and the BPTT each with its two
    products' K slices (the
    launches are recorded, not run: the device test, the launcher and
    the dW's split query, here 2, are monkeypatched)."""
    launched = []
    monkeypatch.setattr(tg, "_on_card", lambda tensors: True)
    monkeypatch.setattr(tg, "_launch",
                        lambda symbol, ptrs, ints, dev:
                        launched.append((symbol, ints)))
    monkeypatch.setattr(tg._build, "kernel",
                        lambda symbol: lambda *ints: 2)
    TFLAGS.set("fused_rnn_hblock", True)
    tg.reset_launch_counts()
    h = 1024
    xw = torch.zeros(8, 2, 3 * h, requires_grad=True)
    w = torch.zeros(h, 3 * h, requires_grad=True)
    out, final = tro.gru_sequence(TSeq(xw, torch.full((8,), 2, dtype=torch.
                                                      int32)), None, w)
    (out.data.sum() + final.sum()).backward()
    assert launched == [("gru_fwd_blocked",
                         (8, 2, h) + tg.fwd_blocked_slices(8, h)),
                        ("gru_bwd_blocked",
                         (8, 2, h) + tg.bwd_blocked_slices(8, h)),
                        ("gru_dw_blocked", (8, 2, h, 2))]
    assert [fn.launches for fn in tg.KERNEL_WRAPPERS] == [0, 0, 1, 1, 1]
    tg.reset_launch_counts()


@pytest.mark.parametrize("case", ["labels", "reference_sweep"])
def test_fused_tier_from_hopper_resources(case):
    """``fused_tier``'s labels on Hopper's resources; the sweep holds them
    to the reference's rule (``recurrent_ops.dispatch_tier``) at every
    fused shape B <= 1024 in steps of 8, H in {128, 256, 384, 512}."""
    if case == "reference_sweep":
        n = 0
        for b in range(8, 1025, 8):
            for h in (128, 256, 384, 512):
                want = tro.dispatch_tier(b, h, 3)
                assert want == "fused", (b, h, want)
                assert tg.fused_tier(b, h) == want, (b, h)
                n += 1
        assert n == 128 * 4
        return
    assert tg.fused_tier(128, 512) == "fused"       # the bench row
    assert tg.fused_tier(3, 50) == "fused"          # no tiling gate
    assert tg.fused_tier(128, 513) == "fused_blocked"
    assert tg.fused_tier(3, 1024) == "fused_blocked"  # kernels 15-17
    assert tg.fused_tier(128, tg.MAX_BLOCKED_HIDDEN + 1) is None
    # kernel 13 serves any batch (its clusters of 16 rows run in waves)
    # on any number of SMs; kernel 14 strides over its tiles
    assert tg.fused_tier(4096, 8) == "fused"
    assert tg.fused_tier(128, 512, sms=127) == "fused"
    TFLAGS.set("fused_rnn_hblock", False)
    assert tg.fused_tier(128, 513) is None
    # kernel 13: 1 KB of alignment, then per 64-wide chunk of K its units'
    # gate planes (2 x 8 KB) and the cluster's buffer (2 x 4 KB), per two
    # chunks its candidate hi planes (8 KB), whatever B; kernel 14: the
    # tensor-core ring, 3 stages of four 16 KB bf16 planes and 1 KB of
    # alignment, whatever B and H
    fwd, bwd = tg.smem_bytes(128, 512)
    assert fwd == tg.smem_bytes(8192, 512)[0] == 1024 + 8 * 24576 + 4 * 8192
    assert tg.smem_bytes(3, 50)[0] == 1024 + 24576 + 8192
    assert bwd == tg.smem_bytes(1024, 8)[1] == 1024 + 3 * 4 * 16384
    assert max(tg.smem_bytes(1024, 512)) <= tg.SMEM_BYTES
