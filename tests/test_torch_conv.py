"""The port's fused conv/BN ops (``paddle_tpu_torch/ops/conv.py``,
``ops/nn_ops.py``) against the JAX package's, on the CPU.

On the CPU the port's kernel wrappers take their plain versions; the
JAX side runs its Pallas kernels in interpret mode.  Inputs are made
with numpy from a seed and handed to both.

- the five dispatch gates over a grid of shapes;
- each kernel's plain version (18: ``_dx_call``, 19: ``_fwd_call``,
  20: ``_fwd_bwd_call``, 21: ``_chain_bwd_call``) in fp32 and bf16,
  ReLU and linear, and at a large C offset (the border test);
- ``_conv_bn_core``, ``_affine_conv_core`` and ``_chain_core``: forward
  values and every gradient (``jax.vjp`` against autograd);
- ``conv2d``, ``pool2d``, ``batch_norm``, ``bn_folded_affine``,
  ``affine_act_conv2d`` and ``conv2d_bn``: eval mode, off-tile channels
  (C = 48, the C = 3 stem), stride 2 and the running statistics, with
  the dispatch each records.

Tolerances.  fp32: values within 2e-5 + 1e-5 * max|ref| (the convs sum
up to 9*128 products, and the BN sums hundreds of pixels, in another
order); gradients within 1e-5 + 1e-4 * max|ref| (they pass through the
batch statistics' 1/std).  bf16 kernel outputs: both sides sum in f32 and
round once to bf16, so within 2 bf16 ulps of the reference plus
1e-5 * max|ref|; the f32 outputs (dA, dC) as fp32.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_ops as jn
from paddle_tpu.ops import pallas_conv as jc
from paddle_tpu_torch.ops import conv as tc
from paddle_tpu_torch.ops import nn_ops as tn

EPS = 1e-5
ATOL, RTOL = 2e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
BF16 = {np.float32: (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol=ATOL, rtol=RTOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=atol + rtol * float(np.abs(want).max()),
        err_msg=what)


def _close_bf16(got, want, what=""):
    """Within 2 bf16 ulps of want (+ 1e-5 * max|want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    _, exp = np.frexp(want)
    tol = 2.0 * np.ldexp(1.0, exp - 8) + 1e-5 * float(np.abs(want).max())
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, float(np.abs(got - want).max()))


# ------------------------------------------------------------------ gates
def test_gates_equal_the_jax_gates():
    dims = [1, 7, 14, 28, 56, 90]
    chans = [3, 48, 64, 128, 256, 512, 1024]
    for h, w, cin, cout in itertools.product(dims, dims, chans, chans):
        for name in ("fused_ok", "fused_fwd_ok", "fused_chain_ok"):
            assert getattr(tc, name)(h, w, cin, cout) == \
                getattr(jc, name)(h, w, cin, cout), (name, h, w, cin, cout)
    shapes = [((2, 14, 14, 64), (3, 3, 64, 64)),
              ((2, 14, 14, 48), (3, 3, 48, 64)),
              ((2, 7, 7, 512), (3, 3, 512, 512)),
              ((2, 56, 56, 64), (1, 1, 64, 256))]
    geoms = [(1, [(1, 1), (1, 1)], 1, 1, "NHWC"), (2, [(1, 1), (1, 1)], 1, 1,
                                                   "NHWC"),
             (1, "SAME", 1, 1, "NHWC"), (1, "VALID", 1, 1, "NHWC"),
             (1, 1, 1, 1, "NHWC"), (1, [(0, 0), (0, 0)], 1, 1, "NHWC"),
             (1, [(1, 1), (1, 1)], 2, 1, "NHWC"),
             (1, [(1, 1), (1, 1)], 1, 2, "NHWC"),
             (1, [(1, 1), (1, 1)], 1, 1, "NCHW")]
    for (xs, ws), geom in itertools.product(shapes, geoms):
        for name in ("fusable", "fusable_fwd"):
            assert getattr(tc, name)(xs, ws, *geom) == \
                getattr(jc, name)(xs, ws, *geom), (name, xs, ws, geom)


# ------------------------------------------------------- kernel plain versions
def _kernel_inputs(seed, n, h, w, cin, cout, c_off=0.0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    return {"z": f(n, h, w, cin), "dy": f(n, h, w, cout),
            "z2": f(n, h, w, cout),
            "w": f(3, 3, cin, cout) * (9 * cin) ** -0.5,
            "aff": np.stack([f(cin) * 0.5 + 1.0, f(cin) * 0.5 + c_off]),
            "co": np.stack([f(cout) * 0.5 + 1.0, f(cout) * 0.1,
                            f(cout) * 0.5 + c_off])}


def _pack(rows, n):
    return jnp.zeros((8, n), jnp.float32).at[:rows.shape[0]].set(rows)


KERNEL_CASES = [((2, 6, 5, 64, 64), 0.0, True),
                ((2, 6, 5, 64, 64), 0.0, False),
                ((1, 4, 7, 64, 128), 3.0, True),     # border: relu(C) > 0
                ((1, 5, 4, 128, 64), -2.0, False)]


@pytest.fixture(scope="module")
def kernel_refs():
    """The JAX kernels' outputs for every case and dtype, computed once."""
    out = {}
    for i, (shape, c_off, relu) in enumerate(KERNEL_CASES):
        inp = _kernel_inputs(i, *shape, c_off=c_off)
        for dt in (np.float32, "bf16"):
            jdt = BF16[dt][0]
            z, dy, z2, w = (jnp.asarray(inp[k]).astype(jdt)
                            for k in ("z", "dy", "z2", "w"))
            cin, cout = shape[3], shape[4]
            ci, co = _pack(inp["aff"], cin), _pack(inp["co"], cout)
            out[i, dt] = {
                "fwd": jc._fwd_call(z, ci, w, jdt, relu),
                "fwd_bwd": jc._fwd_bwd_call(dy, z, ci, w, relu),
                "dx": jc._dx_call(dy, z2, co, w, jdt, jdt),
                "chain": jc._chain_bwd_call(dy, z2, co, z, ci, w, relu)}
    return out


@pytest.mark.parametrize("case", range(len(KERNEL_CASES)))
@pytest.mark.parametrize("dt", [np.float32, "bf16"], ids=["fp32", "bf16"])
def test_kernel_plain_versions_match_the_jax_kernels(kernel_refs, case, dt):
    shape, c_off, relu = KERNEL_CASES[case]
    inp = _kernel_inputs(case, *shape, c_off=c_off)
    tdt = BF16[dt][1]
    z, dy, z2, w = (torch.from_numpy(inp[k]).to(tdt)
                    for k in ("z", "dy", "z2", "w"))
    aff, co = torch.from_numpy(inp["aff"]), torch.from_numpy(inp["co"])
    ref = kernel_refs[case, dt]
    close = _close if dt is np.float32 else _close_bf16
    got = {"fwd": (tc.conv3x3_fwd(z, aff, w, relu),),
           "fwd_bwd": tc.conv3x3_fwd_bwd(dy, z, aff, w, relu),
           "dx": tc.conv3x3_dx(dy, z2, co, w),
           "chain": tc.conv3x3_chain_bwd(dy, z2, co, z, aff, w, relu)}
    for name, outs in got.items():
        want = ref[name]
        want = (want,) if not isinstance(want, (tuple, list)) else want
        for j, (g, r) in enumerate(zip(outs, want)):
            if g.dim() == 2:         # dac [2, C] (f32) vs the [8, C] block
                _close(g, np.asarray(r)[:2], what=f"{name}[{j}]")
            else:
                assert g.dtype == tdt, (name, j, g.dtype)
                close(g, r, what=f"{name}[{j}]")
    assert all(fn.launches == 0 for fn in tc.KERNEL_WRAPPERS)


# ---------------------------------------------------------- custom VJPs
def _core_inputs(seed, n=2, h=5, w=6, cin=64, cout=64):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    return {"z": f(n, h, w, cin), "x": f(n, h, w, cin) * 0.5,
            "w": f(3, 3, cin, cout) * 0.1, "cb": f(cout) * 0.1,
            "scale": rng.rand(cout).astype(np.float32) + 0.5,
            "bias": f(cout) * 0.2, "a": f(cin) * 0.5 + 1.0,
            "c": f(cin) * 0.3, "cot": f(n, h, w, cout)}


def _grads_close(tg, jg, names):
    for name, t, j in zip(names, tg, jg):
        _close(t, j, GRAD_ATOL, GRAD_RTOL, what=name)


@pytest.mark.parametrize("relu", [True, False])
def test_affine_conv_core_matches_jax(relu):
    d = _core_inputs(1)
    jargs = [jnp.asarray(d[k]) for k in ("z", "a", "c", "w")]
    jy, vjp = jax.vjp(lambda z, a, c, w: jc._affine_conv_core(
        z, a, c, w, relu), *jargs)
    jg = vjp(jnp.asarray(d["cot"]))
    targs = [torch.from_numpy(d[k]).requires_grad_(True)
             for k in ("z", "a", "c", "w")]
    ty = tc._AffineConvCore.apply(*targs, relu)
    tg = torch.autograd.grad((ty * torch.from_numpy(d["cot"])).sum(), targs)
    _close(ty, jy, what="y")
    _grads_close(tg, jg, ("dz", "da", "dc", "dw"))


def test_conv_bn_core_matches_jax():
    d = _core_inputs(2)
    names = ("x", "w", "cb", "scale", "bias")
    jy, vjp = jax.vjp(lambda *a: jc._conv_bn_core(*a, EPS),
                      *[jnp.asarray(d[k]) for k in names])
    jg = vjp(jnp.asarray(d["cot"]))
    targs = [torch.from_numpy(d[k]).requires_grad_(True) for k in names]
    ty, m, v = tc._ConvBnCore.apply(*targs, EPS)
    tg = torch.autograd.grad((ty * torch.from_numpy(d["cot"])).sum(), targs)
    _close(ty, jy, what="y")
    _grads_close(tg, jg, names)
    # the statistics the port returns are the ones JAX recomputes
    jz = jc._conv3x3(jnp.asarray(d["x"]), jnp.asarray(d["w"])) \
        + jnp.asarray(d["cb"])
    jm, jv = jn._bn_stats(jz, (0, 1, 2))
    _close(m, jm, what="m")
    _close(v, jv, what="v")


@pytest.mark.parametrize("relu", [True, False])
def test_chain_core_matches_jax(relu):
    d = _core_inputs(3)
    names = ("z", "a", "c", "w", "cb", "scale", "bias")
    (jy, jm, jv), vjp = jax.vjp(
        lambda z, a, c, w, cb, s, b: jc._chain_core(z, a, c, w, cb, s, b,
                                                    EPS, relu),
        *[jnp.asarray(d[k]) for k in names])
    jg = vjp((jnp.asarray(d["cot"]), jnp.zeros_like(jm), jnp.zeros_like(jv)))
    targs = [torch.from_numpy(d[k]).requires_grad_(True) for k in names]
    ty, tm, tv = tc._ChainCore.apply(*targs[:7], EPS, relu)
    tg = torch.autograd.grad((ty * torch.from_numpy(d["cot"])).sum(), targs)
    for name, t, j in (("y", ty, jy), ("m", tm, jm), ("v", tv, jv)):
        _close(t, j, what=name)
    _grads_close(tg, jg, names)


# ------------------------------------------------------------ nn_ops
def _bn_state(rng, c):
    return (rng.rand(c).astype(np.float32) + 0.5,
            rng.randn(c).astype(np.float32) * 0.2,
            rng.randn(c).astype(np.float32) * 0.1,
            rng.rand(c).astype(np.float32) + 0.5)


@pytest.mark.parametrize("shape,wshape,stride,pad", [
    ((2, 16, 16, 3), (7, 7, 3, 64), 2, 3),       # the stem (C = 3)
    ((2, 8, 8, 48), (3, 3, 48, 64), 2, 1),       # off-tile, stride 2
    ((2, 8, 8, 64), (1, 1, 64, 32), 1, 0),       # 1x1 stride 1: a matmul
    ((2, 8, 8, 64), (1, 1, 64, 128), 2, 0),      # 1x1 stride 2
])
def test_conv2d_matches_jax(shape, wshape, stride, pad):
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(*wshape).astype(np.float32) * 0.1
    cot = None
    padding = [(pad, pad), (pad, pad)]
    jy, vjp = jax.vjp(lambda x_, w_: jn.conv2d(x_, w_, stride=stride,
                                               padding=padding),
                      jnp.asarray(x), jnp.asarray(w))
    cot = rng.randn(*jy.shape).astype(np.float32)
    jg = vjp(jnp.asarray(cot))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    ty = tn.conv2d(tx, tw, stride=stride, padding=padding)
    tg = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(), (tx, tw))
    _close(ty, jy, what="y")
    _grads_close(tg, jg, ("dx", "dw"))


@pytest.mark.parametrize("kind,window,stride,pad", [
    ("max", 3, 2, 1), ("avg", 3, 2, 1), ("avg", 4, 1, 0), ("max", 2, 2, 0)])
def test_pool2d_matches_jax(kind, window, stride, pad):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 8, 16).astype(np.float32)
    jy, vjp = jax.vjp(lambda x_: jn.pool2d(x_, kind, window, stride,
                                           [pad, pad]), jnp.asarray(x))
    cot = rng.randn(*jy.shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tn.pool2d(tx, kind, window, stride, [pad, pad])
    tg, = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(), tx)
    _close(ty, jy, what="y")
    _close(tg, vjp(jnp.asarray(cot))[0], what="dx")


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_and_folded_affine_match_jax(training):
    rng = np.random.RandomState(6)
    x = (rng.randn(3, 5, 4, 48) * 2 + 1).astype(np.float32)
    scale, bias, rm, rv = _bn_state(rng, 48)
    cot = rng.randn(*x.shape).astype(np.float32)

    def jf(x_, s, b):
        return jn.batch_norm(x_, s, b, jnp.asarray(rm), jnp.asarray(rv),
                             is_training=training)
    (jy, jrm, jrv), vjp = jax.vjp(jf, *map(jnp.asarray, (x, scale, bias)))
    jg = vjp((jnp.asarray(cot), jnp.zeros_like(jrm), jnp.zeros_like(jrv)))
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (x, scale, bias)]
    ty, trm, trv = tn.batch_norm(*targs, torch.from_numpy(rm),
                                 torch.from_numpy(rv), is_training=training)
    tg = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(), targs)
    for name, t, j in (("y", ty, jy), ("rm", trm, jrm), ("rv", trv, jrv)):
        _close(t, j, what=name)
    _grads_close(tg, jg, ("dx", "dscale", "dbias"))
    ja = jn.bn_folded_affine(*map(jnp.asarray, (x, scale, bias, rm, rv)),
                             is_training=training)
    ta = tn.bn_folded_affine(*map(torch.from_numpy, (x, scale, bias, rm, rv)),
                             is_training=training)
    for name, t, j in zip(("a", "c", "rm", "rv"), ta, ja):
        _close(t, j, what=name)


def _jax_dispatch():
    from paddle_tpu.observe import counter
    return {(s["labels"]["op"], s["labels"]["path"], s["labels"]["reason"]):
            s["value"] for s in counter("conv_dispatch_total").samples()}


def _dispatch_delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0)}


AFFINE_CASES = [  # (z shape, w shape, stride, pad, act, training, path)
    ((2, 5, 6, 64), (3, 3, 64, 64), 1, 1, "relu", True, "pallas3x3"),
    ((2, 5, 6, 64), (3, 3, 64, 128), 1, 1, "", True, "pallas3x3"),
    ((2, 5, 6, 64), (1, 1, 64, 32), 1, 0, "relu", True, "gemm1x1"),
    ((2, 5, 6, 64), (3, 3, 64, 64), 1, 1, "relu", False, "unfused"),
    ((2, 5, 6, 48), (3, 3, 48, 64), 1, 1, "relu", True, "unfused"),
    ((2, 6, 6, 64), (3, 3, 64, 64), 2, 1, "relu", True, "unfused"),
]


@pytest.mark.parametrize("case", range(len(AFFINE_CASES)))
def test_affine_act_conv2d_matches_jax(case):
    zs, ws, stride, pad, act, training, path = AFFINE_CASES[case]
    rng = np.random.RandomState(7 + case)
    z = rng.randn(*zs).astype(np.float32)
    w = rng.randn(*ws).astype(np.float32) * 0.1
    a = rng.randn(zs[3]).astype(np.float32) * 0.5 + 1.0
    c = rng.randn(zs[3]).astype(np.float32) * 0.3
    cb = rng.randn(ws[3]).astype(np.float32) * 0.1
    padding = [(pad, pad), (pad, pad)]
    kw = dict(act=act, is_training=training, stride=stride, padding=padding)
    before = _jax_dispatch()
    jy, vjp = jax.vjp(lambda *t: jn.affine_act_conv2d(*t, **kw),
                      *map(jnp.asarray, (z, a, c, w, cb)))
    jd = _dispatch_delta(before, _jax_dispatch())
    cot = rng.randn(*jy.shape).astype(np.float32)
    jg = vjp(jnp.asarray(cot))
    tn.conv_dispatch.clear()
    targs = [torch.from_numpy(t).requires_grad_(True)
             for t in (z, a, c, w, cb)]
    ty = tn.affine_act_conv2d(*targs, **kw)
    assert dict(tn.conv_dispatch) == jd
    assert [k[1] for k in jd] == [path]
    tg = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(), targs)
    _close(ty, jy, what="y")
    _grads_close(tg, jg, ("dz", "da", "dc", "dw", "dcb"))


CONV_BN_CASES = [  # (x shape, w shape, stride, in_affine, training, path)
    ((2, 5, 6, 64), (3, 3, 64, 64), 1, None, True, "fused"),
    ((2, 5, 6, 64), (3, 3, 64, 64), 1, "relu", True, "chain"),
    ((2, 5, 6, 64), (3, 3, 64, 128), 1, "", True, "chain"),
    ((2, 5, 6, 48), (3, 3, 48, 64), 1, "relu", True, "unfused"),
    ((2, 5, 6, 64), (3, 3, 64, 64), 1, None, False, "unfused"),
    ((2, 6, 6, 64), (3, 3, 64, 64), 2, None, True, "unfused"),
]


@pytest.mark.parametrize("case", range(len(CONV_BN_CASES)))
def test_conv2d_bn_matches_jax(case):
    xs, ws, stride, aff_act, training, path = CONV_BN_CASES[case]
    rng = np.random.RandomState(20 + case)
    x = rng.randn(*xs).astype(np.float32)
    w = rng.randn(*ws).astype(np.float32) * 0.1
    cb = rng.randn(ws[3]).astype(np.float32) * 0.1
    scale, bias, rm, rv = _bn_state(rng, ws[3])
    a = rng.randn(xs[3]).astype(np.float32) * 0.5 + 1.0
    c = rng.randn(xs[3]).astype(np.float32) * 0.3
    kw = dict(is_training=training, stride=stride,
              padding=[(1, 1), (1, 1)])

    def jf(x_, w_, cb_, s, b, a_, c_):
        aff = None if aff_act is None else (a_, c_, aff_act)
        return jn.conv2d_bn(x_, w_, cb_, s, b, jnp.asarray(rm),
                            jnp.asarray(rv), in_affine=aff, **kw)
    before = _jax_dispatch()
    (jy, jrm, jrv), vjp = jax.vjp(
        jf, *map(jnp.asarray, (x, w, cb, scale, bias, a, c)))
    jd = _dispatch_delta(before, _jax_dispatch())
    cot = rng.randn(*jy.shape).astype(np.float32)
    jg = vjp((jnp.asarray(cot), jnp.zeros_like(jrm), jnp.zeros_like(jrv)))
    tn.conv_dispatch.clear()
    targs = [torch.from_numpy(t).requires_grad_(True)
             for t in (x, w, cb, scale, bias, a, c)]
    aff = None if aff_act is None else (targs[5], targs[6], aff_act)
    ty, trm, trv = tn.conv2d_bn(*targs[:5], torch.from_numpy(rm),
                                torch.from_numpy(rv), in_affine=aff, **kw)
    assert dict(tn.conv_dispatch) == jd
    assert [k[1] for k in jd] == [path]
    tg = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(), targs,
                             allow_unused=True)
    for name, t, j in (("y", ty, jy), ("rm", trm, jrm), ("rv", trv, jrv)):
        _close(t, j, what=name)
    names = ("dx", "dw", "dcb", "dscale", "dbias", "da", "dc")
    n = 5 if aff_act is None else 7
    _grads_close(tg[:n], jg[:n], names[:n])
