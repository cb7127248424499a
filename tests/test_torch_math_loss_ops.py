"""The port's math and loss ops (``paddle_tpu_torch/ops/math_ops.py``,
``loss_ops.py``) and its op registry against the JAX package's, on the
CPU.

Every public function of the two modules runs on the same numpy inputs
in both packages: its outputs, and where it has one the gradient of its
first output against a random cotangent in every float argument, must
agree (``test_torch_costs_ops._vjp_parity``).  The op registry's names
and aliases of ``activations``, ``math_ops`` and ``loss_ops`` equal the
JAX package's.  The two random ops are held to their shape, dtype and
moments: the port draws from a ``torch.Generator``, so its numbers are
not JAX's.

Tolerance (fp32): rtol 1e-5, atol 1e-6 · max(1, max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import loss_ops as jloss
from paddle_tpu.ops import math_ops as jmath
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.ops import loss_ops as tloss
from paddle_tpu_torch.ops import math_ops as tmath
from paddle_tpu_torch.ops.registry import OPS as TOPS
from test_torch_costs_ops import _vjp_parity

R = np.random.RandomState(7)


def _u(*shape, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def _probs(*shape):
    z = R.randn(*shape).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# ------------------------------------------------------- math ops
_X = _u(3, 4)
_X3 = _u(2, 3, 4)
MATH_CASES = {
    "matmul": ("matmul", [_u(3, 4), _u(4, 5)], {}),
    "matmul_t_scale": ("matmul", [_u(4, 3), _u(5, 4)],
                       dict(transpose_x=True, transpose_y=True, scale=0.5)),
    "matmul_int": ("matmul", [R.randint(-3, 3, (2, 3)).astype(np.int32),
                              R.randint(-3, 3, (3, 2)).astype(np.int32)], {}),
    "sum_arrays": ("sum_arrays", [_u(3, 4), _u(3, 4), _u(3, 4)], {}),
    "scale": ("scale", [_X], dict(scale=2.0, bias=0.5)),
    "sign": ("sign", [_X], {}),
    "clip": ("clip", [_u(3, 4, lo=-2, hi=2)], dict(min=-0.7, max=0.9)),
    "mean": ("mean", [_X3], {}),
    "minus": ("minus", [_X, _u(3, 4)], {}),
    "increment": ("increment", [_X], dict(step=3.0)),
    "elementwise_add": ("elementwise_add", [_X3, _u(4)], {}),
    "elementwise_sub_axis1": ("elementwise_sub", [_X3, _u(3)],
                              dict(axis=1)),
    "elementwise_mul": ("elementwise_mul", [_X3, _u(3, 4)], {}),
    "elementwise_div": ("elementwise_div",
                        [_X3, _u(2, 3, lo=0.5, hi=2.0)], dict(axis=0)),
    "reduce_sum": ("reduce_sum", [_X3], {}),
    "reduce_sum_dim": ("reduce_sum", [_X3], dict(dim=1, keep_dim=True)),
    "reduce_mean": ("reduce_mean", [_X3], dict(dim=(0, 2))),
    "reduce_max": ("reduce_max", [_X3], dict(dim=-1)),
    "reduce_min": ("reduce_min", [_X3], {}),
    "transpose": ("transpose", [_X3], {}),
    "transpose_axis": ("transpose", [_X3], dict(axis=(1, 0, 2))),
    "reshape": ("reshape", [_X3], dict(shape=(4, 6))),
    "concat": ("concat", [_X, _u(3, 2)], {}),
    "split": ("split", [_u(3, 6)], dict(num_or_sections=3)),
    "split_sections": ("split", [_u(3, 6)], dict(num_or_sections=[1, 3])),
    "pad": ("pad", [_X], dict(paddings=[(1, 0), (0, 2)], pad_value=0.5)),
    "crop": ("crop", [_u(4, 6)], dict(offsets=[1, 5], shape=[2, 3])),
    "gather": ("gather", [_X, np.array([2, 0, 2], np.int32)], {}),
    "gather_axis_oob": ("gather", [_X3, np.array([[3, -1], [7, 0]],
                                                 np.int32)], dict(axis=2)),
    "scatter_set": ("scatter", [_u(5, 3), np.array([4, 0, 2], np.int32),
                                _u(3, 3)], {}),
    "scatter_add": ("scatter", [_u(5, 3), np.array([1, 1, -1, 9], np.int32),
                                _u(4, 3)], dict(overwrite=False)),
    "top_k": ("top_k", [_u(3, 8)], dict(k=3)),
    "multiplex": ("multiplex", [np.array([[0], [2], [1]], np.int32),
                                _u(3, 4), _u(3, 4), _u(3, 4)], {}),
    "fill_zeros_like": ("fill_zeros_like", [_X], {}),
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like", [_X3],
        dict(shape=[-1, 5], value=2.5, input_dim_idx=1, output_dim_idx=0)),
    "cos_sim": ("cos_sim", [_X, _u(3, 4)], dict(scale=2.0)),
    "cos_sim_broadcast": ("cos_sim", [_X, _u(1, 4)], {}),
    "conv_shift": ("conv_shift", [_u(2, 6), _u(2, 3)], {}),
    "outer_prod": ("outer_prod", [_u(2, 3), _u(2, 4)], {}),
    "interpolation": ("interpolation", [_u(3, 1, lo=0.1, hi=0.9), _X,
                                        _u(3, 4)], {}),
    "slope_intercept": ("slope_intercept", [_X],
                        dict(slope=-1.5, intercept=0.25)),
    "sum_to_one_norm": ("sum_to_one_norm", [_u(3, 4, lo=0.2, hi=2.0)], {}),
    "row_l2_norm": ("row_l2_norm", [_X], {}),
    "convex_combination": ("convex_combination", [_u(2, 5, 3),
                                                  _u(2, 5, 12)], {}),
}


@pytest.mark.parametrize("case", sorted(MATH_CASES))
def test_math_op_matches_jax(case):
    fn, args, kw = MATH_CASES[case]
    _vjp_parity(lambda *a: getattr(jmath, fn)(*a, **kw),
                lambda *a: getattr(tmath, fn)(*a, **kw), args)


def test_einsum_matches_jax():
    _vjp_parity(lambda a, b: jmath.einsum("bd,bkd->bk", a, b),
                lambda a, b: tmath.einsum("bd,bkd->bk", a, b),
                [_u(2, 4), _u(2, 3, 4)])
    ints = [R.randint(0, 4, (2, 3)).astype(np.int32)] * 2
    _vjp_parity(lambda a, b: jmath.einsum("ij,ij->i", a, b),
                lambda a, b: tmath.einsum("ij,ij->i", a, b), ints)


def test_cast_and_fill_constant_match_jax():
    x = _u(3, 4, lo=-3, hi=3)
    np.testing.assert_array_equal(
        tmath.cast(torch.from_numpy(x), torch.int32).numpy(),
        np.asarray(jmath.cast(jnp.asarray(x), jnp.int32)))
    got = tmath.fill_constant([2, 3], 1.5, torch.float32, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmath.fill_constant([2, 3], 1.5)))
    got = tmath.fill_constant([4], 7, torch.int32, device="cpu")
    assert got.dtype == torch.int32 and got.tolist() == [7] * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_random_ops_by_shape_dtype_and_moments(dtype):
    n = 200_000
    gen = torch.Generator().manual_seed(5)
    g = tmath.gaussian_random(gen, (n // 100, 100), mean=1.0, std=2.0,
                              dtype=dtype)
    assert g.shape == (n // 100, 100) and g.dtype == dtype
    # the sample mean within 5 standard errors, the std within 1 %
    assert abs(float(g.mean()) - 1.0) < 5 * 2.0 / np.sqrt(n)
    assert abs(float(g.std()) - 2.0) < 0.02
    u = tmath.uniform_random(gen, (n,), min=-3.0, max=5.0, dtype=dtype)
    assert u.shape == (n,) and u.dtype == dtype
    assert float(u.min()) >= -3.0 and float(u.max()) < 5.0
    assert abs(float(u.mean()) - 1.0) < 5 * (8 / np.sqrt(12)) / np.sqrt(n)
    # the JAX functions: same shapes, dtypes and law
    ju = np.asarray(jmath.uniform_random(jax.random.PRNGKey(0), (n,),
                                         min=-3.0, max=5.0))
    assert abs(ju.mean() - float(u.mean())) < 0.05
    # a generator of the same seed draws the same numbers
    again = tmath.gaussian_random(torch.Generator().manual_seed(5),
                                  (n // 100, 100), mean=1.0, std=2.0,
                                  dtype=dtype)
    torch.testing.assert_close(again, g, rtol=0, atol=0)


# ------------------------------------------------------- loss ops
LOSS_CASES = {
    "cross_entropy": ("cross_entropy", [_probs(4, 5),
                                        np.array([0, 4, 2, 1], np.int32)],
                      {}),
    "cross_entropy_soft": ("cross_entropy", [_probs(4, 5), _probs(4, 5)],
                           dict(soft_label=True)),
    "softmax_with_cross_entropy": (
        "softmax_with_cross_entropy",
        [_u(4, 5, lo=-3, hi=3), np.array([1, 0, 4, 4], np.int32)], {}),
    "softmax_with_cross_entropy_soft": (
        "softmax_with_cross_entropy", [_u(4, 5, lo=-3, hi=3), _probs(4, 5)],
        dict(soft_label=True)),
    "softmax_ce_fused": ("softmax_ce_fused",
                         [_u(2, 3, 6, lo=-3, hi=3),
                          R.randint(0, 6, (2, 3)).astype(np.int32)], {}),
    "multi_binary_label_cross_entropy": (
        "multi_binary_label_cross_entropy",
        [_u(3, 4, lo=0.1, hi=0.9), (R.rand(3, 4) > 0.5).astype(np.float32)],
        {}),
    "sigmoid_cross_entropy_with_logits": (
        "sigmoid_cross_entropy_with_logits",
        [_u(3, 4, lo=-3, hi=3), _u(3, 4, lo=0, hi=1)], {}),
    "square_error": ("square_error", [_u(3, 2, 2), _u(3, 2, 2)], {}),
    "squared_l2_distance": ("squared_l2_distance", [_u(3, 4), _u(3, 4)], {}),
    "squared_l2_norm": ("squared_l2_norm", [_u(3, 4)], {}),
    "l1_norm": ("l1_norm", [_u(3, 4)], {}),
    "smooth_l1_loss": ("smooth_l1_loss", [_u(3, 4, lo=-2, hi=2),
                                          _u(3, 4, lo=-2, hi=2)], {}),
    "smooth_l1_loss_sigma": ("smooth_l1_loss", [_u(3, 4, lo=-2, hi=2),
                                                _u(3, 4)], dict(sigma=2.0)),
    "huber_loss": ("huber_loss", [_u(4, 2, lo=-2, hi=2), _u(4, 2)],
                   dict(delta=0.6)),
    "huber_classification_cost": (
        "huber_classification_cost",
        [np.array([[-1.7], [-0.4], [0.3], [1.6], [0.8]], np.float32),
         np.array([[1.0], [1.0], [0.0], [1.0], [0.0]], np.float32)], {}),
    "modified_huber_loss": (
        "modified_huber_loss",
        [np.array([[-1.7], [-0.4], [0.3], [1.6], [0.8]], np.float32),
         np.array([[1.0], [1.0], [0.0], [1.0], [0.0]], np.float32)], {}),
    "rank_loss": ("rank_loss", [_u(4, 1), _u(4, 1),
                                np.array([[1.0], [0.0], [0.5], [1.0]],
                                         np.float32)], {}),
    "margin_rank_loss": ("margin_rank_loss",
                         [_u(4, 1), _u(4, 1),
                          np.array([[1.0], [-1.0], [1.0], [-1.0]],
                                   np.float32)], dict(margin=0.1)),
    "lambda_cost": ("lambda_cost",
                    [_u(2, 5), R.randint(0, 4, (2, 5)).astype(np.float32),
                     np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]],
                              np.float32)], dict(ndcg_num=2)),
    "cross_entropy_over_beam": ("cross_entropy_over_beam",
                                [_u(3, 4, lo=-2, hi=2),
                                 np.eye(4, dtype=np.float32)[[1, 0, 3]]],
                                {}),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_op_matches_jax(case):
    fn, args, kw = LOSS_CASES[case]
    _vjp_parity(lambda *a: getattr(jloss, fn)(*a, **kw),
                lambda *a: getattr(tloss, fn)(*a, **kw), args)


def _module_ops(registry, suffixes):
    names = {n for n, d in registry._entries.items()
             if d.fn.__module__.rsplit(".", 1)[-1] in suffixes}
    aliases = {a: n for a, n in registry._aliases.items() if n in names}
    return names, aliases


def test_every_public_op_is_ported_under_the_jax_names():
    mods = {"activations", "math_ops", "loss_ops"}
    assert _module_ops(TOPS, mods) == _module_ops(JOPS, mods)
    for jmod, tmod, n in ((jmath, tmath, 41), (jloss, tloss, 17)):
        public = {k for k, v in vars(jmod).items()
                  if callable(v) and not k.startswith("_")
                  and getattr(v, "__module__", None) == jmod.__name__}
        assert len(public) == n
        assert all(callable(getattr(tmod, k, None)) for k in public), \
            sorted(k for k in public if not hasattr(tmod, k))
    tested = {fn for fn, _, _ in MATH_CASES.values()} | {
        "einsum", "cast", "fill_constant", "gaussian_random",
        "uniform_random"}
    assert len(tested) == 41
    assert len({fn for fn, _, _ in LOSS_CASES.values()}) == 17
