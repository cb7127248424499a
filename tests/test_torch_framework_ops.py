"""The port's framework op registry (``paddle_tpu_torch/framework/ops.py``)
against the JAX package's (``paddle_tpu/framework/ops.py``), on the CPU.

- The two registries hold exactly the same 108 names.
- Each case of ``tests/test_op_suite.py`` (the op harness of the JAX
  framework) runs through both registries from the same numpy inputs:
  every output slot the case names must agree within rtol 1e-5, atol
  1e-5 in fp32.
- The gradients of ``conv2d``, ``lookup_table``, ``lstm`` and
  ``sequence_conv`` from ``torch.autograd`` against ``jax.grad``, on a
  fixed weighted sum of the outputs (the harness's cotangent), within the
  same tolerance.
- ``gaussian_random``, ``uniform_random`` and training-mode ``dropout``
  draw from a ``torch.Generator`` in the port, so their numbers are not
  JAX's: they are held to their shape, range and moments.
- The outputs the reference fills oddly are kept: ``lstm``'s
  ``BatchGate``/``BatchCellPreAct`` are its input, ``gru_unit``'s
  ``Gate``/``ResetHiddenPrev`` its new hidden state, and ``mul`` drops
  the LoD.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.framework.ops import OPS as JOPS
from paddle_tpu.framework.ops import OpContext as JCtx
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.framework.ops import OPS as TOPS
from paddle_tpu_torch.framework.ops import OpContext as TCtx

RTOL = ATOL = 1e-5


class Seq:
    """A sequence input: data [B, T, ...] and lengths, as numpy."""

    def __init__(self, data, lens):
        self.data, self.lens = data, np.asarray(lens, np.int32)


def _jax_in(v):
    if isinstance(v, Seq):
        return JSeq(jnp.asarray(v.data), jnp.asarray(v.lens))
    return jnp.asarray(v)


def _torch_in(v):
    if isinstance(v, Seq):
        return TSeq(torch.from_numpy(np.array(v.data)),
                    torch.from_numpy(v.lens.copy()))
    return torch.from_numpy(np.array(v))


def _np(v):
    if isinstance(v, (JSeq, TSeq)):
        v = v.data
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


def run_jax(op, ins, attrs, is_test=True):
    ctx = JCtx(is_test=is_test, rng=jax.random.PRNGKey(0))
    return JOPS[op](ctx, {k: [_jax_in(v) for v in vs]
                          for k, vs in ins.items()}, attrs)


def run_torch(op, ins, attrs, is_test=True):
    ctx = TCtx(is_test=is_test, seed=0, device="cpu")
    return TOPS[op](ctx, {k: [_torch_in(v) for v in vs]
                          for k, vs in ins.items()}, attrs)


# ---------------------------------------------------------------- cases
R = np.random.RandomState(1234)


def _x(*shape, lo=-2.0, hi=2.0, away_from=(), margin=0.15):
    """Uniform sample kept off the kink points (the harness's ``_x``)."""
    x = R.uniform(lo, hi, shape).astype(np.float32)
    for p in away_from:
        close = np.abs(x - p) < margin
        x = np.where(close, x + np.sign(x - p + 1e-9) * margin * 2, x)
    return x.astype(np.float32)


def _softmax(z, axis=-1):
    e = np.exp(z - z.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


def _seq(lens, d):
    t = max(lens)
    return Seq(R.randn(len(lens), t, d).astype(np.float32), lens)


ACTS = {  # the harness's ACT_CASES: name -> (attrs, kinks)
    "sigmoid": ({}, ()), "tanh": ({}, ()), "relu": ({}, (0.0,)),
    "exp": ({}, ()), "abs": ({}, (0.0,)), "square": ({}, ()),
    "softplus": ({}, ()), "softsign": ({}, (0.0,)), "logsigmoid": ({}, ()),
    "leaky_relu": ({"alpha": 0.02}, (0.0,)),
    "elu": ({"alpha": 1.0}, (0.0,)),
    "brelu": ({"t_min": -1.0, "t_max": 1.5}, (-1.0, 1.5)),
    "relu6": ({}, (0.0, 6.0)), "soft_relu": ({}, ()),
    "stanh": ({"scale_a": 2.0 / 3.0, "scale_b": 1.7159}, ()),
    "tanh_shrink": ({}, ()), "softshrink": ({"lambda": 0.5}, (-0.5, 0.5)),
    "hard_shrink": ({"threshold": 0.5}, (-0.5, 0.5)),
    "thresholded_relu": ({"threshold": 1.0}, (1.0,)),
    "hard_sigmoid": ({"slope": 0.2, "offset": 0.5}, (-2.5, 2.5)),
}

# id -> (op, ins, attrs, output slots compared); inputs drawn once, in
# this order, from RandomState(1234)
CASES = {}
for _name, (_attrs, _kinks) in ACTS.items():
    CASES[_name] = (_name, {"X": [_x(3, 5, away_from=_kinks)]}, _attrs,
                    ["Out"])
_pos = _x(3, 4, lo=0.3, hi=3.0)
CASES.update({
    "log": ("log", {"X": [_pos]}, {}, ["Out"]),
    "sqrt": ("sqrt", {"X": [_pos]}, {}, ["Out"]),
    "reciprocal": ("reciprocal", {"X": [_pos]}, {}, ["Out"]),
    "pow": ("pow", {"X": [_pos]}, {"factor": 2.5}, ["Out"]),
    "sign": ("sign", {"X": [_x(4, 4, away_from=(0.0,))]}, {}, ["Out"]),
})
_a, _b = _x(3, 4), _x(3, 4)
_yp = _x(3, 4, lo=0.5, hi=2.0)
for _nm, _y in (("elementwise_add", _b), ("elementwise_sub", _b),
                ("elementwise_mul", _b), ("elementwise_div", _yp)):
    CASES[_nm] = (_nm, {"X": [_a], "Y": [_y]}, {}, ["Out"])
CASES["elementwise_add_axis"] = ("elementwise_add", {
    "X": [_x(2, 3, 4, 5)], "Y": [_x(3)]}, {"axis": 1}, ["Out"])
_m, _n = _x(3, 4), _x(4, 5)
CASES.update({
    "mul": ("mul", {"X": [_m], "Y": [_n]}, {}, ["Out"]),
    "mul_flatten": ("mul", {"X": [_x(2, 3, 4)], "Y": [_x(4, 5)]},
                    {"x_num_col_dims": 2}, ["Out"]),
    "mul_drops_lod": ("mul", {"X": [_seq([3, 2], 4)], "Y": [_x(4, 5)]},
                      {"x_num_col_dims": 2}, ["Out"]),
    "matmul": ("matmul", {"X": [_m], "Y": [_n.T.copy()]},
               {"transpose_Y": True}, ["Out"]),
})
_s1, _s2, _s3 = _x(2, 3), _x(2, 3), _x(2, 3)
CASES.update({
    "sum": ("sum", {"X": [_s1, _s2, _s3]}, {}, ["Out"]),
    "mean": ("mean", {"X": [_s1]}, {}, ["Out"]),
    "minus": ("minus", {"X": [_s1], "Y": [_s2]}, {}, ["Out"]),
    "scale": ("scale", {"X": [_s1]}, {"scale": 3.0, "bias": 0.5}, ["Out"]),
    "clip": ("clip", {"X": [_x(3, 4, away_from=(-1.0, 1.0))]},
             {"min": -1.0, "max": 1.0}, ["Out"]),
})
_r = _x(3, 4, 2)
for _nm in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min"):
    CASES[_nm] = (_nm, {"X": [_r]}, {"dim": 1}, ["Out"])
CASES["reduce_sum_keep"] = ("reduce_sum", {"X": [_r]},
                            {"dim": 2, "keep_dim": True}, ["Out"])
CASES.update({
    "reshape": ("reshape", {"X": [_x(2, 6)]}, {"shape": [3, 4]}, ["Out"]),
    "transpose": ("transpose", {"X": [_x(2, 3, 4)]}, {"axis": [2, 0, 1]},
                  ["Out"]),
    "concat": ("concat", {"X": [_x(2, 3), _x(2, 5)]}, {"axis": 1}, ["Out"]),
    "pad": ("pad", {"X": [_x(2, 4)]},
            {"paddings": [0, 1, 2, 0], "pad_value": 1.5}, ["Out"]),
    "crop": ("crop", {"X": [_x(4, 5)]}, {"offsets": [1, 2], "shape": [2, 3]},
             ["Out"]),
    "split": ("split", {"X": [_x(4, 6)]}, {"axis": 1, "num": 3}, ["Out"]),
    "gather": ("gather", {"X": [_x(5, 3)],
                          "Index": [np.array([3, 1, 1], np.int32)]}, {},
               ["Out"]),
    "scatter": ("scatter", {"Ref": [_x(5, 3)],
                            "Index": [np.array([0, 2], np.int32)],
                            "Updates": [_x(2, 3)]}, {}, ["Out"]),
    "multiplex": ("multiplex", {"Ids": [np.array([[0], [1], [0], [1]],
                                                 np.int32)],
                                "X": [_x(4, 3), _x(4, 3)]}, {}, ["Out"]),
    "top_k": ("top_k", {"X": [_x(3, 6)]}, {"k": 2}, ["Out", "Indices"]),
    "fill_zeros_like": ("fill_zeros_like", {"X": [_x(3, 2)]}, {}, ["Out"]),
    "fill_constant": ("fill_constant", {"X": []},
                      {"shape": [2, 3], "value": 1.25}, ["Out"]),
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like", {"Input": [_x(3, 2)]},
        {"shape": [9, 4], "value": 2.0}, ["Out"]),
    "cast": ("cast", {"X": [_x(3, 2)]}, {"dtype": "int32"}, ["Out"]),
    "increment": ("increment", {"X": [_x(3, 2)]}, {"step": 1.0}, ["Out"]),
    "cos_sim": ("cos_sim", {"X": [_x(4, 6)], "Y": [_x(4, 6)]}, {}, ["Out"]),
    "conv_shift": ("conv_shift", {"X": [_x(2, 7)], "Y": [_x(2, 3)]}, {},
                   ["Out"]),
})
_img = _x(2, 3, 6, 6)
_flt = _x(4, 3, 3, 3) * 0.5
_conv_attrs = {"strides": [1, 1], "paddings": [1, 1]}
CASES.update({
    "conv2d": ("conv2d", {"Input": [_img], "Filter": [_flt]}, _conv_attrs,
               ["Output"]),
    "conv_cudnn": ("conv_cudnn", {"Input": [_img], "Filter": [_flt]},
                   {"strides": [2, 2], "paddings": [0, 0]}, ["Output"]),
    "conv2d_groups": ("conv2d", {"Input": [_x(1, 4, 5, 5)],
                                 "Filter": [_x(6, 2, 3, 3) * 0.3]},
                      {"strides": [1, 1], "paddings": [1, 1], "groups": 2},
                      ["Output"]),
    "pool2d_max": ("pool2d", {"X": [_x(1, 2, 4, 4)]},
                   {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
                    "pooling_type": "max"}, ["Out"]),
    "pool2d_cudnn_avg": ("pool2d_cudnn", {"X": [_x(1, 2, 6, 6)]},
                         {"ksize": [3, 3], "strides": [2, 2],
                          "paddings": [1, 1], "pooling_type": "avg"},
                         ["Out"]),
    "pool2d_global": ("pool2d", {"X": [_x(1, 2, 6, 6)]},
                      {"pooling_type": "avg", "global_pooling": True},
                      ["Out"]),
    "lookup_table": ("lookup_table", {
        "W": [_x(10, 4)], "Ids": [np.array([[1], [3], [3], [7]], np.int64)]},
        {}, ["Out"]),
    "lookup_table_seq": ("lookup_table", {
        "W": [_x(10, 4)],
        "Ids": [Seq(np.array([[1, 2, 9], [4, 0, 0]], np.int64), [3, 1])]},
        {}, ["Out"]),
})
_p = _softmax(_x(4, 5))
_lab = np.array([[0], [2], [4], [1]], np.int64)
_t = (R.rand(3, 4) > 0.5).astype(np.float32)
CASES.update({
    "cross_entropy": ("cross_entropy", {"X": [_p], "Label": [_lab]}, {},
                      ["Y"]),
    "cross_entropy_soft": ("cross_entropy", {
        "X": [_p], "Label": [_softmax(_x(4, 5))]}, {"soft_label": True},
        ["Y"]),
    "softmax_with_cross_entropy": (
        "softmax_with_cross_entropy", {"Logits": [_x(4, 5)],
                                       "Label": [_lab]}, {},
        ["Softmax", "Loss"]),
    "sigmoid_cross_entropy_with_logits": (
        "sigmoid_cross_entropy_with_logits", {"X": [_x(3, 4)],
                                              "Label": [_t]}, {}, ["Out"]),
    "squared_l2_distance": ("squared_l2_distance", {
        "X": [_x(4, 3)], "Y": [_x(4, 3)]}, {}, ["Out", "sub_result"]),
    "squared_l2_norm": ("squared_l2_norm", {"X": [_x(4, 3)]}, {}, ["Out"]),
    "l1_norm": ("l1_norm", {"X": [_x(3, 4, away_from=(0.0,))]}, {},
                ["Out"]),
})
_lft, _rgt = _x(5, 1), _x(5, 1)
_rl = (R.rand(5, 1) > 0.5).astype(np.float32)
CASES.update({
    "rank_loss": ("rank_loss", {"Left": [_lft], "Right": [_rgt],
                                "Label": [_rl]}, {}, ["Out"]),
    "margin_rank_loss": ("margin_rank_loss", {
        "X1": [_lft], "X2": [_rgt],
        "Label": [np.where(_rl > 0, 1.0, -1.0).astype(np.float32)]},
        {"margin": 0.1}, ["Out", "Activated"]),
    "dropout_test": ("dropout", {"X": [_x(3, 4)]},
                     {"dropout_prob": 0.5, "is_test": True},
                     ["Out", "Mask"]),
})
_pred = _softmax(_x(6, 3))
_plab = np.argmax(_pred, 1).reshape(-1, 1)
_plab[0] = (_plab[0] + 1) % 3
CASES.update({
    "accuracy": ("accuracy", {"Out": [_pred], "Label": [_plab]}, {},
                 ["Accuracy", "Correct", "Total"]),
    "accuracy_top2": ("accuracy", {"Out": [_pred], "Label": [_plab]},
                      {"k": 2}, ["Accuracy", "Correct", "Total"]),
})
_sb = _seq([3, 5], 4)
for _mode in ("AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST"):
    CASES[f"sequence_pool_{_mode.lower()}"] = (
        "sequence_pool", {"X": [_sb]}, {"pooltype": _mode}, ["Out"])
_sa, _sc = _seq([2, 3], 4), _seq([3, 1], 4)
CASES.update({
    "sequence_concat": ("sequence_concat", {"X": [_sa, _sc]}, {"axis": 0},
                        ["Out"]),
    "sequence_concat_features": ("sequence_concat", {
        "X": [_sa, _seq([2, 3], 2)]}, {"axis": 1}, ["Out"]),
    "seq_expand": ("seq_expand", {"X": [_x(2, 3)],
                                  "Y": [Seq(_x(2, 4, 1), [4, 2])]}, {},
                   ["Out"]),
    "sequence_conv": ("sequence_conv", {
        "X": [Seq(_x(2, 4, 3), [4, 2])], "Filter": [_x(9, 5) * 0.3]},
        {"contextStart": -1, "contextLength": 3}, ["Out"]),
    "sequence_softmax": ("sequence_softmax", {"X": [Seq(_x(2, 5, 1),
                                                        [5, 3])]}, {},
                         ["Out"]),
    "softmax": ("softmax", {"X": [_x(4, 6)]}, {}, ["Out"]),
    "lstm_unit": ("lstm_unit", {"X": [_x(3, 16)], "C_prev": [_x(3, 4)]},
                  {"forget_bias": 0.0}, ["H", "C"]),
    "gru_unit": ("gru_unit", {"Input": [_x(3, 12)], "HiddenPrev": [_x(3, 4)],
                              "Weight": [_x(4, 12) * 0.3]}, {},
                 ["Hidden", "Gate", "ResetHiddenPrev"]),
    "lrn": ("lrn", {"X": [_x(1, 3, 4, 4)]},
            {"n": 3, "k": 1.0, "alpha": 1e-2, "beta": 0.5},
            ["Out", "MidOut"]),
    "prelu": ("prelu", {"X": [_x(2, 6, away_from=(0.0,))],
                        "Alpha": [np.full((1,), 0.1, np.float32)]}, {},
              ["Out"]),
})
_xb = _x(6, 5)
_bn = {"Scale": [_x(5, lo=0.5, hi=1.5)], "Bias": [_x(5)],
       "Mean": [_xb.mean(0)], "Variance": [_xb.var(0)]}
_bn_img = _x(2, 3, 4, 4)
CASES.update({
    "batch_norm_test": ("batch_norm", {"X": [_xb], **_bn},
                        {"is_test": True, "epsilon": 1e-5}, ["Y"]),
    "batch_norm_train": ("batch_norm", {
        "X": [_bn_img], "Scale": [_x(3, lo=0.5, hi=1.5)], "Bias": [_x(3)],
        "Mean": [np.zeros(3, np.float32)], "Variance": [np.ones(3, np.float32)]},
        {"is_test": False, "momentum": 0.9},
        ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]),
    "huber_loss": ("huber_loss", {"X": [_x(5, 1)], "Y": [_x(5, 1)]},
                   {"delta": 0.6}, ["Out", "Residual"]),
    "modified_huber_loss": ("modified_huber_loss", {
        "X": [_x(5, 1)], "Y": [(R.rand(5, 1) > 0.5).astype(np.float32)]},
        {}, ["Out", "IntermediateVal"]),
    "smooth_l1_loss": ("smooth_l1_loss", {"X": [_x(4, 3)], "Y": [_x(4, 3)]},
                       {"sigma": 1.0}, ["Out", "Diff"]),
})
_pp, _gg = _x(4, 3), _x(4, 3)
_lr = np.full((1,), 0.1, np.float32)
_b1p = np.full((1,), 0.9, np.float32)
_b2p = np.full((1,), 0.999, np.float32)
_opt = {"Param": [_pp], "Grad": [_gg], "LearningRate": [_lr]}
CASES.update({
    "sgd": ("sgd", dict(_opt), {}, ["ParamOut"]),
    "momentum": ("momentum", {**_opt, "Velocity": [_x(4, 3)]}, {"mu": 0.9},
                 ["ParamOut", "VelocityOut"]),
    "momentum_nesterov": ("momentum", {**_opt, "Velocity": [_x(4, 3)]},
                          {"mu": 0.9, "use_nesterov": True},
                          ["ParamOut", "VelocityOut"]),
    "adam": ("adam", {**_opt, "Moment1": [_x(4, 3)],
                      "Moment2": [np.abs(_x(4, 3))], "Beta1Pow": [_b1p],
                      "Beta2Pow": [_b2p]}, {},
             ["ParamOut", "Moment1Out", "Moment2Out"]),
    "adamax": ("adamax", {**_opt, "Moment": [_x(4, 3)],
                          "InfNorm": [np.abs(_x(4, 3))], "Beta1Pow": [_b1p]},
               {}, ["ParamOut", "MomentOut", "InfNormOut"]),
    "adagrad": ("adagrad", {**_opt, "Moment": [np.abs(_x(4, 3))]}, {},
                ["ParamOut", "MomentOut"]),
    "decayed_adagrad": ("decayed_adagrad", {**_opt,
                                            "Moment": [np.abs(_x(4, 3))]},
                        {"decay": 0.95}, ["ParamOut", "MomentOut"]),
    "adadelta": ("adadelta", {"Param": [_pp], "Grad": [_gg],
                              "AvgSquaredGrad": [np.abs(_x(4, 3))],
                              "AvgSquaredUpdate": [np.abs(_x(4, 3))]},
                 {"rho": 0.95, "epsilon": 1e-6},
                 ["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"]),
    "rmsprop": ("rmsprop", {**_opt, "MeanSquare": [np.abs(_x(4, 3))],
                            "Moment": [_x(4, 3)]},
                {"decay": 0.95, "momentum": 0.8, "epsilon": 1e-6},
                ["ParamOut", "MomentOut", "MeanSquareOut"]),
    "proximal_gd": ("proximal_gd", dict(_opt), {"l1": 0.05, "l2": 0.02},
                    ["ParamOut"]),
    "proximal_adagrad": ("proximal_adagrad", {**_opt,
                                              "Moment": [np.abs(_x(4, 3))]},
                         {"l1": 0.05, "l2": 0.02},
                         ["ParamOut", "MomentOut"]),
})
_em = Seq(_x(2, 4, 3), [4, 3])
_trans = _x(5, 3) * 0.5
CASES.update({
    "linear_chain_crf": ("linear_chain_crf", {
        "Emission": [_em], "Label": [Seq(np.array([[0, 2, 1, 0], [1, 1, 2, 0]],
                                                  np.int64), [4, 3])],
        "Transition": [_trans]}, {},
        ["LogLikelihood", "Alpha", "EmissionExps", "TransitionExps"]),
    "crf_decoding": ("crf_decoding", {"Emission": [_em],
                                      "Transition": [_trans]}, {},
                     ["ViterbiPath"]),
    "conv2d_transpose": ("conv2d_transpose", {
        "Input": [_x(1, 2, 4, 4)], "Filter": [_x(2, 3, 3, 3) * 0.3]},
        {"strides": [2, 2], "paddings": [0, 0]}, ["Output"]),
    "conv2d_transpose_cudnn": ("conv2d_transpose_cudnn", {
        "Input": [_x(1, 2, 4, 4)], "Filter": [_x(2, 3, 3, 3) * 0.3]},
        {"strides": [1, 1], "paddings": [1, 1]}, ["Output"]),
    "pool3d_max": ("pool3d", {"X": [_x(1, 2, 4, 4, 4)]},
                   {"pooling_type": "max", "ksize": [2, 2, 2],
                    "strides": [2, 2, 2]}, ["Out"]),
    "pool3d_avg": ("pool3d", {"X": [_x(1, 2, 4, 4, 4)]},
                   {"pooling_type": "avg", "ksize": [2, 2, 2],
                    "strides": [1, 1, 1]}, ["Out"]),
    "pool3d_global": ("pool3d", {"X": [_x(1, 2, 4, 4, 4)]},
                      {"pooling_type": "avg", "global_pooling": True},
                      ["Out"]),
    "max_pool2d_with_index": ("max_pool2d_with_index", {
        "X": [_x(1, 2, 4, 4)]}, {"ksize": [2, 2], "strides": [2, 2]},
        ["Out", "Mask"]),
    "max_pool3d_with_index": ("max_pool3d_with_index", {
        "X": [_x(1, 1, 4, 4, 4)]}, {"ksize": [2, 2, 2],
                                    "strides": [2, 2, 2]}, ["Out", "Mask"]),
})
_xw = Seq(_x(2, 5, 16) * 0.4, [5, 3])
_wh = _x(4, 16) * 0.2
CASES.update({
    "lstm": ("lstm", {"Input": [_xw], "Weight": [_wh],
                      "Bias": [_x(16) * 0.1]}, {},
             ["Hidden", "Cell", "BatchGate", "BatchCellPreAct"]),
    "lstm_reverse_acts": ("lstm", {"Input": [_xw], "Weight": [_wh]},
                          {"is_reverse": True,
                           "candidate_activation": "relu",
                           "cell_activation": "sigmoid"},
                          ["Hidden", "Cell"]),
    "auc": ("auc", {"Out": [np.array([[0.8, 0.2], [0.3, 0.7], [0.6, 0.4],
                                      [0.1, 0.9]], np.float32)],
                    "Label": [np.array([0, 1, 1, 1], np.int64)]}, {},
            ["AUC"]),
    "auc_random": ("auc", {"Out": [_softmax(_x(9, 2))],
                           "Label": [R.randint(0, 2, (9, 1))]}, {},
                   ["AUC"]),
    "precision_recall": ("precision_recall", {
        "Out": [_softmax(_x(7, 3))], "Label": [R.randint(0, 3, (7,))]}, {},
        ["BatchMetrics", "AccumMetrics", "AccumStatesInfo"]),
})
RANDOM_OPS = {"gaussian_random", "uniform_random"}


def test_registries_hold_the_same_names():
    assert len(TOPS) == 108
    assert set(TOPS) == set(JOPS)


def test_cases_cover_every_op_but_the_random_ones():
    assert {c[0] for c in CASES.values()} | RANDOM_OPS == set(JOPS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    op, ins, attrs, slots = CASES[case]
    j, t = run_jax(op, ins, attrs), run_torch(op, ins, attrs)
    for slot in slots:
        assert len(t[slot]) == len(j[slot]), slot
        for i, (a, b) in enumerate(zip(t[slot], j[slot])):
            got, want = _np(a), _np(b)
            assert got.shape == want.shape, (slot, i)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case}: {slot}[{i}]")


def test_odd_outputs_are_kept():
    """``lstm``'s BatchGate/BatchCellPreAct are its input; ``gru_unit``'s
    Gate/ResetHiddenPrev are h; ``mul`` drops the LoD."""
    _, ins, attrs, _ = CASES["lstm"]
    out = run_torch("lstm", ins, attrs)
    x = _torch_in(ins["Input"][0]).data
    assert torch.equal(out["BatchGate"][0], x)
    assert torch.equal(out["BatchCellPreAct"][0], x)
    _, ins, attrs, _ = CASES["gru_unit"]
    out = run_torch("gru_unit", ins, attrs)
    assert out["Gate"][0] is out["Hidden"][0]
    assert out["ResetHiddenPrev"][0] is out["Hidden"][0]
    _, ins, attrs, _ = CASES["mul_drops_lod"]
    out = run_torch("mul", ins, attrs)["Out"][0]
    assert isinstance(out, torch.Tensor) and out.shape == (2, 3, 5)


# ------------------------------------------------------------ gradients
def _weights(shape):
    """The harness's fixed cotangent: not all ones, so sign errors in
    single elements cannot cancel."""
    return (np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
            % 7 + 1.0) / 7.0


GRAD_CASES = {  # id -> (case, slots differentiated, output slots summed)
    "conv2d": ("conv2d", ["Input", "Filter"], ["Output"]),
    "conv2d_groups": ("conv2d_groups", ["Input", "Filter"], ["Output"]),
    "lookup_table": ("lookup_table", ["W"], ["Out"]),
    "lookup_table_seq": ("lookup_table_seq", ["W"], ["Out"]),
    "lstm": ("lstm", ["Input", "Weight", "Bias"], ["Hidden", "Cell"]),
    "lstm_reverse_acts": ("lstm_reverse_acts", ["Input", "Weight"],
                          ["Hidden", "Cell"]),
    "sequence_conv": ("sequence_conv", ["X", "Filter"], ["Out"]),
}


def _grad_jax(op, ins, attrs, wrt, outs):
    def loss(arrs):
        jins = {k: [_jax_in(v) for v in vs] for k, vs in ins.items()}
        for k, a in zip(wrt, arrs):
            v = jins[k][0]
            jins[k][0] = JSeq(a, v.length) if isinstance(v, JSeq) else a
        res = JOPS[op](JCtx(is_test=True, rng=jax.random.PRNGKey(0)), jins,
                       attrs)
        return sum(jnp.sum(_val(res[s][0]) * _weights(_val(res[s][0]).shape))
                   for s in outs)
    arrs = [jnp.asarray(_data(ins[k][0])) for k in wrt]
    return [np.asarray(g) for g in jax.grad(loss)(arrs)]


def _grad_torch(op, ins, attrs, wrt, outs):
    tins = {k: [_torch_in(v) for v in vs] for k, vs in ins.items()}
    leaves = []
    for k in wrt:
        v = tins[k][0]
        leaf = _val(v).requires_grad_(True)
        leaves.append(leaf)
        tins[k][0] = TSeq(leaf, v.length) if isinstance(v, TSeq) else leaf
    res = TOPS[op](TCtx(is_test=True, seed=0, device="cpu"), tins, attrs)
    loss = sum(torch.sum(_val(res[s][0]) * torch.from_numpy(
        _weights(tuple(_val(res[s][0]).shape)))) for s in outs)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _val(v):
    return v.data if isinstance(v, (JSeq, TSeq)) else v


def _data(v):
    return v.data if isinstance(v, Seq) else v


@pytest.mark.parametrize("gcase", sorted(GRAD_CASES))
def test_op_gradient_matches_jax_grad(gcase):
    case, wrt, outs = GRAD_CASES[gcase]
    op, ins, attrs, _ = CASES[case]
    want = _grad_jax(op, ins, attrs, wrt, outs)
    got = _grad_torch(op, ins, attrs, wrt, outs)
    for k, a, b in zip(wrt, got, want):
        assert np.abs(b).max() > 0, k
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{gcase}: d/d{k}")


# ----------------------------------------------------------- random ops
def test_random_ops_statistics():
    """Shape, range and moments (the harness's bounds), and one draw per
    op counter: two ops of one run draw differently, two runs of one
    seed the same."""
    shape = [2000, 4]
    got = run_torch("gaussian_random", {}, {"shape": shape, "mean": 1.0,
                                            "std": 2.0})["Out"][0].numpy()
    assert got.shape == tuple(shape) and got.dtype == np.float32
    assert abs(got.mean() - 1.0) < 0.15 and abs(got.std() - 2.0) < 0.15
    got = run_torch("uniform_random", {}, {"shape": shape, "min": -3.0,
                                           "max": 1.0})["Out"][0].numpy()
    assert got.shape == tuple(shape)
    assert got.min() >= -3.0 and got.max() <= 1.0
    assert abs(got.mean() + 1.0) < 0.1   # E = (min+max)/2 = -1
    ctx = TCtx(seed=3, run=1, device="cpu")
    a = TOPS["uniform_random"](ctx, {}, {"shape": [64]})["Out"][0]
    b = TOPS["uniform_random"](ctx, {}, {"shape": [64]})["Out"][0]
    c = TOPS["uniform_random"](TCtx(seed=3, run=1, device="cpu"), {},
                               {"shape": [64]})["Out"][0]
    assert not torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(Exception, match="needs RNG"):
        TOPS["uniform_random"](TCtx(device="cpu"), {}, {"shape": [2]})


def test_dropout_training_statistics():
    """Training-mode dropout: kept share within 5 sigma of 1 - p, kept
    values x / (1 - p), the rest 0; a LoD input stays a LoD output."""
    x = np.ones((200, 50), np.float32) * 2.0
    out = run_torch("dropout", {"X": [x]}, {"dropout_prob": 0.3},
                    is_test=False)["Out"][0].numpy()
    kept = out != 0
    n = out.size
    assert abs(kept.mean() - 0.7) < 5 * np.sqrt(0.21 / n)
    np.testing.assert_allclose(out[kept], 2.0 / 0.7, rtol=1e-6)
    seq = Seq(np.ones((2, 3, 4), np.float32), [3, 1])
    out = run_torch("dropout", {"X": [seq]}, {"dropout_prob": 0.5},
                    is_test=False)["Out"][0]
    assert isinstance(out, TSeq) and out.length.tolist() == [3, 1]


def test_op_context_defaults_to_cuda(monkeypatch):
    """An op context without a device means CUDA, and raises without it."""
    from paddle_tpu_torch.utils import PaddleTpuError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PaddleTpuError, match="no CUDA device"):
        TCtx()
