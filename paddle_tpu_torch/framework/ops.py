"""Framework op registry — the ``paddle/operators`` inventory as torch
adapters (counterpart of ``paddle_tpu/framework/ops.py``, with the same
108 names).

Each op is ``fn(ctx, ins, attrs) -> outs`` where ``ins``/``outs`` map slot
names to lists of tensors, mirroring ``OpDesc``'s name-keyed var lists
(``paddle/framework/framework.proto:33-60``).  The Executor runs the ops
of a block one after another in eager torch, so an op here is a thin
adapter over the port's op modules (``paddle_tpu_torch/ops/``); the
``lstm`` op reaches the fused LSTM kernels through
``recurrent_ops.lstm_sequence``'s dispatch, as the JAX op reaches its
Pallas kernels.

Random ops and dropout draw from a ``torch.Generator`` on the context's
device (:meth:`OpContext.next_key`), seeded from the run's seed, the run
count and the op's place in the run: the draws differ from the JAX
package's, and are held to it by their statistics.

Kept from the reference as they are: ``mul`` drops the LoD of its input,
``lstm`` returns its input as ``BatchGate`` and ``BatchCellPreAct``, and
``gru_unit`` returns the new hidden state as ``Gate`` and
``ResetHiddenPrev``.  Control flow (recurrent, cond), IO
(feed/fetch/save/load), ``backward`` and collectives are owned by the
Executor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.dtypes import dtype_name
from ..core.sequence import SequenceBatch, value_of
from ..ops import activations as A
from ..ops import crf_ops, loss_ops, math_ops, nn_ops
from ..ops import recurrent_ops, sequence_ops
from ..utils import enforce

OPS: Dict[str, Callable] = {}


def register_op(name: str, *aliases: str):
    def deco(fn):
        OPS[name] = fn
        for a in aliases:
            OPS[a] = fn
        return fn
    return deco


@dataclass
class OpContext:
    """Run-time context handed to every op: the mode, the device that
    ops creating tensors (``fill_constant``, the random ops) place them
    on (``None``: CUDA, raising without it), and the seed of the run's
    random draws."""

    is_test: bool = False
    seed: Optional[int] = None     # None: an op that draws raises
    run: int = 0
    device: Any = None
    _n: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def next_key(self) -> torch.Generator:
        """A generator on the context's device for the next op that
        draws, seeded from (seed, run, the op's draw counter)."""
        enforce(self.seed is not None, "op needs RNG but none was provided")
        self._n += 1
        mixed = ((int(self.seed) * 1000003 + self.run) * 1000003
                 + self._n) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(mixed)


def _torch_dtype(dtype) -> torch.dtype:
    """A dtype name, numpy dtype or torch dtype as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype_name(dtype))


def _in(ins, slot, i=0, default=None):
    vs = ins.get(slot) or []
    return vs[i] if len(vs) > i else default


def _wrap_like(ref, data):
    """Preserve SequenceBatch structure for pointwise ops."""
    if isinstance(ref, SequenceBatch):
        return SequenceBatch(data, ref.length)
    return data


def _pointwise(fn):
    code = fn.__code__
    params = code.co_varnames[:code.co_argcount + code.co_kwonlyargcount]

    def op(ctx, ins, attrs):
        x = _in(ins, "X")
        out = fn(value_of(x), **{k: v for k, v in attrs.items()
                                 if k in params})
        return {"Out": [_wrap_like(x, out)]}
    return op


# ----------------------------------------------------------- activations
_ACTS = dict(
    abs=A.abs_, brelu=A.brelu, elu=A.elu, exp=A.exp,
    hard_shrink=A.hard_shrink, hard_sigmoid=A.hard_sigmoid,
    leaky_relu=A.leaky_relu, log=A.log, logsigmoid=A.logsigmoid,
    pow=A.pow_, reciprocal=A.reciprocal, relu=A.relu, relu6=A.relu6,
    sigmoid=A.sigmoid, soft_relu=A.soft_relu, softplus=A.softplus,
    softshrink=A.softshrink, softsign=A.softsign, sqrt=A.sqrt,
    square=A.square, stanh=A.stanh, tanh=A.tanh, tanh_shrink=A.tanh_shrink,
    thresholded_relu=A.thresholded_relu, sign=math_ops.sign,
)
for _name, _fn in _ACTS.items():
    register_op(_name)(_pointwise(_fn))


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    x = _in(ins, "X")
    return {"Out": [_wrap_like(x, A.softmax(value_of(x)))]}


@register_op("sequence_softmax")
def _seq_softmax(ctx, ins, attrs):
    x = _in(ins, "X")
    enforce(isinstance(x, SequenceBatch), "sequence_softmax needs LoD input")
    out = A.sequence_softmax(x.data, mask=x.mask())
    return {"Out": [SequenceBatch(out, x.length)]}


# ------------------------------------------------------------------ math
@register_op("mul")
def _mul(ctx, ins, attrs):
    x, y = value_of(_in(ins, "X")), value_of(_in(ins, "Y"))
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape((int(np.prod(xs[:xd])), -1)) if x.dim() > 2 else x
    y2 = y.reshape((int(np.prod(ys[:yd])), -1)) if y.dim() > 2 else y
    out = x2 @ y2
    if x.dim() > 2 or y.dim() > 2:
        # reference mul_op output shape: xs[:x_num_col_dims] + ys[y_num_col_dims:]
        out = out.reshape(xs[:xd] + ys[yd:])
    return {"Out": [out]}


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    out = math_ops.matmul(value_of(_in(ins, "X")), value_of(_in(ins, "Y")),
                          attrs.get("transpose_X", False),
                          attrs.get("transpose_Y", False))
    return {"Out": [out]}


@register_op("sum")
def _sum(ctx, ins, attrs):
    xs = [value_of(v) for v in ins.get("X", [])]
    return {"Out": [math_ops.sum_arrays(*xs)]}


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = _in(ins, "X")
    out = math_ops.scale(value_of(x), attrs.get("scale", 1.0),
                         attrs.get("bias", 0.0))
    return {"Out": [_wrap_like(x, out)]}


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [math_ops.mean(value_of(_in(ins, "X")))]}


@register_op("minus")
def _minus(ctx, ins, attrs):
    return {"Out": [math_ops.minus(value_of(_in(ins, "X")),
                                   value_of(_in(ins, "Y")))]}


@register_op("increment")
def _increment(ctx, ins, attrs):
    return {"Out": [math_ops.increment(value_of(_in(ins, "X")),
                                       attrs.get("step", 1.0))]}


@register_op("clip")
def _clip(ctx, ins, attrs):
    x = _in(ins, "X")
    out = math_ops.clip(value_of(x), attrs.get("min", attrs.get("Min")),
                        attrs.get("max", attrs.get("Max")))
    return {"Out": [_wrap_like(x, out)]}


@register_op("cast")
def _cast(ctx, ins, attrs):
    x = _in(ins, "X")
    return {"Out": [_wrap_like(x, math_ops.cast(
        value_of(x), _torch_dtype(attrs["dtype"])))]}


for _nm, _f in [("elementwise_add", math_ops.elementwise_add),
                ("elementwise_sub", math_ops.elementwise_sub),
                ("elementwise_mul", math_ops.elementwise_mul),
                ("elementwise_div", math_ops.elementwise_div)]:
    def _mk(f):
        def op(ctx, ins, attrs):
            x = _in(ins, "X")
            out = f(value_of(x), value_of(_in(ins, "Y")),
                    attrs.get("axis", -1))
            return {"Out": [_wrap_like(x, out)]}
        return op
    register_op(_nm)(_mk(_f))

for _nm, _f in [("reduce_sum", math_ops.reduce_sum),
                ("reduce_mean", math_ops.reduce_mean),
                ("reduce_max", math_ops.reduce_max),
                ("reduce_min", math_ops.reduce_min)]:
    def _mkr(f):
        def op(ctx, ins, attrs):
            out = f(value_of(_in(ins, "X")), attrs.get("dim"),
                    attrs.get("keep_dim", False))
            return {"Out": [out]}
        return op
    register_op(_nm)(_mkr(_f))


@register_op("reshape")
def _reshape(ctx, ins, attrs):
    return {"Out": [math_ops.reshape(value_of(_in(ins, "X")),
                                     attrs["shape"])]}


@register_op("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": [math_ops.transpose(value_of(_in(ins, "X")),
                                       attrs.get("axis"))]}


@register_op("concat")
def _concat(ctx, ins, attrs):
    xs = [value_of(v) for v in ins.get("X", [])]
    return {"Out": [math_ops.concat(*xs, axis=attrs.get("axis", 1))]}


@register_op("split")
def _split(ctx, ins, attrs):
    x = value_of(_in(ins, "X"))
    sections = attrs.get("sections") or attrs.get("num", 2)
    outs = math_ops.split(x, sections, attrs.get("axis", 1))
    return {"Out": list(outs)}


@register_op("pad")
def _pad(ctx, ins, attrs):
    p = attrs["paddings"]
    pairs = list(zip(p[::2], p[1::2]))
    return {"Out": [math_ops.pad(value_of(_in(ins, "X")), pairs,
                                 attrs.get("pad_value", 0.0))]}


@register_op("crop")
def _crop(ctx, ins, attrs):
    return {"Out": [math_ops.crop(value_of(_in(ins, "X")),
                                  attrs["offsets"], attrs["shape"])]}


@register_op("gather")
def _gather(ctx, ins, attrs):
    return {"Out": [math_ops.gather(value_of(_in(ins, "X")),
                                    value_of(_in(ins, "Index")))]}


@register_op("scatter")
def _scatter(ctx, ins, attrs):
    return {"Out": [math_ops.scatter(value_of(_in(ins, "Ref")),
                                     value_of(_in(ins, "Index")),
                                     value_of(_in(ins, "Updates")))]}


@register_op("top_k")
def _top_k(ctx, ins, attrs):
    vals, idx = math_ops.top_k(value_of(_in(ins, "X")), attrs.get("k", 1))
    return {"Out": [vals], "Indices": [idx]}


@register_op("multiplex")
def _multiplex(ctx, ins, attrs):
    idx = value_of(_in(ins, "Ids"))
    xs = [value_of(v) for v in ins.get("X", [])]
    return {"Out": [math_ops.multiplex(idx.reshape(-1), *xs)]}


@register_op("fill_constant")
def _fill_constant(ctx, ins, attrs):
    return {"Out": [math_ops.fill_constant(
        attrs["shape"], attrs["value"],
        _torch_dtype(attrs.get("dtype", torch.float32)), device=ctx.device)]}


@register_op("fill_constant_batch_size_like")
def _fill_cbsl(ctx, ins, attrs):
    return {"Out": [math_ops.fill_constant_batch_size_like(
        value_of(_in(ins, "Input")), attrs["shape"], attrs["value"])]}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    x = _in(ins, "X")
    return {"Out": [_wrap_like(x, math_ops.fill_zeros_like(value_of(x)))]}


@register_op("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    out = math_ops.gaussian_random(ctx.next_key(), attrs["shape"],
                                   attrs.get("mean", 0.0),
                                   attrs.get("std", 1.0))
    return {"Out": [out]}


@register_op("uniform_random")
def _uniform_random(ctx, ins, attrs):
    out = math_ops.uniform_random(ctx.next_key(), attrs["shape"],
                                  attrs.get("min", -1.0),
                                  attrs.get("max", 1.0))
    return {"Out": [out]}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    out = math_ops.cos_sim(value_of(_in(ins, "X")), value_of(_in(ins, "Y")))
    return {"Out": [out.reshape(-1, 1)]}


@register_op("conv_shift")
def _conv_shift(ctx, ins, attrs):
    return {"Out": [math_ops.conv_shift(value_of(_in(ins, "X")),
                                        value_of(_in(ins, "Y")))]}


# -------------------------------------------------------------------- nn
@register_op("conv2d", "conv_cudnn")
def _conv2d(ctx, ins, attrs):
    """NCHW input [N,C,H,W], filter [Cout,Cin/g,KH,KW] (reference layout,
    ``conv2d`` in ``paddle/operators/conv_op.cc``)."""
    x = value_of(_in(ins, "Input"))
    w = value_of(_in(ins, "Filter"))
    w_hwio = w.permute(2, 3, 1, 0)
    s = attrs.get("strides", [1, 1])
    p = attrs.get("paddings", [0, 0])
    d = attrs.get("dilations", [1, 1])
    out = nn_ops.conv2d(x, w_hwio, stride=tuple(s),
                        padding=[(p[0], p[0]), (p[1], p[1])],
                        dilation=tuple(d), groups=attrs.get("groups", 1),
                        data_format="NCHW")
    return {"Output": [out]}


@register_op("conv2d_transpose", "conv2d_transpose_cudnn")
def _conv2d_transpose(ctx, ins, attrs):
    x = value_of(_in(ins, "Input"))
    w = value_of(_in(ins, "Filter"))   # [Cin, Cout, KH, KW]
    s = attrs.get("strides", [1, 1])
    p = attrs.get("paddings", [0, 0])
    # helper wants [KH, KW, Cout, Cin]; it owns the reference
    # (i-1)·s + k − 2p sizing for explicit padding
    w_hwio = w.permute(2, 3, 1, 0)
    out = nn_ops.conv2d_transpose(x, w_hwio, stride=tuple(s),
                                  padding=[(p[0], p[0]), (p[1], p[1])],
                                  data_format="NCHW")
    return {"Output": [out]}


@register_op("pool2d", "pool2d_cudnn")
def _pool2d(ctx, ins, attrs):
    out = nn_ops.pool2d(value_of(_in(ins, "X")),
                        pool_type=attrs.get("pooling_type", "max"),
                        window=tuple(attrs.get("ksize", [2, 2])),
                        stride=tuple(attrs.get("strides", [2, 2])),
                        padding=tuple(attrs.get("paddings", [0, 0])),
                        data_format="NCHW",
                        global_pooling=attrs.get("global_pooling", False))
    return {"Out": [out]}


@register_op("pool3d")
def _pool3d(ctx, ins, attrs):
    x = value_of(_in(ins, "X"))
    k = attrs.get("ksize", [2, 2, 2])
    s = attrs.get("strides", k)
    if attrs.get("global_pooling", False):
        if attrs.get("pooling_type", "max") == "max":
            return {"Out": [x.amax((2, 3, 4), keepdim=True)]}
        return {"Out": [x.mean((2, 3, 4), keepdim=True)]}
    # unpadded windows ("VALID"): the average divides by the whole window
    if attrs.get("pooling_type", "max") == "max":
        out = F.max_pool3d(x, tuple(k), tuple(s))
    else:
        out = F.avg_pool3d(x, tuple(k), tuple(s))
    return {"Out": [out]}


@register_op("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, ins, attrs):
    x = value_of(_in(ins, "X"))
    # primitive is NHWC; convert
    xt = x.permute(0, 2, 3, 1)
    out, idx = nn_ops.max_pool2d_with_index(
        xt, window=tuple(attrs.get("ksize", [2, 2])),
        stride=tuple(attrs.get("strides", [2, 2])),
        padding=attrs.get("paddings", [0, 0])[0])
    return {"Out": [out.permute(0, 3, 1, 2)],
            "Mask": [idx.permute(0, 3, 1, 2)]}


@register_op("max_pool3d_with_index")
def _max_pool3d_with_index(ctx, ins, attrs):
    x = value_of(_in(ins, "X"))
    k = tuple(attrs.get("ksize", [2, 2, 2]))
    s = tuple(attrs.get("strides", k))
    out = F.max_pool3d(x, k, s)
    return {"Out": [out],
            "Mask": [torch.zeros(out.shape, dtype=torch.int32,
                                 device=out.device)]}


@register_op("batch_norm")
def _batch_norm(ctx, ins, attrs):
    x = value_of(_in(ins, "X"))
    y, rm, rv = nn_ops.batch_norm(
        x, value_of(_in(ins, "Scale")), value_of(_in(ins, "Bias")),
        value_of(_in(ins, "Mean")), value_of(_in(ins, "Variance")),
        momentum=attrs.get("momentum", 0.9),
        eps=attrs.get("epsilon", 1e-5),
        is_training=not attrs.get("is_test", ctx.is_test),
        data_format="NCHW" if x.dim() == 4 else "NC")
    return {"Y": [y], "MeanOut": [rm], "VarianceOut": [rv],
            "SavedMean": [rm], "SavedVariance": [rv]}


@register_op("lrn")
def _lrn(ctx, ins, attrs):
    x = value_of(_in(ins, "X"))        # NCHW
    xt = x.permute(0, 2, 3, 1)
    out = nn_ops.lrn(xt, n=attrs.get("n", 5), k=attrs.get("k", 2.0),
                     alpha=attrs.get("alpha", 1e-4),
                     beta=attrs.get("beta", 0.75))
    return {"Out": [out.permute(0, 3, 1, 2)],
            "MidOut": [torch.zeros_like(x)]}


@register_op("dropout")
def _dropout(ctx, ins, attrs):
    x = _in(ins, "X")
    is_test = attrs.get("is_test", ctx.is_test)
    rate = attrs.get("dropout_prob", 0.5)
    if is_test:
        out = value_of(x)
    else:
        out = nn_ops.dropout(value_of(x), ctx.next_key(), rate, True)
    return {"Out": [_wrap_like(x, out)],
            "Mask": [torch.ones_like(value_of(x))]}


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    return {"Out": [nn_ops.prelu(value_of(_in(ins, "X")),
                                 value_of(_in(ins, "Alpha")))]}


# ------------------------------------------------------------- embedding
@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    w = value_of(_in(ins, "W"))
    ids = _in(ins, "Ids")
    if isinstance(ids, SequenceBatch):
        data = ids.data
        if data.dim() > 2 and data.shape[-1] == 1:
            data = data[..., 0]
        return {"Out": [SequenceBatch(w[data], ids.length)]}
    iv = value_of(ids)
    if iv.dim() == 2 and iv.shape[-1] == 1:
        iv = iv[:, 0]
    return {"Out": [w[iv]]}


# ----------------------------------------------------------------- loss
@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    x = value_of(_in(ins, "X"))
    label = value_of(_in(ins, "Label"))
    if attrs.get("soft_label", False):
        out = loss_ops.cross_entropy(x, label, soft_label=True)
    else:
        out = loss_ops.cross_entropy(x, label.reshape(-1))
    return {"Y": [out.reshape(-1, 1)]}


@register_op("softmax_with_cross_entropy")
def _softmax_with_ce(ctx, ins, attrs):
    logits = value_of(_in(ins, "Logits"))
    label = value_of(_in(ins, "Label"))
    soft = attrs.get("soft_label", False)
    loss = loss_ops.softmax_with_cross_entropy(
        logits, label if soft else label.reshape(-1), soft_label=soft)
    return {"Softmax": [A.softmax(logits)], "Loss": [loss.reshape(-1, 1)]}


@register_op("sigmoid_cross_entropy_with_logits")
def _sig_ce(ctx, ins, attrs):
    out = loss_ops.sigmoid_cross_entropy_with_logits(
        value_of(_in(ins, "X")), value_of(_in(ins, "Label")))
    return {"Out": [out]}


@register_op("smooth_l1_loss")
def _smooth_l1(ctx, ins, attrs):
    out = loss_ops.smooth_l1_loss(value_of(_in(ins, "X")),
                                  value_of(_in(ins, "Y")),
                                  attrs.get("sigma", 1.0))
    return {"Out": [out.reshape(-1, 1)], "Diff": [out]}


@register_op("huber_loss")
def _huber(ctx, ins, attrs):
    out = loss_ops.huber_loss(value_of(_in(ins, "X")),
                              value_of(_in(ins, "Y")),
                              attrs.get("delta", 1.0))
    return {"Out": [out.reshape(-1, 1)], "Residual": [out]}


@register_op("modified_huber_loss")
def _modified_huber(ctx, ins, attrs):
    out = loss_ops.modified_huber_loss(value_of(_in(ins, "X")),
                                       value_of(_in(ins, "Y")))
    return {"Out": [out.reshape(-1, 1)],
            "IntermediateVal": [out]}


@register_op("rank_loss")
def _rank_loss(ctx, ins, attrs):
    out = loss_ops.rank_loss(value_of(_in(ins, "Left")),
                             value_of(_in(ins, "Right")),
                             value_of(_in(ins, "Label")))
    return {"Out": [out]}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    out = loss_ops.margin_rank_loss(value_of(_in(ins, "X1")),
                                    value_of(_in(ins, "X2")),
                                    value_of(_in(ins, "Label")),
                                    attrs.get("margin", 0.0))
    return {"Out": [out], "Activated": [out]}


@register_op("squared_l2_distance")
def _sq_l2_dist(ctx, ins, attrs):
    out = loss_ops.squared_l2_distance(value_of(_in(ins, "X")),
                                       value_of(_in(ins, "Y")))
    return {"Out": [out.reshape(-1, 1)], "sub_result": [out]}


@register_op("squared_l2_norm")
def _sq_l2_norm(ctx, ins, attrs):
    return {"Out": [loss_ops.squared_l2_norm(value_of(_in(ins, "X")))]}


@register_op("l1_norm")
def _l1_norm(ctx, ins, attrs):
    return {"Out": [loss_ops.l1_norm(value_of(_in(ins, "X")))]}


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx, ins, attrs):
    em = _in(ins, "Emission")
    lab = _in(ins, "Label")
    w = value_of(_in(ins, "Transition"))
    enforce(isinstance(em, SequenceBatch), "crf wants LoD emissions")
    nll = crf_ops.crf_nll(em, lab, w)
    return {"LogLikelihood": [(-nll).reshape(-1, 1)],
            "Alpha": [em.data], "EmissionExps": [em.data],
            "TransitionExps": [w]}


@register_op("crf_decoding")
def _crf_decoding(ctx, ins, attrs):
    em = _in(ins, "Emission")
    w = value_of(_in(ins, "Transition"))
    path = crf_ops.crf_decode(em, w)
    return {"ViterbiPath": [path]}


# --------------------------------------------------------------- metrics
@register_op("accuracy")
def _accuracy(ctx, ins, attrs):
    out = value_of(_in(ins, "Out"))
    label = value_of(_in(ins, "Label")).reshape(-1)
    k = attrs.get("k", 1)
    if k <= 1:
        hit = torch.argmax(out, dim=-1) == label
    else:
        _, topk = math_ops.top_k(out, k)
        hit = torch.any(topk == label[:, None], dim=-1)
    correct = torch.sum(hit.to(torch.float32))
    total = torch.tensor(float(label.shape[0]), dtype=torch.float32,
                         device=out.device)
    return {"Accuracy": [correct / total], "Correct": [correct],
            "Total": [total]}


@register_op("auc")
def _auc(ctx, ins, attrs):
    # streaming AUC is host-side in practice; provide a batch AUC estimate
    out = value_of(_in(ins, "Out"))
    label = value_of(_in(ins, "Label")).reshape(-1)
    score = out[:, 1] if out.dim() == 2 and out.shape[1] > 1 \
        else out.reshape(-1)
    order = torch.argsort(score, stable=True)
    ranks = torch.zeros_like(score).scatter(0, order, torch.arange(
        1, score.shape[0] + 1, dtype=score.dtype, device=score.device))
    pos = (label > 0).to(score.dtype)
    n_pos = torch.sum(pos)
    n_neg = label.shape[0] - n_pos
    auc = (torch.sum(ranks * pos) - n_pos * (n_pos + 1) / 2) / \
        torch.clamp(n_pos * n_neg, min=1.0)
    return {"AUC": [auc]}


@register_op("precision_recall")
def _precision_recall(ctx, ins, attrs):
    out = value_of(_in(ins, "Out"))
    label = value_of(_in(ins, "Label")).reshape(-1)
    ncls = out.shape[-1]
    pred = torch.argmax(out, -1)
    onehot_p = F.one_hot(pred, ncls).to(out.dtype)
    onehot_l = F.one_hot(label.long(), ncls).to(out.dtype)
    tp = torch.sum(onehot_p * onehot_l, 0)
    fp = torch.sum(onehot_p * (1 - onehot_l), 0)
    fn = torch.sum((1 - onehot_p) * onehot_l, 0)
    prec = tp / torch.clamp(tp + fp, min=1.0)
    rec = tp / torch.clamp(tp + fn, min=1.0)
    return {"BatchMetrics": [torch.stack([prec, rec])],
            "AccumMetrics": [torch.stack([prec, rec])],
            "AccumStatesInfo": [torch.stack([tp, fp, fn])]}


# -------------------------------------------------------------- sequence
@register_op("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    x = _in(ins, "X")
    enforce(isinstance(x, SequenceBatch), "sequence_pool needs LoD input")
    out = sequence_ops.sequence_pool(x, attrs.get("pooltype",
                                                  "AVERAGE").lower())
    return {"Out": [out]}


@register_op("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    xs = ins.get("X", [])
    a, b = xs[0], xs[1]
    if attrs.get("axis", 0) == 0:
        return {"Out": [sequence_ops.sequence_concat(a, b)]}
    return {"Out": [SequenceBatch(
        torch.cat([a.data, b.data], dim=-1), a.length)]}


@register_op("seq_expand")
def _seq_expand(ctx, ins, attrs):
    x = value_of(_in(ins, "X"))
    y = _in(ins, "Y")
    return {"Out": [sequence_ops.seq_expand(x, y)]}


@register_op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    x = _in(ins, "X")
    w = value_of(_in(ins, "Filter"))
    out = sequence_ops.sequence_conv(
        x, w, attrs.get("contextStart", -1),
        attrs.get("contextLength", 3))
    return {"Out": [out]}


# -------------------------------------------------------------- recurrent
@register_op("lstm")
def _lstm(ctx, ins, attrs):
    x = _in(ins, "Input")
    enforce(isinstance(x, SequenceBatch), "lstm op wants LoD input")
    w = value_of(_in(ins, "Weight"))       # [H, 4H] recurrent weight
    bias = _in(ins, "Bias")
    # op contract (lstm_op.cc): candidate_activation acts on the
    # candidate c̃; cell_activation acts on the cell when forming
    # h = o·act(c).  lstm_gate_step's cell_act is the candidate slot
    # and out_act the output slot, hence the cross mapping.
    h_seq, final, c_seq = recurrent_ops.lstm_sequence(
        x, None, w, value_of(bias) if bias is not None else None,
        reverse=attrs.get("is_reverse", False),
        gate_act=attrs.get("gate_activation", "sigmoid"),
        cell_act=attrs.get("candidate_activation", "tanh"),
        out_act=attrs.get("cell_activation", "tanh"),
        return_cells=True)
    return {"Hidden": [h_seq], "Cell": [c_seq],
            "BatchGate": [x.data], "BatchCellPreAct": [x.data]}


@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    # recurrent_ops.lstm_unit returns (c, h) — C first
    c, h = recurrent_ops.lstm_unit(value_of(_in(ins, "X")),
                                   value_of(_in(ins, "C_prev")),
                                   attrs.get("forget_bias", 0.0))
    return {"H": [h], "C": [c]}


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    h = recurrent_ops.gru_unit(value_of(_in(ins, "Input")),
                               value_of(_in(ins, "HiddenPrev")),
                               value_of(_in(ins, "Weight")))
    return {"Hidden": [h], "Gate": [h], "ResetHiddenPrev": [h]}


# -------------------------------------------------------- optimizer ops
@register_op("sgd")
def _sgd(ctx, ins, attrs):
    p = value_of(_in(ins, "Param"))
    g = value_of(_in(ins, "Grad"))
    lr = value_of(_in(ins, "LearningRate"))
    return {"ParamOut": [p - lr * g]}


@register_op("momentum")
def _momentum(ctx, ins, attrs):
    p, g = value_of(_in(ins, "Param")), value_of(_in(ins, "Grad"))
    v = value_of(_in(ins, "Velocity"))
    lr = value_of(_in(ins, "LearningRate"))
    mu = attrs.get("mu", 0.9)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - lr * (g + mu * v_new)
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


@register_op("adam")
def _adam(ctx, ins, attrs):
    p, g = value_of(_in(ins, "Param")), value_of(_in(ins, "Grad"))
    m, v = value_of(_in(ins, "Moment1")), value_of(_in(ins, "Moment2"))
    b1p = value_of(_in(ins, "Beta1Pow"))
    b2p = value_of(_in(ins, "Beta2Pow"))
    lr = value_of(_in(ins, "LearningRate"))
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return {"ParamOut": [p_new], "Moment1Out": [m_new],
            "Moment2Out": [v_new]}


@register_op("adamax")
def _adamax(ctx, ins, attrs):
    p, g = value_of(_in(ins, "Param")), value_of(_in(ins, "Grad"))
    m = value_of(_in(ins, "Moment"))
    u = value_of(_in(ins, "InfNorm"))
    b1p = value_of(_in(ins, "Beta1Pow"))
    lr = value_of(_in(ins, "LearningRate"))
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    u_new = torch.maximum(b2 * u, torch.abs(g))
    p_new = p - (lr / (1 - b1p * b1)) * m_new / (u_new + eps)
    return {"ParamOut": [p_new], "MomentOut": [m_new],
            "InfNormOut": [u_new]}


@register_op("adagrad")
def _adagrad(ctx, ins, attrs):
    p, g = value_of(_in(ins, "Param")), value_of(_in(ins, "Grad"))
    mom = value_of(_in(ins, "Moment"))
    lr = value_of(_in(ins, "LearningRate"))
    eps = attrs.get("epsilon", 1e-6)
    m_new = mom + g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("adadelta")
def _adadelta(ctx, ins, attrs):
    p, g = value_of(_in(ins, "Param")), value_of(_in(ins, "Grad"))
    ag = value_of(_in(ins, "AvgSquaredGrad"))
    au = value_of(_in(ins, "AvgSquaredUpdate"))
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    ag_new = rho * ag + (1 - rho) * g * g
    upd = torch.sqrt(au + eps) / torch.sqrt(ag_new + eps) * g
    au_new = rho * au + (1 - rho) * upd * upd
    return {"ParamOut": [p - upd], "AvgSquaredGradOut": [ag_new],
            "AvgSquaredUpdateOut": [au_new]}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    p, g = value_of(_in(ins, "Param")), value_of(_in(ins, "Grad"))
    mom = value_of(_in(ins, "Moment"))
    lr = value_of(_in(ins, "LearningRate"))
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_new = decay * mom + (1 - decay) * g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("rmsprop")
def _rmsprop(ctx, ins, attrs):
    p, g = value_of(_in(ins, "Param")), value_of(_in(ins, "Grad"))
    ms = value_of(_in(ins, "MeanSquare"))
    mom = value_of(_in(ins, "Moment"))
    lr = value_of(_in(ins, "LearningRate"))
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * g * g
    mom_new = momentum * mom + lr * g / torch.sqrt(ms_new + eps)
    return {"ParamOut": [p - mom_new], "MomentOut": [mom_new],
            "MeanSquareOut": [ms_new]}


@register_op("proximal_gd")
def _proximal_gd(ctx, ins, attrs):
    p, g = value_of(_in(ins, "Param")), value_of(_in(ins, "Grad"))
    lr = value_of(_in(ins, "LearningRate"))
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    prox = p - lr * g
    p_new = torch.sign(prox) * torch.clamp(
        torch.abs(prox) - lr * l1, min=0.0) / (1.0 + lr * l2)
    return {"ParamOut": [p_new]}


@register_op("proximal_adagrad")
def _proximal_adagrad(ctx, ins, attrs):
    p, g = value_of(_in(ins, "Param")), value_of(_in(ins, "Grad"))
    mom = value_of(_in(ins, "Moment"))
    lr = value_of(_in(ins, "LearningRate"))
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    m_new = mom + g * g
    lr_t = lr / torch.sqrt(m_new + 1e-10)
    prox = p - lr_t * g
    p_new = torch.sign(prox) * torch.clamp(
        torch.abs(prox) - lr_t * l1, min=0.0) / (1.0 + lr_t * l2)
    return {"ParamOut": [p_new], "MomentOut": [m_new]}
