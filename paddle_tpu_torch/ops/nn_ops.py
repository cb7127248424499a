"""Convolution, pooling and batch-norm ops of the image slice
(counterpart of ``paddle_tpu/ops/nn_ops.py``: ``conv2d``, ``pool2d``,
``batch_norm`` and the fused conv/BN family), and the ``dropout`` and
``feature_map_expand`` of the dense layers.

Layouts are the JAX package's: NHWC activations, HWIO weights.  The
general conv is a library conv (``F.conv2d`` on channels-last views), as
the JAX package leaves it to XLA; the 1×1 stride-1 conv is a matmul over
the flattened pixels, as there.  The JAX package reformulates the
7×7/stride-2 stem by space-to-depth for the TPU's matrix unit; the port
computes the same conv directly.

The fused family dispatches as the JAX functions do, with the same gates
(:mod:`paddle_tpu_torch.ops.conv`), and records each decision in
:data:`conv_dispatch` keyed ``(op, path, reason)`` with the labels of
the JAX package's ``conv_dispatch_total`` counter.

Batch statistics are the JAX package's, not ``F.batch_norm``'s: the
biased v = max(E[x²] − E[x]², 0) in f32, running averages new = m·old +
(1 − m)·batch with m = ``moving_average_fraction`` (0.9), eps 1e-5.
"""

from __future__ import annotations

import collections
import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from ..core.dtypes import current_policy, record_op_precision
from ..utils import enforce
from .activations import get_activation

IntOr2 = Union[int, Tuple[int, int]]

#: Lowering decisions of the fused conv/BN family, counted by
#: ``(op, path, reason)`` (``conv_dispatch_total`` of the JAX package,
#: which counts once per traced call).
conv_dispatch: "collections.Counter" = collections.Counter()


def _record_conv_dispatch(op: str, path: str, reason: str = "") -> None:
    conv_dispatch[(op, path, reason)] += 1


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _explicit_pads(padding, in_hw, k_hw, stride, dilation):
    """[(lo, hi), (lo, hi)] of ``padding`` (an int, a pair of ints, pairs,
    "VALID" or "SAME" as XLA resolves it)."""
    if isinstance(padding, str):
        enforce(padding in ("SAME", "VALID"), f"padding {padding!r}")
        if padding == "VALID":
            return [(0, 0), (0, 0)]
        pads = []
        for i, k, s, d in zip(in_hw, k_hw, stride, dilation):
            out = -(-i // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - i, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        return [(padding, padding)] * 2
    return [_pair(p) for p in padding]


def conv2d(x, w, stride: IntOr2 = 1, padding="SAME", dilation: IntOr2 = 1,
           groups: int = 1, data_format: str = "NHWC") -> torch.Tensor:
    """2-D convolution, x ``[N, H, W, C]``, w ``[KH, KW, Cin/groups,
    Cout]``, in the policy compute dtype, result in the output dtype."""
    enforce(data_format == "NHWC", "only NHWC convolutions are ported")
    pol = current_policy()
    record_op_precision("conv2d")
    x = x.to(pol.compute_dtype)
    w = w.to(pol.compute_dtype)
    stride, dilation = _pair(stride), _pair(dilation)
    pads = _explicit_pads(padding, x.shape[1:3], w.shape[:2], stride,
                          dilation)
    if (groups == 1 and x.dim() == 4 and tuple(w.shape[:2]) == (1, 1)
            and stride == (1, 1) and dilation == (1, 1)
            and pads == [(0, 0), (0, 0)]):
        # a 1×1 stride-1 conv IS a matmul over the flattened pixels
        n, h, ww, cin = x.shape
        out = x.reshape(n * h * ww, cin) @ w.reshape(cin, w.shape[3])
        return out.reshape(n, h, ww, -1).to(pol.output_dtype)
    xc = x.permute(0, 3, 1, 2)
    (ph0, ph1), (pw0, pw1) = pads
    if ph0 != ph1 or pw0 != pw1:
        xc = F.pad(xc, (pw0, pw1, ph0, ph1))
        ph0 = pw0 = 0
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride,
                   padding=(ph0, pw0), dilation=dilation, groups=groups)
    return out.permute(0, 2, 3, 1).to(pol.output_dtype)


def pool2d(x, pool_type: str = "max", window: IntOr2 = 2,
           stride: IntOr2 = 2, padding=0) -> torch.Tensor:
    """Max or average pooling over NHWC.  Max pads with −inf; average
    leaves the padding out of the divisor (cuDNN's
    COUNT_EXCLUDE_PADDING, the reference default)."""
    kh, kw = _pair(window)
    sh, sw = _pair(stride)
    pads = [(padding, padding)] * 2 if isinstance(padding, int) \
        else [_pair(p) for p in padding]
    (ph0, ph1), (pw0, pw1) = pads
    enforce(ph0 == ph1 and pw0 == pw1, "asymmetric pooling pads")
    xc = x.permute(0, 3, 1, 2)
    if pool_type == "max":
        out = F.max_pool2d(xc, (kh, kw), (sh, sw), (ph0, pw0))
    else:
        # the window sums over the window counts, in x's dtype, as
        # ``nn_ops._pool`` divides its two reduce_windows
        summed = F.avg_pool2d(xc, (kh, kw), (sh, sw), (ph0, pw0),
                              count_include_pad=True, divisor_override=1)
        counts = F.avg_pool2d(torch.ones_like(xc[:1, :1]), (kh, kw),
                              (sh, sw), (ph0, pw0), count_include_pad=True,
                              divisor_override=1)
        out = summed / counts
    return out.permute(0, 2, 3, 1)


# ------------------------------------------------------------- batch norm
def _bn_axes(ndim: int, data_format: str):
    c_ax = ndim - 1 if data_format.endswith("C") else 1
    return tuple(i for i in range(ndim) if i != c_ax), c_ax


def _channel_shape(x: torch.Tensor, c_ax: int):
    shape = [1] * x.dim()
    shape[c_ax] = x.shape[c_ax]
    return shape


def _bn_apply(x, scale, bias, m, inv, c_ax):
    """One multiply-add in x's dtype with the per-channel scale/offset
    folded."""
    shape = _channel_shape(x, c_ax)
    a = (inv * scale).to(x.dtype).reshape(shape)
    b = (bias - m * inv * scale).to(x.dtype).reshape(shape)
    return x * a + b


def _bn_stats(x, axes):
    """Per-channel (mean, biased variance) in f32; x is squared in f32
    (a bf16 x·x loses the low bits when |mean| >> std)."""
    xf = x.float()
    m = xf.mean(axes)
    v = torch.clamp_min(xf.square().mean(axes) - m * m, 0.0)
    return m, v


class _BnTrain(torch.autograd.Function):
    """Training-mode batch norm → (y, m, v) with the hand-fused backward
    of ``nn_ops._bn_train_bwd``: dbias = Σdy, dscale = Σdy·x̂, dx =
    scale·inv·(dy − dbias/N − x̂·dscale/N), one reduction pass over (dy,
    x).  The m/v cotangents are dropped (running averages are
    stop-gradient state)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, axes, c_ax):
        m, v = _bn_stats(x, axes)
        inv = torch.rsqrt(v + eps)
        y = _bn_apply(x, scale, bias, m, inv, c_ax)
        ctx.axes, ctx.c_ax = axes, c_ax
        ctx.save_for_backward(x, scale, m, inv)
        ctx.mark_non_differentiable(m, v)
        return y, m, v

    @staticmethod
    def backward(ctx, dy, _dm, _dv):
        x, scale, m, inv = ctx.saved_tensors
        axes, shape = ctx.axes, _channel_shape(x, ctx.c_ax)
        n = float(math.prod(x.shape[i] for i in axes))
        xhat = (x.float() - m.reshape(shape)) * inv.reshape(shape)
        dy_f = dy.float()
        dbias = dy_f.sum(axes)
        dscale = (dy_f * xhat).sum(axes)
        coeff = (scale * inv).float().reshape(shape)
        dx = coeff * (dy_f - (dbias / n).reshape(shape)
                      - xhat * (dscale / n).reshape(shape))
        return (dx.to(x.dtype), dscale.to(scale.dtype),
                dbias.to(scale.dtype), None, None, None)


def _running(old, batch, momentum):
    return momentum * old + (1 - momentum) * batch.detach()


def batch_norm(x, scale, bias, running_mean, running_var,
               momentum: float = 0.9, eps: float = 1e-5,
               is_training: bool = True, data_format: str = "NHWC"):
    """Batch normalization → (y, new_running_mean, new_running_var).
    Training uses the batch statistics (returned by :class:`_BnTrain`,
    not recomputed) and its fused backward; eval the running ones."""
    axes, c_ax = _bn_axes(x.dim(), data_format)
    if is_training:
        y, m, v = _BnTrain.apply(x, scale, bias, eps, axes, c_ax)
        return y, _running(running_mean, m, momentum), \
            _running(running_var, v, momentum)
    inv = torch.rsqrt(running_var + eps)
    return _bn_apply(x, scale, bias, running_mean, inv, c_ax), \
        running_mean, running_var


def bn_folded_affine(x, scale, bias, running_mean, running_var,
                     momentum: float = 0.9, eps: float = 1e-5,
                     is_training: bool = True, data_format: str = "NHWC"):
    """The folded per-channel affine of :func:`batch_norm` without
    applying it, plus the running-stat update: ``(a, c, new_rm, new_rv)``
    with ``batch_norm(x) == a·x + c``.  Gradients reach x through the
    batch statistics (plain tensor code, as the JAX function)."""
    axes, _c_ax = _bn_axes(x.dim(), data_format)
    if is_training:
        m, v = _bn_stats(x, axes)
        new_rm = _running(running_mean, m, momentum)
        new_rv = _running(running_var, v, momentum)
    else:
        m, v = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    inv = torch.rsqrt(v + eps)
    a = (scale * inv).float()
    c = (bias - m * a).float()
    return a, c, new_rm, new_rv


# ----------------------------------------------------------- fused family
def _gemm_prologue_ok(x_shape, w_shape, stride, padding, dilation,
                      groups, data_format) -> bool:
    """Gate of the 1×1 GEMM-prologue path of :func:`affine_act_conv2d`:
    1×1 stride-1 NHWC, groups 1, zero pad."""
    if data_format != "NHWC" or groups != 1:
        return False
    if len(x_shape) != 4 or len(w_shape) != 4 \
            or tuple(w_shape[:2]) != (1, 1):
        return False
    if _pair(stride) != (1, 1) or _pair(dilation) != (1, 1):
        return False
    if isinstance(padding, str):
        return padding in ("SAME", "VALID")
    if isinstance(padding, int):
        return padding == 0
    return [_pair(p) for p in padding] == [(0, 0), (0, 0)]


def _affine_apply(z, a, c, act: str):
    """act(a·z + c) in z's dtype: the unfused BN apply."""
    x = z * a.to(z.dtype) + c.to(z.dtype)
    if act == "relu":
        return torch.relu(x)
    if act in ("", "linear"):
        return x
    return get_activation(act)(x)


class _AffineConv1x1(torch.autograd.Function):
    """act(a·z + c) @ w, the 1×1 stride-1 conv with the upstream BN's
    affine as its prologue (``nn_ops._affine_conv1x1_core``); the
    backward recomputes x from the raw z residual."""

    @staticmethod
    def forward(ctx, z, a, c, w, relu):
        n, h, ww, cin = z.shape
        x = _affine_apply(z, a, c, "relu" if relu else "")
        ctx.relu = relu
        ctx.save_for_backward(z, a, c, w)
        return (x.reshape(n * h * ww, cin) @ w.reshape(cin, -1)) \
            .reshape(n, h, ww, -1)

    @staticmethod
    def backward(ctx, dy):
        z, a, c, w = ctx.saved_tensors
        n, h, ww, cin = z.shape
        cout = w.shape[3]
        u = z * a.to(z.dtype) + c.to(z.dtype)
        x = torch.relu(u) if ctx.relu else u
        dy2 = dy.reshape(n * h * ww, cout)
        t = (dy2 @ w.reshape(cin, cout).t()).reshape(z.shape).float()
        du = torch.where(u > 0, t, torch.zeros_like(t)) if ctx.relu else t
        dz = (a * du).to(z.dtype)
        da = (z.float() * du).sum((0, 1, 2))
        dc = du.sum((0, 1, 2))
        # products of the compute-dtype operands summed in f32
        # (preferred_element_type=float32)
        dw = (x.reshape(n * h * ww, cin).float().t() @ dy2.float()) \
            .reshape(w.shape)
        return dz, da.to(a.dtype), dc.to(c.dtype), dw.to(w.dtype), None


def affine_act_conv2d(z, a, c, w, conv_bias=None, act: str = "relu",
                      is_training: bool = True, stride: IntOr2 = 1,
                      padding="SAME", dilation: IntOr2 = 1,
                      groups: int = 1, data_format: str = "NHWC"):
    """y = conv(act(a·z + c), w): the upstream batch norm's folded
    affine (``a``, ``c``) applied as the conv reads its input.  3×3
    stride-1 pad-1 with 64-multiple channels → kernel 19/20
    (:class:`~paddle_tpu_torch.ops.conv._AffineConvCore`); 1×1 stride-1 →
    the GEMM prologue; anything else (eval mode, other shapes or
    activations) → the exact unfused composition."""
    from . import conv as fused

    pol = current_policy()
    record_op_precision("affine_act_conv2d")
    relu = act == "relu"
    zs, ws = tuple(z.shape), tuple(w.shape)
    fusable_act = act in ("relu", "", "linear")
    if is_training and fusable_act and fused.fusable_fwd(
            zs, ws, stride, padding, dilation, groups, data_format):
        _record_conv_dispatch("affine_act_conv2d", "pallas3x3")
        out = fused._AffineConvCore.apply(
            z.to(pol.compute_dtype), a.float(), c.float(),
            w.to(pol.compute_dtype), relu).to(pol.output_dtype)
    elif is_training and fusable_act and _gemm_prologue_ok(
            zs, ws, stride, padding, dilation, groups, data_format):
        _record_conv_dispatch("affine_act_conv2d", "gemm1x1")
        out = _AffineConv1x1.apply(
            z.to(pol.compute_dtype), a.float(), c.float(),
            w.to(pol.compute_dtype), relu).to(pol.output_dtype)
    else:
        _record_conv_dispatch(
            "affine_act_conv2d", "unfused",
            "eval mode" if not is_training
            else "non-fusable activation" if not fusable_act
            else "off-tile shape/stride/layout")
        out = conv2d(_affine_apply(z, a, c, act), w, stride=stride,
                     padding=padding, dilation=dilation, groups=groups,
                     data_format=data_format)
    if conv_bias is not None:
        out = out + conv_bias
    return out


def conv2d_bn(x, w, conv_bias, scale, bias, running_mean, running_var,
              momentum: float = 0.9, eps: float = 1e-5,
              is_training: bool = True, stride: IntOr2 = 1,
              padding="SAME", dilation: IntOr2 = 1, groups: int = 1,
              data_format: str = "NHWC", in_affine=None):
    """conv (+ conv bias) → batch norm, training: for the 3×3 stride-1
    NHWC family with 64-multiple channels the backward runs kernel 18
    (:class:`~paddle_tpu_torch.ops.conv._ConvBnCore`).  ``in_affine=(a,
    c, act)`` composes the forward fusion: x is then the upstream BN's
    raw input z, and the pair runs kernels 19 and 21
    (:class:`~paddle_tpu_torch.ops.conv._ChainCore`).  Other shapes and
    eval mode take the exact unfused composition.  Returns (y,
    new_running_mean, new_running_var)."""
    from . import conv as fused

    pol = current_policy()
    record_op_precision("conv2d_bn")
    if in_affine is not None:
        a1, c1, act1 = in_affine
        xs, ws = tuple(x.shape), tuple(w.shape)
        if (is_training and act1 in ("relu", "", "linear")
                and fused.fusable(xs, ws, stride, padding, dilation,
                                  groups, data_format)
                and fused.fused_chain_ok(xs[1], xs[2], int(ws[2]),
                                         int(ws[3]))):
            _record_conv_dispatch("conv2d_bn", "chain")
            cb = torch.zeros(ws[3], dtype=torch.float32, device=x.device) \
                if conv_bias is None else conv_bias
            y, m, v = fused._ChainCore.apply(
                x.to(pol.compute_dtype), a1.float(), c1.float(),
                w.to(pol.compute_dtype), cb, scale, bias, eps,
                act1 == "relu")
            return y.to(pol.output_dtype), \
                _running(running_mean, m, momentum), \
                _running(running_var, v, momentum)
        # outside the chain family: apply the affine (the unfused BN
        # apply) and continue as a plain conv→BN pair
        x = _affine_apply(x, a1, c1, act1)
    if not (is_training and fused.fusable(
            tuple(x.shape), tuple(w.shape), stride, padding, dilation,
            groups, data_format)):
        _record_conv_dispatch(
            "conv2d_bn", "unfused",
            "eval mode" if not is_training
            else "off-tile shape/stride/layout")
        z = conv2d(x, w, stride=stride, padding=padding, dilation=dilation,
                   groups=groups, data_format=data_format)
        if conv_bias is not None:
            z = z + conv_bias
        return batch_norm(z, scale, bias, running_mean, running_var,
                          momentum=momentum, eps=eps,
                          is_training=is_training, data_format=data_format)
    _record_conv_dispatch("conv2d_bn", "fused")
    wc = w.to(pol.compute_dtype)
    cb = torch.zeros(wc.shape[3], dtype=torch.float32, device=x.device) \
        if conv_bias is None else conv_bias
    y, m, v = fused._ConvBnCore.apply(x.to(pol.compute_dtype), wc, cb,
                                      scale, bias, eps)
    return y.to(pol.output_dtype), _running(running_mean, m, momentum), \
        _running(running_var, v, momentum)


def dropout(x: torch.Tensor, gen: torch.Generator, rate: float = 0.5,
            is_training: bool = True) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 − rate
    (a uniform draw from ``gen`` below it) and scaled to ``x / keep``,
    the rest 0; the identity in eval or at rate 0.  The gradient is
    ``mask / keep``."""
    if not is_training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def feature_map_expand(x: torch.Tensor, num_filters: int,
                       as_row: bool = True) -> torch.Tensor:
    """Tile ``[B, D]`` into ``[B, num_filters * D]``
    (``FeatureMapExpandLayer``): the whole row repeated, or each element
    repeated in place (``as_row`` False)."""
    b = x.shape[0]
    if as_row:
        return x[:, None, :].expand(b, num_filters, x.shape[1]).reshape(b, -1)
    return x[:, :, None].expand(b, x.shape[1], num_filters).reshape(b, -1)
