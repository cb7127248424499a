"""Convolution, pooling, normalization and image-glue ops (counterpart of
``paddle_tpu/ops/nn_ops.py``): ``conv2d`` / ``conv2d_transpose`` /
``conv3d`` / ``conv3d_transpose``, ``pool2d`` / ``pool3d`` /
``max_pool2d_with_index`` / ``spp``, ``batch_norm`` and the fused conv/BN
family, ``lrn``, ``dropout``, ``maxout``, ``prelu``, ``bilinear_interp``,
``feature_map_expand``, ``block_expand``, ``rotate`` and
``switch_order``, each registered under the JAX package's op name.

Layouts are the JAX package's: NHWC (NDHWC) activations unless
``data_format`` says NCHW, HWIO (DHWIO) weights.  The general conv is a
library conv (``F.conv2d`` / ``F.conv3d`` / ``F.conv_transpose*d``), as
the JAX package leaves it to XLA; the 1×1 stride-1 conv is a matmul over
the flattened pixels, as there.  The JAX package reformulates the
7×7/stride-2 stem by space-to-depth for the TPU's matrix unit; the port
computes the same conv directly.

A transposed conv is the JAX package's "conv of the stride-dilated input
with the flipped kernel" at the pads it gives that conv: the explicit
2-D padding p pads it by k − 1 − p (output (i − 1)·s + k − 2p), a
string padding by ``lax.conv_transpose``'s SAME / VALID pads, and the
3-D op's explicit p by p itself, as ``lax.conv_transpose`` does (output
(i − 1)·s + 2p − k + 2).  The port runs ``F.conv_transpose*d`` at
padding 0 (output (i − 1)·s + k) and crops, or zero-pads, each side to
those pads.

Pooling pads max with −inf and leaves the padding out of an average's
divisor (cuDNN's COUNT_EXCLUDE_PADDING, the reference default), at any
pads, asymmetric ones too.  ``bilinear_interp`` is ``jax.image.resize``'s
bilinear: half-pixel centres, antialiased when it shrinks
(``F.interpolate(antialias=True)``).  ``lrn`` divides by (k + α·Σ x²)^β
over a zero-padded window of n channels (α not divided by n).

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

from ..core.device import data_shard
from ..core.dtypes import current_policy, record_op_precision
from ..observe import counter
from ..utils import PaddleTpuError, enforce
from .activations import get_activation
from .registry import register_op

IntOr2 = Union[int, Tuple[int, int]]

#: Lowering decisions of the fused conv/BN family, counted by
#: ``(op, path, reason)`` (``conv_dispatch_total`` of the JAX package,
#: which counts once per traced call).
conv_dispatch: "collections.Counter" = collections.Counter()


def _record_conv_dispatch(op: str, path: str, reason: str = "") -> None:
    """Count one decision here and in the registry's
    ``conv_dispatch_total{op,path,reason}``."""
    conv_dispatch[(op, path, reason)] += 1
    counter(
        "conv_dispatch_total",
        "conv+BN lowering decisions by tier (trace-time; reason set "
        "when a fusable-looking call took the unfused composition)",
    ).inc(op=op, path=path, reason=reason)


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _tuple(v, n: int) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


def _explicit_pads(padding, in_sp, k_sp, stride, dilation):
    """[(lo, hi), ...] a spatial dim of ``padding`` (an int, ints, pairs,
    "VALID" or "SAME" as XLA resolves it)."""
    n = len(in_sp)
    if isinstance(padding, str):
        enforce(padding in ("SAME", "VALID"), f"padding {padding!r}")
        if padding == "VALID":
            return [(0, 0)] * n
        pads = []
        for i, k, s, d in zip(in_sp, k_sp, stride, dilation):
            out = -(-i // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - i, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        return [(padding, padding)] * n
    return [_pair(p) for p in padding]


def _flat(pads):
    """``F.pad``'s argument for [(lo, hi), ...] over the trailing dims
    (a negative amount crops)."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _channels_first(x, data_format: str):
    return x if data_format[1] == "C" else torch.movedim(x, -1, 1)


def _channels_last(y, data_format: str):
    return y if data_format[1] == "C" else torch.movedim(y, 1, -1)


def _conv_cf(xc, w, stride, pads, dilation=None, groups: int = 1):
    """The N-d conv of channels-first ``xc`` with the channels-last
    weights ``w`` ([*K, I, O]) at pads [(lo, hi), ...]."""
    nd = xc.dim() - 2
    if any(lo != hi or lo < 0 for lo, hi in pads):
        xc = F.pad(xc, _flat(pads))
        pads = [(0, 0)] * nd
    fn = F.conv2d if nd == 2 else F.conv3d
    return fn(xc, w.permute(nd + 1, nd, *range(nd)), stride=stride,
              padding=tuple(lo for lo, _ in pads),
              dilation=dilation or (1,) * nd, groups=groups)


def _conv_transpose_pads(k: int, s: int, padding: str):
    """``lax.conv_transpose``'s pads of the dilated-input conv for a
    SAME or VALID forward padding (``_conv_transpose_padding``)."""
    enforce(padding in ("SAME", "VALID"), f"padding {padding!r}")
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


def _conv_transpose_cf(xc, w, stride, dilated_pads):
    """The conv of the stride-dilated channels-first ``xc`` with the
    spatially flipped kernel of ``w`` ([*K, Cout, Cin]) at
    ``dilated_pads`` [(a, b), ...]: ``F.conv_transpose*d`` at padding 0
    (size (i − 1)·s + k), then each side cropped (or zero-padded) by
    k − 1 − a and k − 1 − b."""
    nd = xc.dim() - 2
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    full = fn(xc, w.permute(nd + 1, nd, *range(nd)), stride=stride)
    ks = w.shape[:nd]
    adj = [(a - (k - 1), b - (k - 1)) for (a, b), k in zip(dilated_pads, ks)]
    if any(lo or hi for lo, hi in adj):
        full = F.pad(full, _flat(adj))
    return full


@register_op("conv2d")
def conv2d(x, w, stride: IntOr2 = 1, padding="SAME", dilation: IntOr2 = 1,
           groups: int = 1, data_format: str = "NHWC") -> torch.Tensor:
    """2-D convolution, x ``[N, H, W, C]`` (NHWC) or ``[N, C, H, W]``, w
    ``[KH, KW, Cin/groups, Cout]``, in the policy compute dtype, result
    in the output dtype."""
    enforce(data_format in ("NHWC", "NCHW"), f"data_format {data_format!r}")
    pol = current_policy()
    record_op_precision("conv2d")
    x = x.to(pol.compute_dtype)
    w = w.to(pol.compute_dtype)
    stride, dilation = _pair(stride), _pair(dilation)
    sp = x.shape[1:3] if data_format == "NHWC" else x.shape[2:4]
    pads = _explicit_pads(padding, sp, w.shape[:2], stride, dilation)
    if (data_format == "NHWC" and groups == 1 and x.dim() == 4
            and tuple(w.shape[:2]) == (1, 1) and stride == (1, 1)
            and dilation == (1, 1) and pads == [(0, 0), (0, 0)]):
        # a 1×1 stride-1 conv IS a matmul over the flattened pixels
        n, h, ww, cin = x.shape
        out = x.reshape(n * h * ww, cin) @ w.reshape(cin, w.shape[3])
        return out.reshape(n, h, ww, -1).to(pol.output_dtype)
    out = _conv_cf(_channels_first(x, data_format), w, stride, pads,
                   dilation, groups)
    return _channels_last(out, data_format).to(pol.output_dtype)


@register_op("conv2d_transpose")
def conv2d_transpose(x, w, stride: IntOr2 = 1, padding="SAME",
                     data_format: str = "NHWC") -> torch.Tensor:
    """Transposed conv (``conv2d_transpose_op.cc``), w ``[KH, KW, Cout,
    Cin]``: an explicit padding p gives (i − 1)·s + k − 2p (the
    scatter-conv identity), "SAME" / "VALID" ``lax.conv_transpose``'s
    sizes."""
    pol = current_policy()
    x = x.to(pol.compute_dtype)
    w = w.to(pol.compute_dtype)
    s = _pair(stride)
    ks = w.shape[:2]
    if isinstance(padding, str):
        pads = [_conv_transpose_pads(k, st, padding) for k, st in zip(ks, s)]
    else:
        fwd = [(padding, padding)] * 2 if isinstance(padding, int) \
            else [_pair(p) for p in padding]
        pads = [(k - 1 - lo, k - 1 - hi) for (lo, hi), k in zip(fwd, ks)]
    out = _conv_transpose_cf(_channels_first(x, data_format), w, s, pads)
    return _channels_last(out, data_format).to(pol.output_dtype)


@register_op("conv3d")
def conv3d(x, w, stride=1, padding="SAME", data_format: str = "NDHWC"
           ) -> torch.Tensor:
    """3-D convolution (``Conv3DLayer``), x ``[N, D, H, W, C]``, w
    ``[KD, KH, KW, I, O]`` (one group, as the JAX op)."""
    pol = current_policy()
    x = x.to(pol.compute_dtype)
    w = w.to(pol.compute_dtype)
    s = _tuple(stride, 3)
    sp = x.shape[1:4] if data_format == "NDHWC" else x.shape[2:5]
    pads = _explicit_pads(padding, sp, w.shape[:3], s, (1, 1, 1))
    out = _conv_cf(_channels_first(x, data_format), w, s, pads)
    return _channels_last(out, data_format).to(pol.output_dtype)


@register_op("conv3d_transpose")
def conv3d_transpose(x, w, stride=1, padding="SAME",
                     data_format: str = "NDHWC") -> torch.Tensor:
    """Transposed 3-D conv (``DeConv3DLayer``), w ``[KD, KH, KW, Cout,
    Cin]``.  Explicit pads are ``lax.conv_transpose``'s: they pad the
    dilated input itself, so a side comes out (i − 1)·s + 2p − k + 2,
    not the reference's (i − 1)·s + k − 2p."""
    pol = current_policy()
    x = x.to(pol.compute_dtype)
    w = w.to(pol.compute_dtype)
    s = _tuple(stride, 3)
    if isinstance(padding, str):
        pads = [_conv_transpose_pads(k, st, padding)
                for k, st in zip(w.shape[:3], s)]
    else:
        pads = [(padding, padding)] * 3 if isinstance(padding, int) \
            else [_pair(p) for p in padding]
    out = _conv_transpose_cf(_channels_first(x, data_format), w, s, pads)
    return _channels_last(out, data_format).to(pol.output_dtype)


def _window_pool(xc, kind: str, k, s, pads):
    """Max (−inf padding) or average (padding out of the divisor: the
    window sums over the window counts, in x's dtype, as the JAX
    package divides its two reduce_windows) of channels-first ``xc``.
    The average pads explicitly and pools at padding 0: on CUDA the 2-D
    average pool's backward with padding of its own is wrong for a
    channels-last input (the NHWC views here), whatever its divisor."""
    nd = len(k)
    padded = any(lo or hi for lo, hi in pads)
    if kind == "max":
        fn = F.max_pool2d if nd == 2 else F.max_pool3d
        if all(lo == hi and 0 <= lo <= kk // 2
               for (lo, hi), kk in zip(pads, k)):
            return fn(xc, k, s, [lo for lo, _ in pads])
        return fn(F.pad(xc, _flat(pads), value=-math.inf), k, s)
    fn = F.avg_pool2d if nd == 2 else F.avg_pool3d
    ones = torch.ones_like(xc[:1, :1])
    if padded:
        xc, ones = F.pad(xc, _flat(pads)), F.pad(ones, _flat(pads))
    summed = fn(xc, k, s, divisor_override=1)
    counts = fn(ones, k, s, divisor_override=1)
    return summed / counts


@register_op("pool3d")
def pool3d(x, pool_type: str = "max", window=2, stride=2, padding=0
           ) -> torch.Tensor:
    """3-D max or average pool over NDHWC (``Pool3DLayer``)."""
    pads = [(p, p) for p in _tuple(padding, 3)]
    kind = "max" if "max" in pool_type else "avg"
    out = _window_pool(torch.movedim(x, -1, 1), kind, _tuple(window, 3),
                       _tuple(stride, 3), pads)
    return torch.movedim(out, 1, -1)


@register_op("pool2d")
def pool2d(x, pool_type: str = "max", window: IntOr2 = 2,
           stride: IntOr2 = 2, padding=0, data_format: str = "NHWC",
           global_pooling: bool = False) -> torch.Tensor:
    """Max or average pooling over NHWC or NCHW; ``global_pooling`` takes
    the max or mean of each whole map (kept as a 1×1 map)."""
    axes = (1, 2) if data_format == "NHWC" else (2, 3)
    if global_pooling:
        return x.amax(axes, keepdim=True) if pool_type == "max" \
            else x.mean(axes, keepdim=True)
    k, s = _pair(window), _pair(stride)
    sp = [x.shape[a] for a in axes]
    if isinstance(padding, int):
        pads = [(padding, padding)] * 2
    elif isinstance(padding, str):
        pads = _explicit_pads(padding, sp, k, s, (1, 1))
    else:
        pads = [_pair(p) for p in padding]
    out = _window_pool(_channels_first(x, data_format),
                       "max" if pool_type == "max" else "avg", k, s, pads)
    return _channels_last(out, data_format)


@register_op("max_pool2d_with_index", n_outputs=2)
def max_pool2d_with_index(x, window: IntOr2 = 2, stride: IntOr2 = 2,
                          padding: int = 0):
    """Max pool over NHWC with the flat ``h·w`` index of each maximum
    (``pool_with_index_op``): the first of equal values in the window's
    row-major order; a window whose max is −inf (wholly in the padding)
    gives −inf and index −1."""
    n, h, w, c = x.shape
    (kh, kw), (sh, sw) = _pair(window), _pair(stride)
    pads = [padding] * 4
    xp = F.pad(x.permute(0, 3, 1, 2), pads, value=-math.inf)
    pos = F.pad(torch.arange(h * w, dtype=torch.float32, device=x.device)
                .reshape(1, 1, h, w), pads, value=-1.0)
    xu = xp.unfold(2, kh, sh).unfold(3, kw, sw)
    oh, ow = xu.shape[2], xu.shape[3]
    xu = xu.reshape(n, c, oh, ow, kh * kw)
    pu = pos.unfold(2, kh, sh).unfold(3, kw, sw) \
        .reshape(1, 1, oh, ow, kh * kw).expand(n, c, oh, ow, kh * kw)
    arg = torch.argmax(xu, dim=-1, keepdim=True)
    vals = torch.gather(xu, -1, arg)[..., 0]
    idx = torch.gather(pu, -1, arg)[..., 0]
    idx = torch.where(vals > -math.inf, idx, -1.0)
    return vals.permute(0, 2, 3, 1), idx.permute(0, 2, 3, 1).to(torch.int32)


@register_op("spp")
def spatial_pyramid_pool(x, pyramid_height: int, pool_type: str = "max"
                         ) -> torch.Tensor:
    """Spatial pyramid pooling (``SpatialPyramidPoolLayer``), NHWC →
    ``[N, F]``: level l splits H and W into 2^l bins at the floor
    splits ``h·i // bins`` (not adaptive pooling's overlapping ceil
    windows)."""
    n, h, w, _c = x.shape
    outs = []
    for lvl in range(pyramid_height):
        bins = 2 ** lvl
        hs = [h * i // bins for i in range(bins + 1)]
        ws = [w * i // bins for i in range(bins + 1)]
        for i in range(bins):
            for j in range(bins):
                region = x[:, hs[i]:hs[i + 1], ws[j]:ws[j + 1], :]
                outs.append(region.amax((1, 2)) if pool_type == "max"
                            else region.mean((1, 2)))
    return torch.cat(outs, dim=-1).reshape(n, -1)


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
    (a bf16 x·x loses the low bits when |mean| >> std).  Inside a
    data-parallel step (``core.device.data_shard``) the statistics are
    the global batch's: the per-channel sums of x and x² are summed over
    the data axis (a differentiable all-reduce), as the JAX package's
    mean over a sharded batch dim is."""
    xf = x.float()
    sh = data_shard()
    if sh is not None:
        from ..parallel.collectives import all_reduce_autograd
        n = float(math.prod(x.shape[i] for i in axes)) * sh.size
        sums = all_reduce_autograd(
            torch.stack([xf.sum(axes), xf.square().sum(axes)]), sh.group)
        m = sums[0] / n
        return m, torch.clamp_min(sums[1] / n - m * m, 0.0)
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
        ctx.axes, ctx.c_ax, ctx.shard = axes, c_ax, data_shard()
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
        gbias, gscale = dbias, dscale
        if ctx.shard is not None:
            # the statistics span every shard: dx takes the global sums
            # (each rank's dy through them); the parameters' gradients
            # stay this rank's, the trainer reduces them
            from ..parallel.collectives import all_reduce_sum
            gbias, gscale = all_reduce_sum([dbias, dscale],
                                           ctx.shard.group)
            n *= ctx.shard.size
        coeff = (scale * inv).float().reshape(shape)
        dx = coeff * (dy_f - (gbias / n).reshape(shape)
                      - xhat * (gscale / n).reshape(shape))
        return (dx.to(x.dtype), dscale.to(scale.dtype),
                dbias.to(scale.dtype), None, None, None)


def _running(old, batch, momentum):
    return momentum * old + (1 - momentum) * batch.detach()


@register_op("batch_norm", n_outputs=3)
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


@register_op("affine_act_conv2d")
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


@register_op("conv2d_bn", n_outputs=3)
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

    if is_training and data_shard() is not None:
        raise PaddleTpuError(
            "conv2d_bn: the fused conv->batch-norm pair sums its "
            "backward's channel statistics on one rank; a data-parallel "
            "step needs them over every rank -- build the network with "
            "--conv_bn_fuse=false and --conv_bn_fuse_fwd=false")
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


@register_op("dropout")
def dropout(x: torch.Tensor, gen: torch.Generator, rate: float = 0.5,
            is_training: bool = True) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 − rate
    (a uniform draw from ``gen`` below it) and scaled to ``x / keep``,
    the rest 0; the identity in eval or at rate 0.  The gradient is
    ``mask / keep``."""
    if not is_training or rate == 0.0:
        return x
    keep = 1.0 - rate
    sh = data_shard()
    if sh is not None and x.dim() >= 1:
        # a data-parallel step: this rank's rows of the global batch's
        # mask (one draw of the global shape), as GSPMD's sharded draw
        b = x.shape[0]
        mask = torch.rand((b * sh.size,) + tuple(x.shape[1:]),
                          generator=gen, device=x.device)[
            sh.index * b:(sh.index + 1) * b] < keep
    else:
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


@register_op("feature_map_expand")
def feature_map_expand(x: torch.Tensor, num_filters: int,
                       as_row: bool = True) -> torch.Tensor:
    """Tile ``[B, D]`` into ``[B, num_filters * D]``
    (``FeatureMapExpandLayer``): the whole row repeated, or each element
    repeated in place (``as_row`` False)."""
    b = x.shape[0]
    if as_row:
        return x[:, None, :].expand(b, num_filters, x.shape[1]).reshape(b, -1)
    return x[:, :, None].expand(b, x.shape[1], num_filters).reshape(b, -1)


@register_op("lrn")
def lrn(x, n: int = 5, k: float = 2.0, alpha: float = 1e-4,
        beta: float = 0.75) -> torch.Tensor:
    """Local response normalization across the channels of NHWC
    (``lrn_op.cc``, ``CrossMapNormLayer``): x / (k + α·Σ x²)^β, the sum
    over a zero-padded window of n channels; α is not divided by n (as
    ``F.local_response_norm`` divides it)."""
    sq = x * x
    half = n // 2
    sq = F.pad(sq, (half, half))
    acc = torch.zeros_like(x)
    for i in range(n):
        acc = acc + sq[..., i:i + x.shape[-1]]
    return x / torch.pow(k + alpha * acc, beta)


@register_op("maxout")
def maxout(x, groups: int, data_format: str = "NHWC") -> torch.Tensor:
    """Max over channel groups (``MaxOutLayer``): NHWC takes each run of
    ``groups`` adjacent channels, NCHW each of C/groups strided ones."""
    if data_format == "NHWC":
        n, h, w, c = x.shape
        return x.reshape(n, h, w, c // groups, groups).amax(-1)
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).amax(1)


@register_op("prelu")
def prelu(x, alpha) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


@register_op("bilinear_interp")
def bilinear_interp(x, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NHWC (``BilinearInterpLayer``) as
    ``jax.image.resize`` computes it: half-pixel centres, antialiased
    where a side shrinks (not the align-corners ratio of the JAX
    docstring)."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                        mode="bilinear", align_corners=False,
                        antialias=True)
    return out.permute(0, 2, 3, 1)


@register_op("block_expand")
def block_expand(x, block_h: int, block_w: int, stride_h: int,
                 stride_w: int, pad_h: int = 0, pad_w: int = 0
                 ) -> torch.Tensor:
    """Image → sequence of flattened patches (``BlockExpandLayer``):
    NHWC in, ``[B, S, C·block_h·block_w]`` out, S the patches in
    row-major order, each patch's features channel-major
    (``conv_general_dilated_patches``' order)."""
    xc = F.pad(x.permute(0, 3, 1, 2), (pad_w, pad_w, pad_h, pad_h))
    return F.unfold(xc, (block_h, block_w),
                    stride=(stride_h, stride_w)).transpose(1, 2)


@register_op("rotate")
def rotate(x, height: int, width: int) -> torch.Tensor:
    """Rotate flat ``[B, H·W·C]`` rows, read as (H, W, C), 90° counter-
    clockwise (``RotateLayer``)."""
    b = x.shape[0]
    c = x.shape[1] // (height * width)
    img = x.reshape(b, height, width, c)
    return torch.rot90(img, 1, (1, 2)).reshape(b, -1)


@register_op("switch_order")
def switch_order(x, to: str = "NHWC") -> torch.Tensor:
    """NCHW ↔ NHWC (``SwitchOrderLayer``)."""
    if to == "NHWC":
        return torch.movedim(x, 1, -1)
    return torch.movedim(x, -1, 1)
