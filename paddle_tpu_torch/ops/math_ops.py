"""Dense math ops (counterpart of ``paddle_tpu/ops/math_ops.py``): the
reference's ``paddle/math`` elementwise and aggregate families, the
``paddle/operators`` math ops (mul, matmul, sum, scale, clip,
elementwise_*, reduce_*, transpose, reshape, concat, split, pad, crop,
cast, gather, scatter, top_k, multiplex, …) and ``paddle/function``'s
Mul / CosSim.  :func:`matmul` and :func:`einsum` apply the precision
policy; the rest compute in their inputs' dtype, as the JAX functions.

The two random ops take an explicit ``torch.Generator`` where the JAX
functions take a key, and draw on the generator's device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from ..core.device import resolve_device
from ..core.dtypes import current_policy, record_op_precision
from ..utils import enforce
from .registry import register_op


@register_op("matmul", "mul")
def matmul(x: torch.Tensor, y: torch.Tensor, transpose_x: bool = False,
           transpose_y: bool = False, scale: float = 1.0) -> torch.Tensor:
    """``x @ y`` (optionally transposed, times ``scale``) with floating
    operands in the policy compute dtype and the result in the policy
    output dtype, as ``jnp.matmul(..., preferred_element_type=
    output_dtype)`` gives it.

    Where the two dtypes differ (bf16 compute, fp32 output), the
    bf16-rounded operands are multiplied in fp32: their products are
    exact in fp32 and the sum is taken in fp32, with no bf16 rounding
    of the result.  ``torch.matmul`` of two bf16 tensors would round
    the result to bf16, a different number.  Where they agree, it is
    ``torch.matmul`` in that dtype (a bf16 product accumulates in fp32
    and rounds once)."""
    pol = current_policy()
    floating = x.is_floating_point()
    if floating:
        record_op_precision("matmul")
        x = x.to(pol.compute_dtype)
        y = y.to(pol.compute_dtype)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    if not floating or pol.compute_dtype == pol.output_dtype:
        out = torch.matmul(x, y)
    else:
        out = torch.matmul(x.to(pol.output_dtype), y.to(pol.output_dtype))
    if scale != 1.0:
        out = out * scale
    return out


@register_op("einsum")
def einsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` under the precision policy, as :func:`matmul`:
    floating operands in the compute dtype, the result in the output
    dtype (bf16-rounded operands contracted in fp32 where the two
    differ).  An integer contraction keeps its dtype."""
    if not any(x.is_floating_point() for x in operands):
        return torch.einsum(subscripts, *operands)
    pol = current_policy()
    record_op_precision("einsum")
    operands = tuple(x.to(pol.compute_dtype) if x.is_floating_point()
                     else x for x in operands)
    if pol.compute_dtype != pol.output_dtype:
        operands = tuple(x.to(pol.output_dtype) for x in operands)
    return torch.einsum(subscripts, *operands)


@register_op("sum")
def sum_arrays(*xs: torch.Tensor) -> torch.Tensor:
    """Sum N same-shape tensors (``paddle/operators/sum_op.cc``)."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register_op("scale")
def scale(x, scale: float = 1.0, bias: float = 0.0):
    return x * scale + bias


@register_op("sign")
def sign(x):
    return torch.sign(x)


@register_op("clip")
def clip(x, min: float, max: float):
    return torch.clamp(x, min, max)


@register_op("mean")
def mean(x):
    return torch.mean(x)


@register_op("minus")
def minus(x, y):
    return x - y


@register_op("increment")
def increment(x, step: float = 1.0):
    return x + step


def _broadcast_to_rank(y: torch.Tensor, rank: int, axis: int) -> torch.Tensor:
    """Reference broadcast rule (``elementwise_op_function.h``): y's shape
    matches a contiguous run of x's dims starting at ``axis``."""
    if y.dim() == rank or y.dim() == 0:
        return y
    if axis < 0:
        axis = rank - y.dim()
    shape = [1] * rank
    for i, d in enumerate(y.shape):
        shape[axis + i] = d
    return y.reshape(shape)


@register_op("elementwise_add")
def elementwise_add(x, y, axis: int = -1):
    return x + _broadcast_to_rank(y, x.dim(), axis)


@register_op("elementwise_sub")
def elementwise_sub(x, y, axis: int = -1):
    return x - _broadcast_to_rank(y, x.dim(), axis)


@register_op("elementwise_mul")
def elementwise_mul(x, y, axis: int = -1):
    return x * _broadcast_to_rank(y, x.dim(), axis)


@register_op("elementwise_div")
def elementwise_div(x, y, axis: int = -1):
    return x / _broadcast_to_rank(y, x.dim(), axis)


def _dims(x: torch.Tensor, dim) -> Tuple[int, ...]:
    """``dim`` as the tuple of axes a reduction takes (None: all)."""
    if dim is None:
        return tuple(range(x.dim()))
    return (dim,) if isinstance(dim, int) else tuple(dim)


@register_op("reduce_sum")
def reduce_sum(x, dim=None, keep_dim: bool = False):
    return torch.sum(x, dim=_dims(x, dim), keepdim=keep_dim)


@register_op("reduce_mean")
def reduce_mean(x, dim=None, keep_dim: bool = False):
    return torch.mean(x, dim=_dims(x, dim), keepdim=keep_dim)


@register_op("reduce_max")
def reduce_max(x, dim=None, keep_dim: bool = False):
    return torch.amax(x, dim=_dims(x, dim), keepdim=keep_dim)


@register_op("reduce_min")
def reduce_min(x, dim=None, keep_dim: bool = False):
    return torch.amin(x, dim=_dims(x, dim), keepdim=keep_dim)


@register_op("transpose", "trans")
def transpose(x, axis: Optional[Sequence[int]] = None):
    """``jnp.transpose``: the dims reversed when ``axis`` is None."""
    if axis is None:
        axis = tuple(reversed(range(x.dim())))
    return x.permute(*axis)


@register_op("reshape")
def reshape(x, shape: Sequence[int]):
    return x.reshape(tuple(shape))


@register_op("concat")
def concat(*xs, axis: int = 1):
    return torch.cat(xs, dim=axis)


@register_op("split", n_outputs=-1)
def split(x, num_or_sections: Union[int, Sequence[int]], axis: int = 1):
    """``jnp.split``: ``num_or_sections`` equal parts (which must divide
    the axis), or cut after each of the section sizes but the last (the
    last part is the rest of the axis)."""
    if isinstance(num_or_sections, int):
        enforce(x.shape[axis] % num_or_sections == 0,
                f"split: axis of {x.shape[axis]} does not divide into "
                f"{num_or_sections} equal parts")
        return list(torch.split(x, x.shape[axis] // num_or_sections,
                                dim=axis))
    cuts, total = [], 0
    for s in list(num_or_sections)[:-1]:
        total += int(s)
        cuts.append(total)
    return list(torch.tensor_split(x, cuts, dim=axis))


@register_op("pad")
def pad(x, paddings: Sequence[Tuple[int, int]], pad_value: float = 0.0):
    """``jnp.pad`` with a constant: ``paddings`` one (before, after) pair
    per dim."""
    flat = []
    for lo, hi in reversed(list(paddings)):
        flat += [int(lo), int(hi)]
    return torch.nn.functional.pad(x, flat, value=pad_value)


@register_op("crop")
def crop(x, offsets: Sequence[int], shape: Sequence[int]):
    """``lax.dynamic_slice``: each offset clamped so the slice fits."""
    out = x
    for d, (off, size) in enumerate(zip(offsets, shape)):
        start = min(max(int(off), 0), x.shape[d] - int(size))
        out = out.narrow(d, start, int(size))
    return out


@register_op("cast")
def cast(x, dtype: torch.dtype):
    return x.to(dtype)


def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s fill for an index out of range: NaN for a float,
    the least value of a signed integer, the largest of an unsigned."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register_op("gather")
def gather(x, index, axis: int = 0):
    """``jnp.take(x, index, axis)``: negative indices count from the end,
    an index out of range reads the fill value (NaN for a float)."""
    axis = axis % x.dim()
    n = x.shape[axis]
    idx = index.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    flat = torch.where(valid, idx, 0).reshape(-1)
    out = torch.index_select(x, axis, flat)
    out = out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                      + tuple(x.shape[axis + 1:]))
    keep = valid.reshape((1,) * axis + tuple(index.shape)
                         + (1,) * (x.dim() - axis - 1))
    return torch.where(keep, out, _fill_value(x.dtype))


@register_op("scatter")
def scatter(ref, index, updates, overwrite: bool = True):
    """Row scatter (``paddle/operators/scatter_op.cc``) out of place:
    ``ref.at[index].set(updates)`` or ``.add``.  Negative indices count
    from the end; rows out of range are dropped."""
    n = ref.shape[0]
    idx = index.to(torch.int64).reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    # a row out of range lands on a spare row n, cut off after
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    upd = updates.reshape((idx.shape[0],) + tuple(ref.shape[1:]))
    spare = torch.cat([ref, ref.new_zeros((1,) + tuple(ref.shape[1:]))])
    return spare.index_put((idx,), upd.to(ref.dtype),
                           accumulate=not overwrite)[:n]


@register_op("top_k", n_outputs=2)
def top_k(x, k: int):
    """Values and int32 indices of the k largest along the last dim, in
    descending order, the lower index first among equal values, as
    ``lax.top_k`` orders them (``torch.topk`` promises no order, nor
    which of the tied values it takes at the k-th place).

    ``torch.topk`` gives the k-th value; a second ``topk`` over a key
    takes every value above it (key n) and, of those equal to it, the
    lowest positions (key −position), as many as are left.  The k taken
    positions, in ascending order, are then sorted stably by value."""
    kth = torch.topk(x, k, dim=-1, largest=True, sorted=True)[0][..., -1:]
    n = x.shape[-1]
    # float32 holds every position below 2^24 exactly
    kd = torch.float32 if n < 2 ** 24 else torch.float64
    pos = torch.arange(n, device=x.device, dtype=kd)
    key = torch.where(x > kth, float(n),
                      torch.where(x == kth, -pos, -float(n) - 1))
    chosen = torch.sort(torch.topk(key, k, dim=-1)[1], dim=-1)[0]
    values = torch.gather(x, -1, chosen)
    order = torch.sort(values, dim=-1, descending=True, stable=True)[1]
    return torch.gather(values, -1, order), \
        torch.gather(chosen, -1, order).to(torch.int32)


@register_op("multiplex")
def multiplex(index, *xs):
    """Row-wise select among candidate tensors by per-row index
    (``paddle/operators/multiplex_op.cc``)."""
    stacked = torch.stack(xs, dim=0)            # [N, B, ...]
    idx = index.reshape(-1).to(torch.int64)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


@register_op("fill_constant")
def fill_constant(shape: Sequence[int], value: float,
                  dtype: torch.dtype = torch.float32, device=None):
    """A tensor of ``value`` on ``device`` (default CUDA; raises when CUDA
    is absent and the CPU was not asked for)."""
    return torch.full(tuple(shape), value, dtype=dtype,
                      device=resolve_device(device))


@register_op("fill_zeros_like")
def fill_zeros_like(x):
    return torch.zeros_like(x)


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(ref, shape: Sequence[int], value: float,
                                  dtype: torch.dtype = torch.float32,
                                  input_dim_idx: int = 0,
                                  output_dim_idx: int = 0):
    shape = list(shape)
    shape[output_dim_idx] = ref.shape[input_dim_idx]
    return torch.full(tuple(shape), value, dtype=dtype, device=ref.device)


@register_op("gaussian_random")
def gaussian_random(gen: torch.Generator, shape: Sequence[int],
                    mean: float = 0.0, std: float = 1.0,
                    dtype: torch.dtype = torch.float32):
    """``mean + std * N(0, 1)`` drawn from ``gen`` on its device."""
    return mean + std * torch.randn(tuple(shape), generator=gen,
                                    dtype=dtype, device=gen.device)


@register_op("uniform_random")
def uniform_random(gen: torch.Generator, shape: Sequence[int],
                   min: float = -1.0, max: float = 1.0,
                   dtype: torch.dtype = torch.float32):
    """U[min, max) drawn from ``gen`` on its device."""
    u = torch.rand(tuple(shape), generator=gen, dtype=dtype,
                   device=gen.device)
    return min + (max - min) * u


@register_op("cos_sim")
def cos_sim(x, y, scale: float = 1.0, eps: float = 1e-10):
    """Row-wise cosine similarity (``paddle/operators/cos_sim_op.cc``,
    ``CosSimLayer``); y may have one row (broadcast)."""
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1) + eps)
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1) + eps)
    dot = torch.sum(x * y, dim=-1)
    return scale * dot / (xn * yn)


@register_op("conv_shift")
def conv_shift(x, y):
    """Circular 1-D convolution of each row of x with the kernel row of y
    (``paddle/operators/conv_shift_op.cc``).  Kernel width must be odd."""
    b, m = x.shape
    n = y.shape[1]
    half = n // 2
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(-half, half + 1, device=x.device)[None, :]) % m
    windows = x[:, idx]                         # [B, M, N]
    return torch.einsum("bmn,bn->bm", windows, y)


@register_op("outer_prod")
def outer_prod(x, y):
    """Row-wise outer product, flattened (``OuterProdLayer``)."""
    return (x[:, :, None] * y[:, None, :]).reshape(x.shape[0], -1)


@register_op("interpolation")
def interpolation(w, x, y):
    """w*x + (1-w)*y with a per-row scalar w (``InterpolationLayer``)."""
    w = w.reshape(-1, 1)
    return w * x + (1.0 - w) * y


@register_op("slope_intercept")
def slope_intercept(x, slope: float = 1.0, intercept: float = 0.0):
    return slope * x + intercept


@register_op("sum_to_one_norm")
def sum_to_one_norm(x, eps: float = 1e-12):
    return x / (torch.sum(x, dim=-1, keepdim=True) + eps)


@register_op("row_l2_norm")
def row_l2_norm(x, eps: float = 1e-12):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


@register_op("convex_combination")
def convex_combination(weights, x):
    """Per-row convex combination: weights [..., K], x [..., K*D] →
    [..., D] (``ConvexCombinationLayer``); leading dims (batch, or
    batch×time for sequence inputs) broadcast."""
    k = weights.shape[-1]
    d = x.shape[-1] // k
    return torch.einsum("...k,...kd->...d", weights,
                        x.reshape(*x.shape[:-1], k, d))
