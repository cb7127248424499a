"""Fused conv/BatchNorm-affine 3×3 kernels (counterpart of
``paddle_tpu/ops/pallas_conv.py``).

Hand-written CUDA C++ kernels for ``sm_90a``, implicit GEMMs over the 9
shifted ``[N·H·W, C] @ [C, C']`` products of a 3×3 stride-1 pad-1 NHWC
conv with a load hook that forms the operand tile and an epilogue hook,
on one main loop on the tensor cores (``csrc/conv3x3_tc.cuh``, wgmma;
an f32 operand as hi + lo bf16, kernel 20's bf16 dy as it is):

- kernel 18, :func:`conv3x3_dx` (``csrc/conv3x3_dx.cu``; plain version
  :func:`conv3x3_dx_reference`): the batch-norm backward's affine
  dz = A·dy + B·z + C formed on load, dz written out once, dx the
  backward-data conv of dz;
- kernel 19, :func:`conv3x3_fwd` (``csrc/conv3x3_fwd.cu``; plain
  :func:`conv3x3_fwd_reference`): the forward conv of act(A·z + C);
- kernel 20, :func:`conv3x3_fwd_bwd` (``csrc/conv3x3_fwd_bwd.cu``; plain
  :func:`conv3x3_fwd_bwd_reference`): kernel 19's backward — dz, the
  recomputed x and dA/dC;
- kernel 21, :func:`conv3x3_chain_bwd` (``csrc/conv3x3_chain_bwd.cu``;
  plain :func:`conv3x3_chain_bwd_reference`): kernel 18's load hook and
  kernel 20's epilogue in one pass.

The border of every conv is 0 in the transformed space (the Pallas
kernels pad their transformed tile with zeros), never act(C) or C.

:class:`_ConvBnCore`, :class:`_AffineConvCore` and :class:`_ChainCore`
(``torch.autograd.Function``) are the three custom VJPs of the JAX
module.  Unlike them, :class:`_ConvBnCore` and :class:`_ChainCore`
return the batch statistics (m, v) beside y: eager PyTorch has no common
subexpression elimination, so recomputing them outside, as the JAX
callers do, would run the conv a second time.  The weight gradients and
the BN reductions stay library convs and plain tensor code, as the JAX
package leaves them to XLA.

A wrapper checks dtype (fp32 or bf16, one dtype for the activations and
weights, fp32 affines), shape and contiguity.  CPU tensors then take the
plain version; CUDA tensors launch the kernel or raise (channels must be
multiples of 64, tensors 16-byte aligned); the kernels take fp32 weights
as hi and lo bf16 planes (:func:`_tc_weights`).  Each wrapper counts its
launches in ``.launches``.  The gates below are the JAX module's, copied
as they are, so the port dispatches — and launches — where the JAX
package does; their VMEM terms are a TPU budget.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import enforce
from . import _build, export_ops
from .nn_ops import _bn_apply, _bn_stats, _pair

# VMEM budget of the JAX gates (a TPU's 16 MB scoped VMEM with headroom)
_VMEM_BUDGET = 12 * 1024 * 1024
#: Channel multiple the CUDA kernels take (their channel tile).
CHANNEL_TILE = 64


# ------------------------------------------------------------------- gates
def fused_ok(h: int, w: int, cin: int, cout: int) -> bool:
    """The JAX backward-data gate (``pallas_conv.fused_ok``): channels
    multiples of 64, per-image tiles plus resident weights within the
    VMEM budget."""
    if cin % 64 or cout % 64 or h < 1 or w < 1:
        return False
    f32 = 4
    tile = h * w * (4 * cout + cin) * f32 \
        + (h + 2) * (w + 2) * cout * f32
    return tile + 9 * cout * cin * f32 <= _VMEM_BUDGET


def _geom3x3_ok(x_shape, w_shape, stride, padding, dilation, groups,
                data_format) -> bool:
    """The 3×3 stride-1 SAME/pad-1 groupless NHWC family."""
    if data_format != "NHWC" or groups != 1:
        return False
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    if tuple(w_shape[:2]) != (3, 3):
        return False
    if _pair(stride) != (1, 1) or _pair(dilation) != (1, 1):
        return False
    if isinstance(padding, str):
        if padding != "SAME":
            return False
    else:
        pads = [_pair(p) for p in padding] if not isinstance(padding, int) \
            else [(padding, padding)] * 2
        if pads != [(1, 1), (1, 1)]:
            return False
    return True


def fusable(x_shape, w_shape, stride, padding, dilation, groups,
            data_format) -> bool:
    """Dispatch gate of the fused conv→BN path (``conv2d_bn``)."""
    if not _geom3x3_ok(x_shape, w_shape, stride, padding, dilation,
                       groups, data_format):
        return False
    n, h, w_, _cin = x_shape
    return fused_ok(h, w_, int(w_shape[2]), int(w_shape[3]))


def fused_fwd_ok(h: int, w: int, cin: int, cout: int) -> bool:
    """The JAX gate of the forward fused conv and its backward
    (``pallas_conv.fused_fwd_ok``)."""
    if cin % 64 or cout % 64 or h < 1 or w < 1:
        return False
    f32 = 4
    fwd = h * w * (2 * cin + 2 * cout) * f32 \
        + (h + 2) * (w + 2) * cin * f32
    bwd = h * w * (4 * cin + 2 * cout) * f32 \
        + (h + 2) * (w + 2) * cout * f32 + 8 * cin * f32
    return max(fwd, bwd) + 9 * cin * cout * f32 <= _VMEM_BUDGET


def fusable_fwd(z_shape, w_shape, stride, padding, dilation, groups,
                data_format) -> bool:
    """Dispatch gate of the fused BN(+ReLU)→3×3 conv forward path
    (``affine_act_conv2d``)."""
    if not _geom3x3_ok(z_shape, w_shape, stride, padding, dilation,
                       groups, data_format):
        return False
    n, h, w_, _cin = z_shape
    return fused_fwd_ok(h, w_, int(w_shape[2]), int(w_shape[3]))


def fused_chain_ok(h: int, w: int, cin: int, cout: int) -> bool:
    """The JAX gate of the chain kernel (``pallas_conv.fused_chain_ok``)."""
    if not fused_fwd_ok(h, w, cin, cout):
        return False
    f32 = 4
    tile = h * w * (4 * cin + 3 * cout) * f32 \
        + (h + 2) * (w + 2) * cout * f32 + 8 * (cin + cout) * f32
    return tile + 9 * cin * cout * f32 <= _VMEM_BUDGET


# --------------------------------------------------------- library convs
def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def _conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 pad-1 NHWC/HWIO conv (a library conv, as
    ``pallas_conv._conv3x3`` is XLA's)."""
    return _nhwc(F.conv2d(_nchw(x), _oihw(w), padding=1))


def _conv3x3_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The backward-data conv of :func:`_conv3x3`: ``[N, H, W, Cout]`` →
    ``[N, H, W, Cin]``."""
    n, h, ww, _ = dy.shape
    return _nhwc(torch.nn.grad.conv2d_input(
        (n, w.shape[2], h, ww), _oihw(w), _nchw(dy), padding=1))


def _conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor,
                   w_shape) -> torch.Tensor:
    """The filter gradient of :func:`_conv3x3` (HWIO), a library conv."""
    kh, kw, cin, cout = w_shape
    dw = torch.nn.grad.conv2d_weight(_nchw(x), (cout, cin, kh, kw),
                                     _nchw(dy), padding=1)
    return dw.permute(2, 3, 1, 0)


# ------------------------------------------------------------ plain versions
# The conv of each plain version sums in ``acc``: f32 by default, as the
# kernels and the Pallas kernels do; a check on the card may pass
# float64, so that only the kernel's own rounding is left to compare (an
# f32 reference adds a summation error of its own, in cuDNN's order).
# The affines stay f32 either way: a ReLU mask and a stored dz keep the
# kernels' bits.
def _act(u: torch.Tensor, relu: bool) -> torch.Tensor:
    return torch.clamp_min(u, 0.0) if relu else u


def _affine_bwd(t, z, aff, relu):
    """The prologue's backward from t = d/dx: (dz in z's dtype, x in z's
    dtype, dac [2, C] f32 = (Σ z·du, Σ du)), summed in t's dtype."""
    zf = z.float()
    u = aff[0] * zf + aff[1]
    du = torch.where(u > 0, t, torch.zeros_like(t)) if relu else t
    dac = torch.stack([(zf * du).sum((0, 1, 2)), du.sum((0, 1, 2))])
    return (aff[0] * du).to(z.dtype), _act(u, relu).to(z.dtype), dac.float()


def conv3x3_fwd_reference(z, aff, w, relu: bool,
                          acc=torch.float32) -> torch.Tensor:
    """Plain version of :func:`conv3x3_fwd`: conv(act(A·z + C), w) summed
    in ``acc``, zero-padded after the affine, in z's dtype."""
    x = _act(aff[0] * z.float() + aff[1], relu)
    return _conv3x3(x.to(acc), w.to(acc)).to(z.dtype)


def conv3x3_fwd_bwd_reference(dy, z, aff, w, relu: bool, acc=torch.float32
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of :func:`conv3x3_fwd_bwd` → (dz, x, dac)."""
    t = _conv3x3_dgrad(dy.to(acc), w.to(acc))
    return _affine_bwd(t, z, aff, relu)


def conv3x3_dx_reference(dy, z, coeffs, w, acc=torch.float32
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`conv3x3_dx` → (dx, dz): dz = A·dy + B·z + C
    in f32, dx its backward-data conv (of the f32 dz)."""
    dz = coeffs[0] * dy.float() + coeffs[1] * z.float() + coeffs[2]
    dx = _conv3x3_dgrad(dz.to(acc), w.to(acc))
    return dx.to(dy.dtype), dz.to(z.dtype)


def conv3x3_chain_bwd_reference(dy, z2, co, z1, ci, w, relu: bool,
                                acc=torch.float32):
    """Plain version of :func:`conv3x3_chain_bwd` → (dz2, dz1, x1, dac)."""
    dz2 = co[0] * dy.float() + co[1] * z2.float() + co[2]
    t = _conv3x3_dgrad(dz2.to(acc), w.to(acc))
    dz1, x1, dac = _affine_bwd(t, z1, ci, relu)
    return dz2.to(z2.dtype), dz1, x1, dac


#: Pixels a CTA of the tensor-core loop owns (csrc/conv3x3_tc.cuh).
TC_TILE = 128
_TC_BAND = TC_TILE + 2        # pixels of one tap row's band


def halo_gather_map(n: int, h: int, w: int, p0: int):
    """The tensor-core loop's halo gather for the CTA of pixels ``[p0, p0
    + 128)`` of the flattened ``N·H·W`` range, as the kernel computes it
    (``csrc/conv3x3_tc.cuh``), in plain index arithmetic:
    ``(pix [R], rows [9, 128])``.  Halo row ``j`` holds x of pixel
    ``pix[j]`` (-1: outside ``[0, N·H·W)``, left zero); the range is
    ``[p0 - W - 1, p0 + 128 + W + 1)``, or for ``W > 130`` three bands of
    130 pixels, one per tap row.  Output pixel ``p0 + r`` reads halo row
    ``rows[3a + b, r]`` for tap ``(a, b)``, or ``R`` (the all-zero row)
    where ``(h + a - 1, w + b - 1)`` leaves its image or the pixel is
    past the range: so the border is 0 after the affine, and a tile that
    spans two images never reads the neighbour image."""
    m = n * h * w
    contiguous = 2 * w + _TC_BAND <= 3 * _TC_BAND
    n_rows = 2 * w + _TC_BAND if contiguous else 3 * _TC_BAND
    step = w if contiguous else _TC_BAND
    band = n_rows if contiguous else _TC_BAND
    j = torch.arange(n_rows)
    q = p0 - w - 1 + j + torch.div(j, band, rounding_mode="floor") \
        * (w - band)
    pix = torch.where((q >= 0) & (q < m), q, torch.full_like(q, -1))
    r = torch.arange(TC_TILE)
    p = p0 + r
    ph = torch.remainder(p, h * w) // w
    pw = torch.remainder(p, w)
    rows = torch.full((9, TC_TILE), n_rows, dtype=torch.long)
    for a in range(3):
        for b in range(3):
            inside = (p < m) & (ph + a - 1 >= 0) & (ph + a - 1 < h) \
                & (pw + b - 1 >= 0) & (pw + b - 1 < w)
            rows[3 * a + b] = torch.where(inside, a * step + r + b,
                                          torch.full_like(r, n_rows))
    return pix, rows


def halo_dz_stores(n: int, h: int, w: int, p0: int) -> torch.Tensor:
    """The halo rows whose dz the CTA of pixels ``[p0, p0 + 128)`` stores
    under the load hook kLoadBnBwd (kernels 18 and 21, first channel
    block), as the kernel decides it: row ``j`` of
    :func:`halo_gather_map` when its pixel ``q`` is one of the CTA's own,
    ``p0 <= q < p0 + 128`` and ``q < N·H·W``.  Returns those ``j``."""
    pix, _ = halo_gather_map(n, h, w, p0)
    return torch.nonzero((pix >= p0) & (pix < p0 + TC_TILE)).flatten()


# ------------------------------------------------------------------ wrappers
def _check(name: str, x, shape, dtype) -> None:
    enforce(isinstance(x, torch.Tensor) and tuple(x.shape) == tuple(shape),
            f"{name}: expected shape {tuple(shape)}, got "
            f"{tuple(getattr(x, 'shape', ()))}")
    enforce(x.dtype == dtype, f"{name}: expected {dtype}, got {x.dtype}")
    enforce(x.is_contiguous(), f"{name}: expected a contiguous tensor")


def _check_conv(z, w, names=("z", "w")):
    """(N, H, W, Cin, Cout, dtype) of an NHWC z and HWIO 3×3 w."""
    enforce(isinstance(z, torch.Tensor) and z.dim() == 4
            and isinstance(w, torch.Tensor) and w.dim() == 4
            and tuple(w.shape[:2]) == (3, 3) and w.shape[2] == z.shape[3],
            f"{names[0]} [N, H, W, Cin] and {names[1]} [3, 3, Cin, Cout] "
            f"expected, got {tuple(getattr(z, 'shape', ()))} and "
            f"{tuple(getattr(w, 'shape', ()))}")
    enforce(z.dtype in (torch.float32, torch.bfloat16),
            f"{names[0]}: expected float32 or bfloat16, got {z.dtype}")
    n, h, ww, cin = z.shape
    _check(names[1], w, w.shape, z.dtype)
    return n, h, ww, cin, w.shape[3], z.dtype


def _on_card(tensors) -> bool:
    """True when the tensors are on CUDA (launch the kernel), False when
    all lie on the CPU (plain version); raises on anything else."""
    devs = {x.device for x in tensors}
    enforce(len(devs) == 1, f"tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    enforce(dev.type == "cuda", f"unsupported device {dev}")
    return True


def _served(tensors, channels) -> None:
    """Raise on what the kernels do not serve: channels off the 64-wide
    tile, tensors not 16-byte aligned."""
    enforce(all(c % CHANNEL_TILE == 0 for c in channels),
            f"the 3x3 conv kernels take channels that are multiples of "
            f"{CHANNEL_TILE}, got {tuple(channels)}")
    enforce(all(x.data_ptr() % 16 == 0 for x in tensors),
            "the 3x3 conv kernels need 16-byte aligned tensors")


def _launch(symbol: str, ptrs, ints, dev) -> None:
    err = _build.kernel(symbol)(*ptrs, *ints,
                                torch.cuda.current_stream(dev).cuda_stream)
    enforce(err == 0, f"{symbol} launch failed (cudaError {err})")


def _flipped(w: torch.Tensor) -> torch.Tensor:
    """wt[a, b] = w[2-a, 2-b]^T: the backward-data GEMM weights
    ``[3, 3, Cout, Cin]``."""
    return torch.flip(w, (0, 1)).permute(0, 1, 3, 2).contiguous()


def _tc_weights(w: torch.Tensor) -> torch.Tensor:
    """The weights as the tensor-core loop takes them: bf16 as they are,
    fp32 as hi and lo bf16 planes ``[2, *w.shape]`` (hi = bf16(w), lo =
    bf16(w - hi))."""
    if w.dtype == torch.bfloat16:
        return w
    w_hi = w.to(torch.bfloat16)
    return torch.stack([w_hi, (w - w_hi.float()).to(torch.bfloat16)])


def _parts(n, h, w, cin, dev):
    """Scratch of the per-CTA channel sums (128-pixel tiles) and dac."""
    tiles = -(-(n * h * w) // 128)
    return (torch.empty((2, cin, tiles), dtype=torch.float32, device=dev),
            torch.empty((2, cin), dtype=torch.float32, device=dev))


def conv3x3_fwd(z, aff, w, relu: bool) -> torch.Tensor:
    """Kernel 19: conv3×3(act(A·z + C), w).  z ``[N, H, W, Cin]``, aff
    ``[2, Cin]`` f32 (rows A, C), w ``[3, 3, Cin, Cout]`` → ``[N, H, W,
    Cout]`` in z's dtype.  The kernel multiplies on the tensor cores."""
    export_ops.refuse_export("kernel 19 (conv3x3_fwd, the conv/BN "
                             "forward fusion)")
    n, h, ww, cin, cout, dt = _check_conv(z, w)
    _check("z", z, z.shape, dt)
    _check("aff", aff, (2, cin), torch.float32)
    if not _on_card((z, aff, w)):
        return conv3x3_fwd_reference(z, aff, w, relu)
    _served((z, aff, w), (cin, cout))
    out = torch.empty((n, h, ww, cout), dtype=dt, device=z.device)
    if out.numel():
        wt = _tc_weights(w)
        _launch("conv3x3_fwd", [x.data_ptr() for x in (z, aff, wt, out)],
                (n, h, ww, cin, cout, int(relu), int(dt == torch.bfloat16)),
                z.device)
        conv3x3_fwd.launches += 1
    return out


conv3x3_fwd.launches = 0


def conv3x3_fwd_bwd(dy, z, aff, w, relu: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 20, the backward of :func:`conv3x3_fwd`: dy ``[N, H, W,
    Cout]``, z ``[N, H, W, Cin]``, aff ``[2, Cin]``, w the forward
    weights → (dz, x ``[N, H, W, Cin]`` in z's dtype, dac ``[2, Cin]``
    f32 = (dA, dC)).  The kernel multiplies on the tensor cores."""
    n, h, ww, cin, cout, dt = _check_conv(z, w)
    for name, x, shape, dtype in (("dy", dy, (n, h, ww, cout), dt),
                                  ("z", z, z.shape, dt),
                                  ("aff", aff, (2, cin), torch.float32)):
        _check(name, x, shape, dtype)
    if not _on_card((dy, z, aff, w)):
        return conv3x3_fwd_bwd_reference(dy, z, aff, w, relu)
    _served((dy, z, aff, w), (cin, cout))
    dz, x = torch.empty_like(z), torch.empty_like(z)
    part, dac = _parts(n, h, ww, cin, z.device)
    if not z.numel():
        return dz, x, dac.zero_()
    wt = _tc_weights(_flipped(w))
    _launch("conv3x3_fwd_bwd",
            [t.data_ptr() for t in (dy, z, aff, wt, dz, x, part, dac)],
            (n, h, ww, cin, cout, int(relu), int(dt == torch.bfloat16)),
            z.device)
    conv3x3_fwd_bwd.launches += 1
    return dz, x, dac


conv3x3_fwd_bwd.launches = 0


def conv3x3_dx(dy, z, coeffs, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 18: dy, z ``[N, H, W, Cout]``, coeffs ``[3, Cout]`` f32
    (rows A, B, C), w ``[3, 3, Cin, Cout]`` the forward weights → (dx
    ``[N, H, W, Cin]``, dz ``[N, H, W, Cout]``) in dy's dtype.  The kernel
    multiplies on the tensor cores."""
    enforce(isinstance(dy, torch.Tensor) and dy.dim() == 4,
            "dy: expected [N, H, W, Cout]")
    n, h, ww, cout = dy.shape
    enforce(isinstance(w, torch.Tensor) and w.dim() == 4
            and tuple(w.shape[:2]) == (3, 3) and w.shape[3] == cout,
            f"w: expected [3, 3, Cin, {cout}], got "
            f"{tuple(getattr(w, 'shape', ()))}")
    dt = dy.dtype
    enforce(dt in (torch.float32, torch.bfloat16),
            f"dy: expected float32 or bfloat16, got {dt}")
    cin = w.shape[2]
    for name, x, shape, dtype in (("dy", dy, dy.shape, dt),
                                  ("z", z, dy.shape, dt),
                                  ("coeffs", coeffs, (3, cout),
                                   torch.float32),
                                  ("w", w, w.shape, dt)):
        _check(name, x, shape, dtype)
    if not _on_card((dy, z, coeffs, w)):
        return conv3x3_dx_reference(dy, z, coeffs, w)
    _served((dy, z, coeffs, w), (cin, cout))
    dx = torch.empty((n, h, ww, cin), dtype=dt, device=dy.device)
    dz = torch.empty_like(z)
    if dy.numel():
        wt = _tc_weights(_flipped(w))
        _launch("conv3x3_dx",
                [t.data_ptr() for t in (dy, z, coeffs, wt, dx, dz)],
                (n, h, ww, cin, cout, int(dt == torch.bfloat16)), dy.device)
        conv3x3_dx.launches += 1
    return dx, dz


conv3x3_dx.launches = 0


def conv3x3_chain_bwd(dy, z2, co, z1, ci, w, relu: bool):
    """Kernel 21: dy, z2 ``[N, H, W, Cout]``, co ``[3, Cout]`` (the BN
    backward's A, B, C), z1 ``[N, H, W, Cin]``, ci ``[2, Cin]`` (the
    prologue's A, C), w ``[3, 3, Cin, Cout]`` → (dz2, dz1, x1 in the
    activations' dtype, dac ``[2, Cin]`` f32 = (dA₁, dC₁)).  The kernel
    multiplies on the tensor cores."""
    n, h, ww, cin, cout, dt = _check_conv(z1, w, ("z1", "w"))
    for name, x, shape, dtype in (("dy", dy, (n, h, ww, cout), dt),
                                  ("z2", z2, (n, h, ww, cout), dt),
                                  ("co", co, (3, cout), torch.float32),
                                  ("z1", z1, z1.shape, dt),
                                  ("ci", ci, (2, cin), torch.float32)):
        _check(name, x, shape, dtype)
    if not _on_card((dy, z2, co, z1, ci, w)):
        return conv3x3_chain_bwd_reference(dy, z2, co, z1, ci, w, relu)
    _served((dy, z2, co, z1, ci, w), (cin, cout))
    dz2 = torch.empty_like(z2)
    dz1, x1 = torch.empty_like(z1), torch.empty_like(z1)
    part, dac = _parts(n, h, ww, cin, z1.device)
    if not z1.numel():
        return dz2, dz1, x1, dac.zero_()
    wt = _tc_weights(_flipped(w))
    _launch("conv3x3_chain_bwd",
            [t.data_ptr() for t in (dy, z2, co, z1, ci, wt, dz2, dz1, x1,
                                    part, dac)],
            (n, h, ww, cin, cout, int(relu), int(dt == torch.bfloat16)),
            z1.device)
    conv3x3_chain_bwd.launches += 1
    return dz2, dz1, x1, dac


conv3x3_chain_bwd.launches = 0

#: Every kernel wrapper of this module (for counters and reports).
KERNEL_WRAPPERS = (conv3x3_dx, conv3x3_fwd, conv3x3_fwd_bwd,
                   conv3x3_chain_bwd)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


# ------------------------------------------------------------------ autograd
def _bn_bwd_coeffs(dy, z, scale, m, inv):
    """The BN backward as a per-channel affine of (dy, z): returns
    (dscale, dbias, [3, C] f32 rows A, B, C, N·H·W) — the one reduction
    pass of ``pallas_conv._core_bwd``."""
    nelem = float(z.shape[0] * z.shape[1] * z.shape[2])
    dy_f = dy.float()
    xhat = (z.float() - m) * inv
    dbias = dy_f.sum((0, 1, 2))
    dscale = (dy_f * xhat).sum((0, 1, 2))
    a_c = scale.float() * inv
    b_c = -a_c * inv * dscale / nelem
    c_c = a_c * (inv * m * dscale - dbias) / nelem
    return dscale, dbias, torch.stack([a_c, b_c, c_c]), nelem


def _bn_fwd(z, scale, bias, eps):
    m, v = _bn_stats(z, (0, 1, 2))
    inv = torch.rsqrt(v + eps)
    return _bn_apply(z, scale, bias, m, inv, 3), m, v, inv


class _ConvBnCore(torch.autograd.Function):
    """Training-mode conv(3×3, s1, p1) + cb → per-batch BatchNorm, NHWC
    (``pallas_conv._conv_bn_core``): x ``[N, H, W, Cin]``, w HWIO, cb /
    scale / bias ``[Cout]`` → (y, m, v).  The backward runs kernel 18;
    the m/v cotangents are dropped (running averages are stop-gradient
    state)."""

    @staticmethod
    def forward(ctx, x, w, cb, scale, bias, eps):
        w = w.contiguous()
        z = _conv3x3(x, w) + cb.to(x.dtype)
        y, m, v, inv = _bn_fwd(z, scale, bias, eps)
        ctx.save_for_backward(x, w, z, cb, scale, m, inv)
        ctx.mark_non_differentiable(m, v)
        return y, m, v

    @staticmethod
    def backward(ctx, dy, _dm, _dv):
        x, w, z, cb, scale, m, inv = ctx.saved_tensors
        dscale, dbias, coeffs, nelem = _bn_bwd_coeffs(dy, z, scale, m, inv)
        dx, dz = conv3x3_dx(dy.contiguous(), z, coeffs, w)
        dw = _conv3x3_wgrad(x, dz, w.shape)
        a_c, b_c, c_c = coeffs
        dcb = a_c * dbias + b_c * (nelem * m) + c_c * nelem
        return (dx, dw.to(w.dtype), dcb.to(cb.dtype),
                dscale.to(scale.dtype), dbias.to(scale.dtype), None)


class _AffineConvCore(torch.autograd.Function):
    """y = conv3×3(act(a·z + c), w) with the affine formed on load
    (``pallas_conv._affine_conv_core``): kernel 19 forward, kernel 20
    backward.  The residual is the RAW z (with a, c, w): x is recomputed
    in the backward kernel, never saved."""

    @staticmethod
    def forward(ctx, z, a, c, w, relu):
        z, w = z.contiguous(), w.contiguous()
        aff = torch.stack([a, c]).float()
        ctx.relu = relu
        ctx.save_for_backward(z, a, c, w)
        return conv3x3_fwd(z, aff, w, relu)

    @staticmethod
    def backward(ctx, dy):
        z, a, c, w = ctx.saved_tensors
        dz, x, dac = conv3x3_fwd_bwd(dy.contiguous(),
                                     z, torch.stack([a, c]).float(), w,
                                     ctx.relu)
        dw = _conv3x3_wgrad(x, dy.to(x.dtype), w.shape)
        return dz, dac[0].to(a.dtype), dac[1].to(c.dtype), dw.to(w.dtype), \
            None


class _ChainCore(torch.autograd.Function):
    """Training-mode act(a1·z1 + c1) → conv(3×3, s1, p1) + cb →
    per-batch BatchNorm, NHWC (``pallas_conv._chain_core``) → (y, m, v):
    kernel 19 forward, kernel 21 backward."""

    @staticmethod
    def forward(ctx, z1, a1, c1, w, cb, scale, bias, eps, relu):
        z1, w = z1.contiguous(), w.contiguous()
        ci = torch.stack([a1, c1]).float()
        z2 = conv3x3_fwd(z1, ci, w, relu) + cb.to(z1.dtype)
        y, m, v, inv = _bn_fwd(z2, scale, bias, eps)
        ctx.relu = relu
        ctx.save_for_backward(z1, ci, w, cb, scale, m, inv, z2)
        ctx.mark_non_differentiable(m, v)
        return y, m, v

    @staticmethod
    def backward(ctx, dy, _dm, _dv):
        z1, ci, w, cb, scale, m, inv, z2 = ctx.saved_tensors
        dscale, dbias, co, nelem = _bn_bwd_coeffs(dy, z2, scale, m, inv)
        dz2, dz1, x1, dac = conv3x3_chain_bwd(dy.contiguous(), z2, co, z1,
                                              ci, w, ctx.relu)
        dw = _conv3x3_wgrad(x1, dz2, w.shape)
        a_c, b_c, c_c = co
        dcb = a_c * dbias + b_c * (nelem * m) + c_c * nelem
        return (dz1, dac[0], dac[1], dw.to(w.dtype), dcb.to(cb.dtype),
                dscale.to(scale.dtype), dbias.to(scale.dtype), None, None)
