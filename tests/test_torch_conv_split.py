"""The numbers of kernel 19's tensor-core loop, modelled on the CPU.

The kernel (``paddle_tpu_torch/csrc/conv3x3_tc.cuh``) multiplies the f32
operand x = act(A·z + C) on bf16 tensor cores by carrying it as
hi = bf16(x) and lo = bf16(x - hi): two passes, hi·w + lo·w, for bf16
weights; fp32 weights are split the same way and the products are
hi·hi + hi·lo + lo·hi.  Here the same split feeds convolutions summed in
float64, so only the split's rounding is measured, against the plain
version summed in float64 and with ``chip_smoke.py``'s phase-3d
tolerance (``CONV_RTOL`` of max|ref| + 1e-6, plus ``CONV_BF16_ULPS`` bf16
ulps for bf16 outputs).  The card adds the tensor cores' own f32
accumulation, which phase 3d measures.  A single bf16 rounding of x must
miss the tolerance: that is why the kernel takes two passes.

The halo gather map the kernel uses (``ops.conv.halo_gather_map``, the
kernel's index arithmetic in plain torch) must reproduce ``F.conv2d``'s
zero padding, also where a 128-pixel tile spans images and for images
wider than 130 pixels (three bands).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import CONV_BF16_ULPS, CONV_CASES, CONV_RTOL, conv_error
from paddle_tpu_torch.ops import conv as C

assert (CONV_RTOL, CONV_BF16_ULPS) == (1e-5, 1.0)

F64 = torch.float64
# phase 3d's cases at N 1-2: the four ResNet-50 stage shapes, H != W with
# Cin != Cout both ways, the C + 3.0 border case, 192 -> 64 channels
CASES = [(1 if h >= 28 else min(n, 2), h, w, cin, cout, c_off)
         for n, h, w, cin, cout, c_off in CONV_CASES]


def _case(n, h, w, cin, cout, c_off, dtype, seed):
    """z, the prologue affine (A, C + c_off) and HWIO weights at the
    fan-in scale, as phase 3d draws them, from a numpy seed."""
    rng = np.random.default_rng(seed)
    aff = np.stack([rng.standard_normal(cin) * 0.5 + 1.0,
                    rng.standard_normal(cin) * 0.5 + c_off])
    z = rng.standard_normal((n, h, w, cin))
    wt = rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5
    return (torch.from_numpy(z.astype(np.float32)).to(dtype),
            torch.from_numpy(aff.astype(np.float32)),
            torch.from_numpy(wt.astype(np.float32)).to(dtype))


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _conv(x, w):
    return C._conv3x3(x.to(F64), w.to(F64))


def _kernel_model(z, aff, w, relu, passes):
    """The kernel's products summed exactly: x (and, for fp32 weights, w)
    as hi + lo bf16; ``passes`` 1 is a single rounding of x."""
    x = C._act(aff[0] * z.float() + aff[1], relu)   # f32, as the kernel
    xh, xl = _split(x)
    if passes == 1:
        return _conv(xh, w.float()).to(z.dtype)
    if w.dtype == torch.bfloat16:
        return (_conv(xh, w) + _conv(xl, w)).to(z.dtype)
    wh, wl = _split(w)
    return (_conv(xh, wh) + _conv(xh, wl) + _conv(xl, wh)).to(z.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", CASES,
                         ids=["x".join(map(str, c[:5])) + f"+{c[5]}"
                              for c in CASES])
def test_split_meets_phase_3d_tolerance(case, dtype):
    n, h, w, cin, cout, c_off = case
    z, aff, wt = _case(*case, dtype, seed=40 + CASES.index(case))
    for relu in (True, False):
        ref = C.conv3x3_fwd_reference(z, aff, wt, relu, F64)
        _, ratio = conv_error(_kernel_model(z, aff, wt, relu, 2), ref)
        assert ratio <= 0.75, (relu, ratio)
        _, once = conv_error(_kernel_model(z, aff, wt, relu, 1), ref)
        assert once > 10.0, (relu, once)


def _gathered_conv(x, w):
    """conv3x3 of x [N, H, W, Cin] through the halo gather map, tile by
    tile, in float64."""
    n, h, ww, cin = x.shape
    m = n * h * ww
    xf = x.reshape(m, cin).to(F64)
    out = torch.zeros((m, w.shape[3]), dtype=F64)
    for p0 in range(0, m, C.TC_TILE):
        pix, rows = C.halo_gather_map(n, h, ww, p0)
        halo = torch.zeros((pix.numel() + 1, cin), dtype=F64)
        inside = pix >= 0
        halo[:-1][inside] = xf[pix[inside]]
        acc = sum(halo[rows[t]] @ w[t // 3, t % 3].to(F64)
                  for t in range(9))
        k = min(C.TC_TILE, m - p0)
        out[p0:p0 + k] = acc[:k]
    return out.reshape(n, h, ww, -1)


@pytest.mark.parametrize("shape", [(3, 7, 7), (2, 9, 13), (2, 14, 14),
                                   (1, 3, 140), (1, 2, 300), (2, 1, 5)],
                         ids=["7x7-spans-images", "9x13", "14x14",
                              "W140-bands", "W300-bands", "1x5"])
def test_halo_gather_map_is_zero_padding(shape):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape + (4,)))
    w = torch.from_numpy(rng.standard_normal((3, 3, 4, 3)))
    want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(_gathered_conv(x, w), want, rtol=0,
                               atol=1e-12)


def test_halo_gather_map_stays_inside_each_image():
    """At 7x7 (ResNet-50's fourth stage) every tile spans images: a tap
    reads its own image's pixels or the zero row, never a neighbour's."""
    n, h, w = 4, 7, 7
    m = n * h * w
    for p0 in range(0, m, C.TC_TILE):
        pix, rows = C.halo_gather_map(n, h, w, p0)
        zero = pix.numel()
        own = torch.arange(p0, p0 + C.TC_TILE) // (h * w)
        for t in range(9):
            real = rows[t] != zero
            src = pix[rows[t][real]]
            assert (src >= 0).all()
            assert torch.equal(src // (h * w), own[real])
        # the centre tap of an in-range pixel is the pixel itself
        live = torch.arange(p0, p0 + C.TC_TILE) < m
        assert torch.equal(pix[rows[4][live]],
                           torch.arange(p0, p0 + C.TC_TILE)[live])
