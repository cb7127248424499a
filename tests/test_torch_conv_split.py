"""The numbers of the tensor-core conv loop (kernels 18-21), modelled on
the CPU.

The loop (``paddle_tpu_torch/csrc/conv3x3_tc.cuh``) multiplies an f32
operand -- x = act(A·z + C) for kernel 19, dz = A·dy + B·z + C for
kernels 18 and 21, dy for kernel 20 (the backward-data convs, with the
flipped weights) -- on bf16 tensor cores by carrying it as hi = bf16(x)
and lo = bf16(x - hi): two passes, hi·w + lo·w, for bf16 weights; fp32
weights are split the same way and the products are hi·hi + hi·lo +
lo·hi.  Kernel 20's bf16 dy is exact in bf16 (lo ≡ 0): one pass.  Here
the same split feeds convolutions summed in float64, so only the split's
rounding is measured, against the plain version summed in float64 and
with ``chip_smoke.py``'s phase-3d tolerance (``CONV_RTOL`` of max|ref| +
1e-6, plus ``CONV_BF16_ULPS`` bf16 ulps for bf16 outputs), on every
output (kernel 20's and 21's dz, x and channel sums come from the
modelled t).  The card adds the tensor cores' own f32 accumulation,
which phase 3d measures.  A single bf16 rounding of an f32 operand must
miss the tolerance: that is why the loop takes two passes.

The halo gather map the loop uses (``ops.conv.halo_gather_map``, the
kernel's index arithmetic in plain torch) must reproduce ``F.conv2d``'s
zero padding, also where a 128-pixel tile spans images and for images
wider than 130 pixels (three bands); and the rows whose dz the
kernels 18 and 21 store (``ops.conv.halo_dz_stores``) must write every
pixel exactly once over the grid.
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


def _bn_case(n, h, w, cout, c_off, dtype, seed):
    """dy, z2 [N, H, W, Cout] and the BN backward's (A, B, C + c_off), as
    phase 3d draws them, from a numpy seed."""
    rng = np.random.default_rng(seed)
    co = np.stack([rng.standard_normal(cout) * 0.5 + 1.0,
                   rng.standard_normal(cout) * 0.1,
                   rng.standard_normal(cout) * 0.5 + c_off])
    dy, z2 = (rng.standard_normal((n, h, w, cout)) for _ in range(2))
    return (torch.from_numpy(dy.astype(np.float32)).to(dtype),
            torch.from_numpy(z2.astype(np.float32)).to(dtype),
            torch.from_numpy(co.astype(np.float32)))


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _conv(x, w):
    return C._conv3x3(x.to(F64), w.to(F64))


def _passes(conv, x, w, passes):
    """conv(x, w) as the loop's products, summed exactly in float64: x
    (and, for fp32 weights, w) as hi + lo bf16; ``passes`` 1 is a single
    rounding of x."""
    xh, xl = _split(x)
    if passes == 1:
        return conv(xh, w.float())
    if w.dtype == torch.bfloat16:
        return conv(xh, w) + conv(xl, w)
    wh, wl = _split(w)
    return conv(xh, wh) + conv(xh, wl) + conv(xl, wh)


def _kernel_model(z, aff, w, relu, passes):
    """Kernel 19: the products of x = act(A·z + C) (f32, as the kernel
    forms it) in ``passes``."""
    x = C._act(aff[0] * z.float() + aff[1], relu)
    return _passes(_conv, x, w, passes).to(z.dtype)


def _dgrad(x, w):
    return C._conv3x3_dgrad(x.to(F64), w.to(F64))


def _bn_bwd_model(kernel, dy, z2, co, z, aff, w, relu, passes):
    """Kernels 18 (``"dx"``) and 21 (``"chain"``): dz = A·dy + B·z + C in
    f32 as the load hook forms it, its backward-data conv in ``passes``,
    then kernel 21's epilogue on that t → the kernel's outputs."""
    dz = co[0] * dy.float() + co[1] * z2.float() + co[2]
    t = _passes(_dgrad, dz, w, passes)
    if kernel == "dx":
        return t.to(dy.dtype), dz.to(dy.dtype)
    return (dz.to(dy.dtype),) + C._affine_bwd(t, z, aff, relu)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", CASES,
                         ids=["x".join(map(str, c[:5])) + f"+{c[5]}"
                              for c in CASES])
@pytest.mark.parametrize("kernel", ["dx", "chain"])
def test_bn_bwd_split_meets_phase_3d_tolerance(kernel, case, dtype):
    """Kernels 18 and 21 multiply the f32 dz as hi + lo: every output
    (dx; dz2, dz1, x1 and the channel sums) within 0.75 of phase 3d's
    tolerance, and a single rounding of dz beyond 10 times it."""
    n, h, w, cin, cout, c_off = case
    seed = 60 + CASES.index(case)
    z, aff, wt = _case(*case, dtype, seed=seed)
    dy, z2, co = _bn_case(n, h, w, cout, c_off, dtype, seed=seed + 100)
    for relu in (True, False):
        if kernel == "dx":
            ref = C.conv3x3_dx_reference(dy, z2, co, wt, F64)
        else:
            ref = C.conv3x3_chain_bwd_reference(dy, z2, co, z, aff, wt,
                                                relu, F64)
        got = _bn_bwd_model(kernel, dy, z2, co, z, aff, wt, relu, 2)
        _, ratio = conv_error(got, ref)
        assert ratio <= 0.75, (relu, ratio)
        once = _bn_bwd_model(kernel, dy, z2, co, z, aff, wt, relu, 1)
        _, ratio_once = conv_error(once, ref)
        assert ratio_once > 10.0, (relu, ratio_once)
        if kernel == "dx":
            break          # kernel 18 has no activation


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", CASES,
                         ids=["x".join(map(str, c[:5])) + f"+{c[5]}"
                              for c in CASES])
def test_fwd_bwd_split_meets_phase_3d_tolerance(case, dtype):
    """Kernel 20 multiplies dy as it is.  bf16 dy has lo ≡ 0, so its one
    pass is the exact product; fp32 dy as hi + lo with hi and lo weights
    (three passes) keeps every output (dz, x, dA, dC) within 0.75 of
    phase 3d's tolerance, and a single rounding of dy misses it by more
    than 10 times."""
    n, h, w, cin, cout, c_off = case
    seed = 80 + CASES.index(case)
    z, aff, wt = _case(*case, dtype, seed=seed)
    dy, _, _ = _bn_case(n, h, w, cout, c_off, dtype, seed=seed + 100)
    for relu in (True, False):
        ref = C.conv3x3_fwd_bwd_reference(dy, z, aff, wt, relu, F64)

        def model(passes):
            t = _passes(_dgrad, dy.float(), wt, passes)
            return C._affine_bwd(t, z, aff, relu)
        if dtype == torch.bfloat16:
            assert not _split(dy.float())[1].any()
            one = model(1)
            for a, b in zip(one, model(2)):
                assert torch.equal(a, b)
            _, ratio = conv_error(one, ref)
            assert ratio <= 0.75, (relu, ratio)
        else:
            _, ratio = conv_error(model(2), ref)
            assert ratio <= 0.75, (relu, ratio)
            _, once = conv_error(model(1), ref)
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


@pytest.mark.parametrize("shape", [(3, 7, 7), (2, 9, 13), (1, 56, 56),
                                   (2, 3, 140), (1, 2, 300), (2, 1, 5),
                                   (5, 7, 7)],
                         ids=["7x7-spans-images", "9x13", "56x56",
                              "W140-bands-partial", "W300-bands", "1x5",
                              "7x7-partial"])
def test_halo_dz_stores_write_each_pixel_once(shape):
    """kLoadBnBwd's dz stores (first channel block): over the grid's tiles
    every pixel's dz is stored exactly once, from the halo row that holds
    that pixel -- the row its centre tap reads -- in contiguous and band
    mode, for tiles that span images and a last tile past N·H·W."""
    n, h, w = shape
    m = n * h * w
    count = torch.zeros(m, dtype=torch.long)
    for p0 in range(0, m, C.TC_TILE):
        pix, rows = C.halo_gather_map(n, h, w, p0)
        j = C.halo_dz_stores(n, h, w, p0)
        q = pix[j]
        assert ((q >= p0) & (q < min(p0 + C.TC_TILE, m))).all()
        assert torch.equal(rows[4, q - p0], j)
        count += torch.bincount(q, minlength=m)
    assert torch.equal(count, torch.ones(m, dtype=torch.long))
