#!/usr/bin/env python3
"""Check and time the tensor-core kernels of the port on one GPU, alone:
kernels 18-21 (``conv3x3_dx``, ``conv3x3_fwd``, ``conv3x3_fwd_bwd``,
``conv3x3_chain_bwd`` on the wgmma loop of ``csrc/conv3x3_tc.cuh``),
kernels 1-train and 2 (``flash_fwd`` / ``flash_fwd_legacy``, bf16 on
wgmma) and kernel 17 (``gru_dw_blocked`` on the wgmma dW tile of
``csrc/dw_wg.cuh``).

    python3 tools/tc_probe.py [--only conv|flash|gru_dw ...] [--full]
                              [--time] [--patch NAME ...] [--csrc DIR ...]

Builds the port's kernels (``paddle_tpu_torch.ops._build``) and prints
what ptxas reports for their sources (and for ``flash_bwd_dq`` and
``flash_bwd_dkv``, kernels 3-6 on the same wgmma pieces), then holds
each kernel against its plain version on a few small cases, bf16 and
fp32 for the convs (every case and output reported, none stopping the
run: a layout fault shows as a pattern of ratios; the cases include W
140, the conv loop's band mode, and pixel counts off the 128-pixel
tile; kernel 17's include partial tiles, H 520 and 640, and lengths 0,
1 and T).  ``--full`` adds ``chip_smoke.py``'s phases 3d, 3g, 3h and 3f
(all cases, their tolerances); ``--time`` its phase-5 timings of these
kernels at the main paths' shapes (kernels 18-21 at the four ResNet-50
stages beside ``F.conv2d`` / ``conv2d_input``; kernels 1-train and 2
beside SDPA; kernels 15-17 at B 128, T 30, H 1024 beside
``torch.matmul``).  ``--patch NAME`` (repeatable) times a knock-out of
the sources (``PATCHES``: a copy of ``csrc`` with one part of the work
removed, whose results are wrong by design and not checked) beside the
unpatched kernels, in turns, at the same shapes: for the convs
``conv_no_halo``, ``conv_no_lo``, ``conv_no_mma`` (18-21; 20's bf16 loop
has no lo pass), ``conv_no_dz_store`` (18, 21), ``conv_no_epi_sums`` and
``conv_no_epi`` (21); for kernel 17 ``gru_dw_no_lo`` (the hi*lo and
lo*hi passes; the lo planes are still formed), ``gru_dw_no_split``,
``gru_dw_no_mma``.  ``--csrc DIR`` (repeatable) times the kernels of
another copy of ``csrc`` (an older version unpacked with ``git
archive`` into a gitignored directory) the same way.  Prints the card's
name and power limit.  Exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONV_SMALL = [(1, 8, 8, 64, 64, 0.0), (2, 7, 7, 64, 64, 3.0),
              (1, 9, 13, 64, 128, 0.0), (2, 7, 7, 128, 64, 0.0),
              (1, 3, 140, 64, 64, 1.0), (2, 3, 140, 64, 128, -1.0)]
#: kernel 17: (B, T, H, lengths) -- partial tiles at H 520 and 640,
#: the scalar staging at H 514 (H % 4 != 0), lengths 0, 1 and T, every
#: step valid at the main shape
GRU_DW_SMALL = [(8, 12, 640, [12, 0, 1, 12, 5, 1, 9, 3]),
                (16, 7, 520, [7, 0, 1] + [1 + i % 7 for i in range(13)]),
                (3, 5, 640, [5, 1, 3]), (5, 6, 514, [6, 0, 1, 6, 3]),
                (128, 30, 1024, [30] * 128)]
FLASH_SMALL = [(1, 128, 1, 64, False, None), (1, 128, 1, 64, True, None),
               (2, 200, 2, 64, True, [200, 77]), (1, 256, 2, 32, True, None),
               (1, 256, 2, 128, False, [256]), (2, 384, 2, 64, False,
                                                [384, 65])]


_TC_CONV = ("conv3x3_fwd", "conv3x3_dx", "conv3x3_fwd_bwd",
            "conv3x3_chain_bwd")
_TC_GRU = ("gru_dw_blocked",)
_TC_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: name -> (kernel stems, [(file, old text, new text)])
PATCHES = {
    # the conv loop without forming the halo (planes left as they are;
    # both paths: registers, and bf16 kLoadBnBwd's cp.async)
    "conv_no_halo": (_TC_CONV, [
        ("conv3x3_tc.cuh", "i0 < rows * 8; i0 += C::kDepth * kThreads)",
         "i0 < 0; i0 += C::kDepth * kThreads)"),
        ("conv3x3_tc.cuh", "i < rows * 8; i += kThreads)",
         "i < 0; i += kThreads)")]),
    # the conv loop without the lo pass
    "conv_no_lo": (_TC_CONV, [(
        "conv3x3_tc.cuh", "        wg::mma_rs_n64<1>(acc, fb[kk],",
        "        if (0) wg::mma_rs_n64<1>(acc, fb[kk],")]),
    # the conv loop without products
    "conv_no_mma": (_TC_CONV, [
        ("conv3x3_tc.cuh", "        wg::mma_rs_n64<1>(acc, fb[kk],",
         "        if (0) wg::mma_rs_n64<1>(acc, fb[kk],"),
        ("conv3x3_tc.cuh", "        wg::mma_rs_n64<1>(acc, fa[kk],",
         "        if (0) wg::mma_rs_n64<1>(acc, fa[kk],"),
        ("conv3x3_tc.cuh", "          wg::mma_rs_n64<1>(acc, f[kk],",
         "          if (0) wg::mma_rs_n64<1>(acc, f[kk],")]),
    # kernels 18 and 21 without the dz store
    "conv_no_dz_store": (("conv3x3_dx", "conv3x3_chain_bwd"), [
        ("conv3x3_tc.cuh", "if (own[e] >= 0) {", "if (0) {"),
        ("conv3x3_tc.cuh", "if (write_dz && q >= p0 && q < p0 + kBM)",
         "if (0)")]),
    # kernel 21 without the epilogue's channel sums (shuffles, shared
    # memory, the CTA's sum)
    "conv_no_epi_sums": (("conv3x3_chain_bwd",), [
        ("conv3x3_tc.cuh", "for (int k = 0; k < 4; ++k) {\n"
         "      s[k] += __shfl_xor_sync", "for (int k = 0; k < 0; ++k) {\n"
         "      s[k] += __shfl_xor_sync"),
        ("conv3x3_tc.cuh", "    if (g == 0) {", "    if (0) {"),
        ("conv3x3_tc.cuh", "  if (tid < 2 * kBN) {", "  if (0) {")]),
    # kernel 21 without its epilogue (no z1 read, dz1 / x1 / sums
    # written); the sums stay live through a store that never runs, or
    # ptxas drops the products with them
    "conv_no_epi": (("conv3x3_chain_bwd",), [(
        "conv3x3_tc.cuh",
        "    epi_affine_bwd<T>(p, tot, st, red, p0, n0, wgi);",
        "    float x = 0.f;\n    for (int i = 0; i < 32; ++i) x += tot[i];\n"
        "    if (x == 1.2345e-30f) p.part[tid] = x;")]),
    # kernel 17 without the hi*lo and lo*hi passes
    "gru_dw_no_lo": (_TC_GRU, [
        ("dw_wg.cuh", "wg::mma_ss_n128<1, 1>(acc, a_hi + kk * kStep, b_lo",
         "if (0) wg::mma_ss_n128<1, 1>(acc, a_hi + kk * kStep, b_lo"),
        ("dw_wg.cuh", "      wg::mma_ss_n128<1, 1>(acc, a_lo",
         "      if (0) wg::mma_ss_n128<1, 1>(acc, a_lo")]),
    # kernel 17 without splitting its copies (the planes hold raw f32)
    "gru_dw_no_split": (_TC_GRU, [
        ("dw_wg.cuh", "if (kVec && ch", "if (0 && ch")]),
    # kernel 17 without its copies (the planes keep what they hold)
    "gru_dw_no_copy": (_TC_GRU, [
        ("dw_wg.cuh", "    cp_async16_l1(h, ok0 ? src + c : any, ok0);\n"
         "    cp_async16_l1(l, ok1 ? src + c + 4 : any, ok1);", "")]),
    # kernel 17 without products (the copies, splits, sums and stores stay)
    "gru_dw_no_mma": (_TC_GRU, [
        ("dw_wg.cuh", "      wg::mma_ss_n128<1, 1>(acc,",
         "      if (0) wg::mma_ss_n128<1, 1>(acc,")]),
    # flash forward without exponentials
    "flash_no_exp": (("flash_fwd",), [(
        "flash_common.cuh",
        'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
        "y = x;")]),
    # flash forward without the lo half of P V
    "flash_no_pv_lo": (("flash_fwd",), [(
        "flash_wg.cuh", "    wg::mma_rs<D, 1>(acc, pl[kk],",
        "    if (0) wg::mma_rs<D, 1>(acc, pl[kk],")]),
    # flash forward without the softmax (P = the raw scores)
    "flash_no_softmax": (("flash_fwd",), [(
        "flash_fwd.cu",
        "      softmax_tile<M>(sc, scale_log2, k0, M ? tile_mask() : "
        "TileMask{}, m0,\n                      m1, l0, l1, al0, al1);",
        "      al0 = al1 = 1.f;")]),
}


def build_variant(variant):
    """Build a variant, ``(name, csrc dir, edits, stems)``; returns
    (kernel stems, {symbol: ctypes function})."""
    from probe_build import build_variant as build
    name, src, edits, stems = variant
    fns, ptxas = build(os.path.join(ROOT, "build", "tc_probe", name), src,
                       edits, stems)
    for stem in stems:
        regs = [ln.strip() for ln in ptxas[stem].splitlines()
                if "registers" in ln or "arning" in ln]
        print(f"  built {name}/{stem}: {regs}", flush=True)
    return stems, fns


def time_variants(dev, cs, variants):
    """Each variant (a knock-out or another csrc) beside the repository's
    kernels, in turns (repo, the variants, then in reverse): kernels
    18-21 at the four ResNet-50 stages (bf16), kernels 1-train
    (non-causal) and 2 (causal) at the transformer's shape, kernel 17 at
    B 128, T 30, H 1024 (every step valid)."""
    import torch
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import gru as G
    names = [v[0] for v in variants]
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        built = dict(zip(names, ex.map(build_variant, variants)))
    real = _build.kernel
    stems = set().union(*(built[n][0] for n in names))
    calls = {}
    for si, (hw, ch) in enumerate(cs.RESNET_STAGES):
        if not stems & set(_TC_CONV):
            break
        case = cs.conv_case(cs.RESNET_B, hw, hw, ch, ch, torch.bfloat16,
                            60 + si, dev)
        for stem, (kern, _) in cs.conv_calls(case, True).items():
            if stem in stems:
                calls[(stem, f"stage {hw}x{hw}x{ch}")] = kern
    if "flash_fwd" in stems:
        q, k, v, _ = cs.causal_t2048_inputs(dev)
        b, t = q.shape[:2]
        win_q, _ = A.tile_windows(None, None, b, t, t, dev)
        calls[("flash_fwd", "1-train non-causal")] = (
            lambda: A.flash_fwd(q, k, v, None, None, False, win_q))
        calls[("flash_fwd", "2 causal")] = (
            lambda: A.flash_fwd_legacy(q, k, v, None, True))
    if "gru_dw_blocked" in stems:
        b, t, h = cs.S2S["B"], cs.S2S["T"], cs.S2S_WIDE_H
        g = torch.Generator(device=dev).manual_seed(0)
        args = (torch.randn(b, t, h, generator=g, device=dev),
                torch.randn(b, h, generator=g, device=dev),
                torch.randn(b, t, h, generator=g, device=dev),
                torch.randn(b, t, 3 * h, generator=g, device=dev),
                torch.ones((b, t), device=dev))
        calls[("gru_dw_blocked", f"B {b} T {t} H {h}")] = (
            lambda: G.gru_dw_blocked(*args))
    def flat(out):
        out = out if isinstance(out, tuple) else (out,)
        return torch.cat([x.float().flatten() for x in out])
    order = ["repo"] + list(names)
    unpatched = {v[0] for v in variants if not v[2]}
    want = {}
    for turn, order_t in enumerate((order, order[::-1])):
        for var in order_t:
            var_stems, fns = built.get(var, ((), {}))
            for (kstem, label), call in calls.items():
                if var != "repo" and kstem not in var_stems:
                    continue
                _build.kernel = (lambda sym, f=fns: f[sym] if sym in f
                                 else real(sym))
                try:
                    ms = cs.time_ms(call, reps=5, rounds=3)
                    out = flat(call()) if turn == 0 else None
                finally:
                    _build.kernel = real
                diff = ""
                if var == "repo" and out is not None:
                    want[(kstem, label)] = out
                elif var in unpatched and out is not None:
                    ref = want[(kstem, label)]
                    diff = (f"; max |out - repo's| / max|repo's| "
                            f"{((out - ref).abs().max() / ref.abs().max()).item():.2e}")
                print(f"turn {turn} {var} {kstem} {label}: "
                      f"{ms * 1e3:.2f} us{diff}", flush=True)


def conv_small(dev, cs):
    """Kernels 18-21 on the small cases, bf16 and fp32, ReLU and linear
    prologues, against their plain versions summed in float64; each
    output's ratio is reported."""
    import torch
    ok = True
    for i, (n, h, w, cin, cout, c_off) in enumerate(CONV_SMALL):
        for dt in (torch.bfloat16, torch.float32):
            case = cs.conv_case(n, h, w, cin, cout, dt, 90 + i, dev, c_off)
            for relu in (True, False):
                calls = cs.conv_calls(case, relu)
                for name in _TC_CONV:
                    kern, plain = calls[name]
                    got, want = kern(), plain(torch.float64)
                    cs.sync(dev)
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    parts = [cs.conv_error(a, b) for a, b in zip(got, want)]
                    ratio = max(r for _, r in parts)
                    print(f"  {name} {str(dt)[6:]} N={n} H={h} W={w} "
                          f"Cin={cin} Cout={cout} C+{c_off} relu={relu}: "
                          "max err / ratio by output " + ", ".join(
                              f"{e:.2e}/{r:.3f}" for e, r in parts),
                          flush=True)
                    ok = ok and ratio <= 1.0
    return ok


def gru_dw_small(dev, cs):
    """Kernel 17 on ``GRU_DW_SMALL`` against its plain version, with
    phase 3f's gradient tolerance; each gradient's ratio is reported."""
    import torch
    from paddle_tpu_torch.ops import gru as G
    ok = True
    for i, (b, t, h, lengths) in enumerate(GRU_DW_SMALL):
        g = torch.Generator(device=dev).manual_seed(110 + i)
        ln = torch.tensor(lengths, device=dev)
        mask = (torch.arange(t, device=dev)[None, :] < ln[:, None]).float()
        args = (torch.randn(b, t, h, generator=g, device=dev) * 0.5,
                torch.randn(b, h, generator=g, device=dev) * 0.5,
                torch.randn(b, t, h, generator=g, device=dev) * 0.5,
                torch.randn(b, t, 3 * h, generator=g, device=dev)
                * mask[..., None], mask)
        got, want = G.gru_dw_blocked(*args), G.gru_dw_blocked_reference(*args)
        cs.sync(dev)
        parts = [cs.grad_errors({0: a}, {0: r}, cs.GRU_GRAD_ATOL,
                                cs.GRU_GRAD_RTOL) for a, r in zip(got, want)]
        print(f"  gru_dw_blocked B={b} T={t} H={h} lengths {min(lengths)}.."
              f"{max(lengths)}: max err / ratio dW_gates, dW_cand "
              + ", ".join(f"{e:.2e}/{r:.3f}" for e, r in parts), flush=True)
        ok = ok and max(r for _, r in parts) <= 1.0
    return ok


def flash_small(dev, cs):
    import torch
    from paddle_tpu_torch.ops import attention as A
    ok = True
    for i, (b, t, h, d, causal, lengths) in enumerate(FLASH_SMALL):
        q, k, v, _ = cs.flash_case(b, t, t, h, d, torch.bfloat16, 70 + i,
                                   dev)
        ln = None if lengths is None else torch.tensor(
            lengths, dtype=torch.int32, device=dev)
        ref, ref_lse = A._dense_forward(q, k, v, ln, causal)
        for name, (out, lse) in (
                ("flash_fwd", A.flash_fwd(q, k, v, ln, None, causal)),
                ("flash_fwd_legacy", A.flash_fwd_legacy(q, k, v, ln,
                                                        causal))):
            cs.sync(dev)
            e, ratio = cs.flash_error(out, ref)
            e_lse = (lse - ref_lse).abs().max().item()
            print(f"  {name} B {b} T {t} H {h} D {d} causal {causal} "
                  f"lengths {lengths}: max err {e:.3e}, {ratio:.3f} of "
                  f"tolerance; lse {e_lse:.3e}", flush=True)
            ok = ok and ratio <= 1.0 and e_lse <= cs.FLASH_LSE_ATOL
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", action="append",
                    choices=("conv", "flash", "gru_dw"))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--patch", action="append", default=[],
                    choices=sorted(PATCHES))
    ap.add_argument("--csrc", action="append", default=[],
                    help="another kernel source directory to time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tc_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.ops import _build
    dev = resolve_device("cuda")
    cs.set_flags(use_bf16=False, bf16_activations=False, precision="fp32",
                 fused_rnn_hblock=True)      # as chip_smoke.py's phases 3-3i
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    _build.build_all()
    for stem in _TC_CONV + _TC_FLASH + _TC_GRU:
        info = _build.build_info.get(stem, {})
        print(f"build {stem}: {info.get('seconds', 0.0):.2f} s", flush=True)
        for ln in info.get("ptxas", "").splitlines():
            if any(s in ln for s in ("registers", "spill", "arning",
                                     "rror", "entry function")):
                print(f"  {ln.strip()}", flush=True)
    ok = True
    only = args.only or ("conv", "flash", "gru_dw")
    conv, flash, gru = (m in only for m in ("conv", "flash", "gru_dw"))
    if conv:
        ok = conv_small(dev, cs) and ok
    if flash:
        ok = flash_small(dev, cs) and ok
    if gru:
        ok = gru_dw_small(dev, cs) and ok
    if not ok:
        print("tc_probe: a small case disagrees", flush=True)
        return 1
    if args.full:
        if conv:
            cs.phase_conv_check(dev)
        if flash:
            cs.phase_flash_check(dev)
            cs.phase_legacy_check(dev)
        if gru:
            cs.phase_gru_blocked_check(dev)
    if args.time:
        launches = collections.defaultdict(dict)
        if conv:
            cs.phase_time_conv(dev, launches, names=_TC_CONV)
        if flash:
            cs.phase_time_flash(dev, launches)
            cs.phase_time_legacy(dev, launches)
        if gru:
            cs.phase_time_gru_blocked(dev, launches)
    stems = (_TC_CONV if conv else ()) + (_TC_FLASH[:1] if flash else ()) \
        + (_TC_GRU if gru else ())
    variants = [(name, _build.CSRC_DIR, PATCHES[name][1], PATCHES[name][0])
                for name in args.patch]
    variants += [(f"csrc{i}", d, [], stems) for i, d in enumerate(args.csrc)]
    if variants:
        time_variants(dev, cs, variants)
    print(f"card: {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
