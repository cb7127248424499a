#!/usr/bin/env python3
"""Check and time the tensor-core kernels of the port on one GPU, alone:
kernel 19 (``conv3x3_fwd``, bf16 on wgmma) and kernels 1-train and 2
(``flash_fwd`` / ``flash_fwd_legacy``, bf16 on wgmma).

    python3 tools/tc_probe.py [--only conv|flash] [--full] [--time]

Builds the port's kernels (``paddle_tpu_torch.ops._build``) and prints
what ptxas reports for the two sources, then holds each kernel against
its plain version on a few small cases (every case reported, none
stopping the run: a layout fault shows as a pattern of ratios).
``--full`` adds ``chip_smoke.py``'s phases 3d, 3g and 3h (all cases,
their tolerances); ``--time`` its phase-5 timings of these kernels at
the main paths' shapes (kernel 19 at the four ResNet-50 stages beside
``F.conv2d``; kernels 1-train and 2 beside SDPA).  ``--patch NAME``
(repeatable) times a knock-out of the sources (``PATCHES``: a copy of
``csrc`` with one part of the work removed, whose results are wrong by
design and not checked) beside the unpatched kernels, in turns, at the
same shapes.  Prints the card's name and power limit.  Exits 1 when a
check fails.
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
              (1, 3, 140, 64, 64, 1.0)]
FLASH_SMALL = [(1, 128, 1, 64, False, None), (1, 128, 1, 64, True, None),
               (2, 200, 2, 64, True, [200, 77]), (1, 256, 2, 32, True, None),
               (1, 256, 2, 128, False, [256]), (2, 384, 2, 64, False,
                                                [384, 65])]


#: name -> (kernel stem, [(file, old text, new text)])
PATCHES = {
    # kernel 19 without forming the halo (planes left as they are)
    "conv_no_halo": ("conv3x3_fwd", [(
        "conv3x3_tc.cuh", "i0 < rows * 8; i0 += 8 * kThreads)",
        "i0 < 0; i0 += 8 * kThreads)")]),
    # kernel 19 without the lo pass
    "conv_no_lo": ("conv3x3_fwd", [(
        "conv3x3_tc.cuh", "        wg::mma_rs_n64<1>(acc, fb[kk],",
        "        if (0) wg::mma_rs_n64<1>(acc, fb[kk],")]),
    # kernel 19 without products
    "conv_no_mma": ("conv3x3_fwd", [
        ("conv3x3_tc.cuh", "        wg::mma_rs_n64<1>(acc, fb[kk],",
         "        if (0) wg::mma_rs_n64<1>(acc, fb[kk],"),
        ("conv3x3_tc.cuh", "        wg::mma_rs_n64<1>(acc, fa[kk],",
         "        if (0) wg::mma_rs_n64<1>(acc, fa[kk],")]),
    # flash forward without exponentials
    "flash_no_exp": ("flash_fwd", [(
        "flash_common.cuh",
        'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
        "y = x;")]),
    # flash forward without the lo half of P V
    "flash_no_pv_lo": ("flash_fwd", [(
        "flash_fwd.cu", "    wg::mma_rs<D, 1>(o, pl[kk],",
        "    if (0) wg::mma_rs<D, 1>(o, pl[kk],")]),
    # flash forward without the softmax (P = the raw scores)
    "flash_no_softmax": ("flash_fwd", [(
        "flash_fwd.cu",
        "      softmax_tile(sc, rm, k0, m0, m1, l0, l1, al0, al1);",
        "      al0 = al1 = 1.f;")]),
}


def build_patch(name):
    """Build the knock-out ``name`` from a patched copy of csrc; returns
    (kernel stem, {symbol: ctypes function})."""
    import ctypes
    import shutil
    from paddle_tpu_torch.ops import _build
    stem, edits = PATCHES[name]
    d = os.path.join(ROOT, "build", "tc_probe", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, d)
    for fname, old, new in edits:
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise SystemExit(f"patch {name}: text not found in {fname}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    so = os.path.join(d, f"{stem}.so")
    out = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS
                         + ["-o", so, os.path.join(d, f"{stem}.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{out.stdout}"
                         f"{out.stderr}")
    lib = ctypes.CDLL(so)
    fns = {}
    for sym, (lib_stem, argtypes) in _build.SIGNATURES.items():
        if lib_stem == stem:
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[sym] = fn
    return stem, fns


def time_patches(dev, cs, names):
    """Each knock-out beside the unpatched kernel, in turns (repo, the
    knock-outs, then in reverse): kernel 19 at the four ResNet-50 stages,
    or kernels 1-train (non-causal) and 2 (causal) at the transformer's
    shape."""
    import torch
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import conv as C
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(build_patch, names)))
    real = _build.kernel
    calls = {}
    for si, (hw, ch) in enumerate(cs.RESNET_STAGES):
        case = cs.conv_case(cs.RESNET_B, hw, hw, ch, ch, torch.bfloat16,
                            60 + si, dev)
        calls[("conv3x3_fwd", f"stage {hw}x{hw}x{ch}")] = (
            lambda c=case: C.conv3x3_fwd(c["z"], c["aff"], c["w"], True))
    q, k, v, _ = cs.causal_t2048_inputs(dev)
    b, t = q.shape[:2]
    win_q, _ = A.tile_windows(None, None, b, t, t, dev)
    calls[("flash_fwd", "1-train non-causal")] = (
        lambda: A.flash_fwd(q, k, v, None, None, False, win_q))
    calls[("flash_fwd", "2 causal")] = (
        lambda: A.flash_fwd_legacy(q, k, v, None, True))
    order = ["repo"] + list(names)
    for turn, variants in enumerate((order, order[::-1])):
        for var in variants:
            stem, fns = built.get(var, (None, {}))
            for (kstem, label), call in calls.items():
                if var != "repo" and kstem != stem:
                    continue
                _build.kernel = (lambda sym, f=fns: f[sym] if sym in f
                                 else real(sym))
                try:
                    ms = cs.time_ms(call, reps=5, rounds=3)
                finally:
                    _build.kernel = real
                print(f"turn {turn} {var} {kstem} {label}: "
                      f"{ms * 1e3:.2f} us", flush=True)


def conv_small(dev, cs):
    import torch
    from paddle_tpu_torch.ops import conv as C
    ok = True
    for i, (n, h, w, cin, cout, c_off) in enumerate(CONV_SMALL):
        for relu in (True, False):
            case = cs.conv_case(n, h, w, cin, cout, torch.bfloat16, 90 + i,
                                dev, c_off)
            got = C.conv3x3_fwd(case["z"], case["aff"], case["w"], relu)
            want = C.conv3x3_fwd_reference(case["z"], case["aff"], case["w"],
                                           relu, torch.float64)
            cs.sync(dev)
            e, ratio = cs.conv_error(got, want)
            print(f"  conv3x3_fwd N={n} H={h} W={w} Cin={cin} Cout={cout} "
                  f"C+{c_off} relu={relu}: max err {e:.3e}, {ratio:.3f} of "
                  "tolerance", flush=True)
            ok = ok and ratio <= 1.0
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
    ap.add_argument("--only", choices=("conv", "flash"))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--patch", action="append", default=[],
                    choices=sorted(PATCHES))
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    _build.build_all()
    for stem in ("conv3x3_fwd", "flash_fwd"):
        info = _build.build_info.get(stem, {})
        print(f"build {stem}: {info.get('seconds', 0.0):.2f} s", flush=True)
        for ln in info.get("ptxas", "").splitlines():
            if any(s in ln for s in ("registers", "spill", "arning",
                                     "rror", "entry function")):
                print(f"  {ln.strip()}", flush=True)
    ok = True
    conv, flash = args.only in (None, "conv"), args.only in (None, "flash")
    if conv:
        ok = conv_small(dev, cs) and ok
    if flash:
        ok = flash_small(dev, cs) and ok
    if not ok:
        print("tc_probe: a small case disagrees", flush=True)
        return 1
    if args.full:
        if conv:
            cs.phase_conv_check(dev)
        if flash:
            cs.phase_flash_check(dev)
            cs.phase_legacy_check(dev)
    if args.time:
        launches = collections.defaultdict(dict)
        if conv:
            cs.phase_time_conv(dev, launches, names=("conv3x3_fwd",))
        if flash:
            cs.phase_time_flash(dev, launches)
            cs.phase_time_legacy(dev, launches)
    if args.patch:
        time_patches(dev, cs, args.patch)
    print(f"card: {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
