#!/usr/bin/env python3
"""Time the hidden-blocked LSTM kernels (kernels 10-12 of the port) in
several variants on one GPU, in one process, so their times compare.

    python3 tools/lstm_blocked_probe.py [--csrc DIR ...] [--patch NAME ...]
                                        [--shape B,T,H ...] [--reps N]

A variant is a copy of a kernel source directory (the repository's
``paddle_tpu_torch/csrc`` by default; ``--csrc`` adds others, such as an
older version unpacked with ``git archive``), optionally with a named
text patch applied (``--patch``, see ``PATCHES``: knock-outs that remove
one part of the work to show what it costs, each keeping the results
live; their results are wrong by design and are not checked).  Every
variant is built with the port's ``nvcc`` flags by
``tools/probe_build.py`` (its ptxas lines printed: registers, spills and
the wgmma serialization warnings C7514-C7517), run at each shape on the
bench feed's lengths, held against the plain versions in
``paddle_tpu_torch.ops.lstm`` (unpatched variants only) and timed
between CUDA events in two turns (the variants in order, then in
reverse).  Sources from before the tensor-core backward (no step ranks
in ``lstm_bwd_blocked.cu``) take that kernel's older arguments.  Prints
one line per (turn, shape, variant, kernel) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "probe")
KERNELS = ("lstm_fwd_blocked", "lstm_bwd_blocked", "lstm_dw_blocked")

#: name -> [(file, old text, new text)]
PATCHES = {
    # kernel 10: a quarter of the product's FMAs (all shared loads stay)
    "quarter_fma": [("lstm_common.cuh",
                     "          acc[i][d] += a[i].y * b[d].y;\n"
                     "          acc[i][d] += a[i].z * b[d].z;\n"
                     "          acc[i][d] += a[i].w * b[d].w;\n", "")],
    # kernel 10: no L2 -> shared copies in the product (stale tiles)
    "no_copy": [("lstm_common.cuh",
                 "      cp_async16(dst + r * kTileStride + c, ok ? src + k0 + c"
                 " : any, ok);\n", "")],
    # kernel 10: a 4-deep k-tile pipeline
    "stages4": [("lstm_common.cuh", "constexpr int kBStages = 3;",
                 "constexpr int kBStages = 4;")],
    # kernels 10 and 11: no grid barrier between the steps' phases (the
    # prologue's barriers stay: the step ranks are read after them)
    "no_barrier": [("lstm_fwd_blocked.cu", "grid.sync();", "(void)grid;"),
                   ("lstm_bwd_blocked.cu", "grid.sync();  // step",
                    "(void)grid;")],
    # kernel 11: no tensor-core products (the loads, waits, drains and
    # stores of the sums stay)
    "no_products": [("lstm_bwd_blocked.cu",
                     "            wg::mma_ss_n128<0, 0>(acc, ah + 2 * kk, "
                     "bh + 2 * kk, kk > 0);\n"
                     "            wg::mma_ss_n128<0, 0>(acc, ah + 2 * kk, "
                     "bl + 2 * kk, 1);\n"
                     "            wg::mma_ss_n128<0, 0>(acc, al + 2 * kk, "
                     "bh + 2 * kk, 1);\n", "")],
    # kernel 11: no TMA loads (each ring slot's barrier completes on its
    # arrival; the products read stale tiles)
    "no_loads": [("lstm_bwd_blocked.cu", "wg::mbar_expect(full + s, kStage);",
                  "wg::mbar_expect(full + s, 0);"),
                 ("lstm_bwd_blocked.cu", "wg::tma_load_2d(",
                  "if (0) wg::tma_load_2d(")],
    # kernel 11: every tile loads w_hh's (or the dgates') planes at the
    # same coordinates (one hot box in L2; the bytes stay)
    "w_same": [("lstm_bwd_blocked.cu", "&tm_whi, full + s, k0, u0);",
                "&tm_whi, full + s, 0, 0);"),
               ("lstm_bwd_blocked.cu", "&tm_wlo, full + s, k0, u0);",
                "&tm_wlo, full + s, 0, 0);")],
    "a_same": [("lstm_bwd_blocked.cu", "&tm_ahi, full + s, k0, r0);",
                "&tm_ahi, full + s, 0, 0);"),
               ("lstm_bwd_blocked.cu", "&tm_alo, full + s, k0, r0);",
                "&tm_alo, full + s, 0, 0);")],
    # kernel 11: the tiles' skeleton (no TMA loads and no products)
    "skeleton": "no_loads+no_products",
    # kernel 11: no stores of the tiles' sums (kept live behind a test
    # that never passes)
    "no_epilogue": [("lstm_bwd_blocked.cu",
                     "        if (row >= n || wgi >= 2) continue;",
                     "        if (row >= n || wgi >= 2 || B > 0) continue;")],
    # kernel 11: the pairs read no slice sums
    "no_parts": [("lstm_bwd_blocked.cu", "      if (r >= 0)\n",
                  "      if (r >= 0 && B < 0)\n")],
    # kernel 11: the pairs run no phase A (their sums kept live in dhp)
    "no_phase_a": [("lstm_bwd_blocked.cu",
                    "        phase_a(a, t - 1, b, unit, dh, dc,\n"
                    "                __ldcg(a.rank + (long)(t - 1) * B + b));",
                    "        a.dhp[p] = dh + dc;")],
    # kernel 11: no product tiles at all (phase A reads stale sums)
    "no_tiles": [("lstm_bwd_blocked.cu", "      if (r0 >= n) continue;",
                  "      if (r0 >= 0) continue;")],
    # kernel 11: no pairs' work in the steps (the tiles read stale planes)
    "no_pairs": [("lstm_bwd_blocked.cu",
                  "    for (long p = first; p < BH; p += stride) {\n"
                  "      const int b = (int)(p / H), unit = (int)(p % H);",
                  "    for (long p = BH + first; p < BH; p += stride) {\n"
                  "      const int b = (int)(p / H), unit = (int)(p % H);")],
    # kernel 11: phase A writes no planes of dgates (the products read
    # stale ones)
    "no_plane_writes": [("lstm_bwd_blocked.cu",
                         "    put_split(p, lo, di_pre);\n"
                         "    put_split(p + H, lo, df_pre);\n"
                         "    put_split(p + 2 * H, lo, dg_pre);\n"
                         "    put_split(p + 3 * H, lo, do_pre);\n", "")],
}


def ptxas_lines(text):
    """Registers, spills and the wgmma serialization warnings of a build."""
    keep = ("entry function", "registers", "spill", "C7514", "C7515",
            "C7516", "C7517")
    return [ln.strip() for ln in text.splitlines()
            if any(k in ln for k in keep)]


def build(name, src_dir, patch):
    from probe_build import build_variant
    edits = PATCHES.get(patch, [])
    if isinstance(edits, str):   # a combination of other knock-outs
        edits = [e for part in edits.split("+") for e in PATCHES[part]]
    fns, ptxas = build_variant(os.path.join(OUT, name), src_dir, edits,
                               KERNELS)
    print("\n".join(f"  {name}/{stem}: {ln}" for stem in KERNELS
                    for ln in ptxas_lines(ptxas[stem])), flush=True)
    with open(os.path.join(src_dir, "lstm_bwd_blocked.cu")) as f:
        ranks = "int* rank" in f.read()
    if not ranks:   # the CUDA-core backward: 14 pointers, 3 ints
        import ctypes
        fns["lstm_bwd_blocked"].argtypes = \
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fns, ranks


def time_ms(run, reps):
    import torch
    if run() != 0:
        raise SystemExit("launch failed")
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        run()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", default=[],
                    help="another kernel source directory to time")
    ap.add_argument("--patch", action="append", default=[],
                    choices=sorted(PATCHES),
                    help="a knock-out of the repository's sources")
    ap.add_argument("--shape", action="append", default=[],
                    help="B,T,H (default 128,100,1280 and 128,100,2048)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--slices", action="append", type=int, default=[],
                    help="also time the repository's kernel 11 with this "
                    "many K slices (its own plan otherwise)")
    ap.add_argument("--only", action="append", default=[], choices=KERNELS,
                    help="time only these kernels (all three by default)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lstm_blocked_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    from paddle_tpu_torch.ops import lstm as L
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    repo = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    variants = [("repo", repo, None)]
    variants += [(f"csrc{i}", d, None) for i, d in enumerate(args.csrc)]
    variants += [(p, repo, p) for p in args.patch]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:   # three variants' nvcc at a time
        done = list(pool.map(lambda v: build(*v), variants))
    built = {n: (p, None) + b for (n, _, p), b in zip(variants, done)}
    for n_sl in args.slices:
        built[f"repo-s{n_sl}"] = (None, n_sl) + built["repo"][2:]
    shapes = [tuple(int(x) for x in s.split(",")) for s in args.shape] \
        or [(128, 100, 1280), (128, 100, 2048)]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s = torch.cuda.current_stream().cuda_stream
    for b, t, h in shapes:
        rng = np.random.RandomState(0)          # the bench feed's lengths
        rng.randint(0, 30000, (b, t))
        lens = torch.from_numpy(rng.randint(t // 2, t + 1, (b,))).to(dev)
        g = torch.Generator(device=dev).manual_seed(0)

        def rnd(*shape, sc=1.0):
            return torch.randn(*shape, generator=g, device=dev) * sc
        mask = (torch.arange(t, device=dev)[None] < lens[:, None]).float()
        xw, w = rnd(b, t, 4 * h, sc=0.3), rnd(h, 4 * h, sc=h ** -0.5)
        ck, h0, c0 = rnd(3, h, sc=0.1), rnd(b, h, sc=0.5), rnd(b, h, sc=0.5)
        dy, dyc = rnd(b, t, h), rnd(b, t, h)
        w_t = w.t().contiguous()
        ref_f = L.lstm_fwd_blocked_reference(xw, mask, w, ck, h0, c0)
        ref_b = L.lstm_bwd_blocked_reference(ref_f[2], ref_f[1], c0, mask, w,
                                             ck, dy, dyc)
        ref_w = L.lstm_dw_blocked_reference(ref_f[0], h0, ref_b[0], mask)
        plan = L.bwd_blocked_slices(b, h, sms)
        kp = -(-4 * h // 64) * 64
        scratch_new = (torch.empty(max([plan] + args.slices), b, h,
                                   device=dev),
                       torch.empty(t * b + t, dtype=torch.int32, device=dev),
                       torch.empty(2, h, kp, dtype=torch.bfloat16,
                                   device=dev),
                       torch.empty(2, b, kp, dtype=torch.bfloat16,
                                   device=dev))
        scratch_old = (torch.empty(4, b, h, device=dev),)
        print(f"({b}, {t}, {h}): kernel 11 in {plan} K slices", flush=True)
        for turn, order in enumerate((list(built), list(built)[::-1])):
            for name in order:
                patch, n_sl, fn, ranks = built[name]
                n_sl = n_sl or plan
                out_f = [torch.empty_like(x) for x in ref_f]
                out_b = [torch.empty_like(ref_b[0])] + \
                    [torch.empty_like(h0) for _ in range(4)]
                dw = torch.empty_like(w)
                n_split = fn["lstm_dw_blocked_splits"](b, t, h)
                rows = torch.empty(b * t + 1, dtype=torch.int32, device=dev)
                dw_part = torch.empty(n_split, h, 4 * h, device=dev)
                scratch = scratch_new if ranks else scratch_old
                bwd_ints = (b, t, h) + ((n_sl,) if ranks else ())
                runs = {
                    "lstm_fwd_blocked": lambda: fn["lstm_fwd_blocked"](
                        *[x.data_ptr() for x in (xw, mask, w_t, ck, h0, c0,
                                                 *out_f)], b, t, h, s),
                    "lstm_bwd_blocked": lambda: fn["lstm_bwd_blocked"](
                        *[x.data_ptr() for x in (ref_f[2], ref_f[1], c0,
                                                 mask, w, ck, dy, dyc, *out_b,
                                                 *scratch)], *bwd_ints, s),
                    "lstm_dw_blocked": lambda: fn["lstm_dw_blocked"](
                        *[x.data_ptr() for x in (ref_f[0], h0, ref_b[0], mask,
                                                 rows, dw_part, dw)],
                        b, t, h, n_split, s)}
                for k, run in runs.items():
                    if args.only and k not in args.only:
                        continue
                    ms = time_ms(run, args.reps)
                    err = ""
                    if patch is None:
                        got_f = out_f[:2] + [out_f[2] * mask[..., None]]
                        got, want = {"lstm_fwd_blocked": (got_f, ref_f),
                                     "lstm_bwd_blocked": (out_b[:3], ref_b),
                                     "lstm_dw_blocked": ([dw], [ref_w])}[k]
                        e = max(((x - y).abs().max() / y.abs().max()).item()
                                for x, y in zip(got, want))
                        err = f", max err / max|ref| {e:.1e}"
                    extra = f" ({n_split} splits)" \
                        if k == "lstm_dw_blocked" else ""
                    print(f"turn {turn} ({b}, {t}, {h}) {name} {k}: "
                          f"{ms:.3f} ms{extra}{err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
