#!/usr/bin/env python3
"""Time the port's LSTM kernels (the blocked kernels 10-12 and the
single-block kernels 8 and 9), the GRU kernels on the same tensor-core
step loop (the blocked forward 15 and the BPTT 14 and 16) and the GRU's
single-block forward 13 in several variants on one GPU, in one process,
so their times compare.

    python3 tools/lstm_blocked_probe.py [--csrc DIR ...] [--patch NAME ...]
                                        [--shape B,T,H ...] [--reps N]
                                        [--gru_shape B,T,H ...]
                                        [--gru14_shape B,T,H ...]
                                        [--gru13_shape B,T,H ...]
                                        [--gru_slices S1,S2 ...]
                                        [--slices N ...] [--only KERNEL ...]

A variant is a copy of a kernel source directory (the repository's
``paddle_tpu_torch/csrc`` by default; ``--csrc`` adds others, such as an
older version unpacked with ``git archive``), optionally with a named
text patch applied (``--patch``, see ``PATCHES``: knock-outs that remove
one part of the work to show what it costs, each keeping the results
live; their results are wrong by design and are not checked).  Every
variant is built with the port's ``nvcc`` flags by
``tools/probe_build.py`` (its ptxas lines printed: registers, spills and
the wgmma serialization warnings C7514-C7517), run at each shape on the
bench feed's lengths -- the blocked kernels 10-12 where H > 512, the
single-block kernels 8 and 9 where H <= 512, and kernel 10 at every H
(at H <= 512 it is the other design of kernel 8's step loop) -- and the
GRU's kernels 15 and 16 at each ``--gru_shape`` (default phase 5's, B
128, T 30, H 1024) and kernels 14 and 13 at each ``--gru14_shape`` /
``--gru13_shape`` (default phase 5's, B 128, T 30, H 512), every step
valid, h0 zero (kernel 13 also prints how many of its clusters the card
holds at once); each held
against the plain versions in ``paddle_tpu_torch.ops.lstm`` /
``ops.gru`` (unpatched variants only) and timed between CUDA events in
two turns (the variants in order, then in reverse).  Sources from before
the tensor-core kernels (kernel 10 reading a transpose of w_hh, kernel 9
with per-CTA partials, kernels 8, 13, 14, 15 and 16 on CUDA cores) take
those kernels' older arguments (kernel 15's transposes of the weights
made once, outside the timing).  ``--slices N`` also times the
repository's kernels 9, 10 and 11 at N K slices where N is a valid
slicing of their K, and ``--gru_slices S1,S2`` kernels 14 and 15 with S1
and S2 slices of their two products.  Prints one line per (turn, shape,
variant, kernel) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "probe")
BLOCKED = ("lstm_fwd_blocked", "lstm_bwd_blocked", "lstm_dw_blocked")
SINGLE = ("lstm_fwd", "lstm_bwd")
GRU = ("gru_bwd_blocked", "gru_fwd_blocked", "gru_bwd", "gru_fwd")
KERNELS = BLOCKED + SINGLE + GRU
#: the kernels whose step product is cut into K slices, and their K
SLICED = {"lstm_fwd_blocked": lambda h: h, "lstm_bwd_blocked":
          lambda h: 4 * h, "lstm_bwd": lambda h: 4 * h}

_WG, _FWD = "lstm_wg.cuh", "lstm_fwd_blocked.cu"
_F8, _GWG, _G15 = "lstm_fwd.cu", "gru_wg.cuh", "gru_fwd_blocked.cu"
_G13 = "gru_fwd.cu"
_CLUSTER_SYNC = ('  asm volatile("barrier.cluster.arrive.aligned;\\n"\n'
                 '               "barrier.cluster.wait.aligned;\\n" '
                 '::: "memory");\n')
# kernel 13: no bulk copies to the peers (and none expected)
_NO_COPIES = [(_G13, "if (tid < C && tid != rank) {",
               "if (tid < C && tid != rank && B < 0) {"),
              (_G13, "wg::mbar_expect(inbox + c, n * kRegion);",
               "wg::mbar_expect(inbox + c, B < 0 ? n * kRegion : 0);")]
_PAIRS = "    for (long p = first; p < BH; p += stride) {\n" \
         "      const int b = (int)(p / H), unit = (int)(p % H);\n"
#: name -> [(file, old text, new text)].  The step loop of kernels 9-11
#: (Tiles, phase A, the backward's kernel) lives in lstm_wg.cuh, so a
#: knock-out of it reaches all three and kernels 14-16 (Tiles); kernels
#: 14 and 16 share gru_wg.cuh; time the one in question (--only).
PATCHES = {
    # no grid barrier between the steps' phases (the prologue's barriers
    # stay: the step ranks are read after them)
    "no_barrier": [(_WG, "grid.sync();  // step", "(void)grid;"),
                   (_FWD, "grid.sync();  // step", "(void)grid;"),
                   (_F8, "grid.sync();  // step", "(void)grid;"),
                   (_GWG, "grid.sync();  // step", "(void)grid;"),
                   (_G15, "grid.sync();  // step", "(void)grid;"),
                   # kernel 13: no cluster barrier in the steps (one after
                   # the prologue and one at the end stay: every CTA of a
                   # cluster is alive, its mbarriers made, while its peers
                   # copy); a phase's copies may land in the next phase,
                   # whose bytes its mbarriers count the same
                   (_G13, 'asm volatile("barrier.cluster.arrive.relaxed.'
                    'aligned;\\n" ::: "memory");', ""),
                   (_G13, 'asm volatile("barrier.cluster.wait.acquire.'
                    'aligned;\\n" ::: "memory");', ""),
                   (_G13, "  wg::fence_proxy_async();   // the planes: "
                    "generic writes, then wgmma\n  __syncthreads();\n",
                    "  wg::fence_proxy_async();\n  __syncthreads();\n"
                    + _CLUSTER_SYNC),
                   (_G13, "  // every copy has landed before any CTA leaves\n"
                    "  cluster_arrive();\n  cluster_wait();\n",
                    _CLUSTER_SYNC)],
    # no tensor-core products (the loads, waits, drains and stores of the
    # sums stay)
    "no_products": [(_WG,
                     "            wg::mma_ss_n128<0, 0>(acc, ah + 2 * kk, "
                     "bh + 2 * kk, kk > 0);\n"
                     "            wg::mma_ss_n128<0, 0>(acc, ah + 2 * kk, "
                     "bl + 2 * kk, 1);\n"
                     "            wg::mma_ss_n128<0, 0>(acc, al + 2 * kk, "
                     "bh + 2 * kk, 1);\n", ""),
                    (_G13,
                     "      wg::mma_ss_n32(acc, ah + 2 * kk, bh, kk > 0);\n"
                     "      wg::mma_ss_n32(acc, ah + 2 * kk, bl, 1);\n",
                     "      acc[kk] = (float)(ah + bl + kk);\n"),
                    (_G13, "      wg::mma_ss_n32(acc, al + 2 * kk, bh, 1);\n",
                     ""),
                    (_G13, "      wg::mma_rs_n32<0>(acc, a, bh, 1);\n",
                     "      acc[kk + 4] += (float)a[0];\n")],
    # no TMA loads, B's ahead of the barrier too (each ring slot's
    # barrier completes on its arrival; the products read stale tiles)
    "no_loads": [(_WG, "wg::mbar_expect(full + s, kStage);",
                  "wg::mbar_expect(full + s, 0);"),
                 (_WG, "wg::tma_load_2d(", "if (0) wg::tma_load_2d(")],
    # every tile loads B's (or A's) planes at the same coordinates (one
    # hot box in L2; the bytes stay)
    "w_same": [(_WG, "bhi, full + s, k0, c0);", "bhi, full + s, 0, 0);"),
               (_WG, "blo, full + s, k0, c0);", "blo, full + s, 0, 0);")],
    "a_same": [(_WG, "ahi, full + s, k0, r0);", "ahi, full + s, 0, 0);"),
               (_WG, "alo, full + s, k0, r0);", "alo, full + s, 0, 0);")],
    # the tiles' skeleton (no TMA loads and no products)
    "skeleton": "no_loads+no_products",
    # no stores of the tiles' sums (kept live behind a test that never
    # passes)
    "no_epilogue": [(_WG, "        if (row >= n || wgi >= 2) continue;",
                     "        if (row >= n || wgi >= 2 || ldr > 0) "
                     "continue;")],
    # the pairs read no slice sums
    "no_parts": [(_WG, "      if (r >= 0)\n        for (int sl",
                  "      if (r >= 0 && B < 0)\n        for (int sl"),
                 (_FWD, "for (int sl = 0; sl < n_slices; ++sl)",
                  "for (int sl = 0; sl < n_slices && B < 0; ++sl)")],
    # the backward's pairs run no phase A (their sums kept live in dhp)
    "no_phase_a": [(_WG,
                    "        phase_a<kDw>(a, d, t - 1, b, unit, dh, dc,\n"
                    "                     __ldcg(a.rank + (long)(t - 1) * B"
                    " + b), false, base);",
                    "        a.dhp[p] = dh + dc;")],
    # no product tiles at all (the pairs read stale sums; kernel 8: no
    # loads, products or sums of h_{t-1}'s planes)
    "no_tiles": [(_WG, "      if (r0 >= n) continue;",
                  "      if (r0 >= 0) continue;"),
                 (_F8, "i < kAAhead && i < nch; ++i) load(i);",
                  "i < kAAhead && i < nch && B < 0; ++i) load(i);"),
                 (_F8, "for (int i = 0; i < nch; ++i) {",
                  "for (int i = 0; i < nch && B < 0; ++i) {")],
    # no pairs' work in the steps (the tiles read stale planes)
    "no_pairs": [(_WG, _PAIRS + "      float dh",
                  _PAIRS.replace("p = first", "p = BH + first")
                  + "      float dh"),
                 (_FWD, "for (long p = first; p < BH; p += 2 * stride)",
                  "for (long p = BH + first; p < BH; p += 2 * stride)"),
                 (_F8, "if (idx >= lwg::kRows * U ||",
                  "if (idx >= 0 || idx >= lwg::kRows * U ||"),
                 (_GWG, "for (long p = first; p < BH; p += stride) {  //",
                  "for (long p = BH + first; p < BH; p += stride) {  //"),
                 (_G15, "for (long p = first; p < BH; p += 2 * stride) {",
                  "for (long p = BH + first; p < BH; p += 2 * stride) {")],
    # the pairs write no planes (the products read stale ones)
    "no_plane_writes": [(_WG,
                         "    put_split(p, lo, di_pre);\n"
                         "    put_split(p + H, lo, df_pre);\n"
                         "    put_split(p + 2 * H, lo, dg_pre);\n"
                         "    put_split(p + 3 * H, lo, do_pre);\n", ""),
                        (_FWD, "  if (v.r1 >= 0)\n",
                         "  if (v.r1 >= 0 && a.B < 0)\n"),
                        (_F8, "if (t + 1 < T) put_split(",
                         "if (t + 1 < T && B < 0) put_split("),
                        (_GWG, "  if (r >= 0) {\n    put_split(",
                         "  if (r >= 0 && a.B < 0) {\n    put_split("),
                        (_GWG, "      if (r >= 0)\n        put_split(",
                         "      if (r >= 0 && B < 0)\n        put_split("),
                        (_G15, "  put_split(a.rpl",
                         "  if (a.B < 0) put_split(a.rpl"),
                        (_G15, "  if (v.r1 >= 0)\n",
                         "  if (v.r1 >= 0 && a.B < 0)\n"),
                        (_G13, "for (int q = 0; q < 8; ++q) put_buf(",
                         "for (int q = 0; q < 8 && B < 0; ++q) put_buf(")]
    + _NO_COPIES,
    # kernel 13: no copies to the peers (each CTA's buffer keeps the
    # peers' units of h0)
    "no_copies": _NO_COPIES,
    # kernel 13: no global stores in the steps (H and the residue)
    "no_stores": [(_G13, "if (b < B && unit_ok) {",
                   "if (b < B && unit_ok && T < 0) {")],
    # kernel 13: no loads of xw in the steps (read as zeros)
    "no_xw": [(_G13, "const bool ok = b < B && unit_ok;",
               "const bool ok = b < B && unit_ok && T < 0;"),
              (_G13, "xc[q] = b < B && unit_ok\n",
               "xc[q] = b < B && unit_ok && T < 0\n")],
    # kernel 13: no gate nonlinearities (u, r and c taken as their sums)
    "no_math": [(_G13, "uu[q] = sigm(xu[q] + g[e]);",
                 "uu[q] = xu[q] + g[e];"),
                (_G13, "const float rr = sigm(xr[q] + g[e + 2]);",
                 "const float rr = xr[q] + g[e + 2];"),
                (_G13, "const float c = tanhf(xc[q] + s[4 * (q >> 1) + "
                 "(q & 1)]);",
                 "const float c = xc[q] + s[4 * (q >> 1) + (q & 1)];")],
    # kernels 9 and 14: no dW tiles after the loop (the splits' sum stays)
    "no_dw": [(_WG, "task < n_dw * d.n_split;",
               "task < n_dw * d.n_split && B < 0;"),
              (_GWG, "task < n_dw * d.n_split;",
               "task < n_dw * d.n_split && B < 0;")],
}


def ptxas_lines(text):
    """Registers, spills and the wgmma serialization warnings of a build."""
    keep = ("entry function", "registers", "spill", "C7514", "C7515",
            "C7516", "C7517")
    return [ln.strip() for ln in text.splitlines()
            if any(k in ln for k in keep)]


def build(name, src_dir, patch, stems=KERNELS):
    """Build one variant: its functions by symbol and which argument
    forms its sources take ({"fwd_t": kernel 10 reads w_hh's transpose,
    "bwd_u": kernel 9 takes U and per-CTA partials, "fwd8": kernel 8
    takes no planes, "gru16": kernel 16 takes no planes, ranks or
    slices, "gru15": kernel 15 reads the weights' transposes and an
    f32 r h scratch, "gru14": kernel 14 takes only an rh scratch})."""
    from probe_build import build_variant
    edits = PATCHES.get(patch, [])
    if isinstance(edits, str):   # a combination of other knock-outs
        edits = [e for part in edits.split("+") for e in PATCHES[part]]
    fns, ptxas = build_variant(os.path.join(OUT, name), src_dir, edits,
                               stems)
    print("\n".join(f"  {name}/{stem}: {ln}" for stem in stems
                    for ln in ptxas_lines(ptxas[stem])), flush=True)
    read = lambda f: open(os.path.join(src_dir, f)).read()  # noqa: E731
    old = {"fwd_t": "int* rank" not in read("lstm_fwd_blocked.cu"),
           "bwd_u": "pbuf" in read("lstm_bwd.cu"),
           "fwd8": "void* apl" not in read("lstm_fwd.cu"),
           "gru16": "int* rank" not in read("gru_bwd_blocked.cu"),
           "gru15": "int* rank" not in read("gru_fwd_blocked.cu"),
           "gru14": "int* rows" not in read("gru_bwd.cu"),
           "gru13": "float* rh" in read("gru_fwd.cu")}
    if old["fwd_t"] and "lstm_fwd_blocked" in fns:
        fns["lstm_fwd_blocked"].argtypes = \
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    if old["bwd_u"] and "lstm_bwd" in fns:
        fns["lstm_bwd"].argtypes = \
            [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    if old["fwd8"] and "lstm_fwd" in fns:
        fns["lstm_fwd"].argtypes = \
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    if old["gru16"] and "gru_bwd_blocked" in fns:
        fns["gru_bwd_blocked"].argtypes = \
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    if old["gru15"] and "gru_fwd_blocked" in fns:
        fns["gru_fwd_blocked"].argtypes = \
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    if old["gru14"] and "gru_bwd" in fns:
        fns["gru_bwd"].argtypes = \
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    if old["gru13"] and "gru_fwd" in fns:
        fns["gru_fwd"].argtypes = \
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fns, old


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


def valid_slices(n_sl, k):
    chunks = -(-k // 64)
    return 1 <= n_sl <= chunks and (n_sl - 1) * -(-chunks // n_sl) < chunks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", default=[],
                    help="another kernel source directory to time")
    ap.add_argument("--patch", action="append", default=[],
                    choices=sorted(PATCHES),
                    help="a knock-out of the repository's sources")
    ap.add_argument("--shape", action="append", default=[],
                    help="B,T,H (default 128,100,1280, 128,100,2048 and "
                    "128,100,512)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--gru_shape", action="append", default=[],
                    help="B,T,H of kernels 15 and 16, every step valid "
                    "(default 128,30,1024)")
    ap.add_argument("--gru14_shape", action="append", default=[],
                    help="B,T,H of kernel 14, every step valid (default "
                    "128,30,512)")
    ap.add_argument("--gru13_shape", action="append", default=[],
                    help="B,T,H of kernel 13, every step valid (default "
                    "128,30,512)")
    ap.add_argument("--gru_slices", action="append", default=[],
                    help="S1,S2: also time the repository's kernels 14 and "
                    "15 with S1 and S2 K slices of their two products "
                    "(14: drh, carry; 15: gates, candidate)")
    ap.add_argument("--slices", action="append", type=int, default=[],
                    help="also time the repository's kernels 9-11 with "
                    "this many K slices (their own plans otherwise)")
    ap.add_argument("--only", action="append", default=[], choices=KERNELS,
                    help="time only these kernels (all by default)")
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
    want = lambda k: not args.only or k in args.only  # noqa: E731
    # the LSTM's kernels all together (their loop runs them by shape), the
    # GRU's as asked
    stems = [k for k in KERNELS if want(k)
             or (k not in GRU and any(want(j) for j in BLOCKED + SINGLE))]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:   # three variants' nvcc at a time
        done = list(pool.map(lambda v: build(*v, stems), variants))
    built = {n: (p, None) + b for (n, _, p), b in zip(variants, done)}
    for n_sl in args.slices:
        built[f"repo-s{n_sl}"] = (None, n_sl) + built["repo"][2:]
    shapes = [tuple(int(x) for x in s.split(",")) for s in args.shape] \
        or [(128, 100, 1280), (128, 100, 2048), (128, 100, 512)]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s = torch.cuda.current_stream().cuda_stream
    f32 = dict(device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    if not any(want(k) for k in BLOCKED + SINGLE):
        shapes = []
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
        blocked = h > 512
        ref_f = (L.lstm_fwd_blocked_reference if blocked
                 else L.lstm_fwd_reference)(xw, mask, w, ck, h0, c0)
        hseq, cseq, gates = ref_f
        keep = (mask != 0).float()[..., None]
        ref_fb = (hseq, cseq, gates * keep)   # kernel 10's contract
        ref_w = None
        if blocked:
            ref_b = L.lstm_bwd_blocked_reference(gates, cseq, c0, mask, w,
                                                 ck, dy, dyc)
            ref_w = L.lstm_dw_blocked_reference(hseq, h0, ref_b[0], mask)
        else:
            ref_b = L.lstm_bwd_reference(gates, hseq, cseq, h0, c0, mask, w,
                                         ck, dy, dyc)
        plan = {k: (L.fwd_blocked_slices if k == "lstm_fwd_blocked"
                    else L.bwd_blocked_slices)(b, h, sms) for k in SLICED}
        n_split = L.bwd_dw_splits(h, sms)
        kp4, kp1 = -(-4 * h // 64) * 64, -(-h // 64) * 64
        n_cols = 4 * -(-h // 32) * 32
        most = max([1] + list(plan.values()) + args.slices)
        # scratch, sized for every variant and slicing
        sc = {"part_b": torch.empty(most, b, h, **f32),
              "part_f": torch.empty(most, b, n_cols, **f32),
              "rank": torch.empty(t * b + t, **i32),
              "rows": torch.empty(b * t + 1, **i32),
              "wpl4": torch.empty(2, h, kp4, **bf),
              "apl4": torch.empty(2, b, kp4, **bf),
              "wplf": torch.empty(2, n_cols, kp1, **bf),
              "aplf": torch.empty(2, b, kp1, **bf),
              "state": [torch.empty(b, h, **f32) for _ in range(2)],
              "ckp": torch.empty(3, b, h, **f32),
              "dw_part": torch.empty(L.MAX_DW_SPLIT, h, 4 * h, **f32),
              "apl8": torch.empty(2, 2, b, kp1, **bf)}
        w_t = w.t().contiguous()
        u = L.units_per_cta(h, sms)
        pbuf = torch.empty(2 * -(-h // (u or 1)) * b * (-(-h // 4) * 4),
                           **f32) if not blocked else None
        print(f"({b}, {t}, {h}): K slices {plan}, kernel 9's dW splits "
              f"{n_split}", flush=True)
        for turn, order in enumerate((list(built), list(built)[::-1])):
            for name in order:
                patch, n_sl_opt, fn, old = built[name]
                out_f = [torch.empty_like(x) for x in ref_f]
                out_b = [torch.empty_like(x) for x in ref_b]
                dw = torch.empty_like(w)
                runs = {}
                n_sl = {k: n_sl_opt or plan[k] for k in SLICED}
                # kernel 10 at every H (at H <= 512 the other design of
                # kernel 8's step loop)
                if old["fwd_t"]:
                    fwd_args = (xw, mask, w_t, ck, h0, c0, *out_f)
                    fwd_ints = (b, t, h)
                else:
                    fwd_args = (xw, mask, w, ck, h0, c0, *out_f,
                                sc["part_f"], sc["rank"], sc["wplf"],
                                sc["aplf"])
                    fwd_ints = (b, t, h, n_sl["lstm_fwd_blocked"])
                runs["lstm_fwd_blocked"] = (lambda a=fwd_args, i=fwd_ints:
                                            fn["lstm_fwd_blocked"](
                    *[x.data_ptr() for x in a], *i, s))
                if blocked:
                    dw_split = fn["lstm_dw_blocked_splits"](b, t, h)
                    runs["lstm_bwd_blocked"] = lambda: fn["lstm_bwd_blocked"](
                        *[x.data_ptr() for x in (gates, cseq, c0, mask, w,
                                                 ck, dy, dyc, *out_b,
                                                 *sc["state"], sc["part_b"],
                                                 sc["rank"], sc["wpl4"],
                                                 sc["apl4"])],
                        b, t, h, n_sl["lstm_bwd_blocked"], s)
                    runs["lstm_dw_blocked"] = lambda: fn["lstm_dw_blocked"](
                        *[x.data_ptr() for x in (hseq, h0, ref_b[0], mask,
                                                 sc["rows"], sc["dw_part"],
                                                 dw)],
                        b, t, h, dw_split, s)
                else:
                    fwd8 = (xw, mask, w, ck, h0, c0, *out_f) + \
                        (() if old["fwd8"] else (sc["apl8"],))
                    runs["lstm_fwd"] = lambda a=fwd8: fn["lstm_fwd"](
                        *[x.data_ptr() for x in a], b, t, h, u, s)
                    bwd_in = (gates, hseq, cseq, h0, c0, mask, w, ck, dy,
                              dyc, *out_b)
                    if old["bwd_u"]:
                        bwd_args, bwd_ints = bwd_in + (pbuf,), (b, t, h, u)
                    else:
                        bwd_args = bwd_in + (*sc["state"], sc["ckp"],
                                             sc["part_b"], sc["rank"],
                                             sc["rows"], sc["wpl4"],
                                             sc["apl4"], sc["dw_part"])
                        bwd_ints = (b, t, h, n_sl["lstm_bwd"], n_split)
                    runs["lstm_bwd"] = (lambda a=bwd_args, i=bwd_ints:
                                        fn["lstm_bwd"](
                        *[x.data_ptr() for x in a], *i, s))
                for k, run in runs.items():
                    if args.only and k not in args.only:
                        continue
                    if n_sl_opt and (k not in SLICED or not valid_slices(
                            n_sl_opt, SLICED[k](h))):
                        continue
                    ms = time_ms(run, args.reps)
                    err = ""
                    if patch is None:
                        got_fb = out_f[:2] + [out_f[2] * keep]
                        got, want = {"lstm_fwd_blocked": (got_fb, ref_fb),
                                     "lstm_fwd": (out_f, ref_f),
                                     "lstm_bwd_blocked": (out_b, ref_b),
                                     "lstm_bwd": (out_b, ref_b),
                                     "lstm_dw_blocked": ([dw], [ref_w])}[k]
                        e = max(((x - y).abs().max() / y.abs().max()).item()
                                for x, y in zip(got, want))
                        err = f", max err / max|ref| {e:.1e}"
                    extra = f" ({dw_split} splits)" \
                        if k == "lstm_dw_blocked" else ""
                    print(f"turn {turn} ({b}, {t}, {h}) {name} {k}: "
                          f"{ms:.3f} ms{extra}{err}", flush=True)
    extra = [tuple(int(x) for x in c.split(",")) for c in args.gru_slices]
    for shape in args.gru_shape or ["128,30,1024"]:
        shape = tuple(int(x) for x in shape.split(","))
        for k in ("gru_fwd_blocked", "gru_bwd_blocked"):
            if want(k):
                time_gru(built, k, shape, sms, args.reps,
                         extra if k == "gru_fwd_blocked" else ())
    if want("gru_bwd"):
        for shape in args.gru14_shape or ["128,30,512"]:
            time_gru(built, "gru_bwd", tuple(int(x) for x in
                                             shape.split(",")), sms,
                     args.reps, extra)
    if want("gru_fwd"):
        for shape in args.gru13_shape or ["128,30,512"]:
            time_gru(built, "gru_fwd", tuple(int(x) for x in
                                             shape.split(",")), sms,
                     args.reps)
    return 0


def time_gru(built, kernel, shape, sms, reps, extra_slices=()):
    """GRU kernel 15, 16 or 14 (``kernel``) at (B, T, H), every step
    valid, h0 zero (phase 5's feed), each variant in two turns (and each
    unpatched variant that takes slices at each slicing of
    ``extra_slices`` that cuts its K); unpatched variants held against
    the plain versions."""
    import torch
    from paddle_tpu_torch.ops import gru as G
    b, t, h = shape
    dev = torch.device("cuda")
    s = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shp, sc=1.0):
        return torch.randn(*shp, generator=g, device=dev) * sc
    mask = torch.ones((b, t), device=dev)
    xw, wg = rnd(b, t, 3 * h, sc=0.5), rnd(h, 2 * h, sc=h ** -0.5)
    wc, h0 = rnd(h, h, sc=h ** -0.5), torch.zeros((b, h), device=dev)
    dy = rnd(b, t, h)
    f32 = dict(device=dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    kp, kg = -(-h // 64) * 64, -(-2 * h // 64) * 64
    n_gcols = 2 * -(-h // 64) * 64
    if kernel == "gru_fwd":
        ins = old_ins = (xw, mask, wg, wc, h0)
        ref = G.gru_fwd_reference(*ins)
        plan, old_sc = (), (torch.empty(b, h, **f32),)
        for name, v in built.items():
            if "gru_fwd_clusters" in v[2]:
                print(f"gru ({b}, {t}, {h}) kernel 13 ({name}): "
                      f"{v[2]['gru_fwd_clusters'](h)} clusters of "
                      f"{-(-h // G.UNITS)} CTAs at once", flush=True)
    elif kernel == "gru_fwd_blocked":
        ins = (xw, mask, wg, wc, h0)
        ref = G.gru_fwd_blocked_reference(*ins)
        plan = G.fwd_blocked_slices(b, h, sms)
        ks = (h, h)
        most = max(max(c[0] * n_gcols, c[1] * h)
                   for c in [plan, *extra_slices]) * b
        new_sc = (torch.empty(most, **f32),
                  torch.empty(t * b + t, dtype=torch.int32, device=dev),
                  torch.empty(2, n_gcols, kp, **bf),
                  torch.empty(2, h, kp, **bf), torch.empty(2, b, kp, **bf),
                  torch.empty(2, b, kp, **bf))
        old_ins = (xw, mask, wg.t().contiguous(), wc.t().contiguous(), h0)
        old_sc = (torch.empty(b, h, **f32),)
    else:
        fwd = G.gru_fwd_blocked_reference if kernel == "gru_bwd_blocked" \
            else G.gru_fwd_reference
        hseq, gates = fwd(xw, mask, wg, wc, h0)
        ins = old_ins = (gates, hseq, h0, mask, wg, wc, dy)
        plan = (G.bwd_blocked_slices if kernel == "gru_bwd_blocked"
                else G.bwd_slices)(b, h, sms)
        ks = (h, 2 * h)
        most = max([*plan] + [max(c) for c in extra_slices])
        # kernel 14's row list starts as zeros: a knock-out that skips
        # phase A leaves it listing row 0, not garbage
        common = (torch.empty(b, h, **f32), torch.empty(b, h, **f32),
                  torch.empty(most, b, h, **f32),
                  torch.empty(t * b + t, dtype=torch.int32, device=dev))
        planes = (torch.empty(2, h, kp, **bf), torch.empty(2, h, kg, **bf),
                  torch.empty(2, b, kp, **bf), torch.empty(2, b, kg, **bf))
        if kernel == "gru_bwd_blocked":
            ref = G.gru_bwd_blocked_reference(*ins)
            new_sc = common + planes
            old_sc = common[:2]
        else:
            ref = G.gru_bwd_reference(*ins)
            n_split = G.bwd_dw_splits(h, sms)
            rh = torch.empty(b, t, h, **f32)
            new_sc = (rh,) + common + (
                torch.zeros(b * t, dtype=torch.int32, device=dev),) + \
                planes + (torch.empty(G.MAX_DW_SPLIT, h, 3 * h, **f32),)
            old_sc = (rh,)
    tag = {"gru_fwd_blocked": "15", "gru_bwd_blocked": "16",
           "gru_bwd": "14", "gru_fwd": "13"}[kernel]
    print(f"gru ({b}, {t}, {h}) kernel {tag}"
          + (f": K slices {plan}" if plan else ""), flush=True)
    flag = {"gru_fwd_blocked": "gru15", "gru_bwd_blocked": "gru16",
            "gru_bwd": "gru14", "gru_fwd": "gru13"}[kernel]
    # the extra slicings for every unpatched variant that takes slices
    runs = [(name, None) for name in built] + \
        [(name, c) for c in extra_slices for name, v in built.items()
         if v[0] is None and not v[1] and not v[3][flag]
         and all(valid_slices(n, k) for n, k in zip(c, ks))]
    for turn, order in enumerate((runs, runs[::-1])):
        for name, slices in order:
            patch, n_sl_opt, fn, old = built[name]
            if n_sl_opt:
                continue
            out = [torch.empty_like(x) for x in ref]
            if old[flag]:
                ptrs, ints = old_ins + tuple(out) + old_sc, (b, t, h)
            elif kernel == "gru_fwd":
                ptrs, ints = ins + tuple(out), (b, t, h)
            else:
                ints = (b, t, h) + (slices or plan)
                if kernel == "gru_bwd":
                    ints += (n_split,)
                # kernel 16 returns dxw, dh0, rh and takes rh as an output
                ptrs = ins + tuple(out) + new_sc
            ms = time_ms(lambda: fn[kernel](
                *[x.data_ptr() for x in ptrs], *ints, s), reps)
            err = ""
            if patch is None:
                e = max(((x - y).abs().max() / y.abs().max()).item()
                        for x, y in zip(out, ref))
                err = f", max err / max|ref| {e:.1e}"
            label = name if slices is None else \
                f"{name}-s{slices[0]},{slices[1]}"
            print(f"turn {turn} gru ({b}, {t}, {h}) {label} {kernel}: "
                  f"{ms:.3f} ms{err}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
