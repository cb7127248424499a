#!/usr/bin/env python3
"""Time the hidden-blocked LSTM kernels (kernels 10-12 of the port) in
several variants on one GPU, in one process, so their times compare.

    python3 tools/lstm_blocked_probe.py [--csrc DIR ...] [--patch NAME ...]
                                        [--shape B,T,H ...]

A variant is a copy of a kernel source directory (the repository's
``paddle_tpu_torch/csrc`` by default; ``--csrc`` adds others, such as an
older version unpacked with ``git archive``), optionally with a named
text patch applied (``--patch``, see ``PATCHES``: knock-outs that remove
one part of the work to show what it costs; their results are wrong by
design and are not checked).  Every variant is built with the port's
``nvcc`` flags into ``build/probe/``, loaded with ctypes, run at each
shape on the bench feed's lengths, held against the plain versions in
``paddle_tpu_torch.ops.lstm`` (unpatched variants only) and timed
between CUDA events.  Prints one line per (shape, variant, kernel) and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "probe")
KERNELS = ("lstm_fwd_blocked", "lstm_bwd_blocked", "lstm_dw_blocked")

#: name -> [(file, old text, new text)]
PATCHES = {
    # a quarter of the product's FMAs (all shared loads stay)
    "quarter_fma": [("lstm_common.cuh",
                     "          acc[i][d] += a[i].y * b[d].y;\n"
                     "          acc[i][d] += a[i].z * b[d].z;\n"
                     "          acc[i][d] += a[i].w * b[d].w;\n", "")],
    # no L2 -> shared copies in the product (the FMAs read stale tiles)
    "no_copy": [("lstm_common.cuh",
                 "      cp_async16(dst + r * kTileStride + c, ok ? src + k0 + c"
                 " : any, ok);\n", "")],
    # a 4-deep k-tile pipeline in kernels 10 and 11
    "stages4": [("lstm_common.cuh", "constexpr int kBStages = 3;",
                 "constexpr int kBStages = 4;")],
    # no grid barrier
    "no_barrier": [("lstm_fwd_blocked.cu", "grid.sync();", "(void)grid;"),
                   ("lstm_bwd_blocked.cu", "grid.sync();", "(void)grid;")],
}


def build(name, src_dir, patch):
    from paddle_tpu_torch.ops import _build
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    for fname, old, new in PATCHES.get(patch, []):
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise SystemExit(f"patch {patch}: text not found in {fname}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    procs = {}
    for k in KERNELS:
        so = os.path.join(d, f"{k}.so")
        procs[k] = (so, subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS
            + ["-Xptxas", "-v", "-o", so, os.path.join(d, f"{k}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return d, procs


def load(d, procs):
    from paddle_tpu_torch.ops import _build
    fns = {}
    for k, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {d}/{k}.cu:\n{out}")
        regs = [ln.split("Used")[1].strip() for ln in out.splitlines()
                if "registers" in ln]
        print(f"  built {os.path.basename(d)}/{k}: {regs}", flush=True)
        with open(os.path.join(d, f"{k}.cu")) as f:
            src = f.read()
        lib = ctypes.CDLL(so)
        fn = getattr(lib, k)
        argtypes = list(_build.SIGNATURES[k][1])
        # sources from before the pull-back parts and the dW row list
        new = {"lstm_bwd_blocked": "float* part" in src,
               "lstm_dw_blocked": "lstm_dw_blocked_splits" in src}.get(k, True)
        if not new:
            argtypes = {"lstm_bwd_blocked": argtypes[:13] + argtypes[14:],
                        "lstm_dw_blocked": [ctypes.c_void_p] * 4
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p]}[k]
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        splits = None
        if k == "lstm_dw_blocked" and new:
            splits = lib.lstm_dw_blocked_splits
            splits.argtypes = [ctypes.c_int] * 3
            splits.restype = ctypes.c_int
        fns[k] = (fn, new, splits)
    return fns


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
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lstm_blocked_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
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
    built = [(n, p, build(n, d, p)) for n, d, p in variants]
    fns = {n: (p, load(*b)) for n, p, b in built}
    shapes = [tuple(int(x) for x in s.split(",")) for s in args.shape] \
        or [(128, 100, 1280), (128, 100, 2048)]
    dev = torch.device("cuda")
    for b, t, h in shapes:
        rng = np.random.RandomState(0)          # the bench feed's lengths
        rng.randint(0, 30000, (b, t))
        lens = torch.from_numpy(rng.randint(t // 2, t + 1, (b,))).to(dev)
        g = torch.Generator(device=dev).manual_seed(0)

        def rnd(*s, sc=1.0):
            return torch.randn(*s, generator=g, device=dev) * sc
        mask = (torch.arange(t, device=dev)[None] < lens[:, None]).float()
        xw, w = rnd(b, t, 4 * h, sc=0.3), rnd(h, 4 * h, sc=h ** -0.5)
        ck, h0, c0 = rnd(3, h, sc=0.1), rnd(b, h, sc=0.5), rnd(b, h, sc=0.5)
        dy, dyc = rnd(b, t, h), rnd(b, t, h)
        w_t = w.t().contiguous()
        ref_f = L.lstm_fwd_blocked_reference(xw, mask, w, ck, h0, c0)
        ref_b = L.lstm_bwd_blocked_reference(ref_f[2], ref_f[1], c0, mask, w,
                                             ck, dy, dyc)
        ref_w = L.lstm_dw_blocked_reference(ref_f[0], h0, ref_b[0], mask)
        s = torch.cuda.current_stream().cuda_stream
        for name, (patch, fn) in fns.items():
            out_f = [torch.empty_like(x) for x in ref_f]
            out_b = [torch.empty_like(ref_b[0])] + \
                [torch.empty_like(h0) for _ in range(4)]
            part = torch.empty(4, b, h, device=dev)
            dw = torch.empty_like(w)
            f_fwd = fn["lstm_fwd_blocked"][0]
            f_bwd, has_part, _ = fn["lstm_bwd_blocked"]
            f_dw, dw_rows, splits = fn["lstm_dw_blocked"]
            n_split = splits(b, t, h) if dw_rows else 1
            rows = torch.empty(b * t + 1, dtype=torch.int32, device=dev)
            dw_part = torch.empty(n_split, h, 4 * h, device=dev)
            dw_in = (ref_f[0], h0, ref_b[0]) + (
                (mask, rows, dw_part) if dw_rows else ())
            runs = {
                "lstm_fwd_blocked": lambda: f_fwd(
                    *[x.data_ptr() for x in (xw, mask, w_t, ck, h0, c0,
                                             *out_f)], b, t, h, s),
                "lstm_bwd_blocked": lambda: f_bwd(
                    *[x.data_ptr() for x in (ref_f[2], ref_f[1], c0, mask, w,
                                             ck, dy, dyc, *out_b)
                      + ((part,) if has_part else ())], b, t, h, s),
                "lstm_dw_blocked": lambda: f_dw(
                    *[x.data_ptr() for x in dw_in + (dw,)], b, t, h,
                    *((n_split,) if dw_rows else ()), s)}
            for k, run in runs.items():
                ms = time_ms(run, args.reps)
                err = ""
                if patch is None:
                    # gates compared at valid steps (sources that
                    # computed them at padded steps too compare the same)
                    got_f = out_f[:2] + [out_f[2] * mask[..., None]]
                    got, want = {"lstm_fwd_blocked": (got_f, ref_f),
                                 "lstm_bwd_blocked": (out_b[:3], ref_b),
                                 "lstm_dw_blocked": ([dw], [ref_w])}[k]
                    e = max(((x - y).abs().max() / y.abs().max()).item()
                            for x, y in zip(got, want))
                    err = f", max err / max|ref| {e:.1e}"
                print(f"({b}, {t}, {h}) {name} {k}: {ms:.3f} ms{err}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
