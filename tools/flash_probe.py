#!/usr/bin/env python3
"""Time the training flash-attention kernels (kernels 1-train, 3 and 4 of
the port) in several variants on one GPU, in one process, so their times
compare.

    python3 tools/flash_probe.py [--csrc DIR ...] [--patch NAME ...]
                                 [--causal] [--reps N]

A variant is a copy of a kernel source directory (the repository's
``paddle_tpu_torch/csrc`` by default; ``--csrc`` adds others, such as an
older version unpacked with ``git archive``), optionally with a named
text patch applied (``--patch``, see ``PATCHES``: knock-outs that remove
one part of the work to show what it costs, whose results are wrong by
design and are not checked (``KNOCKOUTS``), and tuning variants).  Every variant is built with the port's
``nvcc`` flags into ``build/flash_probe/`` and loaded with ctypes; the
wrappers of ``paddle_tpu_torch.ops.attention`` then launch it on the
transformer step's shape (q/k/v bf16 [16, 2048, 8, 64], views of one
projection; all keys valid).  Unpatched variants are held against the
plain versions (``chip_smoke.flash_error``).  Each variant is timed in
two turns (variants in order, then in reverse), CUDA-graph replay
between CUDA events.  Prints one line per (variant, kernel, turn) and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "flash_probe")
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

#: name -> [(file, old text, new text)]
PATCHES = {
    # the mma.sync products with P / dS take hi only (the split's extra
    # mma work) -- kernels 3 and 4, and the fp32 form of kernel 1; the
    # bf16 forward splits P in flash_fwd.cu (tools/tc_probe.py)
    "no_split": [("flash_common.cuh",
                  "      mma(acc[2 * np], al, bh[0], bh[1]);\n"
                  "      mma(acc[2 * np + 1], al, bh[2], bh[3]);\n", "")],
    # no exponentials (p = the scaled score's difference)
    "no_exp": [("flash_common.cuh",
                'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x;")],
    # kernel 3 and the fp32 form of kernel 1 without their register cap
    # for 4 CTAs an SM
    "uncapped": [(f, "__global__ void __launch_bounds__(kThreads, 4)\n",
                  "__global__ void __launch_bounds__(kThreads)\n")
                 for f in ("flash_fwd.cu", "flash_bwd_dq.cu")],
    # kernel 4 walks q tiles of 32 rows at every head dim
    "dkv_bn32": [("flash_bwd_dkv.cu", "BN = Tile<D>::BN;", "BN = 32;"),
                 ("flash_bwd_dkv.cu", "constexpr int BN = Tile<Dv>::BN;",
                  "constexpr int BN = 32;")],
    # the same with at least 3 CTAs an SM (registers capped at 168)
    "dkv_bn32_minblocks3": [
        ("flash_bwd_dkv.cu", "BN = Tile<D>::BN;", "BN = 32;"),
        ("flash_bwd_dkv.cu", "constexpr int BN = Tile<Dv>::BN;",
         "constexpr int BN = 32;"),
        ("flash_bwd_dkv.cu", "__global__ void __launch_bounds__(kThreads)\n",
         "__global__ void __launch_bounds__(kThreads, 3)\n")],
}
#: patches whose results are wrong by design
KNOCKOUTS = {"no_split", "no_exp"}


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
        fn = getattr(ctypes.CDLL(so), k)
        fn.argtypes, fn.restype = _build.SIGNATURES[k][1], ctypes.c_int
        fns[k] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", default=[],
                    help="another kernel source directory to time")
    ap.add_argument("--patch", action="append", default=[],
                    choices=sorted(PATCHES),
                    help="a knock-out of the repository's sources")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A
    dev = resolve_device("cuda")
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

    b, t, h, d = cs.ATTN_B, cs.ATTN_T, 8, 64
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    do = torch.randn(b, t, h, d, generator=g, device=dev).to(torch.bfloat16)
    causal = args.causal
    win_q, win_k = A.tile_windows(None, None, b, t, t, dev)
    ref, lse = A._dense_forward(q, k, v, None, causal)
    delta = A._delta(ref, do)
    ref_dq = A._dense_grads(q, k, v, do, lse, delta, None, causal, want="dq")
    ref_dkv = A._dense_grads(q, k, v, do, lse, delta, None, causal,
                             want="dkv")
    calls = {
        "flash_fwd": lambda: A.flash_fwd(q, k, v, None, None, causal,
                                         win_q)[0],
        "flash_bwd_dq": lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, None,
                                               None, causal, win_q),
        "flash_bwd_dkv": lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                 None, None, causal, win_k)}
    refs = {"flash_fwd": (ref,), "flash_bwd_dq": (ref_dq,),
            "flash_bwd_dkv": ref_dkv}
    pairs = b * t * (t + 1) // 2 if causal else b * t * t
    real_kernel = _build.kernel
    order = list(fns)
    for turn, names in enumerate((order, order[::-1])):
        for name in names:
            patch, lib = fns[name]
            _build.kernel = lambda symbol, lib=lib: lib[symbol]
            for kname, call in calls.items():
                err = ""
                if patch not in KNOCKOUTS and turn == 0:
                    got = call()
                    got = got if isinstance(got, tuple) else (got,)
                    res = [cs.flash_error(x, r) for x, r in
                           zip(got, refs[kname])]
                    err = f", max abs err {max(e for e, _ in res):.3e} " \
                          f"({max(r for _, r in res):.3f} of tolerance)"
                ms = cs.time_ms(call, reps=args.reps, rounds=3)
                bound, _ = cs.bound_ms(*cs.flash_work(kname, b, t, t, h, d,
                                                      pairs, 2),
                                       cs.BF16_FLOPS_PER_S)
                print(f"turn {turn} {name} {kname} (causal {causal}): "
                      f"{ms * 1e3:.2f} us, {100 * bound / ms:.1f} % of the "
                      f"bound rate{err}", flush=True)
    _build.kernel = real_kernel
    return 0


if __name__ == "__main__":
    sys.exit(main())
