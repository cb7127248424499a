#!/usr/bin/env python3
"""Time the training flash-attention kernels (kernels 1-train, 3 and 4 of
the port), or a serving kernel (kernel 7, ``--decode``; kernel 1's
serving form, ``--prefill``), in several variants on one GPU, in one
process, so their times compare.

    python3 tools/flash_probe.py [--csrc DIR ...] [--patch NAME ...]
                                 [--causal] [--packed] [--reps N]
                                 [--decode] [--prefill]

A variant is a copy of a kernel source directory (the repository's
``paddle_tpu_torch/csrc`` by default; ``--csrc`` adds others, such as an
older version unpacked with ``git archive``), optionally with a named
knock-out applied (``--patch``, see ``PATCHES``: one part of the bf16
wgmma loops' work removed to show what it costs; the results are wrong
by design and are not checked).  Each knock-out keeps the products it
does not remove live (ptxas drops products whose results nothing reads)
and keeps the number of wgmma groups, so every wait still retires what
it did.  Every variant is built with the port's ``nvcc`` flags into
``build/flash_probe/`` (``tools/probe_build.py``), and the wrappers of
``paddle_tpu_torch.ops.attention`` then launch it on the transformer
step's shape (q/k/v bf16 [16, 2048, 8, 64], views of one projection; all
keys valid; ``--packed``: the 16 rows, of lengths in [T/4, T], packed
into one row of 32768 tokens with segment ids, as the row's
``padded_mixed`` packed reading runs).  Unpatched variants are held
against the plain versions (``chip_smoke.flash_error``; not with
``--packed``, whose plain version does not fit on the card).  Each variant is timed in two turns
(variants in order, then in reverse), CUDA-graph replay between CUDA
events.  Prints each build's registers and spills, one line per
(variant, kernel, turn), and the card's name and power limit.

``--prefill`` times ``prefill_attention_packed`` (kernel 1's serving
form, ``csrc/flash_packed_fwd.cu``) at phase 5's shape (the first
admission round: 8 prompts packed at their bucket of 96, q [1, 768, 8,
32], causal, the same inputs from the same seed), then an empty kernel
(the launch floor).  Its knock-outs: ``prefill_no_stage`` (K and V read
from global memory, not staged), ``prefill_no_scan`` (no scan of the
row's ids, each window taken from the slot of 96, which these inputs
follow), ``prefill_no_math`` (no products and no exponentials, K and V
summed) and ``prefill_no_keys`` (no key visited: the launch, setup,
staging, combine and stores alone).  Patches combine as ``a+b``.
Every variant whose knock-out keeps the results is held against the
plain version within ``chip_smoke.ATOL``, and each prompt alone (B 1 at
its own bucket) against its rows in the pack, bit for bit.

``--decode`` times ``paged_decode_attention`` (``csrc/paged_decode.cu``)
instead, at phase 5's serving shape (``chip_smoke.phase_time``: 8 rows
mid-generation, q [8, 1, 8, 32] over the 512-page pool, the same inputs
from the same seed); its patch ``decode_w8`` splits the keys over eight
warps a block instead of four.  Every variant, patched or not, is held
against the plain version within
``chip_smoke.ATOL``, and each row's output alone (B 1) against its
output in the batch of 8, bit for bit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "flash_probe")
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: the decode kernel's variants (--decode): eight warps a block
DECODE_PATCHES = {"decode_w8": [("paged_decode.cu",
                                 "constexpr int kWarps = 4;",
                                 "constexpr int kWarps = 8;")]}

#: kernel 1's serving form (--prefill): knock-outs; the scan's takes
#: each window from the slot of 96
_PF = "flash_packed_fwd.cu"
PREFILL_SLOT = 96
PREFILL_PATCHES = {
    "prefill_no_stage": [
        (_PF, "    stage_kv(kg, vg, k_s, v_s, c0, n, D, sk, tok, tid);\n", "")]
    + [(_PF, f"load_row({x}_s + rr * sk, d0, Dl, {x}{x}[u]);",
        f"load_row({x}g + (size_t)(c0 + rr) * tok, d0, Dl, {x}{x}[u]);")
       for x in "kv"],
    "prefill_no_math": [
        (_PF, 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = x;"),
        (_PF, "float x = q[0] * k[0];", "float x = k[0];"),
        (_PF, "x = fmaf(q[d], k[d], x);", "x += k[d];"),
        (_PF, "acc[d] = fmaf(p, v[d], acc[d]);", "acc[d] += v[d];")],
    "prefill_no_scan": [
        (_PF, "  scan_row(segb, scan_end, idv, heads, my_sid, run_lo, run_hi, "
              "causal, tid,\n           lane);\n",
         "  if (tid < kQT)\n"
         f"    run_lo[tid] = (q0 + tid) / {PREFILL_SLOT} * {PREFILL_SLOT};\n")],
    "prefill_no_keys": [
        (_PF, "const int wcnt = __reduce_max_sync(ptt::kFull, cnt);",
         "const int wcnt = 0 * __reduce_max_sync(ptt::kFull, cnt);")],
}

#: knock-outs whose results are wrong by design (not held to ATOL)
PREFILL_UNCHECKED = ("prefill_no_math", "prefill_no_keys")

# a product knocked out: its fragments folded into the accumulator's
# lowest bit (so the split stays live) and an empty wgmma group in its
# place (so the waits' counts hold)
_NO_PRODUCT = """
template <int D>
__device__ __forceinline__ void no_product(
    float (&acc)[D / 2], const uint32_t (&ph)[kKeys / 16][4],
    const uint32_t (&pl)[kKeys / 16][4], uint32_t) {
  uint32_t x = 0;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) x ^= ph[kk][w] ^ pl[kk][w];
  acc[0] += __uint_as_float(x & 1u);
  wg::fence();
  wg::commit();
}

}  // namespace fa
"""

#: name -> [(file, old text, new text)]: knock-outs of the bf16 wgmma
#: loops of kernels 3 and 4 (flash_wg.cuh's edits reach the forward too)
PATCHES = {
    # the lo half of every F B product (dQ += dS K, dV += P^T dO, dK +=
    # dS^T Q; the forward's P V)
    "no_lo": [("flash_wg.cuh", "    wg::mma_rs<D, 1>(acc, pl[kk],",
               "    if (0) wg::mma_rs<D, 1>(acc, pl[kk],")],
    # no exponentials (p = the scaled score's difference)
    "no_exp": [("flash_common.cuh",
                'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x;")],
    # no dS product: dQ += dS K (kernel 3) and dK += dS^T Q (kernel 4)
    "no_ds_product": [
        ("flash_wg.cuh", "}  // namespace fa\n", _NO_PRODUCT),
        ("flash_bwd_dq.cu", "issue_pv<D>(acc, fh, fl,",
         "no_product<D>(acc, fh, fl,"),
        ("flash_bwd_dkv.cu", "issue_pv<D>(dka, sh, sl,",
         "no_product<D>(dka, sh, sl,")],
    # no wait on the ring's mbarriers (the inner tiles are read as they
    # land; Q, dO / K, V still waited for once)
    "no_ring_wait": [
        (f, "    wg::mbar_wait(full + i % kWgStages, (i / kWgStages) & 1);\n",
         "") for f in ("flash_bwd_dq.cu", "flash_bwd_dkv.cu")],
}


ALL_PATCHES = {**PATCHES, **DECODE_PATCHES, **PREFILL_PATCHES}


def build(name, src_dir, patch, stems=KERNELS):
    """The variant's entry points, and its ptxas lines printed."""
    from probe_build import build_variant
    edits = [e for p in (patch or "").split("+") if p
             for e in ALL_PATCHES[p]]
    fns, ptxas = build_variant(os.path.join(OUT, name), src_dir, edits,
                               stems)
    for stem in stems:
        for ln in ptxas[stem].splitlines():
            if any(s in ln for s in ("registers", "spill", "arning")):
                print(f"  {name}/{stem}: {ln.strip()}", flush=True)
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", default=[],
                    help="another kernel source directory to time")
    ap.add_argument("--patch", action="append", default=[],
                    help="a knock-out of the repository's sources (with "
                    "--decode or --prefill: a variant of that kernel); "
                    "a+b applies both; one of " + ", ".join(sorted(
                        ALL_PATCHES)))
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--packed", action="store_true",
                    help="the 16 rows packed into one, lengths in [T/4, T]")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--decode", action="store_true",
                    help="time kernel 7 (paged decode) at phase 5's shape")
    ap.add_argument("--prefill", action="store_true",
                    help="time kernel 1's serving form at phase 5's shape")
    args = ap.parse_args()
    for p in args.patch:
        for x in p.split("+"):
            if x not in ALL_PATCHES:
                ap.error(f"unknown patch {x}")
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
    if args.decode:
        return decode(dev, variants, args.reps)
    if args.prefill:
        return prefill(dev, variants, args.reps)
    fns = {n: (p, build(n, d, p)) for n, d, p in variants}

    b, t, h, d = cs.ATTN_B, cs.ATTN_T, 8, 64
    g = torch.Generator(device=dev).manual_seed(0)
    causal = args.causal
    seg = None
    if args.packed:
        # padded_mixed's rows packed into one: lengths in [T/4, T]
        lens = np.random.RandomState(1).randint(t // 4, t + 1, b)
        seg = A.segments_from_lengths(torch.from_numpy(lens).to(dev), b, t)
        pairs = int(sum(n * (n + 1) // 2 if causal else n * n for n in lens))
        b, t = 1, b * t
    else:
        pairs = b * t * (t + 1) // 2 if causal else b * t * t
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    do = torch.randn(b, t, h, d, generator=g, device=dev).to(torch.bfloat16)
    win_q, win_k = A.tile_windows(None, seg, b, t, t, dev)
    refs = None
    if args.packed:
        # the plain version's [T, T] scores take 34 GB here: lse and delta
        # come from the repository's forward kernel, nothing is checked
        ref, lse = A.flash_fwd(q, k, v, None, seg, causal, win_q)
        delta = A._delta(ref, do)
    else:
        ref, lse = A._dense_forward(q, k, v, None, causal)
        delta = A._delta(ref, do)
        refs = {"flash_fwd": (ref,),
                "flash_bwd_dq": (A._dense_grads(q, k, v, do, lse, delta,
                                                None, causal, want="dq"),),
                "flash_bwd_dkv": A._dense_grads(q, k, v, do, lse, delta,
                                                None, causal, want="dkv")}
    calls = {
        "flash_fwd": lambda: A.flash_fwd(q, k, v, None, seg, causal,
                                         win_q)[0],
        "flash_bwd_dq": lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, None,
                                               seg, causal, win_q),
        "flash_bwd_dkv": lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                 None, seg, causal, win_k)}
    real_kernel = _build.kernel
    order = list(fns)
    for turn, names in enumerate((order, order[::-1])):
        for name in names:
            patch, lib = fns[name]
            _build.kernel = lambda symbol, lib=lib: lib[symbol]
            for kname, call in calls.items():
                err = ""
                if patch is None and turn == 0 and refs:
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
                print(f"turn {turn} {name} {kname} (causal {causal}, "
                      f"packed {args.packed}): "
                      f"{ms * 1e3:.2f} us, {100 * bound / ms:.1f} % of the "
                      f"bound rate{err}", flush=True)
    _build.kernel = real_kernel
    return 0


def decode(dev, variants, reps):
    """Kernel 7 in each variant at phase 5's decode shape, two turns."""
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A
    fns = {n: build(n, d, p, ("paged_decode",)) for n, d, p in variants}
    h, d = cs.CFG["heads"], cs.CFG["dim"] // cs.CFG["heads"]
    lens = [len(p) for p in cs._prompts(0, cs.N_REQ, cs.CFG["vocab"])]
    lens = lens[:cs.MAX_BATCH]
    rng = np.random.default_rng(2)   # phase_time's stream: prefill first
    cs.packed_case(rng, lens, -(-max(lens) // 16) * 16, h, d, dev)
    dl = [ln + cs.MAX_NEW // 2 for ln in lens]
    max_pages = -(-cs.CFG["max_context"] // cs.PAGE)
    args = cs.decode_case(rng, dl, 1, h, d, cs.POOL_PAGES, cs.PAGE,
                          max_pages, dev)
    ref = A.paged_decode_reference(*args)
    n_bytes, n_flops = cs.decode_work(np.array(dl), 1, h, d, max_pages)
    bound, _ = cs.bound_ms(n_bytes, n_flops)
    print(f"decode lengths {dl}: bound {bound * 1e3:.3f} us", flush=True)
    real_kernel = _build.kernel
    order = list(fns)
    for turn, names in enumerate((order, order[::-1])):
        for name in names:
            lib = fns[name]
            _build.kernel = lambda symbol, lib=lib: lib[symbol]
            err = ""
            if turn == 0:
                out = A.paged_decode_attention(*args)
                e = (out - ref).abs().max().item()
                q, kp, vp, tables, lengths = args
                alone = all(torch.equal(
                    A.paged_decode_attention(q[i:i + 1].clone(), kp, vp,
                                             tables[i:i + 1].clone(),
                                             lengths[i:i + 1].clone())[0],
                    out[i]) for i in range(len(dl)))
                if not e <= cs.ATOL:
                    raise SystemExit(f"{name}: decode error {e} > {cs.ATOL}")
                err = f", max abs err {e:.3e}, rows alone == in the batch " \
                      f"{alone}"
            ms = cs.time_ms(lambda: A.paged_decode_attention(*args),
                            reps=reps * 10, rounds=5)
            print(f"turn {turn} {name} paged_decode: {ms * 1e3:.2f} us, "
                  f"{100 * bound / ms:.1f} % of the bound{err}", flush=True)
    _build.kernel = real_kernel
    return 0


def prefill(dev, variants, reps):
    """Kernel 1's serving form in each variant at phase 5's prefill shape,
    two turns, then the launch floor."""
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A
    fns = {n: (p, build(n, d, p, ("flash_packed_fwd",)))
           for n, d, p in variants}
    h, d = cs.CFG["heads"], cs.CFG["dim"] // cs.CFG["heads"]
    lens = [len(p) for p in cs._prompts(0, cs.N_REQ, cs.CFG["vocab"])]
    lens = lens[:cs.MAX_BATCH]
    slot = -(-max(lens) // 16) * 16
    assert slot == PREFILL_SLOT, slot        # prefill_no_scan's windows
    rng = np.random.default_rng(2)           # phase_time's stream
    q, k, v, seg = cs.packed_case(rng, lens, slot, h, d, dev)
    ref, ref_lse = A._dense_forward(q, k, v, None, True, seg)
    valid = (seg >= 0)[0]
    n_bytes, n_flops = cs.prefill_work(seg.cpu().numpy(), h, d)
    bound, _ = cs.bound_ms(n_bytes, n_flops)
    print(f"prefill lengths {lens} at slot {slot}: bound "
          f"{bound * 1e3:.3f} us", flush=True)

    def call():
        return A.prefill_attention_packed(q, k, v, seg, causal=True)

    real_kernel = _build.kernel
    order = list(fns)
    for turn, names in enumerate((order, order[::-1])):
        for name in names:
            patch, lib = fns[name]
            _build.kernel = lambda symbol, lib=lib: lib[symbol]
            err = ""
            if turn == 0:
                out, lse = call()
                e = max((out - ref).abs().max().item(),
                        (lse - ref_lse)[:, :, valid].abs().max().item())
                alone = True
                for i, n in enumerate(lens):
                    bucket = -(-n // 16) * 16
                    rows = slice(i * slot, i * slot + bucket)
                    s1 = A.segments_from_lengths(torch.tensor(
                        [n], dtype=torch.int32, device=dev), 1, bucket)
                    o1, l1 = A.prefill_attention_packed(
                        *(x[:, rows].contiguous() for x in (q, k, v)),
                        s1.contiguous(), causal=True)
                    mine = slice(i * slot, i * slot + n)
                    alone &= torch.equal(o1[:, :n], out[:, mine]) and \
                        torch.equal(l1[:, :, :n], lse[:, :, mine])
                checked = not set((patch or "").split("+")) & set(
                    PREFILL_UNCHECKED)
                if checked and not e <= cs.ATOL:
                    raise SystemExit(f"{name}: prefill error {e} > {cs.ATOL}")
                err = f", max abs err {e:.3e}, prompts alone == in the " \
                      f"pack {alone}"
            ms = cs.time_ms(call, reps=reps * 10, rounds=5)
            print(f"turn {turn} {name} flash_packed_fwd: {ms * 1e3:.2f} us, "
                  f"{100 * bound / ms:.1f} % of the bound{err}", flush=True)
    _build.kernel = real_kernel
    floor = real_kernel("launch_floor")
    floor_ms = cs.time_ms(lambda: floor(
        torch.cuda.current_stream().cuda_stream), reps=reps * 10, rounds=5)
    print(f"launch floor (an empty kernel): {floor_ms * 1e3:.2f} us",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
