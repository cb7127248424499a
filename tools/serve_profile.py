#!/usr/bin/env python3
"""Continuous serving on one GPU, from the tree in the working directory:
``chip_smoke.py``'s continuous pass (a warm pass, then a timed one) a
few times, then one pass under ``torch.profiler`` for the device time of
kernels 1 (the packed prefill) and 7 (paged decode) over the pass.

    cd <a checkout> && python3 <this repository>/tools/serve_profile.py TAG \\
        [--passes N]

Run it from two checkouts in turns (A, B, B, A) in one call to compare
their req/s, TTFT and kernel time on the same card; the spread of one
tree's passes is the host's noise.  Every line starts with TAG.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag", help="the label printed on every line")
    ap.add_argument("--passes", type=int, default=3,
                    help="timed continuous passes before the profiled one")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving.model import (DecoderConfig, DecoderModel,
                                                init_decoder_params)
    from paddle_tpu_torch.serving.server import InferenceServer
    tag = args.tag
    dev = resolve_device("cuda")
    cs.set_flags(use_bf16=False, bf16_activations=False, precision="fp32",
                 fused_rnn_hblock=True)
    _build.build_all()
    cfg = DecoderConfig(**cs.CFG)
    model = DecoderModel(init_decoder_params(cfg, seed=0), cfg, device=dev)
    prompts = cs._prompts(0, cs.N_REQ, cfg.vocab)
    for i in range(args.passes):
        _, m = cs._serve(model, prompts, continuous=True)
        print(f"{tag} serving continuous pass {i}: {m['req_per_s']:.3f} "
              f"req/s, TTFT p50 {m['ttft_p50_ms']:.3f} ms p99 "
              f"{m['ttft_p99_ms']:.3f} ms, flash_packed_fwd launches "
              f"{m['launches']['flash_packed_fwd']}", flush=True)
    srv = InferenceServer(model, max_batch=cs.MAX_BATCH,
                          n_pages=cs.POOL_PAGES, page_size=cs.PAGE,
                          continuous=True).start()
    try:
        for r in [srv.submit(p, cs.MAX_NEW) for p in prompts]:
            srv.result(r, timeout=600.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for r in [srv.submit(p, cs.MAX_NEW) for p in prompts]:
                srv.result(r, timeout=600.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        srv.stop()
    rows = cs.device_rows(prof)
    busy = sum(r[1] for r in rows)
    print(f"{tag} 4c: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms", flush=True)
    for label, mark in (("kernel 1", "flash_packed_fwd_kernel"),
                        ("kernel 7", "paged_decode_kernel")):
        us = sum(r[1] for r in rows if mark in r[0])
        n = sum(r[2] for r in rows if mark in r[0])
        print(f"{tag} 4c {label}: {us / 1e3:.3f} ms over {n} launches",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
