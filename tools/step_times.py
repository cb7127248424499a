#!/usr/bin/env python3
"""ms/step and device time a step of the transformer and image rows for a
tree of the port — two trees compared in one run on the card.

    python3 tools/step_times.py [--tree DIR] [--rows 4w,4x,4y,4l,4o]
                                [--steps N] [--profile] [--relu]
                                [--relu_ab] [--rounds R]

Imports ``paddle_tpu_torch`` from ``--tree`` (default: this checkout; an
older tree unpacked into a gitignored directory, ``git archive <commit> |
tar -x -C build/parent``) and ``chip_smoke`` from this checkout, then
trains each row with ``chip_smoke``'s own phase code, config, feed and
flags (``use_bf16`` + ``bf16_activations``), on the card:

- ``4w``: the transformer row (B 16, T 2048, D 512, 4 layers), 2 warm
  steps (``chip_smoke.phase_transformer``);
- ``4x``: the same on padded_mixed lengths, padded and packed, 1 warm
  step each;
- ``4y``: causal_t2048 in block_skip mode, 1 warm step;
- ``4l``: ResNet-50 (B 128, 224x224), 2 warm steps;
- ``4o``: resnet_cifar10(20) (B 128, 32x32), 2 warm steps.

Each row times ``--steps`` steps (default: ``chip_smoke``'s own count,
10 for 4w and 4l, 3 for 4x and 4y, 10 for 4o where ``chip_smoke`` times
2) with CUDA events, beside the host's wall clock a step.  With
``--profile``, 3 more steps of 4w and of 4o under ``torch.profiler``
give the device's busy time a step (every kernel and copy).  With
``--relu``, one process times ``ops.activations.relu`` against
``torch.relu``, forward and backward, in turns: the host's µs a call at
[128, 64] bf16, and the device's ms a call at 4w's feed-forward
activation, [16, 2048, 2048] bf16.  With ``--relu_ab`` (a tree whose
``ops.activations.relu`` is an ``autograd.Function``), each row's
trainer then takes ``--rounds`` (4) rounds of ``--steps`` timed steps with that relu
and with ``torch.relu`` bound in its place, in turns, in this process.
Prints one JSON line: the tree, the card (``nvidia-smi`` name and power
limit) and the readings.  Compare two trees in turns (parent, this,
this, parent) in one call.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_ms_per_step(cs, trainer, feed, steps=3):
    """Device busy time a step over ``steps`` profiled steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_one_batch(feed)
        torch.cuda.synchronize()
    return sum(r[1] for r in cs.device_rows(prof)) / 1e3 / steps


def relu_costs(dev, rounds=5, calls=200):
    """Host µs a forward + backward call at a small shape and device ms a
    call at 4w's activation, ``ops.activations.relu`` and ``torch.relu``
    in turns; the best round of each."""
    import torch
    from paddle_tpu_torch.ops import activations
    forms = {"port": activations.relu, "torch.relu": torch.relu}
    small = torch.randn(128, 64, device=dev).bfloat16().requires_grad_()
    big = torch.randn(16, 2048, 2048, device=dev).bfloat16() \
        .requires_grad_()
    g_small, g_big = torch.ones_like(small), torch.ones_like(big)
    host = {k: [] for k in forms}
    device = {k: [] for k in forms}
    for _ in range(rounds):
        for k, f in forms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                torch.autograd.grad(f(small), small, g_small)
            host[k].append((time.perf_counter() - t0) * 1e6 / calls)
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(5):
                torch.autograd.grad(f(big), big, g_big)
            b.record()
            torch.cuda.synchronize()
            device[k].append(a.elapsed_time(b) / 5)
    return {"host_us_per_call_128x64": {k: min(v) for k, v in host.items()},
            "device_ms_per_call_16x2048x2048": {k: min(v)
                                                for k, v in device.items()}}


def relu_ab(cs, trainer, feed, steps, rounds):
    """ms/step of ``rounds`` turns with the port's relu and with
    ``torch.relu`` in its place, on one trainer and feed."""
    import torch
    from paddle_tpu_torch.ops import activations
    res = {"port": [], "torch.relu": []}
    for _ in range(rounds):
        for k in res:
            if k == "torch.relu":
                activations._Relu.apply = torch.relu
            try:
                res[k].append(cs.timed_steps(trainer, feed, steps)[2])
            finally:
                if "apply" in vars(activations._Relu):
                    del activations._Relu.apply
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="root of the tree whose paddle_tpu_torch is timed")
    ap.add_argument("--rows", default="4w,4x,4y,4l,4o")
    ap.add_argument("--steps", type=int, default=0,
                    help="timed steps a row (0: chip_smoke's own)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--relu", action="store_true")
    ap.add_argument("--relu_ab", action="store_true")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, tree)
    import torch
    import paddle_tpu_torch
    if os.path.dirname(os.path.dirname(
            os.path.abspath(paddle_tpu_torch.__file__))) != tree:
        raise SystemExit(f"step_times: imported {paddle_tpu_torch.__file__}, "
                         f"not the tree {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("step_times: no CUDA device")
    from paddle_tpu_torch.models import resnet, resnet_cifar10
    dev = torch.device("cuda")
    card = cs.phase_card()
    cs.phase_build()
    cs.set_flags(**cs.BENCH_FLAGS)
    rows = set(args.rows.split(","))
    out = {}

    def steps(default):
        return args.steps or default

    def keep(name, m, trainer, feed, profile=False):
        out[name] = {k: m[k] for k in ("ms_per_step", "host_wall_ms_per_step")
                     if k in m}
        if profile and args.profile:
            out[name]["device_busy_ms_per_step"] = busy_ms_per_step(
                cs, trainer, feed)
        if args.relu_ab:
            out[name]["relu_ab_ms_per_step"] = relu_ab(
                cs, trainer, feed, args.steps or 10, args.rounds)
        torch.cuda.empty_cache()

    def attn(name, n, warm, **kw):
        _, m, trainer, feed = cs.phase_transformer(dev, n, warm, **kw)
        keep(name, m, trainer, feed, profile=name == "4w")

    if "4w" in rows:
        attn("4w", steps(cs.ATTN_STEPS), cs.ATTN_WARM)
    if "4x" in rows:
        for packed in (False, True):
            attn("4x_packed" if packed else "4x_padded",
                 steps(cs.ATTN_AB_STEPS), 1, packed=packed, mixed=True,
                 seed=1)
    if "4y" in rows:
        attn("4y", steps(cs.ATTN_AB_STEPS), 1, causal=True)
    if "4l" in rows:
        _, m, trainer, feed = cs.phase_train_image(
            dev, resnet(50, cs.RESNET_CLASSES, cs.RESNET_IMG), cs.RESNET_B,
            cs.RESNET_IMG, cs.RESNET_CLASSES, steps(cs.RESNET_STEPS),
            cs.RESNET_WARM, {})
        keep("4l", m, trainer, feed)
    if "4o" in rows:
        _, m, trainer, feed = cs.phase_train_image(
            dev, resnet_cifar10(20, 10, 32), cs.RESNET_B, 32, 10, steps(10),
            2, {})
        keep("4o", m, trainer, feed, profile=True)
    if args.relu:
        out["relu"] = relu_costs(dev)
    print(json.dumps({"tree": args.tree, "card": card, "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
