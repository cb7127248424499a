#!/usr/bin/env python3
"""The numerics behind phase 4z-image's gates, on one GPU, in fp32 with
TF32 off, each as its worst share of 4z-image (a)'s tolerance (rtol 1e-4,
atol 1e-5 · max(1, max|ref|)):

- ``F.avg_pool2d``'s input gradient card against CPU in six forms over a
  channels-last [4, 64, 27, 27] view, 3×3 stride 2: padding of its own
  (three divisor modes), a contiguous input, explicit zero padding, none;
- the weight gradient of a 3×3 conv (B 4, 28×28, 64 → 64) in fp32 against
  float64 on the CPU: the CPU's, cuDNN's under each ``cudnn`` flag and in
  both layouts, and PyTorch's own CUDA conv (cuDNN off);
- ``configs/image.py``'s smallnet, alexnet, googlenet and VGG-19 at B 4:
  the loss's gradients card against CPU from the same parameters, with
  cuDNN on and off, beside the CPU's own gradients after a 1e-7 relative
  nudge of the weights (how far a nudge within rounding moves them), each
  as its worst share and as its worst norm-relative error
  ``||g − g_cpu|| / ||g_cpu||`` (what 4z-image (c) gates);
- 4z-image (c)'s gate on smallnet with the average pool of C8 put back
  (padding of its own inside ``F.avg_pool2d``): the readings and what
  the gate says of them.

    python3 tools/image_probe.py    # one H100
"""

from __future__ import annotations

import itertools
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def share(got, ref) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    tol = 1e-5 * max(1.0, float(ref.abs().max())) + 1e-4 * ref.abs()
    return float(((got - ref).abs() / tol).max())


def ramp_grad(out, leaves):
    import torch
    ramp = torch.cos(0.1 * torch.arange(out.numel(), device=out.device,
                                        dtype=torch.float32)).to(out.dtype)
    return torch.autograd.grad(torch.sum(out * ramp.reshape(out.shape)),
                               leaves)


def avg_pool_forms(dev):
    import torch
    import torch.nn.functional as F
    x = np.random.RandomState(1).uniform(-1, 1, (4, 27, 27, 64)) \
        .astype(np.float32)
    forms = {
        "own padding, divisor_override 1": lambda t: F.avg_pool2d(
            t, 3, 2, 1, count_include_pad=True, divisor_override=1),
        "own padding, count_include_pad": lambda t: F.avg_pool2d(
            t, 3, 2, 1, count_include_pad=True),
        "own padding, exclude padding": lambda t: F.avg_pool2d(
            t, 3, 2, 1, count_include_pad=False),
        "own padding, contiguous input": lambda t: F.avg_pool2d(
            t.contiguous(), 3, 2, 1, count_include_pad=True,
            divisor_override=1),
        "explicit zero padding": lambda t: F.avg_pool2d(
            F.pad(t, (1, 1, 1, 1)), 3, 2, divisor_override=1),
        "no padding": lambda t: F.avg_pool2d(t, 3, 2, divisor_override=1)}
    for name, fn in forms.items():
        grads = []
        for where in ("cpu", dev):
            t = torch.from_numpy(x).to(where).requires_grad_(True)
            grads.append(ramp_grad(fn(t.permute(0, 3, 1, 2)), [t])[0])
        print(f"avg_pool2d backward, {name}: card vs CPU "
              f"{share(grads[1], grads[0]):.3f}", flush=True)


def conv_wgrad(dev):
    import torch
    import torch.nn.functional as F
    r = np.random.RandomState(78)
    x = r.uniform(-1, 1, (4, 28, 28, 64))
    w = r.randn(64, 64, 3, 3) / 24

    def wgrad(where, dt, layout, **flags):
        with torch.backends.cudnn.flags(**dict(
                dict(enabled=True, benchmark=False, deterministic=False,
                     allow_tf32=False), **flags)):
            xt = torch.from_numpy(x).to(where, dt).permute(0, 3, 1, 2)
            if layout == "contiguous":
                xt = xt.contiguous()
            ww = torch.from_numpy(w).to(where, dt).requires_grad_(True)
            return ramp_grad(F.conv2d(xt, ww, padding=1), [ww])[0]
    ref = wgrad("cpu", torch.float64, "channels-last")
    print(f"3x3 conv weight gradient vs float64: CPU fp32 "
          f"{share(wgrad('cpu', torch.float32, 'channels-last'), ref):.3f}",
          flush=True)
    for layout, (name, flags) in itertools.product(
            ("channels-last", "contiguous"),
            (("cuDNN", {}), ("cuDNN benchmark", {"benchmark": True}),
             ("cuDNN deterministic", {"deterministic": True}),
             ("cuDNN off", {"enabled": False}))):
        got = wgrad(dev, torch.float32, layout, **flags)
        print(f"3x3 conv weight gradient vs float64: {name}, {layout} "
              f"{share(got, ref):.3f}", flush=True)


def net_gradients(dev):
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.config.config_parser import parse_config
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.layers.network import NeuralNetwork
    config = os.path.join(ROOT, cs.IMAGE_CONFIG)
    for model in cs.IMAGE_NETS:
        cfg, _, ds = parse_config(config, f"model={model},batch_size=4")
        net = NeuralNetwork(cfg)
        provider = cs._image_provider(config)
        samples = list(itertools.islice(provider.reader(**ds.args)(), 4))
        feed = DataFeeder(list(zip(("data", "label"),
                                   provider.settings.input_types))) \
            .convert(samples)
        p0 = net.init_params(seed=1, device="cpu")

        def grads(params, where, **flags):
            with torch.backends.cudnn.flags(**dict(
                    dict(enabled=True, benchmark=False, deterministic=False,
                         allow_tf32=False), **flags)):
                ps = {n: p.to(where).requires_grad_(True)
                      for n, p in params.items()}
                loss, _ = net.loss(ps, {k: v.to(where)
                                        for k, v in feed.items()},
                                   is_training=False)
                return dict(zip(ps, [g.cpu() for g in torch.autograd.grad(
                    loss, list(ps.values()))]))
        ref = grads(p0, "cpu")
        gen = torch.Generator().manual_seed(0)
        nudged = {n: p * (1 + 1e-7 * torch.randn(p.shape, generator=gen))
                  for n, p in p0.items()}
        for name, got in (("card, cuDNN", grads(p0, dev)),
                          ("card, cuDNN off", grads(p0, dev, enabled=False)),
                          ("CPU, weights nudged 1e-7", grads(nudged, "cpu"))):
            worst = max((share(got[n], ref[n]), n) for n in ref)
            rel = max((cs._grad_rel(got[n], ref[n]), n) for n in ref)
            print(f"{model} gradients, {name}: worst share {worst[0]:.3f} "
                  f"({worst[1]}), worst norm-relative {rel[0]:.3e} "
                  f"({rel[1]})", flush=True)


def planted_c8(dev):
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from paddle_tpu_torch.ops import nn_ops
    repaired = nn_ops._window_pool

    def own_padding(xc, kind, k, s, pads):
        if kind == "max" or len(k) != 2 or any(lo != hi for lo, hi in pads):
            return repaired(xc, kind, k, s, pads)
        p = [lo for lo, _ in pads]
        summed = F.avg_pool2d(xc, k, s, p, count_include_pad=True,
                              divisor_override=1)
        counts = F.avg_pool2d(torch.ones_like(xc[:1, :1]), k, s, p,
                              count_include_pad=True, divisor_override=1)
        return summed / counts
    nn_ops._window_pool = own_padding
    try:
        m = cs.image_step("smallnet", dev)
    finally:
        nn_ops._window_pool = repaired
    faults = cs.image_step_faults(m)
    print(f"smallnet step with C8 put back: loss card {m['loss']:.6f} vs "
          f"CPU {m['loss_cpu']:.6f}, worst norm-relative gradient "
          f"{m['grad_rel']:.3e} ({m['grad_rel_param']}), weights within "
          f"{m['weight_max']:.2e} ({m['weight_share_past_2e-5']:.2e} past "
          f"2e-5); the gate: {'; '.join(faults) if faults else 'passes'}",
          flush=True)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("image_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.core.device import resolve_device
    dev = resolve_device("cuda")
    cs.set_flags(use_bf16=False, bf16_activations=False, precision="fp32")
    print(f"card: {cs.phase_card()}", flush=True)
    avg_pool_forms(dev)
    conv_wgrad(dev)
    net_gradients(dev)
    planted_c8(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
