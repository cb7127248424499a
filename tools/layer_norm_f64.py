#!/usr/bin/env python3
"""The layer norm's gradients against float64 on one device: the port's
two fp32 forms, ``F.layer_norm`` and the closed form of
``paddle_tpu_torch.layers.attention._LayerNorm``.

    python3 tools/layer_norm_f64.py [--device cuda|cpu] [--draws 400]
                                    [--rows 32768]

Two cases, each form's gradient held against the same function evaluated
in float64 on the same device, as an error relative to the gradient's
largest magnitude:

- ``sweep``: the layer sweep's ``layer_norm`` case, as
  ``tests/test_torch_layer_norm_f64.py`` runs it — ``--draws`` inputs
  [3, 5] uniform in [-1, 1] from ``RandomState(77)``, the gain
  1 + 0.01 n and the bias 0.01 n (n = ``RandomState(1).randn(5)``, the
  test's carried parameters), the sweep's cosine readout; the input
  gradient's largest, 99th-percentile and median error over the draws;
- ``row``: the transformer row's shape ([``--rows``, 512]: B 16 × T
  2048, D 512) — inputs N(0, 1) plus a per-row offset N(0, 3²) rounded
  to bf16 (the row's activations are bf16), an upstream gradient N(0, 1)
  rounded to bf16, the same gain and bias drawn at width 512; the input,
  gain and bias gradients' errors.

Prints one JSON line.  The CPU tests hold the JAX package to the same
float64 on the sweep case (1.59e-5 its largest error over 400 draws).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grads(form, x, w, b, dy):
    x, w, b = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    y = form(x, w, b)
    return torch.autograd.grad(y, (x, w, b), dy)


def _forms(_LayerNorm):
    return {
        "F.layer_norm": lambda x, w, b: F.layer_norm(
            x, (x.shape[-1],), w, b, 1e-5),
        "closed_form": lambda x, w, b: _LayerNorm.apply(x, w, b, 1e-5),
    }


def _f64(x, w, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * w + b


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def sweep_case(dev, forms, draws):
    n = np.random.RandomState(1).randn(5)
    w = torch.tensor(1 + 0.01 * n, dtype=torch.float32, device=dev)
    b = torch.tensor(0.01 * n, dtype=torch.float32, device=dev)
    ramp = torch.cos(0.1 * torch.arange(15, dtype=torch.float64,
                                        device=dev)).reshape(3, 5)
    rng = np.random.RandomState(77)
    err = {k: [] for k in forms}
    for _ in range(draws):
        x = torch.tensor(rng.uniform(-1, 1, (3, 5)).astype(np.float32),
                         device=dev)
        want = _grads(_f64, x.double(), w.double(), b.double(), ramp)[0]
        for k, form in forms.items():
            got = _grads(form, x, w, b, ramp.float())[0]
            err[k].append(_rel(got, want))
    return {k: {"max": max(v), "p99": float(np.quantile(v, 0.99)),
                "median": float(np.median(v))} for k, v in err.items()}


def row_case(dev, forms, rows):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(rows, 512, generator=g, device=dev)
         + 3 * torch.randn(rows, 1, generator=g, device=dev)
         ).bfloat16().float()
    dy = torch.randn(rows, 512, generator=g, device=dev).bfloat16().float()
    w = 1 + 0.01 * torch.randn(512, generator=g, device=dev)
    b = 0.01 * torch.randn(512, generator=g, device=dev)
    want = _grads(_f64, x.double(), w.double(), b.double(), dy.double())
    out = {}
    for k, form in forms.items():
        got = _grads(form, x, w, b, dy)
        out[k] = {name: _rel(gi, wi)
                  for name, gi, wi in zip(("dx", "dw", "db"), got, want)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=400)
    ap.add_argument("--rows", type=int, default=16 * 2048)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    global torch, F
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.layers.attention import _LayerNorm
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("layer_norm_f64: no CUDA device")
    dev = torch.device(args.device)
    forms = _forms(_LayerNorm)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
        else "cpu",
        "torch": torch.__version__,
        "sweep": sweep_case(dev, forms, args.draws),
        "row": row_case(dev, forms, args.rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
