"""The layer norm's input gradient against float64, over many draws.

Runs the JAX layer sweep's ``layer_norm`` case (size 5, a [3, 5] input
uniform in [-1, 1], the sweep's cosine readout, parameters from
``carried_params``) on ``N`` draws of ``RandomState(77)``, and prints,
for the JAX package's gradient, the port's (its ``LayerNormLayer``: the
closed-form backward on the centred input) and ``F.layer_norm``'s, the
largest, 99th-percentile and median error against a float64 evaluation (relative
to max|g|), and how many draws each torch form misses the
port-against-JAX tolerance of ``test_torch_dense_layers.close`` on.  The
draws that the port misses are listed with the errors.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_layer_norm_f64.py [N]

As a test, over the first 48 draws (the 24th, the worst of 400 for both
packages, among them): the port's layer stays within 2× the JAX
package's largest error from float64, and ``F.layer_norm`` does not.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_layer_grad_sweep as sweep  # noqa: E402
from layer_grad_util import build_single_layer_net, scalar_loss  # noqa: E402
from test_torch_dense_layers import (ATOL, RTOL, carried_params,  # noqa: E402
                                     port_net, torch_feed,
                                     torch_scalar_loss)


def _f64_grad(x, w, b):
    x = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + 1e-5) * torch.tensor(w) \
        + torch.tensor(b)
    ramp = torch.cos(0.1 * torch.arange(y.numel(), dtype=torch.float64))
    return torch.autograd.grad((y * ramp.reshape(y.shape)).sum(), x)[0] \
        .numpy()


def _torch_grad(form, x, tnet, tp):
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    if form == "port":
        val = torch_scalar_loss(tnet, tp, torch_feed({"in0": x}, {"in0": tx}))
    else:
        y = torch.nn.functional.layer_norm(
            tx, (x.shape[-1],), tp["_test.w0"], tp["_test.wbias"], 1e-5)
        ramp = torch.cos(0.1 * torch.arange(y.numel(), dtype=y.dtype))
        val = (y * ramp.reshape(y.shape)).sum()
    return torch.autograd.grad(val, tx)[0].numpy().astype(np.float64)


def _misses(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    return not np.all(np.abs(got - want) <= ATOL * scale
                      + RTOL * np.abs(want))


def measure(n: int):
    """Per form, each draw's error against float64 (of max|g|), and the
    draws each torch form misses the port-against-JAX tolerance on."""
    kwargs, _, _ = sweep.CASES["layer_norm"]
    jnet = build_single_layer_net("layer_norm", **kwargs)
    tnet = port_net(jnet)
    jp, tp = carried_params(jnet, tnet)
    tp = {k: v.detach() for k, v in tp.items()}
    w64, b64 = (np.asarray(jp[k], np.float64)
                for k in ("_test.w0", "_test.wbias"))
    jgrad = jax.jit(jax.grad(lambda x: scalar_loss(jnet, jp, {"in0": x})))
    forms = ("F.layer_norm", "port")
    err = {k: [] for k in ("jax",) + forms}
    miss = {k: [] for k in forms}
    rng = np.random.RandomState(77)
    for i in range(n):
        x = rng.uniform(-1, 1, (3, 5)).astype(np.float32)
        ref = _f64_grad(x, w64, b64)
        scale = np.abs(ref).max()
        jx = np.asarray(jgrad(jnp.asarray(x)), np.float64)
        err["jax"].append(np.abs(jx - ref).max() / scale)
        for form in forms:
            g = _torch_grad(form, x, tnet, tp)
            err[form].append(np.abs(g - ref).max() / scale)
            if _misses(g, jx):
                miss[form].append(i)
    return err, miss


def test_layer_norm_gradient_error_is_within_the_jax_packages():
    err, _ = measure(48)
    jax_worst = max(err["jax"])
    assert max(err["port"]) <= 2 * jax_worst, (err["port"], jax_worst)
    assert max(err["F.layer_norm"]) > 2 * jax_worst


def main(n: int) -> None:
    err, miss = measure(n)
    for k, v in err.items():
        v = np.asarray(v)
        print(f"{k}: against float64, of max|g|: max {v.max():.3g}, "
              f"p99 {np.quantile(v, 0.99):.3g}, median {np.median(v):.3g}"
              + (f"; misses the port-against-JAX tolerance on "
                 f"{len(miss[k])} of {n} draws" if k in miss else ""))
    for i in miss["port"]:
        print(f"draw {i} (the port misses): port {err['port'][i]:.3g}, "
              f"jax {err['jax'][i]:.3g}, F.layer_norm "
              f"{err['F.layer_norm'][i]:.3g}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 400)
