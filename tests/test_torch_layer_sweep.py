"""The JAX layer sweep's case (``tests/test_layer_grad_sweep.py::CASES``)
of every layer type the port registered before its dense layers, run
through both packages on the CPU: the layer's output and the gradients
of the sweep's readout in every parameter and float input agree
(``test_torch_dense_layers.check_parity``: rtol 1e-5, atol 1e-6 ·
max(1, max|ref|)).  The dense types, projections, operators and costs
have their cases in ``test_torch_dense_layers.py`` and
``test_torch_costs_ops.py``; other files hold these types inside whole
models.

``layer_norm`` takes data of its own, not the sweep's shared stream
(whose draws depend on the tests run before): the 24th draw of
``RandomState(77)``'s ``uniform(-1, 1, (3, 5))``, rows of small variance
where both packages' input gradients are farthest from a float64
evaluation among 400 draws (the JAX package's 1.59e-5 of max|g|, the
port's 2.4e-5).  Each package's input gradient is held against the
float64 value within twice the JAX package's largest error over those
draws, 3.2e-5 of max|g|; the output and the parameter gradients keep
the port-against-JAX tolerance.
"""

import numpy as np
import pytest

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net
from test_torch_dense_layers import check_parity, numpy_feed

#: the sweep's names of the types the earlier slices ported
EARLIER_TYPES = ["embedding", "lstmemory", "gated_recurrent", "gru_step",
                 "exconv", "pool", "batch_norm",
                 "scaled_dot_product_attention", "layer_norm",
                 "position_embedding", "seqlastins", "average", "expand"]


#: the float64 bound of layer_norm's input gradient, of max|g|
LAYER_NORM_F64_BOUND = 3.2e-5


def _layer_norm_case(jnet):
    """The layer_norm case's feed and its input gradient in float64 from
    the carried parameters (the readout's cosine ramp, ε 1e-5)."""
    from test_torch_dense_layers import carried_params, port_net
    rng = np.random.RandomState(77)
    for _ in range(24):
        x = rng.uniform(-1, 1, (3, 5)).astype(np.float32)
    jp, _ = carried_params(jnet, port_net(jnet))
    w, b = (np.asarray(jp[f"_test.{n}"], np.float64)
            for n in ("w0", "wbias"))
    xd = x.astype(np.float64)
    mu = xd.mean(-1, keepdims=True)
    c = xd - mu
    rstd = 1.0 / np.sqrt((c * c).mean(-1, keepdims=True) + 1e-5)
    g = w * np.cos(0.1 * np.arange(x.size)).reshape(x.shape)
    xhat = c * rstd
    gx = rstd * (g - g.mean(-1, keepdims=True)
                 - xhat * (g * xhat).mean(-1, keepdims=True))
    return {"in0": x}, {"feed:in0": (gx, LAYER_NORM_F64_BOUND)}


@pytest.mark.parametrize("name", EARLIER_TYPES)
def test_sweep_case_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    jnet = build_single_layer_net(name, **kwargs)
    if name == "layer_norm":
        feed, f64 = _layer_norm_case(jnet)
        check_parity(jnet, feed, f64=f64)
        return
    check_parity(jnet, numpy_feed(feed_fn()))
