"""The JAX layer sweep's case (``tests/test_layer_grad_sweep.py::CASES``)
of every layer type the port registered before its dense layers, run
through both packages on the CPU: the layer's output and the gradients
of the sweep's readout in every parameter and float input agree
(``test_torch_dense_layers.check_parity``: rtol 1e-5, atol 1e-6 ·
max(1, max|ref|)).  The dense types, projections, operators and costs
have their cases in ``test_torch_dense_layers.py`` and
``test_torch_costs_ops.py``; other files hold these types inside whole
models.
"""

import pytest

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net
from test_torch_dense_layers import check_parity, numpy_feed

#: the sweep's names of the types the earlier slices ported
EARLIER_TYPES = ["embedding", "lstmemory", "gated_recurrent", "gru_step",
                 "exconv", "pool", "batch_norm",
                 "scaled_dot_product_attention", "layer_norm",
                 "position_embedding", "seqlastins", "average", "expand"]


@pytest.mark.parametrize("name", EARLIER_TYPES)
def test_sweep_case_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    check_parity(build_single_layer_net(name, **kwargs),
                 numpy_feed(feed_fn()))
