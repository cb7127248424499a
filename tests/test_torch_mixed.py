"""``mixed`` (``paddle_tpu_torch/layers/common.py``) against the JAX
package's, on the CPU: one case per projection (``fc`` on a sequence,
``trans_fc``, ``identity``, ``dot_mul``, ``scaling``, ``table`` on
sequence and dense ids, ``context`` without and with trainable padding
at both ends, ``slice`` with one and several ranges) and operator
(``dot_mul``, alone and beside a projection, the ``dot_mul_operator``
attribute form, ``conv`` with one filter per sample), ``concat2`` over
a slice and a context projection, ``mkldnn_fc``, and a bias on
``addto`` / ``concat`` (an image output's CHW bias too).

Each net is built by the JAX sweep's function
(``layer_grad_util.build_single_layer_net``) and compared by
``test_torch_dense_layers.check_parity``: the output and the gradients
of the sweep's readout in every parameter and float input, within rtol
1e-5 and atol 1e-6 · max(1, max|ref|) (fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layer_grad_util import build_single_layer_net
from paddle_tpu.config.model_config import ProjConfig
from paddle_tpu.core.sequence import pad_batch
from paddle_tpu.layers import common as jcommon
from paddle_tpu_torch.layers import common as tcommon
from test_torch_dense_layers import check_parity, port_net, torch_feed

R = np.random.RandomState(2024)


def _d(b, d, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, (b, d)).astype(np.float32)


def _seq(lens, d):
    sb = pad_batch([R.randn(n, d).astype(np.float32) for n in lens])
    return np.asarray(sb.data), np.asarray(sb.length)


def _iseq(lens, hi):
    sb = pad_batch([R.randint(0, hi, (n,)) for n in lens])
    return np.asarray(sb.data), np.asarray(sb.length)


def _proj(typ, **kw):
    return ProjConfig(type=typ, **kw)


def _conv_op():
    # a 2 x 4 x 5 image (H 4, W 5), a 2 x 3 filter per sample (fh 2, fw
    # 3), stride (2, 1), padding (0, 1): out 3 filters x 2 x 5
    return {"type": "conv", "input_indices": (0, 1), "channels": 2,
            "img_size": 5, "img_size_y": 4, "filter_size": 3,
            "filter_size_y": 2, "num_filters": 3, "stride": 1,
            "stride_y": 2, "padding": 1, "padding_y": 0}


#: (layer type, build kwargs, numpy feed maker) for each case
EXTRA = {
    "mkldnn_fc": ("mkldnn_fc", dict(size=5, input_sizes=[4],
                                    active_type="softmax", with_bias=True),
                  lambda: {"in0": _d(3, 4)}),
    "addto_bias": ("addto", dict(size=4, input_sizes=[4, 4],
                                 with_bias=True, active_type="tanh"),
                   lambda: {"in0": _d(3, 4), "in1": _d(3, 4)}),
    "concat_bias": ("concat", dict(size=7, input_sizes=[3, 4],
                                   with_bias=True, active_type="relu"),
                    lambda: {"in0": _d(3, 3), "in1": _d(3, 4)}),
    "proj_fc_seq": ("mixed", dict(
        size=5, input_sizes=[4], active_type="sigmoid", with_bias=True,
        projs=[_proj("fc", input_size=4, output_size=5)]),
        lambda: {"in0": _seq([3, 2], 4)}),
    "proj_trans_fc": ("mixed", dict(
        size=5, input_sizes=[4],
        projs=[_proj("trans_fc", input_size=4, output_size=5)]),
        lambda: {"in0": _d(3, 4)}),
    "proj_identity": ("mixed", dict(
        size=4, input_sizes=[4], active_type="tanh",
        projs=[_proj("identity", input_size=4, output_size=4)]),
        lambda: {"in0": _d(3, 4)}),
    "proj_dot_mul": ("mixed", dict(
        size=4, input_sizes=[4],
        projs=[_proj("dot_mul", input_size=4, output_size=4)]),
        lambda: {"in0": _d(3, 4)}),
    "proj_scaling": ("mixed", dict(
        size=4, input_sizes=[4],
        projs=[_proj("scaling", input_size=4, output_size=4)]),
        lambda: {"in0": _d(3, 4)}),
    "proj_table": ("mixed", dict(
        size=5, input_sizes=[9],
        projs=[_proj("table", input_size=9, output_size=5)]),
        lambda: {"in0": _iseq([4, 2], 9)}),
    "proj_table_dense_ids": ("mixed", dict(
        size=5, input_sizes=[9],
        projs=[_proj("table", input_size=9, output_size=5)]),
        lambda: {"in0": np.array([3, 0, 8], np.int32)}),
    "proj_context": ("mixed", dict(
        size=12, input_sizes=[4],
        projs=[_proj("context", input_size=4, context_start=-1,
                     context_length=3)]),
        lambda: {"in0": _seq([4, 2, 3], 4)}),
    "proj_context_trainable_padding": ("mixed", dict(
        size=16, input_sizes=[4], with_bias=True,
        projs=[_proj("context", input_size=4, context_start=-2,
                     context_length=4, trainable_padding=True)]),
        lambda: {"in0": _seq([5, 1, 3], 4)}),
    "proj_context_end_padding": ("mixed", dict(
        size=9, input_sizes=[3],
        projs=[_proj("context", input_size=3, context_start=0,
                     context_length=3, trainable_padding=True)]),
        lambda: {"in0": _seq([4, 2], 3)}),
    "proj_slice": ("mixed", dict(
        size=2, input_sizes=[5],
        projs=[_proj("slice", input_size=5, slice_begin=1, slice_end=3)]),
        lambda: {"in0": _d(3, 5)}),
    "proj_slices": ("mixed", dict(
        size=3, input_sizes=[5], active_type="relu",
        projs=[_proj("slice", input_size=5, slices=[(0, 2), (3, 4)])]),
        lambda: {"in0": _d(3, 5)}),
    "proj_sum_with_bias": ("mixed", dict(
        size=4, input_sizes=[6, 4, 4], with_bias=True, active_type="tanh",
        projs=[_proj("fc", input_size=6, output_size=4),
               _proj("identity", input_size=4, output_size=4),
               _proj("dot_mul", input_size=4, output_size=4)]),
        lambda: {"in0": _d(3, 6), "in1": _d(3, 4), "in2": _d(3, 4)}),
    "operator_dot_mul": ("mixed", dict(
        size=4, input_sizes=[4, 4], active_type="exp",
        attrs={"operators": [{"type": "dot_mul", "scale": 0.5,
                              "input_indices": (0, 1)}]}),
        lambda: {"in0": _d(3, 4), "in1": _d(3, 4)}),
    "operator_dot_mul_with_projection": ("mixed", dict(
        size=4, input_sizes=[4, 4, 4],
        projs=[_proj("identity", input_size=4, output_size=4), None, None],
        attrs={"operators": [{"type": "dot_mul", "scale": 1.0,
                              "input_indices": (1, 2)}]}),
        lambda: {"in0": _d(3, 4), "in1": _d(3, 4), "in2": _d(3, 4)}),
    "dot_mul_operator_attr": ("mixed", dict(
        size=4, input_sizes=[4, 4],
        attrs={"dot_mul_operator": True, "dotmul_scale": 2.0}),
        lambda: {"in0": _d(3, 4), "in1": _d(3, 4)}),
    "operator_conv": ("mixed", dict(
        size=30, input_sizes=[2 * 4 * 5, 3 * 2 * 2 * 3], with_bias=True,
        attrs={"operators": [_conv_op()]}),
        lambda: {"in0": _d(3, 2 * 4 * 5), "in1": _d(3, 3 * 2 * 2 * 3)}),
    "concat2_slice_context": ("concat2", dict(
        size=2 + 9, input_sizes=[5, 3],
        projs=[_proj("slice", input_size=5, slices=[(1, 3)]),
               _proj("context", input_size=3, context_start=-1,
                     context_length=3)]),
        lambda: {"in0": _seq([3, 2], 5), "in1": _seq([3, 2], 3)}),
}


@pytest.mark.parametrize("case", sorted(EXTRA))
def test_port_case_matches_jax(case):
    ltype, kwargs, feed_fn = EXTRA[case]
    check_parity(build_single_layer_net(ltype, **kwargs), feed_fn())


def test_conv_operator_uses_each_samples_filter():
    """The per-sample filter: swapping two samples' filters swaps their
    outputs and nothing else."""
    _, kwargs, feed_fn = EXTRA["operator_conv"]
    tnet = port_net(build_single_layer_net("mixed", **kwargs))
    params = tnet.init_params(0, "cpu")
    feed = feed_fn()
    swapped = dict(feed, in1=feed["in1"][[1, 0, 2]])
    outs = [tnet.forward(params, torch_feed(f), is_training=False)[0]["test"]
            for f in (feed, swapped)]
    a, b = (o.detach().numpy() for o in outs)
    img = dict(feed, in0=feed["in0"][[1, 0, 2]])
    c = tnet.forward(params, torch_feed(img), is_training=False)[0]["test"]
    np.testing.assert_array_equal(a[2], b[2])
    assert not np.allclose(a[0], b[0])
    # with the images swapped too, rows 0 and 1 are a's, swapped
    both = dict(swapped, in0=img["in0"])
    d = tnet.forward(params, torch_feed(both), is_training=False)[0]["test"]
    np.testing.assert_allclose(d.detach().numpy()[[1, 0, 2]], a, rtol=1e-6,
                               atol=1e-6)
    assert c.shape == (3, 30)


def test_flat_bias_of_an_image_output_matches_jax():
    """A bias of size C*H*W in the reference's CHW order on an NHWC
    output (an inception ``concat`` with a bias)."""
    out = R.randn(2, 3, 4, 5).astype(np.float32)
    bias = R.randn(5 * 3 * 4).astype(np.float32)
    want = jcommon._add_flat_bias(jnp.asarray(out), jnp.asarray(bias))
    got = tcommon._add_flat_bias(torch.from_numpy(out),
                                 torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
