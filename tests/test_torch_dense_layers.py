"""The port's dense layers (``paddle_tpu_torch/layers/common.py``) against
the JAX package's, on the CPU.

Each case is a one-layer net built by the JAX sweep's own function
(``layer_grad_util.build_single_layer_net``), most from its case table
(``test_layer_grad_sweep.CASES``); the net's ``ModelConfig.to_json()``
goes into the port's ``ModelConfig.from_json``, the JAX
``init_params(3)`` (nudged off zero, as ``check_layer_grad`` does) into
the port by name (``network_params_from_jax``), and one numpy feed into
both.  The layer's output and the gradient of the sweep's readout
(``scalar_loss``: the output against a cosine ramp) with respect to
every parameter and every float input must agree.  One case per
projection and operator of ``mixed``, ``mkldnn_fc`` and a bias on
``addto`` / ``concat`` are in ``test_torch_mixed.py``; a type neither
package registers refuses by name.

Tolerance (fp32, different summation orders): every output and
gradient within rtol 1e-5 and atol 1e-6 · max(1, max|ref|).

The closure test holds every layer type the port registers to a parity
case (here, in ``test_torch_mixed.py``, ``test_torch_costs_ops.py``,
``test_torch_layer_sweep.py``, ``test_torch_seq_layers.py``,
``test_torch_sampled_layers.py``, ``test_torch_beam_search.py``,
``test_torch_rnn_types.py``, ``test_torch_crf_ctc.py``,
``test_torch_image_layers.py`` or ``test_torch_detection.py``), an alias
of one, or a stated reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net, scalar_loss
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu_torch.config.model_config import ModelConfig as TModel
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.core.sequence import value_of as tvalue
from paddle_tpu_torch.layers.base import LAYERS as TLAYERS
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

RTOL, ATOL = 1e-5, 1e-6


# ------------------------------------------------------------ helpers
def close(got, want, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


def numpy_feed(feed):
    """A JAX feed (arrays, SequenceBatch) as numpy: an array, or a pair
    (data, lengths) for a sequence."""
    return {k: (np.asarray(v.data), np.asarray(v.length))
            if isinstance(v, JSeq) else np.asarray(v)
            for k, v in feed.items()}


def _floating(v):
    return (v[0] if isinstance(v, tuple) else v).dtype.kind == "f"


def jax_feed(np_feed, datas=None):
    out = {}
    for k, v in np_feed.items():
        d = datas[k] if datas is not None and k in datas else None
        if isinstance(v, tuple):
            out[k] = JSeq(data=jnp.asarray(v[0]) if d is None else d,
                          length=jnp.asarray(v[1]))
        else:
            out[k] = jnp.asarray(v) if d is None else d
    return out


def torch_feed(np_feed, datas=None):
    out = {}
    for k, v in np_feed.items():
        d = datas[k] if datas is not None and k in datas else None
        if isinstance(v, tuple):
            out[k] = TSeq(data=torch.from_numpy(v[0].copy())
                          if d is None else d,
                          length=torch.from_numpy(v[1].copy()))
        else:
            out[k] = torch.from_numpy(v.copy()) if d is None else d
    return out


def torch_scalar_loss(net, params, feed, is_training=False, rng=None):
    """``layer_grad_util.scalar_loss`` in the port: the layer's output
    (masked by its lengths) against a cosine ramp."""
    values, _ = net.forward(params, feed, is_training=is_training, rng=rng)
    val = values["test"]
    out = tvalue(val)
    if isinstance(val, TSeq):
        mask = val.mask(torch.float32)
        out = out * mask.reshape(tuple(mask.shape)
                                 + (1,) * (out.dim() - 2))
    ramp = torch.cos(0.1 * torch.arange(out.numel(), dtype=out.dtype))
    return torch.sum(out * ramp.reshape(out.shape))


def carried_params(jnet, tnet, seed=3):
    """The JAX ``init_params(seed)`` nudged off zero (as
    ``check_layer_grad``), and the same values as the port's params."""
    params = jnet.init_params(seed)
    params = {k: v + 0.01 * jnp.asarray(
        np.random.RandomState(1).randn(*v.shape), jnp.float32)
        for k, v in params.items()}
    return params, network_params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, tnet, "cpu")


def port_net(jnet):
    return TNet(TModel.from_json(jnet.config.to_json()))


def check_parity(jnet, np_feed, objective="readout", jit=False):
    """Forward output of ``test`` and the gradients of the objective
    (``readout``: the sweep's ``scalar_loss``; ``loss``: the network's
    cost) in every parameter and float input, JAX against the port
    (``jit``: the JAX side compiled whole, which is quicker for nets
    with a time loop)."""
    tnet = port_net(jnet)
    jparams, tparams = carried_params(jnet, tnet)
    fnames = [k for k, v in np_feed.items() if _floating(v)]

    def jobj(params, datas):
        feed = jax_feed(np_feed, datas)
        if objective == "loss":
            return jnet.loss(params, feed, {}, is_training=False)[0]
        return scalar_loss(jnet, params, feed)

    jdatas = {k: jax_feed(np_feed)[k] for k in fnames}
    jdatas = {k: v.data if isinstance(v, JSeq) else v
              for k, v in jdatas.items()}
    value_and_grad = jax.value_and_grad(jobj, argnums=(0, 1))
    if jit:
        value_and_grad = jax.jit(value_and_grad)
    jval, (jgp, jgd) = value_and_grad(jparams, jdatas)

    tp = {k: v.requires_grad_(True) for k, v in tparams.items()}
    tdatas = {k: torch.from_numpy(np.array(
        np_feed[k][0] if isinstance(np_feed[k], tuple) else np_feed[k]))
        .requires_grad_(True) for k in fnames}
    feed = torch_feed(np_feed, tdatas)
    if objective == "loss":
        tval = tnet.loss(tp, feed, is_training=False)[0]
    else:
        tval = torch_scalar_loss(tnet, tp, feed)
    leaves = [*tp.values(), *tdatas.values()]
    grads = torch.autograd.grad(tval, leaves, allow_unused=True)
    close(float(tval.detach()), float(jval), "objective")
    got = dict(zip([*tp, *[f"feed:{k}" for k in tdatas]], grads))
    want = {**{k: v for k, v in jgp.items()},
            **{f"feed:{k}": v for k, v in jgd.items()}}
    assert set(got) == set(want)
    for name, g in want.items():
        t = got[name]
        close(np.zeros_like(np.asarray(g)) if t is None else t.numpy(), g,
              f"gradient of {name}")

    # the forward value itself
    def jforward(params, feed):
        return jnet.forward(params, feed, is_training=False)[0]["test"]
    want_out = (jax.jit(jforward) if jit else jforward)(jparams,
                                                        jax_feed(np_feed))
    with torch.no_grad():
        tv, _ = tnet.forward(tparams, torch_feed(np_feed), is_training=False)
    got_out = tv["test"]
    assert isinstance(got_out, TSeq) == isinstance(want_out, JSeq)
    if isinstance(want_out, JSeq):
        np.testing.assert_array_equal(got_out.length.numpy(),
                                      np.asarray(want_out.length))
    close(tvalue(got_out).numpy(), np.asarray(
        want_out.data if isinstance(want_out, JSeq) else want_out),
        "output")
    return tnet


# --------------------------------------------------- the sweep's cases
#: the dense types of ``common.py`` that the sweep's table holds
SWEEP_TYPES = ["mixed", "concat2", "interpolation", "out_prod", "power",
               "scaling", "slope_intercept", "convex_comb", "cos", "cos_vm",
               "sum_to_one_norm", "row_l2_norm", "trans", "resize", "clip",
               "multiplex", "dot_prod", "featmap_expand", "conv_shift",
               "fc", "addto", "concat"]


@pytest.mark.parametrize("name", SWEEP_TYPES)
def test_sweep_case_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    check_parity(build_single_layer_net(name, **kwargs),
                 numpy_feed(feed_fn()))


# ---------------------------------------------------------- closure
#: a registered type with no parity case, and why
NO_CASE = {"data": "fed, not computed (DataLayer raises)",
           "beam_gen": "exposes a generating group's bundle: whole decodes "
                       "in test_torch_beam_search.py"}


def test_every_registered_type_has_a_parity_case():
    import test_torch_costs_ops as costs
    import test_torch_crf_ctc as crf
    import test_torch_detection as detection
    import test_torch_image_layers as image
    import test_torch_layer_sweep as earlier
    import test_torch_mixed as mixed
    import test_torch_rnn_types as rnn
    import test_torch_sampled_layers as sampled
    import test_torch_seq_layers as seq
    covered = set(SWEEP_TYPES) | {t for t, _, _ in mixed.EXTRA.values()} \
        | set(costs.COST_TYPES) | set(earlier.EARLIER_TYPES) | set(NO_CASE) \
        | set(seq.SEQ_TYPES) | set(sampled.SAMPLED_TYPES) \
        | set(rnn.RNN_TYPES) | set(crf.COST_SEQ_TYPES) \
        | set(image.IMAGE_TYPES) | set(image.ALIASES) \
        | set(detection.DETECTION_TYPES)
    missing = []
    for name, cls in TLAYERS.items():
        if name in covered or cls.layer_type in covered:
            continue        # the type, or an alias of a covered class
        missing.append(name)
    assert missing == []
    assert {"mse", "regression_cost", "mkldnn_fc", "grumemory",
            "cudnn_conv", "conv", "cudnn_batch_norm",
            "multi_head_attention"} <= set(TLAYERS)
    # the reference's 110 names, all ported (test_torch_dsl)
    assert len(TLAYERS) == 110


@pytest.mark.parametrize("name", [
    "norm", "maxout", "spp", "blockexpand", "pad", "crop", "rotate",
    "switch_order", "bilinear_interp", "cross-channel-norm", "pool3d",
    "priorbox", "multibox_loss"])
def test_unported_types_refuse_by_name(name):
    """These types were refused until the image, 3-D and detection slice
    ported them: each now builds as the JAX package's type, and a type
    neither package registers still refuses by name."""
    from paddle_tpu.layers import LAYERS as JLAYERS
    from paddle_tpu_torch.config.model_config import (LayerConfig,
                                                      LayerInput)
    from paddle_tpu_torch.layers.base import get_layer_class
    from paddle_tpu_torch.utils import PaddleTpuError
    assert name in JLAYERS
    assert get_layer_class(name).layer_type == name
    unknown = name + "_unknown"
    cfg = TModel(layers=[
        LayerConfig(name="x", type="data", size=4),
        LayerConfig(name="test", type=unknown, size=1,
                    inputs=[LayerInput(input_layer_name="x")])],
        input_layer_names=["x"], output_layer_names=["test"])
    with pytest.raises(PaddleTpuError, match=f"layer type '{unknown}' is "
                                             "not ported"):
        TNet(cfg)
