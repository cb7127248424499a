"""The port's dense types that own parameters or sample (``tensor``,
``selective_fc``, ``prelu``, ``scale_shift``, ``data_norm``,
``hsigmoid``, ``nce``, ``print``; ``paddle_tpu_torch/layers/common.py``),
the ops behind them and ``sampling_id`` (``ops/embedding_ops.py``), and
``core/dtypes.py``'s naming, counting and stamp helpers, against the
JAX package's, on the CPU.

Layers run the JAX sweep's case (``test_layer_grad_sweep.CASES``)
through ``test_torch_dense_layers.check_parity``: output and readout
gradients within rtol 1e-5, atol 1e-6 · max(1, max|ref|).  ``nce`` and
``sampling_id`` draw from the layer's own generator, so ``nce`` is held
to JAX's ``nce_loss`` on the port's draws (same tolerance), and
``sampling_id`` exactly on one-hot rows and by its frequencies
otherwise (within 5σ of p over 2^14 draws a row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net
from paddle_tpu.core import dtypes as jdt
from paddle_tpu.ops import embedding_ops as jemb
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch.core import dtypes as tdt
from paddle_tpu_torch.layers.base import ForwardContext
from paddle_tpu_torch.ops import embedding_ops as temb
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.utils import FLAGS as TFLAGS
from test_torch_dense_layers import (carried_params, check_parity, close,
                                     numpy_feed, port_net, torch_feed)

#: the sweep's cases held by check_parity
PARITY_TYPES = ["tensor", "selective_fc", "prelu", "scale_shift",
                "data_norm", "hsigmoid"]
#: every type this file holds (the closure test reads it)
SAMPLED_TYPES = PARITY_TYPES + ["nce", "print", "sampling_id"]
FLAG_NAMES = ("use_bf16", "bf16_activations", "precision")


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = [(f, {k: f.get(k) for k in FLAG_NAMES})
             for f in (JFLAGS, TFLAGS)]
    yield
    for f, values in saved:
        for k, v in values.items():
            f.set(k, v)


@pytest.mark.parametrize("name", PARITY_TYPES)
def test_sweep_case_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    check_parity(build_single_layer_net(name, **kwargs),
                 numpy_feed(feed_fn()))


def _x(b, d, seed):
    return np.random.RandomState(seed).uniform(-1, 1, (b, d)).astype(
        np.float32)


@pytest.mark.parametrize("strategy,attrs", [
    ("z-score", {"mean": [0.5, -1.0, 0.0, 2.0], "std": [2.0, 1.0, 0.5, 3]}),
    ("min-max", {"min": -1.0, "max": 3.0}),
    ("decimal-scaling", {"a": 10.0})])
def test_data_norm_strategies_match_jax(strategy, attrs):
    net = build_single_layer_net(
        "data_norm", size=4, input_sizes=[4],
        attrs=dict(attrs, data_norm_strategy=strategy))
    check_parity(net, {"in0": _x(3, 4, 1)})


@pytest.mark.parametrize("extra", [
    dict(active_type="tanh"), dict(with_bias=False, active_type="softmax")])
def test_selective_fc_with_select_ids_matches_jax(extra):
    """With the second input the op computes only the selected columns
    (the activation inside the op, as in JAX)."""
    kw = dict(size=6, input_sizes=[4, 2], with_bias=True)
    kw.update(extra)
    net = build_single_layer_net("selective_fc", **kw)
    check_parity(net, {"in0": _x(3, 4, 2),
                       "in1": np.asarray([[0, 5], [2, 2], [4, 1]],
                                         np.int32)})


def test_prelu_partial_sum_and_tensor_bias_free_match_jax():
    check_parity(build_single_layer_net(
        "prelu", size=6, input_sizes=[6], attrs={"partial_sum": 2}),
        {"in0": _x(4, 6, 3)})
    check_parity(build_single_layer_net(
        "tensor", size=2, input_sizes=[3, 5], active_type="sigmoid"),
        {"in0": _x(2, 3, 4), "in1": _x(2, 5, 5)})


@pytest.mark.parametrize("num_classes", [13])
def test_hsigmoid_matches_jax(num_classes):
    """The bit-code tree at a class count that is not a power of two
    (the sweep's case has 8)."""
    net = build_single_layer_net(
        "hsigmoid", size=1, input_sizes=[4, 1],
        attrs={"num_classes": num_classes}, with_bias=True)
    labels = np.arange(num_classes, dtype=np.int32) % num_classes
    check_parity(net, {"in0": _x(num_classes, 4, num_classes),
                       "in1": labels})
    for depth in (3, 4):
        for j, t in zip(jemb._bit_codes(jnp.asarray(labels), num_classes,
                                        depth),
                        temb._bit_codes(torch.from_numpy(labels),
                                        num_classes, depth)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_nce_matches_jax_on_the_ports_draws():
    """The layer's negatives are the port's (its own generator); JAX's
    ``nce_loss`` on those ids gives the same cost and gradients."""
    kwargs, feed_fn, _ = sweep.CASES["nce"]
    jnet = build_single_layer_net("nce", **kwargs)
    feed = numpy_feed(feed_fn())
    tnet = port_net(jnet)
    jparams, tparams = carried_params(jnet, tnet)
    tp = {k: v.requires_grad_(True) for k, v in tparams.items()}
    x = torch.from_numpy(feed["in0"].copy()).requires_grad_(True)
    out = tnet.forward(tp, {"in0": x, "in1": torch.from_numpy(
        feed["in1"].copy())}, is_training=True)[0]["test"]
    # the same generator the layer drew from (no call generator: seed 0)
    ids = torch.randint(0, 7, (3, 3), generator=ForwardContext().layer_rng(
        "test", "cpu"))
    cot = np.random.RandomState(0).randn(3, 1).astype(np.float32)

    def jcost(w, b, xx):
        return jemb.nce_loss(xx, jnp.asarray(feed["in1"]), w, b,
                             jnp.asarray(ids.numpy()),
                             jnp.full((3, 3), 1 / 7.0)).reshape(-1, 1)
    args = (jparams["_test.w0"], jparams["_test.wbias"],
            jnp.asarray(feed["in0"]))
    want = jcost(*args)
    close(out.detach().numpy(), np.asarray(want), "cost")
    jg = jax.grad(lambda *a: jnp.sum(jcost(*a) * cot), argnums=(0, 1, 2))(
        *args)
    tg = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)),
                             [tp["_test.w0"], tp["_test.wbias"], x])
    for g, w, what in zip(tg, jg, ("w", "bias", "x")):
        close(g.numpy(), np.asarray(w), "gradient of " + what)
    # the draws depend on the call's seed and the layer's name only
    again = tnet.forward(tparams, torch_feed(feed), is_training=True)[0]
    close(again["test"].detach().numpy(), out.detach().numpy(), "redraw")


def test_sampling_id_exact_on_one_hot_and_by_frequency():
    gen = torch.Generator().manual_seed(3)
    onehot = np.eye(5, dtype=np.float32)[[3, 0, 4, 1, 1, 2]]
    got = temb.sampling_id(gen, torch.from_numpy(onehot))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), [3, 0, 4, 1, 1, 2])
    jgot = jemb.sampling_id(jax.random.PRNGKey(0), jnp.asarray(onehot))
    np.testing.assert_array_equal(np.asarray(jgot), [3, 0, 4, 1, 1, 2])
    p = np.array([0.05, 0.4, 0.0, 0.25, 0.3], np.float32)
    n = 2 ** 14
    draws = temb.sampling_id(gen, torch.from_numpy(np.tile(p, (n, 1))))
    freq = np.bincount(draws.numpy(), minlength=5) / n
    sigma = np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= 5 * sigma + 1e-12).all(), (freq, p)
    assert freq[2] == 0
    # the layer draws from its own generator: one-hot rows give the ids
    kwargs, _, _ = sweep.CASES["sampling_id"]
    tnet = port_net(build_single_layer_net("sampling_id", **kwargs))
    out = tnet.forward({}, {"in0": torch.from_numpy(onehot[:, :5])},
                       is_training=False)[0]["test"]
    np.testing.assert_array_equal(out.numpy(), [3, 0, 4, 1, 1, 2])


def test_print_writes_name_and_value_and_passes_through(capsys):
    net = build_single_layer_net("print", size=3, input_sizes=[3])
    tnet = port_net(net)
    x = np.array([[1.0, 2.5, -3.0], [0.0, 4.0, 5.0]], np.float32)
    out = tnet.forward({}, {"in0": torch.from_numpy(x)},
                       is_training=False)[0]["test"]
    np.testing.assert_array_equal(out.numpy(), x)
    assert capsys.readouterr().out == f"test: {x}\n"


def test_embedding_ops_are_registered_under_the_jax_names():
    def names(registry):
        ents = {n for n, d in registry._entries.items()
                if d.fn.__module__.rsplit(".", 1)[-1] == "embedding_ops"}
        return ents, {a: n for a, n in registry._aliases.items()
                      if n in ents}
    assert names(TOPS) == names(JOPS)


# ------------------------------------------------------- core/dtypes
def test_dtype_names_and_np_dtype_match_jax():
    for name in ("float32", "float64", "float16", "int8", "int16", "int32",
                 "int64", "uint8", "bool"):
        assert tdt.np_dtype(name) == jdt.np_dtype(name)
        assert tdt.dtype_name(name) == jdt.dtype_name(name) == name
        assert tdt.dtype_name(tdt.np_dtype(name)) == name
    assert tdt.dtype_name(torch.bfloat16) == jdt.dtype_name(jnp.bfloat16) \
        == "bfloat16"
    assert tdt.dtype_name(torch.float32) == "float32"
    assert tdt.dtype_name(torch.int32) == "int32"
    assert tdt.np_dtype(torch.int64) == np.dtype(np.int64)
    with pytest.raises(TypeError, match="bfloat16"):
        tdt.np_dtype("bfloat16")
    with pytest.raises(TypeError, match="bfloat16"):
        tdt.np_dtype(torch.bfloat16)


@pytest.mark.parametrize("flags", [
    dict(precision="fp32", use_bf16=False, bf16_activations=False),
    dict(precision="fp32", use_bf16=True, bf16_activations=True),
    dict(precision="bf16", use_bf16=False, bf16_activations=False),
    dict(precision="bf16", use_bf16=False, bf16_activations=True)])
def test_dispatch_dtypes_match_jax(flags):
    for f in (JFLAGS, TFLAGS):
        for k, v in flags.items():
            f.set(k, v)
    assert tdt.dispatch_dtypes() == jdt.dispatch_dtypes()


def _jax_counts():
    from paddle_tpu import observe
    c = observe.counter("precision_dispatch_total")
    return {(s["labels"]["op"], s["labels"]["dtype"]): s["value"]
            for s in c.samples()}


@pytest.mark.parametrize("bf16", [False, True])
def test_precision_counter_ticks_the_jax_keys(bf16):
    """One forward of a net with an embedding, an fc, a tensor layer and
    a GRU: the port ticks the (op, dtype) keys the JAX package ticks
    (the JAX counter ticks once per trace, the port's once per call)."""
    from paddle_tpu.config import dsl as jdsl
    from paddle_tpu.data.feeder import integer_value_sequence as jivs
    from paddle_tpu.layers.network import NeuralNetwork as JNet
    from paddle_tpu.core.sequence import pad_batch
    from paddle_tpu_torch.config.model_config import ModelConfig as TModel
    from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
    from paddle_tpu_torch.utils.jax_interop import network_params_from_jax
    for f in (JFLAGS, TFLAGS):
        f.set("use_bf16", bf16)
        f.set("bf16_activations", False)
        f.set("precision", "fp32")
    with jdsl.config_scope():
        w = jdsl.data("w", jivs(20))
        e = jdsl.embedding(w, size=6, vocab_size=20, name="emb")
        g = jdsl.grumemory(jdsl.fc(e, size=12, name="proj"), size=4,
                           name="gru")
        last = jdsl.last_seq(g, name="last")
        t = jdsl.tensor_layer(last, last, size=2, name="ten")
        cfg = jdsl.topology(t)
    jnet = JNet(cfg)
    tnet = TNet(TModel.from_json(cfg.to_json()))
    jp = jnet.init_params(0)
    tp = network_params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                 tnet, "cpu")
    ids = [np.random.RandomState(i).randint(0, 20, (n,))
           for i, n in enumerate((4, 6))]
    before = _jax_counts()
    jnet.forward(jp, {"w": pad_batch(ids)}, is_training=False)
    after = _jax_counts()
    jkeys = {k for k, v in after.items() if v > before.get(k, 0)}
    tdt.precision_dispatch_total.clear()
    with torch.no_grad():
        tnet.forward(tp, torch_feed(numpy_feed({"w": pad_batch(ids)})),
                     is_training=False)
    dt = "bfloat16" if bf16 else "float32"
    assert set(tdt.precision_dispatch_total) == jkeys
    assert jkeys >= {("lookup_table", dt), ("matmul", dt), ("gru", dt),
                     ("einsum", dt)}
