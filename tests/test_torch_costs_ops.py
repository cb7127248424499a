"""The port's cost layers and activations against the JAX package's, on
the CPU.

- The ten dense cost classes (twelve names): the JAX sweep's case of
  each (``test_layer_grad_sweep.CASES``), with a per-example weight (a
  third input) and ``coeff`` where the JAX layer takes them, and on
  sequence inputs where it flattens them; the network's loss and its
  gradient in every float input must agree
  (``test_torch_dense_layers.check_parity``).
- All 28 activations under their names and aliases, forward and
  backward (the gradient of the output against a random cotangent).

The math and loss ops are in ``test_torch_math_loss_ops.py``.

Tolerance (fp32): rtol 1e-5, atol 1e-6 · max(1, max|ref|), as the dense
layers'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net
from paddle_tpu.ops import activations as jact
from paddle_tpu_torch.ops import activations as tact
from paddle_tpu_torch.utils import PaddleTpuError
from test_torch_dense_layers import check_parity, close, numpy_feed

R = np.random.RandomState(99)


def _u(*shape, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def _seq(lens, d, fn=None):
    t = max(lens)
    data = np.zeros((len(lens), t, d), np.float32)
    for i, n in enumerate(lens):
        data[i, :n] = fn(n, d) if fn else R.randn(n, d)
    return data, np.array(lens, np.int32)


def _probs(*shape):
    z = R.randn(*shape).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# ------------------------------------------------------------ costs
COST_TYPES = ["multi-class-cross-entropy",
              "multi_class_cross_entropy_with_selfnorm",
              "soft_binary_class_cross_entropy", "square_error", "mse",
              "regression_cost", "rank-cost", "lambda_cost",
              "multi_binary_label_cross_entropy", "huber_regression",
              "huber_classification", "smooth_l1", "sum_cost"]
#: the JAX layers that take a weight input (``_CostBase.weighted``)
WEIGHTED = ["multi-class-cross-entropy",
            "multi_class_cross_entropy_with_selfnorm",
            "soft_binary_class_cross_entropy", "square_error",
            "multi_binary_label_cross_entropy", "huber_regression",
            "huber_classification", "smooth_l1"]


@pytest.mark.parametrize("name", sorted(set(COST_TYPES)
                                        - {"mse", "regression_cost"}))
def test_cost_sweep_case_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    check_parity(build_single_layer_net(name, **kwargs),
                 numpy_feed(feed_fn()), objective="loss")


@pytest.mark.parametrize("name", WEIGHTED)
def test_cost_with_weight_and_coeff_matches_jax(name):
    kwargs, feed_fn, _ = sweep.CASES[name]
    feed = numpy_feed(feed_fn())
    b = feed["in0"].shape[0]
    feed["in2"] = R.uniform(0.2, 2.0, (b, 1)).astype(np.float32)
    kwargs = dict(kwargs, input_sizes=list(kwargs["input_sizes"]) + [1],
                  attrs={**kwargs.get("attrs", {}), "coeff": 0.7})
    check_parity(build_single_layer_net(name, **kwargs), feed,
                 objective="loss")


@pytest.mark.parametrize("name", ["mse", "regression_cost"])
def test_cost_aliases_match_jax(name):
    kwargs, feed_fn, _ = sweep.CASES["square_error"]
    kwargs = dict(kwargs, attrs={"coeff": 2.5})
    check_parity(build_single_layer_net(name, **kwargs),
                 numpy_feed(feed_fn()), objective="loss")


def test_rank_cost_coeff_matches_jax():
    kwargs, feed_fn, _ = sweep.CASES["rank-cost"]
    check_parity(build_single_layer_net(
        "rank-cost", **dict(kwargs, attrs={"coeff": 0.3})),
        numpy_feed(feed_fn()), objective="loss")


def _seq_ce_feed(weighted):
    lens = [4, 2, 3]
    feed = {"in0": _seq(lens, 5, lambda n, d: _probs(n, d)),
            "in1": _seq(lens, 1, lambda n, d: R.randint(0, 5, (n, d)))}
    feed["in1"] = (feed["in1"][0][..., 0].astype(np.int32), feed["in1"][1])
    if weighted:
        feed["in2"] = _seq(lens, 1, lambda n, d: R.uniform(0.5, 1.5, (n, d)))
    return feed


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["multi-class-cross-entropy",
                                  "multi_class_cross_entropy_with_selfnorm"])
def test_sequence_ce_costs_match_jax(name, weighted):
    """Per-token CE of a sequence of predictions, padded steps masked,
    optionally weighted by a sequence of per-token weights."""
    sizes = [5, 1] + ([1] if weighted else [])
    check_parity(build_single_layer_net(
        name, size=1, input_sizes=sizes,
        input_types=["seq"] * len(sizes), attrs={"coeff": 1.5}),
        _seq_ce_feed(weighted), objective="loss")


@pytest.mark.parametrize("name", ["square_error",
                                  "multi_binary_label_cross_entropy",
                                  "smooth_l1"])
def test_sequence_regression_costs_match_jax(name):
    lens = [3, 1, 2]
    lab = (lambda n, d: (R.rand(n, d) > 0.5)) \
        if name == "multi_binary_label_cross_entropy" else None
    pred = (lambda n, d: R.uniform(0.2, 0.8, (n, d))) \
        if name == "multi_binary_label_cross_entropy" else None
    feed = {"in0": _seq(lens, 4, pred), "in1": _seq(lens, 4, lab)}
    check_parity(build_single_layer_net(
        name, size=1, input_sizes=[4, 4], input_types=["seq", "seq"]),
        feed, objective="loss")


# ------------------------------------------------------ activations
#: input range per activation: positive where the function needs it
POSITIVE = {"sqrt", "log", "reciprocal", "pow"}


def _act_input(name):
    if name in POSITIVE:
        return R.uniform(0.3, 2.0, (4, 7)).astype(np.float32)
    # away from the kinks (0, ±0.5, ±1, 6, the brelu / soft_relu clips)
    x = R.uniform(-8.0, 8.0, (4, 7)).astype(np.float32)
    kinks = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 6.0, -2.5, 2.5])
    near = np.abs(x[..., None] - kinks).min(-1) < 0.05
    return np.where(near, x + 0.1, x).astype(np.float32)


def _vjp_parity(jfn, tfn, args, cot_seed=0):
    """Forward values and the gradient of sum(out · cotangent) in every
    float numpy argument, JAX against the port; other arguments pass as
    they are (numpy int arrays as tensors)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a
             for a in args]
    fidx = [i for i, a in enumerate(args)
            if isinstance(a, np.ndarray) and a.dtype.kind == "f"]
    for i in fidx:
        targs[i].requires_grad_(True)
    want = jfn(*jargs)
    got = tfn(*targs)
    wants = list(want) if isinstance(want, (tuple, list)) else [want]
    gots = list(got) if isinstance(got, (tuple, list)) else [got]
    assert len(gots) == len(wants)
    for g, w in zip(gots, wants):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype.kind == "f":
            close(g.detach().numpy(), w, "output")
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    out = wants[0]
    if not fidx or np.asarray(out).dtype.kind != "f":
        return
    cot = np.asarray(np.random.RandomState(cot_seed).randn(
        *np.shape(out)), np.float32)

    def jscalar(*fargs):
        a = list(jargs)
        for i, v in zip(fidx, fargs):
            a[i] = v
        o = jfn(*a)
        o = o[0] if isinstance(o, (tuple, list)) else o
        return jnp.sum(o * cot)

    jgrads = jax.grad(jscalar, argnums=tuple(range(len(fidx))))(
        *[jargs[i] for i in fidx])
    tout = gots[0]
    if not tout.requires_grad:      # a constant of its inputs' shape
        tgrads = [None] * len(fidx)
    else:
        tgrads = torch.autograd.grad(
            torch.sum(tout * torch.from_numpy(cot)),
            [targs[i] for i in fidx], allow_unused=True)
    for i, jg, tg in zip(fidx, jgrads, tgrads):
        tg = np.zeros(np.shape(jg), np.float32) if tg is None else tg.numpy()
        close(tg, jg, f"gradient of argument {i}")


ACT_NAMES = sorted(set(jact.ACTIVATIONS._entries)
                   | set(jact.ACTIVATIONS._aliases))


@pytest.mark.parametrize("name", ACT_NAMES)
def test_activation_matches_jax(name):
    x = _act_input(name)
    _vjp_parity(jact.get_activation(name), tact.get_activation(name), [x])


def test_activation_names_and_defaults_match_jax():
    assert sorted(tact.ACTIVATIONS.names()) == sorted(
        jact.ACTIVATIONS._entries)
    assert len(tact.ACTIVATIONS.names()) == 28
    assert tact.ACTIVATIONS._aliases == jact.ACTIVATIONS._aliases
    import inspect
    for name in tact.ACTIVATIONS.names():
        jsig = inspect.signature(jact.ACTIVATIONS.get(name))
        tsig = inspect.signature(tact.ACTIVATIONS.get(name))
        assert [(p.name, p.default) for p in tsig.parameters.values()] == \
            [(p.name, p.default) for p in jsig.parameters.values()], name
    with pytest.raises(PaddleTpuError, match="'no_such_act'"):
        tact.get_activation("no_such_act")


@pytest.mark.parametrize("name, kw", [
    ("brelu", dict(t_min=-1.0, t_max=2.0)), ("stanh", dict(scale_a=0.5,
                                                            scale_b=2.0)),
    ("soft_relu", dict(threshold=3.0)), ("pow", dict(factor=2.5)),
    ("leaky_relu", dict(alpha=0.1)), ("elu", dict(alpha=0.7)),
    ("relu6", dict(threshold=3.0)), ("hard_shrink", dict(threshold=0.9)),
    ("softshrink", dict(lambda_=0.7)), ("thresholded_relu",
                                        dict(threshold=0.3)),
    ("hard_sigmoid", dict(slope=0.3, offset=0.4)), ("swish", dict(beta=2.0))])
def test_activation_arguments_match_jax(name, kw):
    x = _act_input("pow" if name == "pow" else name)
    _vjp_parity(lambda v: jact.get_activation(name)(v, **kw),
                lambda v: tact.get_activation(name)(v, **kw), [x])


def test_sequence_softmax_with_mask_matches_jax():
    x = R.randn(3, 5, 1).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5, [1, 0, 0, 0, 0]], np.float32)
    _vjp_parity(lambda v, m: jact.sequence_softmax(v, mask=m),
                lambda v, m: tact.sequence_softmax(v, mask=m), [x, mask])
