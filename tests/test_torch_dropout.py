"""Dropout and error clipping in the port (``Layer.finalize`` /
``apply_extras``, ``nn_ops.dropout``, ``ForwardContext.layer_rng``)
against the JAX package, on the CPU.

The JAX package draws its masks from a key folded with Python's salted
``hash`` of the layer's name, so they differ from process to process
and the port does not reproduce them: dropout is held to JAX's formula
(``jnp.where(mask, x / keep, 0)``, identity in eval) on the port's own
mask, read back from the port's generator.  The error clip has no
randomness and is held to the JAX ``_clip_error`` through whole nets.
``lstmemory`` and ``grumemory`` return without ``finalize`` in both
packages, so a ``drop_rate`` on them changes nothing.  The
classification cost's logits peephole follows the JAX conditions: no
``.logits`` route past dropout or an error clip.

Tolerance: dropout's values and gradients exact (the same fp32
division); through nets rtol 1e-5, atol 1e-6 · max(1, max|ref|).
"""

import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_layer_grad_sweep as sweep
from layer_grad_util import build_single_layer_net, scalar_loss
from paddle_tpu.config.model_config import LayerConfig as JLayer
from paddle_tpu.config.model_config import LayerInput as JInput
from paddle_tpu.config.model_config import ModelConfig as JModel
from paddle_tpu.layers.base import _clip_error
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.core.sequence import value_of as tvalue
from paddle_tpu_torch.layers.base import ForwardContext
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from test_torch_dense_layers import (carried_params, check_parity, close,
                                     jax_feed, numpy_feed, port_net,
                                     torch_feed, torch_scalar_loss)

R = np.random.RandomState(5)


def _with(jnet, **conf):
    """The JAX net rebuilt with ``conf`` set on its layer ``test``."""
    cfg = JModel.from_json(jnet.config.to_json())
    for k, v in conf.items():
        setattr(cfg.layer_map()["test"], k, v)
    return JNet(cfg)


def _port_mask(seed, name, shape, keep):
    """The mask the port draws for layer ``name`` in a call seeded
    ``seed`` (its own generator, as ``Layer.apply_dropout``)."""
    gen = ForwardContext(rng=torch.Generator().manual_seed(seed)) \
        .layer_rng(name + "/drop", "cpu")
    return (torch.rand(shape, generator=gen) < keep).numpy()


# ------------------------------------------------------------ the op
@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_dropout_op_is_the_jax_formula_on_its_mask(rate):
    x = R.randn(64, 33).astype(np.float32)
    cot = R.randn(64, 33).astype(np.float32)
    keep = 1.0 - rate
    xt = torch.from_numpy(x).requires_grad_(True)
    out = nn_ops.dropout(xt, torch.Generator().manual_seed(3), rate)
    mask = torch.rand(x.shape, generator=torch.Generator().manual_seed(3)) \
        < keep
    mask = mask.numpy()

    def jdrop(v):
        return jnp.where(mask, v / keep, 0.0).astype(v.dtype)

    want, vjp = jax.vjp(jdrop, jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    g, = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), [xt])
    np.testing.assert_array_equal(g.numpy(),
                                  np.asarray(vjp(jnp.asarray(cot))[0]))
    assert 0 < mask.mean() < 1


def test_dropout_is_the_identity_in_eval_and_at_rate_0():
    x = torch.from_numpy(R.randn(8, 5).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    assert nn_ops.dropout(x, gen, 0.5, is_training=False) is x
    assert nn_ops.dropout(x, gen, 0.0) is x


def test_layer_rng_is_stable_across_processes_and_names():
    """The CRC-32 of the name (not Python's salted ``hash``): another
    process with another hash seed draws the same mask."""
    here = _port_mask(11, "fc1", (4, 6), 0.5)
    code = ("import torch; from paddle_tpu_torch.layers.base import "
            "ForwardContext as F; g = F(rng=torch.Generator().manual_seed("
            "11)).layer_rng('fc1/drop', 'cpu'); print((torch.rand((4, 6), "
            "generator=g) < 0.5).int().flatten().tolist())")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONHASHSEED": "12345",
                              "PATH": "/usr/bin:/bin"},
                         cwd=str(__import__("pathlib").Path(
                             __file__).parent.parent))
    assert eval(out.stdout.strip()) == here.astype(int).flatten().tolist()
    gen = ForwardContext(rng=torch.Generator().manual_seed(11)) \
        .layer_rng("fc1/drop")
    assert gen.initial_seed() == (11 * 1000003 + zlib.crc32(b"fc1/drop")) \
        % 2 ** 63
    assert not np.array_equal(here, _port_mask(11, "fc2", (4, 6), 0.5))
    assert not np.array_equal(here, _port_mask(12, "fc1", (4, 6), 0.5))
    # no call generator: seed 0, as JAX's PRNGKey(0)
    assert ForwardContext().layer_rng("fc1").initial_seed() == \
        zlib.crc32(b"fc1")


# ---------------------------------------------------- through a layer
def _fc_net(**conf):
    kwargs, _, _ = sweep.CASES["fc"]
    return _with(build_single_layer_net("fc", **kwargs), **conf)


def test_fc_dropout_matches_jax_on_the_ports_mask():
    """fc (tanh, bias) at drop_rate 0.4 in training: the port's output and
    gradients equal JAX's eval output under ``where(mask, y / 0.6, 0)``
    with the port's mask."""
    jnet = _fc_net(drop_rate=0.4)
    feed = {"in0": R.uniform(-1, 1, (6, 4)).astype(np.float32)}
    tnet = port_net(jnet)
    jparams, tparams = carried_params(jnet, tnet)
    mask = _port_mask(21, "test", (6, 5), 0.6)

    def jobj(params, x):
        v, _ = jnet.forward(params, {"in0": x}, is_training=False)
        y = jnp.where(mask, v["test"] / 0.6, 0.0)
        return jnp.sum(y * jnp.cos(0.1 * jnp.arange(y.size).reshape(y.shape)))

    want, (jgp, jgx) = jax.value_and_grad(jobj, argnums=(0, 1))(
        jparams, jnp.asarray(feed["in0"]))
    tp = {k: v.requires_grad_(True) for k, v in tparams.items()}
    x = torch.from_numpy(feed["in0"]).requires_grad_(True)
    values, _ = tnet.forward(tp, {"in0": x}, is_training=True,
                             rng=torch.Generator().manual_seed(21))
    y = values["test"]
    got = torch.sum(y * torch.cos(0.1 * torch.arange(y.numel())
                                  .reshape(y.shape)))
    grads = torch.autograd.grad(got, [*tp.values(), x])
    close(float(got.detach()), float(want), "objective")
    for g, (name, w) in zip(grads, [*jgp.items(), ("in0", jgx)]):
        close(g.numpy(), w, name)
    np.testing.assert_array_equal(y.detach().numpy() == 0, ~mask)
    # in eval the same layer is JAX's, dropout or not
    check_parity(jnet, feed)


def test_error_clipping_matches_jax():
    """fc with error_clipping_threshold 0.05: the readout's gradient
    reaches the layer clipped, as the JAX ``_clip_error`` does."""
    jnet = _fc_net(error_clipping_threshold=0.05)
    check_parity(jnet, {"in0": R.uniform(-1, 1, (3, 4)).astype(np.float32)})
    # the clip bites: without it the gradients differ
    tnet = port_net(jnet)
    _, tparams = carried_params(jnet, tnet)
    plain = port_net(_fc_net())
    feed = torch_feed({"in0": R.uniform(-1, 1, (3, 4)).astype(np.float32)})
    gs = []
    for net in (tnet, plain):
        p = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
        gs.append(torch.autograd.grad(torch_scalar_loss(net, p, feed),
                                      list(p.values())))
    assert not all(torch.allclose(a, b) for a, b in zip(*gs))


def test_clip_error_gradient_matches_jax_clip_error():
    from paddle_tpu_torch.layers.base import _ClipError
    x = R.randn(5, 7).astype(np.float32)
    cot = 3.0 * R.randn(5, 7).astype(np.float32)
    _, vjp = jax.vjp(lambda v: _clip_error(v, 0.7), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = _ClipError.apply(xt, 0.7)
    g, = torch.autograd.grad(torch.sum(y * torch.from_numpy(cot)), [xt])
    np.testing.assert_array_equal(y.detach().numpy(), x)
    np.testing.assert_array_equal(g.numpy(),
                                  np.asarray(vjp(jnp.asarray(cot))[0]))
    assert float(g.abs().max()) == pytest.approx(0.7)


def test_gru_step_takes_the_error_clip_like_jax():
    """``gru_step`` applies dropout and the clip without an activation
    (``apply_extras``), as the JAX layer."""
    kwargs, feed_fn, _ = sweep.CASES["gru_step"]
    jnet = _with(build_single_layer_net("gru_step", **kwargs),
                 error_clipping_threshold=0.02)
    check_parity(jnet, numpy_feed(feed_fn()))


@pytest.mark.parametrize("ltype", ["lstmemory", "gated_recurrent"])
def test_recurrent_layers_ignore_drop_rate_like_jax(ltype):
    """``lstmemory`` / ``grumemory`` return without ``finalize`` in the
    JAX package, so their ``drop_rate`` does nothing there; the port
    follows: the training output equals JAX's."""
    kwargs, feed_fn, _ = sweep.CASES[ltype]
    jnet = _with(build_single_layer_net(ltype, **kwargs), drop_rate=0.5,
                 error_clipping_threshold=1e-4)
    feed = numpy_feed(feed_fn())
    tnet = port_net(jnet)
    jparams, tparams = carried_params(jnet, tnet)
    jv, _ = jnet.forward(jparams, jax_feed(feed), is_training=True,
                         rng=jax.random.PRNGKey(3))
    want = scalar_loss(jnet, jparams, jax_feed(feed))   # eval: the same
    tv, _ = tnet.forward(tparams, torch_feed(feed), is_training=True,
                         rng=torch.Generator().manual_seed(3))
    close(tvalue(tv["test"]).detach().numpy(),
          np.asarray(jv["test"].data), "training output")
    tp = {k: v.requires_grad_(True) for k, v in tparams.items()}
    got = torch_scalar_loss(tnet, tp, torch_feed(feed), is_training=True,
                            rng=torch.Generator().manual_seed(3))
    close(float(got.detach()), float(want), "readout")
    # the error clip is ignored too: the gradients are the unclipped ones
    jg = jax.grad(lambda p: scalar_loss(jnet, p, jax_feed(feed)))(jparams)
    tg = dict(zip(tp, torch.autograd.grad(got, list(tp.values()))))
    for name, g in jg.items():
        close(tg[name].numpy(), g, name)
    assert max(float(np.abs(np.asarray(g)).max()) for g in jg.values()) \
        > 1e-3


# ------------------------------------------ the logits peephole repair
def _ce_net(**fc_conf):
    """data (6) → fc softmax 5 (with ``fc_conf``) → multi-class CE."""
    fc = JLayer(name="test", type="fc", size=5, active_type="softmax",
                with_bias=True, inputs=[JInput(input_layer_name="x")],
                **fc_conf)
    cost = JLayer(name="cost", type="multi-class-cross-entropy", size=1,
                  inputs=[JInput(input_layer_name="test"),
                          JInput(input_layer_name="label")])
    return JNet(JModel(layers=[
        JLayer(name="x", type="data", size=6),
        JLayer(name="label", type="data", size=1), fc, cost],
        input_layer_names=["x", "label"], output_layer_names=["cost"]))


def _ce_feed():
    return {"x": R.uniform(-2, 2, (4, 6)).astype(np.float32),
            "label": np.array([0, 3, 4, 1], np.int32)}


def test_ce_takes_the_logits_only_without_dropout_or_clip():
    assert port_net(_ce_net())._cost_logit_alias == {"cost": "test.logits"}
    for conf in (dict(drop_rate=0.3), dict(error_clipping_threshold=0.5)):
        tnet = port_net(_ce_net(**conf))
        assert tnet._cost_logit_alias == {}, conf
        assert _ce_net(**conf)._cost_logit_alias == {}, conf
    values, _ = port_net(_ce_net(drop_rate=0.3)).forward(
        port_net(_ce_net()).init_params(0, "cpu"), torch_feed(_ce_feed()),
        is_training=False)
    assert "test.logits" not in values


def test_ce_behind_an_error_clipped_softmax_matches_jax():
    """The clip sits between the softmax and the CE: its gradient is
    clipped in JAX, so the port's CE must read the probabilities (the
    fused logits path would skip the clip)."""
    check_parity(_ce_net(error_clipping_threshold=0.3), _ce_feed(),
                 objective="loss")


def test_ce_behind_a_dropped_out_softmax_matches_jax_on_the_ports_mask():
    """In training the CE reads the dropped-out probabilities:
    ``-log(clip(where(mask, p / keep, 0)[label], 1e-8, 1))``."""
    jnet = _ce_net(drop_rate=0.5)
    feed = _ce_feed()
    tnet = port_net(jnet)
    jparams, tparams = carried_params(jnet, tnet)
    mask = _port_mask(8, "test", (4, 5), 0.5)
    jv, _ = jnet.forward(jparams, jax_feed(feed), is_training=False)
    p = jnp.where(mask, jv["test"] / 0.5, 0.0)
    want = -jnp.log(jnp.clip(p[jnp.arange(4), feed["label"]], 1e-8, 1.0))
    loss, (values, _) = tnet.loss(tparams, torch_feed(feed),
                                  is_training=True,
                                  rng=torch.Generator().manual_seed(8))
    close(float(loss), float(jnp.mean(want)), "loss")
    close(tvalue(values["cost"])[:, 0].numpy(), want, "per-example cost")


# ------------------------------------------------ the trainer's seeds
def _dropout_regression_net():
    fc = JLayer(name="h", type="fc", size=16, active_type="relu",
                inputs=[JInput(input_layer_name="x")], drop_rate=0.5)
    out = JLayer(name="y", type="fc", size=2,
                 inputs=[JInput(input_layer_name="h")])
    cost = JLayer(name="cost", type="square_error", size=1,
                  inputs=[JInput(input_layer_name="y"),
                          JInput(input_layer_name="t")])
    return JModel(layers=[JLayer(name="x", type="data", size=8),
                          JLayer(name="t", type="data", size=2),
                          fc, out, cost],
                  input_layer_names=["x", "t"], output_layer_names=["cost"])


def test_trainer_draws_new_masks_each_step_and_the_same_at_a_seed():
    from paddle_tpu_torch.config.model_config import ModelConfig as TModel
    cfg = TModel.from_json(_dropout_regression_net().to_json())
    feed = {"x": torch.from_numpy(R.randn(32, 8).astype(np.float32)),
            "t": torch.from_numpy(R.randn(32, 2).astype(np.float32))}

    def run(seed):
        tr = TTrainer(TNet(cfg), TOpt(learning_method="momentum",
                                      learning_rate=0.0),
                      seed=seed, device="cpu")
        return [float(tr.train_one_batch(feed)) for _ in range(3)]

    a, b, c = run(0), run(0), run(1)
    assert a == b                   # one seed, one set of masks
    assert len(set(a)) == 3         # lr 0: only the masks change a loss
    assert a != c
