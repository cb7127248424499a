"""The VAE demo's config (``paddle_tpu_torch/configs/vae.py``) through the
port against the JAX package, on the CPU, at the published widths: x
784, hidden 128, z 100, batch 32, Adam lr 1e-3.

- The config parses to the same ``to_json()`` in both packages, equal
  to ``demo/vae/vae_conf.py``'s, for training and for
  ``is_generating=1``.
- Five ``train_one_batch`` steps of the port's ``Trainer`` from the JAX
  ``Trainer(seed=0)``'s parameters (carried by name) on the demo's feeds
  (binarised 784-vectors and N(0, 1) noise of width 100 from
  ``RandomState(0)``, as ``demo/vae/train.py`` draws them; synthetic
  images) give JAX's losses and parameters.
- Sampling through the generating topology with the trained parameters
  shared by name gives JAX's samples.
- The objective is the sum of the cost layers, CE + ``sum_cost``, as in
  the JAX package: the 0.5 of ``KL_loss`` and the ``mixed`` layer that
  adds the two terms are the output, not the loss.

Tolerances (fp32, different summation orders): losses rtol 1e-5;
parameters after 5 Adam steps within 1e-4 (a tenth of one step at lr
1e-3: Adam turns a rounding difference in a gradient near 0 into a share
of a step), all but one weight in 10^4 within 2e-5; samples from the
same decoder parameters atol 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import config_parser as jparser
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.config import config_parser as tparser
from paddle_tpu_torch.core.sequence import value_of
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax
from test_torch_config_parser import REPO, paddle_aliases  # noqa: F401

VAE = os.path.join(REPO, "paddle_tpu_torch", "configs", "vae.py")
DEMO = os.path.join(REPO, "demo", "vae", "vae_conf.py")
B, X, Z = 32, 784, 100


def _port_parse(block, args):
    with block():
        return tparser.parse_config(VAE, args)


def vae_feeds(n, b=B, seed=0):
    """``demo/vae/train.py``'s feeds without its MNIST: binarised uniform
    784-vectors and N(0, 1) noise, from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = (rng.rand(b, X) > 0.5).astype(np.float32)
        out.append((x, rng.randn(b, Z).astype(np.float32)))
    return out


@pytest.mark.parametrize("args", ["", "is_generating=1"])
def test_config_matches_the_jax_package_and_the_demo(paddle_aliases, args):
    jmodel, jopt, _ = jparser.parse_config(VAE, args)
    demo, dopt, _ = jparser.parse_config(DEMO, args)
    tmodel, topt, _ = _port_parse(paddle_aliases, args)
    assert jmodel.to_json() == demo.to_json()
    assert tmodel.to_json() == jmodel.to_json()
    assert (topt.batch_size, topt.learning_rate, topt.learning_method) == \
        (dopt.batch_size, dopt.learning_rate, dopt.learning_method) == \
        (32, 1e-3, "adam")
    sizes = {l.name: l.size for l in tmodel.layers}
    assert sizes["noise"] == Z and (args or sizes["x_batch"] == X)


@pytest.fixture(scope="module")
def trained():
    """Five steps of both trainers from JAX's seed-0 parameters."""
    from paddle_tpu_torch import compat
    jmodel, jopt, _ = jparser.parse_config(VAE, "")
    with compat.swapped(extra=("provider",)):
        tmodel, topt, _ = tparser.parse_config(VAE, "")
    jtr = JTrainer(JNet(jmodel), opt_config=jopt, seed=0)
    tnet = TNet(tmodel)
    ttr = TTrainer(tnet, opt_config=topt, seed=0, device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    losses = []
    for x, eps in vae_feeds(5):
        want = float(jtr.train_one_batch({"x_batch": jnp.asarray(x),
                                          "noise": jnp.asarray(eps)}))
        got = float(ttr.train_one_batch({"x_batch": torch.from_numpy(x),
                                         "noise": torch.from_numpy(eps)}))
        losses.append((got, want))
    return jtr, ttr, losses


def test_five_adam_steps_match_jax(trained):
    jtr, ttr, losses = trained
    for step, (got, want) in enumerate(losses):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"loss of step {step}")
    assert losses[-1][0] < losses[0][0]
    assert ttr.samples_seen == 5 * B
    assert set(ttr.params) == set(jtr.params) == {
        f"{n}.{k}" for n in ("share", "mu", "logvar", "hidden", "prob")
        for k in ("w", "bias")}
    for name, p in jtr.params.items():
        diff = np.abs(ttr.params[name].numpy() - np.asarray(p))
        # Adam gives a gradient near 0 a step of up to lr whatever its
        # size, so a rounding difference there moves a weight by a
        # share of lr: every weight within a tenth of one step, all but
        # 1 in 10^4 within 2e-5
        assert diff.max() <= 1e-4, (name, diff.max())
        assert np.mean(diff > 2e-5) <= 1e-4, (name, np.mean(diff > 2e-5))


def test_generation_from_shared_parameters_matches_jax(trained,
                                                       paddle_aliases):
    jtr, ttr, _ = trained
    jgen = JNet(jparser.parse_config(VAE, "is_generating=1")[0])
    tgen = TNet(_port_parse(paddle_aliases, "is_generating=1")[0])
    assert set(tgen.param_specs) == {"hidden.w", "hidden.bias", "prob.w",
                                     "prob.bias"}
    z = np.random.RandomState(1).randn(16, Z).astype(np.float32)
    # JAX's trained decoder in both: the samples are compared on the same
    # parameters (the port's own trained ones sit within 1e-4 of them)
    jp = {n: jtr.params[n] for n in jgen.init_params()}
    tp = network_params_from_jax({n: np.asarray(v) for n, v in jp.items()},
                                 tgen, "cpu")
    assert set(tp) <= set(ttr.params)
    jv, _ = jgen.forward(jp, {"noise": jnp.asarray(z)}, is_training=False)
    with torch.no_grad():
        tv, _ = tgen.forward(tp, {"noise": torch.from_numpy(z)},
                             is_training=False)
    want = np.asarray(jv[jgen.output_names[0]])
    got = value_of(tv[tgen.output_names[0]]).numpy()
    assert got.shape == (16, X)
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_objective_is_ce_plus_sum_cost_as_in_jax(paddle_aliases):
    """Only the cost layers enter the loss: mean(CE) + mean(sum_cost),
    not the ``mixed`` output CE + 0.5 · sum_cost, in both packages."""
    jmodel = jparser.parse_config(VAE, "")[0]
    jnet = JNet(jmodel)
    tnet = TNet(_port_parse(paddle_aliases, "")[0])
    costs = [n for n in tnet.order if getattr(tnet.layers[n], "is_cost",
                                              False)]
    assert costs == jnet.cost_layers
    assert [tnet.layers[n].conf.type for n in costs] == \
        ["multi_binary_label_cross_entropy", "sum_cost"]
    jp = jnet.init_params(0)
    tp = network_params_from_jax({n: np.asarray(v) for n, v in jp.items()},
                                 tnet, "cpu")
    (x, eps), = vae_feeds(1, b=8, seed=3)
    jloss, (jv, _) = jnet.loss(jp, {"x_batch": jnp.asarray(x),
                                    "noise": jnp.asarray(eps)}, {})
    with torch.no_grad():
        loss, (values, _) = tnet.loss(tp, {"x_batch": torch.from_numpy(x),
                                           "noise": torch.from_numpy(eps)})
    ce, kl = (value_of(values[n])[:, 0] for n in costs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(ce.mean() + kl.mean()),
                               rtol=1e-6)
    out = value_of(values[tnet.output_names[0]])[:, 0]
    np.testing.assert_allclose(out.numpy(), (ce + 0.5 * kl).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jv[jnet.output_names[0]])[:, 0], rtol=1e-5)
    assert abs(float(loss) - float(out.mean())) > 1.0
