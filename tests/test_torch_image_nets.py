"""The image benchmark's nets in the port (``paddle_tpu_torch/models/
image.py``'s builders and ``paddle_tpu_torch/configs/image.py``) against
the JAX package's, on the CPU.

- ``configs/image.py``, parsed by both packages under each ``model=``,
  gives the same model JSON and optimization config, equal to
  ``benchmark/image.py``'s (the JAX builders' nets) parsed by the JAX
  package; ``provider.process`` yields ``benchmark/provider.py``'s
  samples.
- The port's builders give the JAX builders' JSON.
- smallnet at 32², alexnet at 67² and VGG-16 at 32² (B 2): the loss and
  every gradient from the same parameters (the JAX side jitted);
  googlenet by its JSON only (its JAX forward does not fit this
  file's budget).
- A format-2 checkpoint of ``model=smallnet`` crosses the packages byte
  for byte (JAX save → port load → port save, and back).

Tolerance (fp32): rtol 1e-5, atol 1e-6 · max(1, max|ref|).  ~45 s alone.
"""

import dataclasses
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import config_parser as jparser
from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.data.feeder import dense_vector, integer_value
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.models import image as jimage
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch import compat as tcompat
from paddle_tpu_torch.config import config_parser as tparser
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.models import image as timage
from paddle_tpu_torch.trainer import checkpoint as tck
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from test_torch_checkpoint import _assert_same_state, _digests
from test_torch_config_parser import (CONFIGS, REPO,  # noqa: F401
                                      paddle_aliases)
from test_torch_dense_layers import carried_params, close, port_net

IMAGE = os.path.join(CONFIGS, "image.py")
BENCH = os.path.join(REPO, "benchmark", "image.py")
MODELS = ["smallnet", "alexnet", "googlenet", "vgg", "resnet",
          "resnet_cifar10"]


def _jax_net(builder, side, k):
    with jdsl.config_scope():
        img = jdsl.data("image", dense_vector(3 * side * side), height=side,
                        width=side)
        lab = jdsl.data("label", integer_value(k))
        return jdsl.topology(jdsl.classification_cost(builder(img, k), lab))


@pytest.mark.parametrize("model", MODELS)
def test_config_parses_alike_in_both_packages(
        paddle_aliases, model):  # noqa: F811
    args = f"model={model},batch_size=32,num_samples=64"
    jm, jo, jd = jparser.parse_config(IMAGE, args)
    bm, bo, _ = jparser.parse_config(BENCH, args)
    with paddle_aliases():
        tm, to, td = tparser.parse_config(IMAGE, args)
    assert tm.to_json() == jm.to_json() == bm.to_json()
    assert dataclasses.asdict(to) == dataclasses.asdict(jo) \
        == dataclasses.asdict(bo)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert (to.batch_size, to.learning_method, to.momentum) == \
        (32, "momentum", 0.9)
    assert np.isclose(to.learning_rate, 0.01 / 32)
    assert np.isclose(to.l2_weight_decay, 0.0005 * 32)


def test_provider_yields_the_benchmark_samples(paddle_aliases):  # noqa: F811
    sys.path.insert(0, CONFIGS)
    try:
        with paddle_aliases():
            tcompat.install()
            prov = importlib.import_module("provider").process
            samples = list(prov.reader(height=5, width=4, num_class=7,
                                       num_samples=3)())
    finally:
        sys.path.remove(CONFIGS)
    rng = np.random.RandomState(0)
    for pixels, label in samples:
        np.testing.assert_array_equal(
            pixels, rng.uniform(-1, 1, 60).astype(np.float32))
        assert label == int(rng.randint(7))
    assert len(samples) == 3


BUILDERS = {
    "smallnet": (timage.smallnet_mnist_cifar, jimage.smallnet_mnist_cifar,
                 32, 10),
    "alexnet": (timage.alexnet, jimage.alexnet, 227, 1000),
    "vgg16": (lambda k, s: timage.vgg(16, k, s),
              lambda i, k: jimage.vgg(i, 16, k), 224, 1000),
    "vgg19": (lambda k, s: timage.vgg(19, k, s),
              lambda i, k: jimage.vgg(i, 19, k), 224, 1000),
    "googlenet": (timage.googlenet, jimage.googlenet, 224, 1000)}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_json_equals_the_jax_builders(name):
    tb, jb, side, k = BUILDERS[name]
    want = _jax_net(jb, side, k).to_json()
    assert tb(k, side).to_json() == want


@pytest.mark.parametrize("name, side", [("smallnet", 32), ("alexnet", 67),
                                        ("vgg16", 32)])
def test_net_loss_and_gradients_match_jax(name, side):
    _, jb, _, k = BUILDERS[name]
    k = 10 if name == "smallnet" else 12
    jnet = JNet(_jax_net(jb, side, k))
    rng = np.random.RandomState(4)
    feed = {"image": rng.uniform(-1, 1, (2, 3 * side * side))
            .astype(np.float32),
            "label": np.array([1, k - 1], np.int32)}
    tnet = port_net(jnet)
    jparams, tparams = carried_params(jnet, tnet)
    jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnet.loss(p, jfeed, {}, is_training=False)[0]))(jparams)
    leaves = {k: v.requires_grad_(True) for k, v in tparams.items()}
    tloss = tnet.loss(leaves, {k: torch.from_numpy(v) for k, v in
                               feed.items()}, is_training=False)[0]
    grads = torch.autograd.grad(tloss, list(leaves.values()))
    close(float(tloss.detach()), float(jloss), "loss")
    assert set(leaves) == set(jgrads)
    for (n, _), g in zip(leaves.items(), grads):
        close(g.numpy(), jgrads[n], f"gradient of {n}")


def test_smallnet_checkpoint_crosses_packages(
        tmp_path, paddle_aliases):  # noqa: F811
    args = "model=smallnet,batch_size=4"
    jm, jo, _ = jparser.parse_config(IMAGE, args)
    with paddle_aliases():
        tm, to, _ = tparser.parse_config(IMAGE, args)
    jtr = JTrainer(JNet(jm), opt_config=jo, seed=0)
    ttr = TTrainer(TNet(tm), to, seed=5, device="cpu")
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (4, 3 * 32 * 32)).astype(np.float32)
    y = rng.randint(0, 10, (4,)).astype(np.int32)
    jtr.train_one_batch({"data": jnp.asarray(x), "label": jnp.asarray(y)})
    a = jtr.save(str(tmp_path / "jax"), 0)
    ttr.load(a)
    _assert_same_state(jtr, ttr)
    assert {n: tuple(p.shape) for n, p in ttr.params.items()} \
        == {n: tuple(p.shape) for n, p in jtr.params.items()}
    b = ttr.save(str(tmp_path / "port"), 0)
    assert _digests(b) == _digests(a)
    assert tck.load_manifest(b) == tck.load_manifest(a)
    ttr.train_one_batch({"data": torch.from_numpy(x),
                         "label": torch.from_numpy(y)})
    c = ttr.save(str(tmp_path / "port"), 1)
    jtr2 = JTrainer(JNet(jm), opt_config=JOpt(**dataclasses.asdict(jo)),
                    seed=3)
    jtr2.load(c)
    _assert_same_state(jtr2, ttr)
    assert _digests(jtr2.save(str(tmp_path / "jax2"), 1)) == _digests(c)
