"""Local SGD in the port (``parallel/local_sgd.py``) against the JAX
package's ``tests/test_local_sgd.py``, case for case, on two spawned
ranks over gloo (``tests/torch_dist_workers.py``, once for the module).

- the factory picks ``LocalSGDTrainer`` for ``local_sgd_steps`` > 0;
- K = 1 with plain SGD is synchronous DP: the consolidated parameters
  equal the synchronous trainer's after 5 steps (rtol 1e-5, atol 1e-6,
  the JAX test's);
- between averages the ranks' copies differ, at the K-th step they are
  equal again (bit for bit);
- K = 4 reaches the synchronous loss within the JAX test's margin
  (sgd and adam, 40 steps);
- K = 2 against the JAX ``LocalSGDTrainer`` on a 2-device mesh from the
  same parameters: losses and consolidated parameters (rtol 1e-5, atol
  1e-6); a save and a test before the first step reduce nothing.
"""

import os

import jax
import numpy as np
import pytest

from paddle_tpu.config import dsl
from paddle_tpu.config.dsl import config_scope
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.core.device import build_mesh, set_mesh
from paddle_tpu.data.feeder import dense_vector, integer_value
from paddle_tpu.layers import NeuralNetwork as JNet
from paddle_tpu.parallel.local_sgd import LocalSGDTrainer as JLocal
from paddle_tpu_torch.config.model_config import ModelConfig
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.core.device import Mesh
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.parallel.local_sgd import LocalSGDTrainer, make_trainer
from paddle_tpu_torch.trainer import checkpoint as tck
from paddle_tpu_torch.trainer.trainer import Trainer

from torch_dist_workers import run_cases, run_ranks

RTOL, ATOL = 1e-5, 1e-6


def _mlp_config(in_dim=8, classes=3):
    with config_scope():
        x = dsl.data("x", dense_vector(in_dim))
        h = dsl.fc(x, size=16, act=dsl.Activation("tanh"))
        y = dsl.fc(h, size=classes, act=dsl.Activation("softmax"))
        lab = dsl.data("label", integer_value(classes))
        return dsl.topology(dsl.classification_cost(y, lab))


#: rows of a rank and width of the dropout layer in the mask case
MASK_ROWS, MASK_WIDTH = 64, 32


def _dropout_config(in_dim=8, classes=3):
    with config_scope():
        x = dsl.data("x", dense_vector(in_dim))
        h = dsl.fc(x, size=MASK_WIDTH, act=dsl.Activation("tanh"),
                   layer_attr=dsl.ExtraAttr(drop_rate=0.5))
        y = dsl.fc(h, size=classes, act=dsl.Activation("softmax"))
        lab = dsl.data("label", integer_value(classes))
        return dsl.topology(dsl.classification_cost(y, lab))


def _data(rng, n, in_dim=8, classes=3):
    x = rng.randn(n, in_dim).astype(np.float32)
    w = rng.randn(in_dim, classes).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.randn(n, classes), axis=1)
    return {"x": x, "label": y.astype(np.int32)}


def test_factory_selects_local_sgd():
    cfg = ModelConfig.from_json(_mlp_config().to_json())
    t = make_trainer(TNet(cfg), TOpt(learning_method="sgd",
                                     local_sgd_steps=4), device="cpu",
                     mesh=Mesh({"data": 1}), seed=0)
    assert isinstance(t, LocalSGDTrainer) and t.local_steps == 4
    t0 = make_trainer(TNet(cfg), TOpt(learning_method="sgd"), device="cpu",
                      mesh=Mesh({"data": 1}), seed=0)
    assert type(t0) is Trainer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("local_sgd"))
    cfg = _mlp_config().to_json()
    # the JAX oracle: K = 2 on two devices from its own parameters
    mesh = build_mesh({"data": 2}, jax.devices()[:2])
    set_mesh(mesh)
    jfeed = _data(np.random.RandomState(4), 64)
    jtr = JLocal(JNet(_mlp_config()), opt_config=JOpt(
        learning_method="adam", learning_rate=0.01, local_sgd_steps=2),
        mesh=mesh, seed=5)
    init = jtr.save(os.path.join(root, "init"), 0)
    jlosses = [float(jtr.train_one_batch(
        {k: jax.numpy.asarray(v) for k, v in jfeed.items()}))
        for _ in range(5)]
    jparams = {n: np.asarray(v) for n, v in
               jtr.consolidated_params().items()}
    set_mesh(None)

    def case(feeds, seed=3, trace=False, **opt):
        return {"config": cfg, "opt": opt, "mesh": {"data": 2},
                "feeds": feeds, "seed": seed, "fn": "local_sgd_case",
                "trace": trace}

    k1 = _data(np.random.RandomState(0), 64)
    div = _data(np.random.RandomState(1), 64)
    conv = _data(np.random.RandomState(2), 128)
    cases = {
        "sync": case([k1] * 5, learning_method="sgd", learning_rate=0.1),
        "k1": case([k1] * 5, learning_method="sgd", learning_rate=0.1,
                   local_sgd_steps=1),
        "k4": case([div] * 4, seed=0, trace=True, learning_method="sgd",
                   learning_rate=0.1, local_sgd_steps=4),
        "jax": {**case([jfeed] * 5, learning_method="adam",
                       learning_rate=0.01, local_sgd_steps=2),
                "ckpt": init, "save_dir": os.path.join(root, "port")},
    }
    for method, lr in (("sgd", 0.2), ("adam", 0.01)):
        for k in (0, 4):
            cases[f"{method}_{k}"] = case([conv] * 40, seed=1,
                                          learning_method=method,
                                          learning_rate=lr,
                                          local_sgd_steps=k)
    drop = {"config": _dropout_config().to_json(), "fn": "local_sgd_mask_case",
            "opt": {"learning_method": "sgd", "learning_rate": 0.1,
                    "local_sgd_steps": 2}, "mesh": {"data": 2}, "seed": 3}
    cases["masks"] = {**drop, "feeds": [_data(np.random.RandomState(6),
                                              2 * MASK_ROWS)]}
    cases["undivided"] = {**drop, "feeds": [_data(np.random.RandomState(7),
                                                  15)]}
    port = run_ranks(run_cases, 2, cases, deadline_s=120.0)
    return {"losses": jlosses, "params": jparams, "init": init}, port


def test_k1_sgd_identical_to_sync_dp(runs):
    _, port = runs
    assert port[0]["k1"]["type"] == "LocalSGDTrainer"
    assert port[0]["sync"]["type"] == "Trainer"
    for k, p in port[0]["sync"]["params"].items():
        np.testing.assert_allclose(port[0]["k1"]["params"][k], p, rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_local_sgd_shards_diverge_between_averages(runs):
    _, port = runs
    own0, own1 = port[0]["k4"]["own"], port[1]["k4"]["own"]
    name = sorted(own0[0])[0]
    assert np.abs(own0[0][name] - own1[0][name]).max() > 0, \
        "the copies did not diverge under local updates"
    for n in own0[3]:
        np.testing.assert_array_equal(own0[3][n], own1[3][n], err_msg=n)


@pytest.mark.parametrize("method", ["sgd", "adam"])
def test_local_sgd_converges_close_to_sync(runs, method):
    _, port = runs
    sync_loss = port[0][f"{method}_0"]["losses"][-1]
    async_loss = port[0][f"{method}_4"]["losses"][-1]
    assert async_loss < 1.0, f"local SGD failed to learn: {async_loss}"
    assert async_loss < sync_loss * 1.25 + 0.05, (sync_loss, async_loss)


def test_local_sgd_matches_the_jax_trainer(runs):
    """K = 2 from the JAX trainer's parameters: the losses (the ranks'
    mean) and the consolidated parameters; before the first step a save
    writes the starting parameters and a test runs on them."""
    jax_side, port = runs
    got = port[0]["jax"]
    np.testing.assert_allclose(got["losses"], jax_side["losses"], rtol=RTOL)
    for k, p in jax_side["params"].items():
        np.testing.assert_allclose(got["params"][k], p, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    before = tck.load_params(got["saved_before"])
    for k, v in tck.load_params(jax_side["init"]).items():
        np.testing.assert_array_equal(before[k], v, err_msg=k)
    assert np.isfinite(got["test_before"]["test_cost"])


def test_each_rank_draws_its_own_dropout_masks(runs):
    """Fault C9: the two ranks' keep-masks at rate 0.5 on equal-shaped
    rows agree on about half their elements (p^2 + (1 - p)^2 = 0.5 for
    independent masks, as the JAX package's per-shard keys give), within
    5 binomial standard deviations; one shared seed would agree on all."""
    _, port = runs
    m0, m1 = (port[r]["masks"]["masks"] for r in (0, 1))
    assert len(m0) == len(m1) == 1
    assert m0[0].shape == m1[0].shape == (MASK_ROWS, MASK_WIDTH)
    for m in (m0[0], m1[0]):
        sigma = np.sqrt(0.25 / m.size)
        assert abs(m.mean() - 0.5) < 5 * sigma
    agree = (m0[0] == m1[0]).mean()
    assert abs(agree - 0.5) < 5 * np.sqrt(0.25 / m0[0].size), agree


def test_an_undivided_batch_raises(runs):
    """Fault C10: 15 rows do not divide over two ranks; local SGD raises
    the JAX package's message on every rank rather than stepping on the
    whole batch."""
    _, port = runs
    for r in (0, 1):
        got = port[r]["undivided"]
        assert "masks" not in got
        assert got["error"] == ("PaddleTpuError: local SGD: batch 15 not "
                                "divisible by 2 shards"), got
