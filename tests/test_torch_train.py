"""The port's LSTM text-classifier training path against the JAX
package's, on the CPU.

The same ``ModelConfig`` comes out of both packages; the JAX
``init_params(0)`` is carried into the port by name
(``network_params_from_jax``), since the two frameworks draw different
numbers from one seed; feeds come from a numpy seed.  The JAX side runs
its fused Pallas LSTM kernels in interpret mode (B = 8, H = 128); the
port runs its kernels' plain versions on CPU tensors.

Tolerances (fp32, different summation orders): loss rtol 1e-5;
gradients atol 1e-5 + 1e-4 * max|ref|; Adam trajectory losses rtol 1e-5
and parameters after step 5 atol 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.models import lstm_text_classifier as j_classifier
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.entry import entry as t_entry
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.models import lstm_text_classifier as t_classifier
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

# entry()'s shapes
V, E, H, C, B, T = 4000, 64, 128, 2, 8, 32
# the bench row's optimizer (bench.py:270-278, :303)
OPT = dict(learning_method="adam", learning_rate=2e-3, l2_weight_decay=8e-4,
           gradient_clipping_threshold=25.0)


def _feed(b, t, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, size=(b, t)).astype(np.int32)
    lengths = rng.randint(max(1, t // 2), t + 1, size=(b,)).astype(np.int32)
    lengths[0] = t                      # one full-length row
    labels = rng.randint(0, C, size=(b,)).astype(np.int32)
    return ids, lengths, labels


def _jfeed(ids, lengths, labels):
    return {"data": JSeq(jnp.asarray(ids), jnp.asarray(lengths)),
            "label": jnp.asarray(labels)}


def _tfeed(ids, lengths, labels):
    return {"data": TSeq(torch.from_numpy(ids), torch.from_numpy(lengths)),
            "label": torch.from_numpy(labels)}


@pytest.mark.parametrize("dims", [(V, E, H, 2, C), (30000, 128, 512, 2, 2),
                                  (50, 8, 16, 3, 5)],
                         ids=["entry", "bench_row", "three_lstms"])
def test_config_and_param_specs_match_jax(dims):
    jcfg, tcfg = j_classifier(*dims), t_classifier(*dims)
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    want = {n: dataclasses.asdict(s) for n, s in JNet(jcfg).param_specs.items()}
    got = {n: dataclasses.asdict(s) for n, s in TNet(tcfg).param_specs.items()}
    assert got == want


def test_loss_and_gradients_match_jax():
    jnet, tnet = JNet(j_classifier(V, E, H, 2, C)), TNet(
        t_classifier(V, E, H, 2, C))
    jparams = jnet.init_params(seed=0)
    ids, lengths, labels = _feed(B, T)

    def jloss(p):
        return jnet.loss(p, _jfeed(ids, lengths, labels), {},
                         is_training=True)[0]

    want_loss, want_g = jax.value_and_grad(jloss)(jparams)
    params = network_params_from_jax(
        {n: np.asarray(v) for n, v in jparams.items()}, tnet, "cpu")
    params = {n: p.requires_grad_(True) for n, p in params.items()}
    loss, _ = tnet.loss(params, _tfeed(ids, lengths, labels))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert set(grads) == set(want_g)
    for name, g in want_g.items():
        g = np.asarray(g)
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=0,
                                   atol=1e-5 + 1e-4 * float(np.abs(g).max()),
                                   err_msg=name)


def test_adam_trajectory_matches_jax():
    """Five Adam steps from the same carried params.  Adam turns rounding
    noise in a near-zero gradient into a full ±lr step, so the bench
    row's L2 term (which keeps every gradient off zero) stays on."""
    t = 12
    jtr = JTrainer(JNet(j_classifier(V, E, H, 2, C)),
                   opt_config=JOpt(**OPT), seed=0)
    tnet = TNet(t_classifier(V, E, H, 2, C))
    ttr = TTrainer(tnet, opt_config=TOpt(**OPT), seed=0, device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    for step in range(5):
        feed = _feed(B, t, seed=10 + step)
        want = float(jtr.train_one_batch(_jfeed(*feed)))
        got = float(ttr.train_one_batch(_tfeed(*feed)))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"loss of step {step}")
    assert ttr.samples_seen == 5 * B
    for name, p in jtr.params.items():
        np.testing.assert_allclose(ttr.params[name].numpy(), np.asarray(p),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_entry_runs_on_cpu_and_matches_jax_entry():
    import __graft_entry__
    fn, (params, ids, lengths, labels) = t_entry(device="cpu")
    assert all(p.device.type == "cpu" for p in params.values())
    loss = fn(params, ids, lengths, labels)
    assert loss.shape == () and np.isfinite(float(loss))
    # the same function on the JAX entry's params and feed
    jfn, (jparams, jids, jlen, jlab) = __graft_entry__.entry()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    carried = network_params_from_jax(
        {n: np.asarray(v) for n, v in jparams.items()},
        TNet(t_classifier(V, E, H, 2, C)), "cpu")
    np.testing.assert_allclose(float(fn(carried, ids, lengths, labels)),
                               float(jfn(jparams, jids, jlen, jlab)),
                               rtol=1e-5)


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_lookup_table_matches_jax(padding_idx):
    from paddle_tpu.ops.embedding_ops import lookup_table as j_lookup
    from paddle_tpu_torch.ops.embedding_ops import lookup_table as t_lookup
    rng = np.random.RandomState(0)
    table = rng.randn(10, 4).astype(np.float32)
    ids = rng.randint(0, 10, (3, 5)).astype(np.int32)
    ids[0, :2] = 3
    want = np.asarray(j_lookup(jnp.asarray(table), jnp.asarray(ids),
                               padding_idx))
    t = torch.from_numpy(table).requires_grad_(True)
    got = t_lookup(t, torch.from_numpy(ids), padding_idx)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    assert (t.grad[3].abs().sum() == 0) == (padding_idx == 3)
