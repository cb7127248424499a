"""Five steps of the small LSTM text classifier (V 50, E 8, H 16, 2
LSTMs; both packages on their per-step scan: H % 128 != 0) in the JAX
package and in the port from the JAX package's parameters, B 8, T 10
feeds from a numpy seed, L2 8e-4 and clipping 25 on: losses rtol 1e-5,
parameters after the last step atol 1e-5 (the Adam trajectory
tolerance of ``tests/test_torch_train.py``).  Shared by the
``test_torch_optimizer_steps_*.py`` files, which split the ten rules
so that no file runs long on one worker.
"""

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.core.sequence import SequenceBatch as JSeq
from paddle_tpu.layers.network import NeuralNetwork as JNet
from paddle_tpu.models import lstm_text_classifier as j_classifier
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.core.sequence import SequenceBatch as TSeq
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.models import lstm_text_classifier as t_classifier
from paddle_tpu_torch.trainer.trainer import Trainer as TTrainer
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax

V, E, H, C = 50, 8, 16, 2
TRAINER_OPTS = {
    "sgd": dict(learning_rate=0.1),
    "momentum": dict(learning_method="momentum", momentum=0.9,
                     learning_rate=0.05),
    "adagrad": dict(learning_method="adagrad", learning_rate=0.05),
    "adadelta": dict(learning_method="adadelta", learning_rate=1.0),
    "rmsprop": dict(learning_method="rmsprop", learning_rate=1e-3),
    "decayed_adagrad": dict(learning_method="decayed_adagrad",
                            learning_rate=1e-2),
    "adam": dict(learning_method="adam", learning_rate=2e-3),
    "adamax": dict(learning_method="adamax", learning_rate=2e-3),
    "proximal_gd": dict(learning_method="proximal_gd", learning_rate=0.1),
    "proximal_adagrad": dict(learning_method="proximal_adagrad",
                             learning_rate=0.05),
}


def _lstm_feed(seed, b=8, t=10):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (b, t)).astype(np.int32)
    lengths = rng.randint(t // 2, t + 1, (b,)).astype(np.int32)
    labels = rng.randint(0, C, (b,)).astype(np.int32)
    return ({"data": JSeq(jnp.asarray(ids), jnp.asarray(lengths)),
             "label": jnp.asarray(labels)},
            {"data": TSeq(torch.from_numpy(ids), torch.from_numpy(lengths)),
             "label": torch.from_numpy(labels)})


def trajectory(opt_kw, steps=5):
    """``steps`` steps of both packages' trainers under
    ``OptimizationConfig(**opt_kw)`` (with L2 and clipping) from the same
    parameters and feeds, held to the stated tolerance."""
    kw = dict(opt_kw, l2_weight_decay=8e-4, gradient_clipping_threshold=25.0)
    jtr = JTrainer(JNet(j_classifier(V, E, H, 2, C)), opt_config=JOpt(**kw),
                   seed=0)
    tnet = TNet(t_classifier(V, E, H, 2, C))
    ttr = TTrainer(tnet, TOpt(**kw), seed=0, device="cpu")
    assert type(ttr.optimizer).__name__ == type(jtr.optimizer).__name__
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    for step in range(steps):
        jf, tf = _lstm_feed(20 + step)
        want = float(jtr.train_one_batch(jf))
        got = float(ttr.train_one_batch(tf))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"loss of step {step}")
    for name, p in jtr.params.items():
        np.testing.assert_allclose(ttr.params[name].numpy(), np.asarray(p),
                                   rtol=0, atol=1e-5, err_msg=name)
