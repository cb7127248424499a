"""The port's SGD-family optimizer rules (SGD, Momentum, Adagrad,
ProximalGD, ProximalAdagrad) and L1 through ``optimizer_from_config``
and the trainer, against the JAX package's, on the CPU: five steps of
the small LSTM classifier each (``tests/torch_opt_steps_util.py`` says
how and to what tolerance).
"""

import pytest
import torch

from torch_opt_steps_util import TRAINER_OPTS, trajectory


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["adagrad", "momentum",
                                  "proximal_adagrad", "proximal_gd", "sgd"])
def test_five_steps_of_the_small_classifier_match_jax(name):
    trajectory(TRAINER_OPTS[name])


def test_l1_in_the_trainer_matches_jax():
    trajectory(dict(TRAINER_OPTS["momentum"], l1_weight_decay=1e-3))
