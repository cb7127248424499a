"""The port's moment-based optimizer rules (AdaDelta, Adam, Adamax,
RMSProp, DecayedAdagrad) through ``optimizer_from_config`` and the
trainer, against the JAX package's, on the CPU: five steps of the small
LSTM classifier each (``tests/torch_opt_steps_util.py`` says how and to
what tolerance).
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


@pytest.mark.parametrize("name", ["adadelta", "adam", "adamax",
                                  "decayed_adagrad", "rmsprop"])
def test_five_steps_of_the_small_classifier_match_jax(name):
    trajectory(TRAINER_OPTS[name])
