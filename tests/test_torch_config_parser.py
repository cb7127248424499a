"""The port's config-file parser (``paddle_tpu_torch/config/
config_parser.py``) and its ``paddle.*`` aliases (``compat/``) against
the JAX package's.

``configs/rnn.py`` (written in the reference's idiom: ``from
paddle.trainer_config_helpers import *``) runs through both packages'
``parse_config``: the model JSON text and ``dataclasses.asdict`` of the
optimization config are equal under several ``--config_args``.

Both packages claim ``sys.modules['paddle']``.  Every test here that
installs the port's aliases does it inside the block the
:func:`paddle_aliases` fixture gives (``compat.swapped``): the
``paddle`` / ``paddle.*`` entries and the config's ``provider`` module
are moved aside before the block and restored after it, so a
JAX-package config on the same worker never builds through the port's
DSL.  The JAX package's own parse runs outside the block, as its tests
run it.  The other port test files import the fixture from here.
"""

import dataclasses
import importlib
import json
import os
import sys

import pytest

from paddle_tpu.config import config_parser as jparser
from paddle_tpu_torch import compat as tcompat
from paddle_tpu_torch.config import config_parser as tparser
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.models import lstm_text_classifier
from paddle_tpu_torch.utils import ConfigError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "paddle_tpu_torch", "configs")
RNN = os.path.join(CONFIGS, "rnn.py")
#: the settings of configs/rnn.py (bench.py:270-278: Adam 2e-3, L2 8e-4,
#: clipping 25)
RNN_OPT = dict(learning_method="adam", learning_rate=2e-3,
               l2_weight_decay=8e-4, gradient_clipping_threshold=25)


def _port_entries():
    return [k for k in sys.modules
            if (k == "paddle" or k.startswith("paddle.")) and
            getattr(sys.modules.get("paddle"), tcompat.MARK, False)]


@pytest.fixture
def paddle_aliases():
    """A block in which the port's aliases may be installed: every
    ``paddle`` / ``paddle.*`` module and the ``provider`` module moved
    aside before it, the port's aliases dropped and the old entries put
    back after it.  After the test no alias of the port is left."""
    yield lambda: tcompat.swapped(extra=("provider",))
    assert not _port_entries(), "the port's paddle aliases leaked"


def _port_parse(block, config_args=""):
    with block():
        return tparser.parse_config(RNN, config_args)


@pytest.mark.parametrize("config_args", [
    "", "hidden_size=16,vocab_size=50,batch_size=8,num_samples=32",
    "lstm_num=1,hidden_size=128,batch_size=16",
    "lstm_num=3,hidden_size=1280"])
def test_parse_config_matches_the_jax_package(paddle_aliases, config_args):
    jmodel, jopt, jds = jparser.parse_config(RNN, config_args)
    with paddle_aliases():
        tmodel, topt, tds = tparser.parse_config(RNN, config_args)
        assert getattr(sys.modules["paddle"], tcompat.MARK)
    assert tmodel.to_json() == jmodel.to_json()
    assert dataclasses.asdict(topt) == dataclasses.asdict(jopt)
    assert dataclasses.asdict(tds) == dataclasses.asdict(jds)


def test_rnn_config_is_the_lstm_classifier(paddle_aliases):
    model, opt, ds = _port_parse(paddle_aliases)
    assert model.to_json() == lstm_text_classifier(30000, 128, 512, 2,
                                                   2).to_json()
    for k, v in RNN_OPT.items():
        assert getattr(opt, k) == v, k
    assert opt.batch_size == 128
    assert (ds.module, ds.obj, ds.args) == (
        "provider", "process_rnn",
        {"vocab_size": 30000, "maxlen": 100, "num_samples": 2048})


def test_provider_yields_the_reference_samples(paddle_aliases):
    """configs/provider.py through the port's PyDataProvider2 alias:
    ``RandomState(0)`` ids then label, sample by sample, unshuffled."""
    import numpy as np
    sys.path.insert(0, CONFIGS)
    try:
        with paddle_aliases():
            tcompat.install()
            prov = importlib.import_module("provider").process_rnn
    finally:
        sys.path.remove(CONFIGS)
    samples = list(prov.reader(vocab_size=50, maxlen=100,
                               num_samples=5)())
    rng = np.random.RandomState(0)
    for ids, label in samples:
        assert ids == rng.randint(0, 50, 100).tolist()
        assert label == int(rng.randint(2))
    assert len(samples) == 5
    assert [str(t.kind) for t in prov.settings.input_types] == \
        ["index", "index"]


def test_install_refuses_a_foreign_paddle(paddle_aliases):
    import types
    with paddle_aliases():
        sys.modules["paddle"] = types.ModuleType("paddle")
        with pytest.raises(ConfigError, match="'paddle' module the port "
                                              "did not make"):
            tcompat.install()
        del sys.modules["paddle"]
        tcompat.install()
        tcompat.install()    # idempotent while its aliases are present
        assert getattr(sys.modules["paddle"], tcompat.MARK)


def test_install_refuses_the_jax_package_aliases(paddle_aliases):
    """The trap of the shared name: the JAX package's ``paddle`` (marked
    with its own attribute) is foreign to the port."""
    from paddle_tpu import compat as jcompat
    jcompat.install()
    assert getattr(sys.modules["paddle"], "_paddle_tpu_compat")
    with pytest.raises(ConfigError, match="JAX package"):
        tcompat.install()
    with pytest.raises(ConfigError, match="will not shadow"):
        tparser.parse_config(RNN)
    assert getattr(sys.modules["paddle"], "_paddle_tpu_compat")


def test_paddle_v2_refuses_by_name(paddle_aliases):
    """``paddle.v2`` through the port's aliases is the port's ``v2``
    (deep imports too); the master it cannot build yet refuses by
    name."""
    from paddle_tpu_torch import v2 as tv2
    from paddle_tpu_torch.utils import PaddleTpuError
    with paddle_aliases():
        tcompat.install()
        assert importlib.import_module("paddle.v2") is tv2
        ns = {}
        exec("from paddle import v2", ns)
        assert ns["v2"] is tv2
        assert importlib.import_module("paddle.v2.layer") is tv2.layer
        assert importlib.import_module("paddle.v2.dataset.imdb") is \
            tv2.dataset.imdb
        with pytest.raises(PaddleTpuError, match="A9"):
            importlib.import_module("paddle.v2.master").client()
        helpers = importlib.import_module("paddle.trainer_config_helpers")
        assert helpers.fc_layer is tdsl.fc
        assert helpers.simple_lstm.__module__ == \
            "paddle_tpu_torch.v2.networks"


def test_the_alias_swap_restores_every_entry(paddle_aliases):
    before = {k: v for k, v in sys.modules.items()
              if k == "paddle" or k.startswith("paddle.")}
    with paddle_aliases():
        tcompat.install()
        assert getattr(sys.modules["paddle"], tcompat.MARK)
    after = {k: v for k, v in sys.modules.items()
             if k == "paddle" or k.startswith("paddle.")}
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] for k in before)


def test_get_config_arg_types_and_defaults(paddle_aliases):
    _port_parse(paddle_aliases, "batch_size=7,hidden_size=12")
    assert tparser.get_config_arg("batch_size", int) == 7
    assert tparser.get_config_arg("missing", int, 3) == 3
    assert tparser.parse_config_args(" a = 1, b=x,,c") == {"a": "1",
                                                           "b": "x"}


@pytest.mark.parametrize("method,reg", [
    ("MomentumOptimizer(0.8)", "L2Regularization(2e-3)"),
    ("AdamOptimizer(0.8, 0.99, 1e-6)", "L1Regularization(1e-3)"),
    ("AdamaxOptimizer(0.7, 0.9)", "L2Regularization(2e-3)"),
    ("AdaGradOptimizer()", "L1Regularization(1e-3)"),
    ("AdaDeltaOptimizer(0.9, 1e-5)", "L2Regularization(2e-3)"),
    ("RMSPropOptimizer(0.9, 1e-5)", "L1Regularization(1e-3)"),
    ("DecayedAdaGradOptimizer(0.9, 1e-5)", "L2Regularization(2e-3)")])
def test_settings_optimizers_and_regularization(paddle_aliases, tmp_path,
                                                method, reg):
    """Each of the seven optimizer settings, with L1 or L2, writes the
    same OptimizationConfig fields in both packages."""
    path = tmp_path / "c.py"
    path.write_text(
        "from paddle.trainer_config_helpers import *\n"
        f"settings(batch_size=4, learning_rate=0.1, learning_method="
        f"{method}, regularization={reg}, "
        "learning_rate_schedule='poly', learning_rate_decay_a=0.1, "
        "learning_rate_decay_b=0.5, average_window=0.5)\n"
        "x = data_layer('x', size=3)\n"
        "outputs(fc_layer(x, size=2))\n")
    _, jopt, _ = jparser.parse_config(str(path))
    with paddle_aliases():
        _, topt, _ = tparser.parse_config(str(path))
    assert dataclasses.asdict(topt) == dataclasses.asdict(jopt)


def test_config_without_outputs_refuses(paddle_aliases, tmp_path):
    path = tmp_path / "none.py"
    path.write_text("from paddle.trainer_config_helpers import *\n"
                    "x = data_layer('x', size=3)\n")
    with paddle_aliases(), pytest.raises(Exception, match="no outputs"):
        tparser.parse_config(str(path))


def test_namespace_names_match_the_jax_package():
    assert set(tparser.config_namespace()) == set(jparser.config_namespace())


def test_dump_whole_payload_is_json(paddle_aliases):
    model, opt, ds = _port_parse(paddle_aliases, "hidden_size=16")
    payload = {"model": json.loads(model.to_json()),
               "opt": dataclasses.asdict(opt),
               "data": dataclasses.asdict(ds)}
    assert json.loads(json.dumps(payload)) == payload
