"""v1 config-file protocol (``config_parser.py:4208 parse_config``;
counterpart of ``paddle_tpu/config/config_parser.py``, the port's own
copy).

A reference config file does ``from paddle.trainer_config_helpers import *``
then calls ``settings(...)``, ``define_py_data_sources2(...)``, builds
layers and calls ``outputs(...)``; ``get_config_arg`` reads
``--config_args``.  This module executes such files in a namespace exposing
the port's config DSL (``compat.install`` makes the ``paddle.*`` aliases
first), producing (ModelConfig, OptimizationConfig, data sources).
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils import enforce
from . import dsl
from .model_config import OptimizationConfig


# ---------------------------------------------------------- settings DSL
class _OptSetting:
    name = "sgd"
    extra: Dict[str, Any] = {}

    def apply(self, oc: OptimizationConfig) -> None:
        oc.learning_method = self.name
        for k, v in self.extra.items():
            setattr(oc, k, v)


class MomentumOptimizer(_OptSetting):
    name = "momentum"

    def __init__(self, momentum: float = 0.9, sparse: bool = False):
        self.extra = {"momentum": momentum}


class AdamOptimizer(_OptSetting):
    name = "adam"

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.extra = {"adam_beta1": beta1, "adam_beta2": beta2,
                      "adam_epsilon": epsilon}


class AdamaxOptimizer(_OptSetting):
    name = "adamax"

    def __init__(self, beta1=0.9, beta2=0.999):
        self.extra = {"adam_beta1": beta1, "adam_beta2": beta2}


class AdaGradOptimizer(_OptSetting):
    name = "adagrad"


class AdaDeltaOptimizer(_OptSetting):
    name = "adadelta"

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.extra = {"ada_rou": rho, "ada_epsilon": epsilon}


class RMSPropOptimizer(_OptSetting):
    name = "rmsprop"

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.extra = {"ada_rou": rho, "ada_epsilon": epsilon}


class DecayedAdaGradOptimizer(_OptSetting):
    name = "decayed_adagrad"

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.extra = {"ada_rou": rho, "ada_epsilon": epsilon}


class BaseRegularization:
    rate = 0.0


class L2Regularization(BaseRegularization):
    def __init__(self, rate: float):
        self.rate = rate


class L1Regularization(BaseRegularization):
    def __init__(self, rate: float):
        self.rate = rate


@dataclass
class DataSources:
    train_list: Optional[str] = None
    test_list: Optional[str] = None
    module: Optional[str] = None
    obj: Optional[str] = None
    args: Dict[str, Any] = field(default_factory=dict)


class _ParseState(threading.local):
    def __init__(self):
        self.reset()

    def reset(self):
        self.opt = OptimizationConfig()
        self.outputs: List[dsl.LayerOutput] = []
        self.data_sources = DataSources()
        self.config_args: Dict[str, str] = {}


_state = _ParseState()


def get_config_arg(name: str, type_, default=None):
    v = _state.config_args.get(name)
    if v is None:
        return default
    if type_ is bool:
        return str(v).lower() in ("1", "true", "yes")
    return type_(v)


def settings(batch_size: int = 32, learning_rate: float = 0.01,
             learning_method: Optional[_OptSetting] = None,
             regularization: Optional[BaseRegularization] = None,
             gradient_clipping_threshold: float = 0.0,
             learning_rate_decay_a: float = 0.0,
             learning_rate_decay_b: float = 0.0,
             learning_rate_schedule: str = "constant",
             average_window: float = 0.0,
             max_average_window: int = 0,
             local_sgd_steps: int = 0, **_ignored) -> None:
    oc = _state.opt
    oc.local_sgd_steps = local_sgd_steps
    oc.batch_size = batch_size
    oc.learning_rate = learning_rate
    oc.gradient_clipping_threshold = gradient_clipping_threshold
    oc.learning_rate_decay_a = learning_rate_decay_a
    oc.learning_rate_decay_b = learning_rate_decay_b
    oc.learning_rate_schedule = learning_rate_schedule
    oc.average_window = average_window
    oc.max_average_window = max_average_window
    (learning_method or _OptSetting()).apply(oc)
    if isinstance(regularization, L2Regularization):
        oc.l2_weight_decay = regularization.rate
    elif isinstance(regularization, L1Regularization):
        oc.l1_weight_decay = regularization.rate


def outputs(*layers) -> None:
    for group in layers:
        if isinstance(group, (list, tuple)):
            _state.outputs.extend(group)
        else:
            _state.outputs.append(group)


def define_py_data_sources2(train_list, test_list, module, obj,
                            args=None) -> None:
    _state.data_sources = DataSources(train_list, test_list, module, obj,
                                      dict(args or {}))


def parse_config_args(s: str) -> Dict[str, str]:
    out = {}
    for part in (s or "").split(","):
        part = part.strip()
        if part and "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def config_namespace() -> Dict[str, Any]:
    """Names a config file sees (the ``import *`` surface)."""
    ns: Dict[str, Any] = {}
    for k in dir(dsl):
        if not k.startswith("_"):
            ns[k] = getattr(dsl, k)
    # trainer_config_helpers.networks composites (vgg.py/rnn.py use them)
    from ..v2 import networks as _networks
    for k in dir(_networks):
        if not k.startswith("_") and callable(getattr(_networks, k)) \
                and k not in ns:
            ns[k] = getattr(_networks, k)
    from . import layer_math
    ns["layer_math"] = layer_math
    # trainer/recurrent_units.py helpers (v1 config-parser level)
    from . import recurrent_units as _ru
    for k in _ru.__all__:
        ns.setdefault(k, getattr(_ru, k))
    from ..data import feeder
    for k in ("dense_vector", "integer_value", "integer_value_sequence",
              "sparse_binary_vector", "sparse_float_vector",
              "dense_vector_sequence"):
        ns[k] = getattr(feeder, k)
    ns.update(
        settings=settings, outputs=outputs, get_config_arg=get_config_arg,
        define_py_data_sources2=define_py_data_sources2,
        MomentumOptimizer=MomentumOptimizer, AdamOptimizer=AdamOptimizer,
        AdamaxOptimizer=AdamaxOptimizer, AdaGradOptimizer=AdaGradOptimizer,
        AdaDeltaOptimizer=AdaDeltaOptimizer,
        RMSPropOptimizer=RMSPropOptimizer,
        DecayedAdaGradOptimizer=DecayedAdaGradOptimizer,
        L2Regularization=L2Regularization, L1Regularization=L1Regularization,
    )
    return ns


def parse_config(config_path: str, config_args: str = ""):
    """Execute a config file → (ModelConfig, OptimizationConfig,
    DataSources).  The reference embeds CPython to do this
    (``TrainerConfigHelper`` → ``parse_config``); here it's just exec."""
    from ..compat import install as _install_compat
    _install_compat()   # 'from paddle.trainer_config_helpers import *'
    _state.reset()
    _state.config_args = parse_config_args(config_args)
    with dsl.config_scope():
        ns = config_namespace()
        ns["__file__"] = os.path.abspath(config_path)
        sys.path.insert(0, os.path.dirname(os.path.abspath(config_path)))
        try:
            with open(config_path) as f:
                code = compile(f.read(), config_path, "exec")
            exec(code, ns)
        finally:
            sys.path.pop(0)
        enforce(_state.outputs, f"config {config_path} calls no outputs()")
        model = dsl.topology(_state.outputs)
    return model, _state.opt, _state.data_sources
