"""``paddle.v2.optimizer`` (counterpart of ``paddle_tpu/v2/optimizer.py``).

Reference: ``python/paddle/v2/optimizer.py`` — optimizer objects carrying
an ``OptimizationConfig``, consumed by the trainer (``create_updater``
chose local or remote updaters; the port has the local one,
``trainer.optimizer_from_config``).  The same keywords give the same
config as the JAX package's classes.
"""

from __future__ import annotations

from typing import Optional

from ..config.model_config import OptimizationConfig


class Optimizer:
    method = "sgd"

    def __init__(self, learning_rate: float = 0.01,
                 learning_rate_schedule: str = "constant",
                 learning_rate_decay_a: float = 0.0,
                 learning_rate_decay_b: float = 0.0,
                 learning_rate_args: str = "",
                 regularization=None,
                 gradient_clipping_threshold: float = 0.0,
                 model_average=None, batch_size: int = 32, **kw):
        self.conf = OptimizationConfig(
            batch_size=batch_size,
            learning_rate=learning_rate,
            learning_method=self.method,
            learning_rate_schedule=learning_rate_schedule,
            learning_rate_decay_a=learning_rate_decay_a,
            learning_rate_decay_b=learning_rate_decay_b,
            learning_rate_args=learning_rate_args,
            gradient_clipping_threshold=gradient_clipping_threshold,
        )
        if regularization is not None:
            self.conf.l2_weight_decay = getattr(regularization, "l2", 0.0)
            self.conf.l1_weight_decay = getattr(regularization, "l1", 0.0)
        if model_average is not None:
            self.conf.average_window = model_average.average_window
            self.conf.max_average_window = model_average.max_average_window
        for k, v in kw.items():
            if hasattr(self.conf, k):
                setattr(self.conf, k, v)


class SGD(Optimizer):
    method = "sgd"


class Momentum(Optimizer):
    method = "momentum"

    def __init__(self, momentum: float = 0.9, **kw):
        super().__init__(**kw)
        self.conf.momentum = momentum


class Adam(Optimizer):
    method = "adam"

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, **kw):
        super().__init__(**kw)
        self.conf.adam_beta1 = beta1
        self.conf.adam_beta2 = beta2
        self.conf.adam_epsilon = epsilon


class Adamax(Optimizer):
    method = "adamax"

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999, **kw):
        super().__init__(**kw)
        self.conf.adam_beta1 = beta1
        self.conf.adam_beta2 = beta2


class AdaGrad(Optimizer):
    method = "adagrad"


class DecayedAdaGrad(Optimizer):
    method = "decayed_adagrad"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.conf.ada_rou = rho
        self.conf.ada_epsilon = epsilon


class AdaDelta(Optimizer):
    method = "adadelta"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.conf.ada_rou = rho
        self.conf.ada_epsilon = epsilon


class RMSProp(Optimizer):
    method = "rmsprop"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.conf.ada_rou = rho
        self.conf.ada_epsilon = epsilon


class L2Regularization:
    def __init__(self, rate: float):
        self.l2 = rate
        self.l1 = 0.0


class L1Regularization:
    def __init__(self, rate: float):
        self.l1 = rate
        self.l2 = 0.0


class ModelAverage:
    def __init__(self, average_window: float = 0.5,
                 max_average_window: int = 10000):
        self.average_window = average_window
        self.max_average_window = max_average_window
