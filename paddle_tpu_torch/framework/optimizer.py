"""Optimizers building update ops (``python/paddle/v2/framework/optimizer.py``;
counterpart of ``paddle_tpu/framework/optimizer.py``, the same code):
``minimize`` = append_backward + per-parameter accumulator creation +
optimizer ops, all in the main program's global block; the Executor runs
the ops after the backward under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .backward import append_backward
from .initializer import ConstantInitializer
from .program import Program, Variable, default_main_program, \
    default_startup_program, unique_name
from .regularizer import append_regularization_ops


class Optimizer:
    op_type = ""

    def __init__(self, learning_rate: float = 0.01,
                 global_step: Optional[Variable] = None,
                 regularization=None):
        self.learning_rate = learning_rate
        self.global_step = global_step
        self.regularization = regularization
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    # -------------------------------------------------------- helpers
    def _lr_var(self, block) -> Variable:
        name = unique_name("learning_rate")
        v = block.create_parameter(name, shape=(), dtype="float32")
        v.trainable = False
        sp = default_startup_program().global_block
        sv = sp.create_parameter(name, shape=(), dtype="float32")
        ConstantInitializer(self.learning_rate)(sv, sp)
        return v

    def _acc(self, block, param: Variable, name: str,
             fill: float = 0.0, shape=None) -> Variable:
        key = f"{param.name}_{name}"
        if key in self._accumulators:
            return self._accumulators[key]
        v = block.create_parameter(key, shape=shape or param.shape,
                                   dtype=param.dtype)
        v.trainable = False
        sp = default_startup_program().global_block
        sv = sp.create_parameter(key, shape=shape or param.shape,
                                 dtype=param.dtype)
        ConstantInitializer(fill)(sv, sp)
        self._accumulators[key] = v
        return v

    def _append_update(self, block, param, grad, lr) -> None:
        raise NotImplementedError

    def _increment_global_step(self, block):
        if self.global_step is not None:
            block.append_op("increment",
                            inputs={"X": [self.global_step]},
                            outputs={"Out": [self.global_step]},
                            attrs={"step": 1.0})

    # ----------------------------------------------------------- api
    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None) -> List:
        program = loss.block.program if loss.block else \
            default_main_program()
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       program)
        params_grads = append_regularization_ops(
            params_grads, self.regularization, program)
        block = program.global_block
        lr = self._lr_var(block)
        for p, g in params_grads:
            self._append_update(block, p, g, lr)
        self._increment_global_step(block)
        return params_grads


class SGDOptimizer(Optimizer):
    op_type = "sgd"

    def _append_update(self, block, p, g, lr):
        block.append_op("sgd",
                        inputs={"Param": [p], "Grad": [g],
                                "LearningRate": [lr]},
                        outputs={"ParamOut": [p]})


class MomentumOptimizer(Optimizer):
    op_type = "momentum"

    def __init__(self, learning_rate=0.01, momentum=0.9,
                 use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _append_update(self, block, p, g, lr):
        vel = self._acc(block, p, "velocity")
        block.append_op("momentum",
                        inputs={"Param": [p], "Grad": [g],
                                "Velocity": [vel], "LearningRate": [lr]},
                        outputs={"ParamOut": [p], "VelocityOut": [vel]},
                        attrs={"mu": self.momentum,
                               "use_nesterov": self.use_nesterov})


class AdagradOptimizer(Optimizer):
    op_type = "adagrad"

    def __init__(self, learning_rate=0.01, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon

    def _append_update(self, block, p, g, lr):
        mom = self._acc(block, p, "moment")
        block.append_op("adagrad",
                        inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                                "LearningRate": [lr]},
                        outputs={"ParamOut": [p], "MomentOut": [mom]},
                        attrs={"epsilon": self.epsilon})


class AdamOptimizer(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _append_update(self, block, p, g, lr):
        m1 = self._acc(block, p, "moment1")
        m2 = self._acc(block, p, "moment2")
        b1p = self._acc(block, p, "beta1_pow", fill=1.0, shape=())
        b2p = self._acc(block, p, "beta2_pow", fill=1.0, shape=())
        block.append_op(
            "adam",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [lr],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1],
                     "Moment2Out": [m2]},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon})
        # advance beta powers
        block.append_op("scale", inputs={"X": [b1p]},
                        outputs={"Out": [b1p]},
                        attrs={"scale": self.beta1})
        block.append_op("scale", inputs={"X": [b2p]},
                        outputs={"Out": [b2p]},
                        attrs={"scale": self.beta2})


class AdamaxOptimizer(Optimizer):
    op_type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _append_update(self, block, p, g, lr):
        m = self._acc(block, p, "moment")
        u = self._acc(block, p, "inf_norm")
        b1p = self._acc(block, p, "beta1_pow", fill=1.0, shape=())
        block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [lr],
                    "Moment": [m], "InfNorm": [u], "Beta1Pow": [b1p]},
            outputs={"ParamOut": [p], "MomentOut": [m],
                     "InfNormOut": [u]},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon})
        block.append_op("scale", inputs={"X": [b1p]},
                        outputs={"Out": [b1p]},
                        attrs={"scale": self.beta1})


class AdadeltaOptimizer(Optimizer):
    op_type = "adadelta"

    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def _append_update(self, block, p, g, lr):
        ag = self._acc(block, p, "avg_squared_grad")
        au = self._acc(block, p, "avg_squared_update")
        block.append_op(
            "adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [ag],
                    "AvgSquaredUpdate": [au]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [ag],
                     "AvgSquaredUpdateOut": [au]},
            attrs={"rho": self.rho, "epsilon": self.epsilon})


class DecayedAdagradOptimizer(Optimizer):
    op_type = "decayed_adagrad"

    def __init__(self, learning_rate=0.01, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def _append_update(self, block, p, g, lr):
        mom = self._acc(block, p, "moment")
        block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [p], "MomentOut": [mom]},
            attrs={"decay": self.decay, "epsilon": self.epsilon})


class RMSPropOptimizer(Optimizer):
    op_type = "rmsprop"

    def __init__(self, learning_rate=0.01, decay=0.95, momentum=0.0,
                 epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.momentum, self.epsilon = decay, momentum, epsilon

    def _append_update(self, block, p, g, lr):
        ms = self._acc(block, p, "mean_square")
        mom = self._acc(block, p, "moment")
        block.append_op(
            "rmsprop",
            inputs={"Param": [p], "Grad": [g], "MeanSquare": [ms],
                    "Moment": [mom], "LearningRate": [lr]},
            outputs={"ParamOut": [p], "MeanSquareOut": [ms],
                     "MomentOut": [mom]},
            attrs={"decay": self.decay, "momentum": self.momentum,
                   "epsilon": self.epsilon})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
RMSProp = RMSPropOptimizer
