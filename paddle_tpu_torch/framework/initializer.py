"""Initializers as init-op emitters (``v2/framework/initializer.py``:
Constant/Uniform/Normal/Xavier/MSRA append ops to the startup program).

Counterpart of ``paddle_tpu/framework/initializer.py``, the same code.
"""

from __future__ import annotations

import math

import numpy as np


class Initializer:
    def __call__(self, var, block) -> None:
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": [var]},
                        attrs={"shape": list(var.shape),
                               "value": self.value, "dtype": var.dtype})


class UniformInitializer(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": [var]},
                        attrs={"shape": list(var.shape), "min": self.low,
                               "max": self.high, "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": [var]},
                        attrs={"shape": list(var.shape), "mean": self.loc,
                               "std": self.scale, "seed": self.seed})


def _fan(var):
    shape = var.shape
    if len(shape) < 2:
        return shape[0] if shape else 1, shape[0] if shape else 1
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[0] * receptive, shape[1] * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None,
                 seed: int = 0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform: bool = True, fan_in=None, seed: int = 0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / fi), self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
