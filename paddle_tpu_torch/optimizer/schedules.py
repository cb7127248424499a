"""Learning-rate schedules (counterpart of
``paddle_tpu/optimizer/schedules.py``).

Reference: ``paddle/parameter/LearningRateScheduler.cpp:50-172``:
schedules are keyed by the number of samples processed (``pass_manual``
too, as the JAX package keys it).  The JAX trainer evaluates them in
float32 on ``progress = float32(samples_seen)``; here they are computed
on the host in numpy float32, at the same points and with the same
roundings, and handed to the step as a Python float, so the step makes
no tensor from a host number (on CUDA that is a blocking copy).  XLA
flushes subnormal float32 results to zero; so do these functions, after
each power and product.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

from ..utils import PaddleTpuError
from ..utils.registry import Registry

SCHEDULES: Registry = Registry("lr schedule")

_F = np.float32
_TINY = np.finfo(np.float32).tiny


def _ftz(x):
    """``x`` with a subnormal value flushed to zero, as XLA computes."""
    x = _F(x)
    return _F(0.0) * x if abs(x) < _TINY else x


def _pow(a, b):
    with np.errstate(invalid="ignore", over="ignore", under="ignore"):
        return _ftz(np.power(_F(a), _F(b)))


def _reg(name):
    def deco(fn):
        SCHEDULES.register_value(name, fn)
        return fn

    return deco


@_reg("constant")
def constant(base_lr, num_samples, a=0.0, b=0.0):
    return _F(base_lr)


@_reg("poly")
def poly(base_lr, num_samples, a=1.0, b=0.0):
    """lr * (1 + a*n)^(-b)  (reference 'poly': a=gamma, b=power)."""
    return _ftz(_F(base_lr) * _pow(_F(1.0) + _F(a) * _F(num_samples), -b))


@_reg("caffe_poly")
def caffe_poly(base_lr, num_samples, a=1.0, b=0.0):
    """lr * (1 - n/a)^b  (a=max steps, b=power)."""
    return _ftz(_F(base_lr) * _pow(_F(1.0) - _F(num_samples) / _F(a), b))


@_reg("exp")
def exp(base_lr, num_samples, a=0.5, b=1.0):
    """lr * a^(n/b)."""
    return _ftz(_F(base_lr) * _pow(a, _F(num_samples) / _F(b)))


@_reg("discexp")
def discexp(base_lr, num_samples, a=0.5, b=1.0):
    """lr * a^floor(n/b)."""
    return _ftz(_F(base_lr) * _pow(a, np.floor(_F(num_samples) / _F(b))))


@_reg("linear")
def linear(base_lr, num_samples, a=0.0, b=0.0):
    """max(lr - a*n, b)."""
    return np.maximum(_F(base_lr) - _F(a) * _F(num_samples), _F(b))


def parse_manual_spec(spec: str) -> Tuple[Sequence[float], Sequence[float]]:
    """Parse 'seg0:lr0,seg1:lr1,...' (learning_rate_args for manual modes)."""
    bounds, rates = [], []
    for part in spec.split(","):
        if not part.strip():
            continue
        seg, lr = part.split(":")
        bounds.append(float(seg))
        rates.append(float(lr))
    return bounds, rates


def manual(base_lr, progress, spec: str):
    """The rate of the first segment whose bound ``progress`` is below,
    times ``base_lr``; the last segment's past every bound.  The last
    rate is a float32 product, the others a double product rounded to
    float32, as the reference's ``jnp.where`` of a Python product gives
    them."""
    bounds, rates = parse_manual_spec(spec)
    p = _F(progress)
    lr = _F(rates[-1]) * _F(base_lr)
    for bound, rate in zip(reversed(bounds[:-1]), reversed(rates[:-1])):
        if p < _F(bound):
            lr = _F(rate * base_lr)
    if p < _F(bounds[0]):
        lr = _F(rates[0] * base_lr)
    return lr


SCHEDULES.register_value("manual", manual)
SCHEDULES.register_value("pass_manual", manual)


def make_schedule(name: str = "constant", base_lr: float = 0.01,
                  decay_a: float = 0.0, decay_b: float = 0.0,
                  args: str = "") -> Callable[[float], float]:
    """lr(num_samples) from the config fields (learning_rate_schedule /
    learning_rate_decay_a/_b / learning_rate_args), as a Python float
    (a float32 value)."""
    name = name or "constant"
    if name not in SCHEDULES:
        raise PaddleTpuError(f"unknown learning_rate_schedule {name!r}")
    fn = SCHEDULES.get(name)
    if name in ("manual", "pass_manual"):
        return lambda progress: float(fn(base_lr, progress, args))
    kw = {}
    if decay_a:
        kw["a"] = decay_a
    if decay_b:
        kw["b"] = decay_b
    return lambda progress: float(fn(base_lr, progress, **kw))
