"""Activation functions (counterpart of ``paddle_tpu/ops/activations.py``):
the 28 of the reference's two activation surfaces, the gserver registry
(``paddle/gserver/activations/ActivationFunction.cpp``) and the
activation op family (``paddle/operators/activation_op.cc``), under the
reference's names and aliases and with its default arguments.  Each is
also registered as an op."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..utils.registry import Registry
from .registry import register_op

ACTIVATIONS: Registry = Registry("activation")


def _act(name: str, *aliases: str):
    def deco(fn):
        ACTIVATIONS.register_value(name, fn, *aliases)
        register_op(name)(fn)
        return fn

    return deco


class _Bf16Sigmoid(torch.autograd.Function):
    """Sigmoid of a bf16 tensor with the reference's roundings.  XLA's CPU
    backend lowers ``jax.nn.sigmoid`` (``lax.logistic``) of a bf16 array
    to 1 / (1 + exp(-x)) with a bf16 rounding after each op, and JAX
    differentiates it as g * (y * (1 - y)); ``torch.sigmoid`` rounds
    once, which leaves a third of the values one bf16 ulp away and, over
    a recurrence, bf16 scans up to 1.6e-2 apart."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (y * (1.0 - y))


@_act("sigmoid")
def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return _Bf16Sigmoid.apply(x)
    return torch.sigmoid(x)


@_act("logsigmoid")
def logsigmoid(x):
    return F.logsigmoid(x)


@_act("exp", "exponential")
def exp(x):
    return torch.exp(x)


class _Relu(torch.autograd.Function):
    """``torch.relu`` differentiated as ``jax.nn.relu`` is: the gradient
    passes where the output is > 0 and is 0 elsewhere, NaN inputs
    included (``torch.relu``'s own backward passes a NaN row's gradient,
    so one non-finite step made every later gradient NaN where the JAX
    package recovers, and the training-health report differed from the
    reference's).  Its backward is a Python call and two kernels where
    ``torch.relu``'s is one (its cost on the card: PERF.md §6)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.relu(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return torch.where(y > 0, g, 0.0)


@_act("relu")
def relu(x):
    return _Relu.apply(x)


@_act("tanh")
def tanh(x):
    return torch.tanh(x)


@_act("tanh_shrink")
def tanh_shrink(x):
    return x - torch.tanh(x)


@_act("sqrt")
def sqrt(x):
    return torch.sqrt(x)


@_act("abs")
def abs_(x):
    return torch.abs(x)


@_act("reciprocal")
def reciprocal(x):
    return 1.0 / x


@_act("log")
def log(x):
    return torch.log(x)


@_act("square")
def square(x):
    return torch.square(x)


@_act("brelu")
def brelu(x, t_min: float = 0.0, t_max: float = 24.0):
    return torch.clamp(x, t_min, t_max)


@_act("soft_relu", "softrelu")
def soft_relu(x, threshold: float = 40.0):
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


@_act("pow")
def pow_(x, factor: float = 1.0):
    return torch.pow(x, factor)


@_act("stanh")
def stanh(x, scale_a: float = 2.0 / 3.0, scale_b: float = 1.7159):
    return scale_b * torch.tanh(scale_a * x)


@_act("softplus")
def softplus(x):
    # log(1 + e^x) as jax.nn.softplus (logaddexp(x, 0)): F.softplus
    # returns x itself past its threshold
    return torch.logaddexp(x, torch.zeros_like(x))


@_act("softsign")
def softsign(x):
    return x / (1.0 + torch.abs(x))


@_act("leaky_relu")
def leaky_relu(x, alpha: float = 0.02):
    return torch.where(x >= 0, x, alpha * x)


@_act("elu")
def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha)


@_act("relu6")
def relu6(x, threshold: float = 6.0):
    return torch.clamp(x, 0.0, threshold)


@_act("hard_shrink")
def hard_shrink(x, threshold: float = 0.5):
    return torch.where(torch.abs(x) > threshold, x, 0.0)


@_act("softshrink")
def softshrink(x, lambda_: float = 0.5):
    return torch.where(x > lambda_, x - lambda_,
                       torch.where(x < -lambda_, x + lambda_, 0.0))


@_act("thresholded_relu")
def thresholded_relu(x, threshold: float = 1.0):
    return torch.where(x > threshold, x, 0.0)


@_act("hard_sigmoid")
def hard_sigmoid(x, slope: float = 0.2, offset: float = 0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@_act("swish")
def swish(x, beta: float = 1.0):
    return x * sigmoid(beta * x)


@_act("linear", "identity", "")
def linear(x):
    return x


@_act("softmax")
def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    # fp32 internally, as the reference
    return torch.softmax(x.float(), dim=axis).to(x.dtype)


@_act("sequence_softmax")
def sequence_softmax(x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax over the time axis of a padded ``[B, T]`` (or ``[B, T,
    1]``) batch, in x's dtype; padded positions (``mask`` 0) get 0
    (the reference's per-sequence ``SequenceSoftmaxActivation``)."""
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    if squeeze:
        x = x[..., 0]
    if mask is not None:
        x = torch.where(mask > 0, x, float("-inf"))
    out = torch.softmax(x, dim=-1)
    if mask is not None:
        out = torch.where(mask > 0, out, 0.0)
    return out[..., None] if squeeze else out


def get_activation(name: Optional[str]) -> Callable:
    """The activation registered as ``name`` (None: linear); an unknown
    name raises, naming it."""
    if name is None:
        return linear
    return ACTIVATIONS.get(name)
