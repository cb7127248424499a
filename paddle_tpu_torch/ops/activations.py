"""Activation functions this slice uses (counterpart of
``paddle_tpu/ops/activations.py``), looked up by the reference's names."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..utils import PaddleTpuError


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


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return _Bf16Sigmoid.apply(x)
    return torch.sigmoid(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    # fp32 internally, as the reference
    return torch.softmax(x.float(), dim=dim).to(x.dtype)


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


def linear(x: torch.Tensor) -> torch.Tensor:
    return x


ACTIVATIONS: Dict[str, Callable] = {
    "sigmoid": sigmoid, "tanh": tanh, "relu": relu, "softmax": softmax,
    "sequence_softmax": sequence_softmax, "linear": linear, "": linear,
}


def get_activation(name: Optional[str]) -> Callable:
    if name is None:
        return linear
    if name not in ACTIVATIONS:
        raise PaddleTpuError(f"activation {name!r} is not ported; have "
                             f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]
