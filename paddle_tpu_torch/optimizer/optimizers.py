"""First-order optimizers (counterpart of
``paddle_tpu/optimizer/optimizers.py``; the base ``apply``, SGD and
Adam).

An :class:`Optimizer` holds static hyperparameters; ``init_state(params)``
builds ``(count, slots by name)`` and ``apply(params, grads, state, lr)``
returns new params and state.  Params are dicts of tensors; the update
is written out of place, under ``torch.no_grad``.  ``count`` is a 0-d
int32 tensor on the params' device, so a skipped mixed-precision step
can keep it with the rest of the state without a host round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..utils import PaddleTpuError

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Optimizer:
    """Base class; subclasses define per-parameter slots and update math."""

    learning_rate: float = 0.01
    # L2 ("decay_rate"): grad += decay * param, after clipping
    weight_decay: float = 0.0
    gradient_clipping_threshold: float = 0.0

    def _init_slot(self, p: torch.Tensor) -> tuple:
        return ()

    def _update(self, p, g, slot, lr, count):
        raise NotImplementedError

    def init_state(self, params: Params
                   ) -> Tuple[torch.Tensor, Dict[str, tuple]]:
        dev = next(iter(params.values())).device if params else "cpu"
        return (torch.zeros((), dtype=torch.int32, device=dev),
                {n: self._init_slot(p) for n, p in params.items()})

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state,
              lr: Optional[float] = None,
              lr_scales: Optional[Dict[str, float]] = None):
        """One update: clip each element to ±threshold, then add L2, then
        the rule's step (the reference's order)."""
        lr = self.learning_rate if lr is None else lr
        count, slots = state
        count = count + 1
        new_p, new_slots = {}, {}
        for name, p in params.items():
            g = grads[name]
            if self.gradient_clipping_threshold > 0:
                t = self.gradient_clipping_threshold
                g = torch.clamp(g, -t, t)
            if self.weight_decay:
                g = g + self.weight_decay * p
            eff_lr = lr if lr_scales is None else lr * lr_scales[name]
            np_, ns = self._update(p, g, slots[name], eff_lr, count)
            new_p[name] = np_
            new_slots[name] = ns
        return new_p, (count, new_slots)


@dataclasses.dataclass
class SGD(Optimizer):
    """Plain SGD (``SgdOptimizer``), the config's default method."""

    def _update(self, p, g, slot, lr, count):
        return (p - lr * g).to(p.dtype), slot


@dataclasses.dataclass
class Adam(Optimizer):
    """``AdamOptimizer`` (adamApply): bias-corrected moments."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def _init_slot(self, p):
        return (torch.zeros_like(p, dtype=torch.float32),
                torch.zeros_like(p, dtype=torch.float32))

    def _update(self, p, g, slot, lr, count):
        m, v = slot
        g32 = g.float()
        m = self.beta1 * m + (1 - self.beta1) * g32
        v = self.beta2 * v + (1 - self.beta2) * g32 * g32
        # bias corrections in fp32, as the reference computes them, on
        # the count's device: a tensor made from a Python float on the
        # card would be a blocking copy
        t = count.to(torch.float32)
        c1 = 1 - self.beta1 ** t
        c2 = 1 - self.beta2 ** t
        step = lr * (m / c1) / (torch.sqrt(v / c2) + self.epsilon)
        return (p - step).to(p.dtype), (m, v)


OPTIMIZERS = {"sgd": SGD, "adam": Adam}


def create_optimizer(name: str, **kw) -> Optimizer:
    if name not in OPTIMIZERS:
        raise PaddleTpuError(f"optimizer {name!r} is not ported; have "
                             f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](**kw)
