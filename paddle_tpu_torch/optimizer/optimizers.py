"""First-order optimizers (counterpart of
``paddle_tpu/optimizer/optimizers.py``): the base ``apply`` with L1,
its lazy row masks and ``apply_rows``; the ten rules of the reference's
registry (SGD, Momentum, Adagrad, AdaDelta, RMSProp, DecayedAdagrad,
Adam, Adamax, ProximalGD, ProximalAdagrad) and ``ModelAverage``.

An :class:`Optimizer` holds static hyperparameters; ``init_state(params)``
builds ``(count, slots by name)`` and ``apply(params, grads, state, lr)``
returns new params and state.  Params are dicts of tensors; the update
is written out of place, under ``torch.no_grad``.  ``count`` is a 0-d
int32 tensor on the params' device, so a skipped mixed-precision step
can keep it with the rest of the state without a host round trip.
Each rule's slot tuple has the reference's order, shapes and dtypes, so
``(count, slots)`` flattens, parameter by sorted name, into the JAX
package's optimizer-state leaves (``trainer/checkpoint.py``).

The learning rate is a Python float; scalar factors the reference
computes in float32 from it (the per-parameter scale, L1's shrink, the
proximal rules' denominators) are rounded the same way here, on the
host, so the step makes no tensor from a host number.

``apply_rows`` is the fixed-capacity row-sparse update of one table
(the sparse gradient exchange): it updates the touched rows of the
table and of its slots IN PLACE, so a step moves O(K) rows and not the
``[V, D]`` table (the JAX version returns new arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.sparse import row_gather, row_scatter_set_
from ..utils.registry import Registry

OPTIMIZERS: Registry = Registry("optimizer")

Params = Dict[str, torch.Tensor]


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def _f32_mul(a: float, b: float) -> float:
    """The float32 product of two host numbers (the reference's scalar
    arithmetic on a float32 learning rate)."""
    return float(np.float32(a) * np.float32(b))


def _l1_shrink(p: torch.Tensor, shrink: float) -> torch.Tensor:
    """sign(p) * max(|p| - shrink, 0)."""
    return torch.sign(p) * torch.clamp(p.abs() - shrink, min=0.0)


def _mask_rows(mask, p_old, p_new, slot_old, slot_new):
    """Keep updated values only on touched rows; revert the rest (value
    and any param-shaped slot; other slots pass through)."""
    m = mask.reshape((-1,) + (1,) * (p_old.dim() - 1))
    p = torch.where(m, p_new, p_old)
    slot = tuple(
        torch.where(m, sn, so) if getattr(so, "shape", None) == p_old.shape
        else sn for so, sn in zip(slot_old, slot_new))
    return p, slot


@dataclasses.dataclass
class Optimizer:
    """Base class; subclasses define per-parameter slots and update math."""

    learning_rate: float = 0.01
    # L2 ("decay_rate"): grad += decay * param, after clipping
    weight_decay: float = 0.0
    # L1: after the rule, p = sign(p) * max(|p| - lr * l1_decay, 0)
    l1_decay: float = 0.0
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

    def _grad(self, g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Clip each element to ±threshold, then add L2 (the reference's
        order)."""
        if self.gradient_clipping_threshold > 0:
            t = self.gradient_clipping_threshold
            g = torch.clamp(g, -t, t)
        if self.weight_decay:
            g = g + self.weight_decay * p
        return g

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state,
              lr: Optional[float] = None,
              lr_scales: Optional[Dict[str, float]] = None,
              sparse_masks: Optional[Dict[str, torch.Tensor]] = None):
        """One update of every parameter.  ``sparse_masks`` (name → [V]
        bool, or None): lazy row-sparse semantics — rows outside the mask
        keep their value and their param-shaped slots bit-identical."""
        lr = _f32(self.learning_rate if lr is None else lr)
        count, slots = state
        count = count + 1
        new_p, new_slots = {}, {}
        for name, p in params.items():
            g = self._grad(grads[name], p)
            eff_lr = lr if lr_scales is None \
                else _f32_mul(lr, lr_scales[name])
            np_, ns = self._update(p, g, slots[name], eff_lr, count)
            if self.l1_decay:
                np_ = _l1_shrink(np_, _f32_mul(eff_lr, self.l1_decay))
            mask = None if sparse_masks is None else sparse_masks.get(name)
            if mask is not None:
                np_, ns = _mask_rows(mask, p, np_, slots[name], ns)
            new_p[name] = np_
            new_slots[name] = ns
        return new_p, (count, new_slots)

    @torch.no_grad()
    def apply_rows(self, table: torch.Tensor, rows: torch.Tensor,
                   row_grads: torch.Tensor, state,
                   lr: Optional[float] = None,
                   keep: Optional[torch.Tensor] = None):
        """Fixed-capacity row-sparse update of one table: gather the
        touched rows of the table and its slots, run the rule on them,
        scatter them back IN PLACE.  Right for every rule here, since
        each is elementwise.  ``rows`` ``[K]`` distinct real rows plus
        pads (-1 or >= V, dropped); ``row_grads`` ``[K, D]``; ``state =
        (count, slot tuple)`` of this table, returned with the count
        advanced.  ``keep`` (0-d bool tensor): where False the rows are
        written back unchanged (a skipped mixed-precision step).
        Returns ``(table, (count, slot))``, the same tensors."""
        lr = _f32(self.learning_rate if lr is None else lr)
        count, slot = state
        count = count + 1
        p_rows = row_gather(table, rows)
        g = self._grad(row_grads, p_rows)
        param_shaped = [getattr(s, "shape", None) == table.shape
                        for s in slot]
        slot_rows = tuple(row_gather(s, rows) if ps else s
                          for s, ps in zip(slot, param_shaped))
        np_, ns = self._update(p_rows, g, slot_rows, lr, count)
        if self.l1_decay:
            np_ = _l1_shrink(np_, _f32_mul(lr, self.l1_decay))
        if keep is not None:
            np_ = torch.where(keep, np_, p_rows)
            ns = tuple(torch.where(keep, n, o) for n, o in zip(ns, slot_rows))
        row_scatter_set_(table, rows, np_)
        new_slot = tuple(row_scatter_set_(s, rows, n) if ps else n
                         for s, n, ps in zip(slot, ns, param_shaped))
        return table, (count, new_slot)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


@OPTIMIZERS.register("sgd")
@dataclasses.dataclass
class SGD(Optimizer):
    """Plain SGD (``SgdOptimizer``), the config's default method."""

    def _update(self, p, g, slot, lr, count):
        return (p - lr * g).to(p.dtype), slot


@OPTIMIZERS.register("momentum")
@dataclasses.dataclass
class Momentum(Optimizer):
    """Momentum SGD (``sgdUpdate`` in TrainingAlgorithmOp.h):
    v = mom*v - lr*g ; p += v."""

    momentum: float = 0.9

    def _init_slot(self, p):
        return (torch.zeros_like(p),)

    def _update(self, p, g, slot, lr, count):
        (v,) = slot
        v = self.momentum * v - lr * g
        return (p + v).to(p.dtype), (v,)


@OPTIMIZERS.register("adagrad")
@dataclasses.dataclass
class Adagrad(Optimizer):
    """``AdagradOptimizer``: accum += g^2; p -= lr*g/(sqrt(accum)+eps)."""

    epsilon: float = 1e-6

    def _init_slot(self, p):
        return (_zeros(p),)

    def _update(self, p, g, slot, lr, count):
        (acc,) = slot
        acc = acc + g * g
        step = lr * g / (torch.sqrt(acc) + self.epsilon)
        return (p - step).to(p.dtype), (acc,)


@OPTIMIZERS.register("adadelta")
@dataclasses.dataclass
class AdaDelta(Optimizer):
    """``AdaDeltaOptimizer`` (rou/epsilon as in adadeltaApply)."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def _init_slot(self, p):
        return (_zeros(p), _zeros(p))

    def _update(self, p, g, slot, lr, count):
        eg2, edx2 = slot
        eg2 = self.rho * eg2 + (1 - self.rho) * (g * g)
        dx = torch.sqrt((edx2 + self.epsilon) / (eg2 + self.epsilon)) * g
        edx2 = self.rho * edx2 + (1 - self.rho) * (dx * dx)
        return (p - lr * dx).to(p.dtype), (eg2, edx2)


@OPTIMIZERS.register("rmsprop")
@dataclasses.dataclass
class RMSProp(Optimizer):
    """``RMSPropOptimizer``, the centered variant the reference
    implements (keeps E[g] as well as E[g^2]; rmspropApply)."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def _init_slot(self, p):
        return (_zeros(p), _zeros(p))

    def _update(self, p, g, slot, lr, count):
        eg2, eg = slot
        eg2 = self.rho * eg2 + (1 - self.rho) * (g * g)
        eg = self.rho * eg + (1 - self.rho) * g
        step = lr * g / torch.sqrt(eg2 - eg * eg + self.epsilon)
        return (p - step).to(p.dtype), (eg2, eg)


@OPTIMIZERS.register("decayed_adagrad")
@dataclasses.dataclass
class DecayedAdagrad(Optimizer):
    """``DecayedAdagradOptimizer``: like RMSProp without centering."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def _init_slot(self, p):
        return (_zeros(p),)

    def _update(self, p, g, slot, lr, count):
        (acc,) = slot
        acc = self.rho * acc + (1 - self.rho) * (g * g)
        step = lr * g / torch.sqrt(acc + self.epsilon)
        return (p - step).to(p.dtype), (acc,)


@OPTIMIZERS.register("adam")
@dataclasses.dataclass
class Adam(Optimizer):
    """``AdamOptimizer`` (adamApply): bias-corrected moments."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def _init_slot(self, p):
        return (_zeros(p), _zeros(p))

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


@OPTIMIZERS.register("adamax")
@dataclasses.dataclass
class Adamax(Optimizer):
    """``AdamaxOptimizer`` (adamaxApply): infinity-norm second moment."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def _init_slot(self, p):
        return (_zeros(p), _zeros(p))

    def _update(self, p, g, slot, lr, count):
        m, u = slot
        g32 = g.float()
        m = self.beta1 * m + (1 - self.beta1) * g32
        u = torch.maximum(self.beta2 * u, g32.abs())
        t = count.to(torch.float32)
        # lr / (1 - beta1^t) as a true division, as the reference has it
        step = torch.div(lr, 1 - self.beta1 ** t) * m / (u + self.epsilon)
        return (p - step).to(p.dtype), (m, u)


@OPTIMIZERS.register("proximal_gd")
@dataclasses.dataclass
class ProximalGD(Optimizer):
    """``proximal_gd_op``: SGD + proximal L1/L2 shrinkage."""

    l1: float = 0.0
    l2: float = 0.0

    def _update(self, p, g, slot, lr, count):
        prox = p - lr * g
        if self.l1:
            prox = _l1_shrink(prox, _f32_mul(lr, self.l1))
        den = float(np.float32(1.0) + np.float32(lr) * np.float32(self.l2))
        return (prox / den).to(p.dtype), slot


@OPTIMIZERS.register("proximal_adagrad")
@dataclasses.dataclass
class ProximalAdagrad(Optimizer):
    """``proximal_adagrad_op``."""

    l1: float = 0.0
    l2: float = 0.0
    epsilon: float = 1e-6

    def _init_slot(self, p):
        return (_zeros(p),)

    def _update(self, p, g, slot, lr, count):
        (acc,) = slot
        acc = acc + g * g
        eff = torch.div(lr, torch.sqrt(acc) + self.epsilon)
        prox = p - eff * g
        if self.l1:
            prox = torch.sign(prox) * torch.clamp(
                prox.abs() - eff * self.l1, min=0.0)
        return (prox / (1.0 + eff * self.l2)).to(p.dtype), (acc,)


@dataclasses.dataclass
class ModelAverage:
    """Parameter averaging over a sliding window (``AverageOptimizer.h``
    / v2 ``ModelAverage``): a running sum and a count; ``average(state)``
    gives the eval-time parameters.  The window restarts when the count
    passes ``max_average_window``."""

    average_window: float = 0.5
    max_average_window: int = 10000

    def init(self, params: Params) -> dict:
        dev = next(iter(params.values())).device if params else "cpu"
        return {"sum": {n: p.detach().float() for n, p in params.items()},
                "count": torch.ones((), dtype=torch.float32, device=dev)}

    @torch.no_grad()
    def accumulate(self, state: dict, params: Params) -> dict:
        count = state["count"] + 1
        reset = count > self.max_average_window
        new_sum = {n: torch.where(reset, params[n].float(),
                                  s + params[n].float())
                   for n, s in state["sum"].items()}
        return {"sum": new_sum,
                "count": torch.where(reset, torch.ones_like(count), count)}

    @torch.no_grad()
    def average(self, state: dict) -> Params:
        return {n: s / state["count"] for n, s in state["sum"].items()}


def create_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS.create(name, **kw)
