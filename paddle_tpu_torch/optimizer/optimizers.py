"""First-order optimizers (counterpart of
``paddle_tpu/optimizer/optimizers.py``; the base ``apply`` with its lazy
row masks, ``apply_rows``, SGD and Adam).

An :class:`Optimizer` holds static hyperparameters; ``init_state(params)``
builds ``(count, slots by name)`` and ``apply(params, grads, state, lr)``
returns new params and state.  Params are dicts of tensors; the update
is written out of place, under ``torch.no_grad``.  ``count`` is a 0-d
int32 tensor on the params' device, so a skipped mixed-precision step
can keep it with the rest of the state without a host round trip.

``apply_rows`` is the fixed-capacity row-sparse update of one table
(the sparse gradient exchange): it updates the touched rows of the
table and of its slots IN PLACE, so a step moves O(K) rows and not the
``[V, D]`` table (the JAX version returns new arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..parallel.sparse import row_gather, row_scatter_set_
from ..utils import PaddleTpuError

Params = Dict[str, torch.Tensor]


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
        lr = self.learning_rate if lr is None else lr
        count, slots = state
        count = count + 1
        new_p, new_slots = {}, {}
        for name, p in params.items():
            g = self._grad(grads[name], p)
            eff_lr = lr if lr_scales is None else lr * lr_scales[name]
            np_, ns = self._update(p, g, slots[name], eff_lr, count)
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
        lr = self.learning_rate if lr is None else lr
        count, slot = state
        count = count + 1
        p_rows = row_gather(table, rows)
        g = self._grad(row_grads, p_rows)
        param_shaped = [getattr(s, "shape", None) == table.shape
                        for s in slot]
        slot_rows = tuple(row_gather(s, rows) if ps else s
                          for s, ps in zip(slot, param_shaped))
        np_, ns = self._update(p_rows, g, slot_rows, lr, count)
        if keep is not None:
            np_ = torch.where(keep, np_, p_rows)
            ns = tuple(torch.where(keep, n, o) for n, o in zip(ns, slot_rows))
        row_scatter_set_(table, rows, np_)
        new_slot = tuple(row_scatter_set_(s, rows, n) if ps else n
                         for s, n, ps in zip(slot, ns, param_shaped))
        return table, (count, new_slot)


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
