"""Dynamic loss scaling for the ``--precision=bf16`` training step
(counterpart of ``paddle_tpu/optimizer/loss_scale.py``).

Multiply the loss by a scale before the backward pass, divide the
gradients by it in fp32 afterwards, and adapt the scale: grow 2x after
``growth_interval`` overflow-free steps (at most 2^24), halve (at least
1.0) and skip the update when any gradient is non-finite, leaving
parameters and optimizer state bit-identical.

The state is three 0-d tensors on the training device, and every
function here is tensor arithmetic with no branch on a tensor's value,
so a step never waits for the device to decide.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import torch

from ..core.device import resolve_device
from ..utils import FLAGS

GROWTH_FACTOR = 2.0
BACKOFF_FACTOR = 0.5
MIN_SCALE = 1.0
# without a ceiling a long clean run doubles the fp32 scale to inf, after
# which every step skips and backoff (inf * 0.5) never recovers
MAX_SCALE = float(2 ** 24)


class LossScaleState(NamedTuple):
    scale: torch.Tensor          # f32: the current multiplier
    growth_count: torch.Tensor   # i32: overflow-free steps since a change
    skipped_total: torch.Tensor  # i32: skipped steps so far


def init_state(device: Optional[Union[str, torch.device]] = None
               ) -> LossScaleState:
    """Fresh state from ``--loss_scale_init`` on ``device`` (default
    CUDA; raises when CUDA is absent and the CPU was not asked for)."""
    device = resolve_device(device)
    return LossScaleState(
        scale=torch.tensor(float(FLAGS.get("loss_scale_init")),
                           dtype=torch.float32, device=device),
        growth_count=torch.zeros((), dtype=torch.int32, device=device),
        skipped_total=torch.zeros((), dtype=torch.int32, device=device))


def all_finite(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor: every float gradient is finite."""
    flags = [torch.isfinite(g).all() for g in grads.values()
             if g.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def unscale(grads: Dict[str, torch.Tensor], scale: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
    """Gradients / scale, in fp32 (the master-gradient dtype)."""
    inv = (1.0 / scale).to(torch.float32)
    return {n: g.to(torch.float32) * inv if g.is_floating_point() else g
            for n, g in grads.items()}


def update(state: LossScaleState, finite: torch.Tensor,
           growth_interval: Optional[int] = None) -> LossScaleState:
    """The scale after a step whose gradients were ``finite``."""
    if growth_interval is None:
        growth_interval = FLAGS.get("loss_scale_growth_interval")
    count = state.growth_count + 1
    grow = count >= int(growth_interval)
    grown = torch.where(grow, torch.clamp(state.scale * GROWTH_FACTOR,
                                          max=MAX_SCALE), state.scale)
    backed_off = torch.clamp(state.scale * BACKOFF_FACTOR, min=MIN_SCALE)
    zero = torch.zeros_like(count)
    return LossScaleState(
        scale=torch.where(finite, grown, backed_off),
        growth_count=torch.where(finite, torch.where(grow, zero, count),
                                 zero),
        skipped_total=state.skipped_total + (~finite).to(torch.int32))


def select(finite: torch.Tensor, updated, previous):
    """``updated`` where the step was finite, else ``previous``,
    elementwise over matching (nested) dicts, tuples and tensors — a
    skipped step's state stays bit-identical."""
    if isinstance(updated, dict):
        return {k: select(finite, updated[k], previous[k]) for k in updated}
    if isinstance(updated, (tuple, list)):
        return type(updated)(select(finite, u, p)
                             for u, p in zip(updated, previous))
    return torch.where(finite, updated, previous)
