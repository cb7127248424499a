"""Parameter updater hooks: the static pruning hook (counterpart of
``paddle_tpu/optimizer/hooks.py``).

Reference: ``paddle/parameter/ParameterUpdaterHook.cpp:39``
(``StaticPruningHook``, Han et al. magnitude pruning).  At init a mask
keeping the largest ``(1 - sparsity_ratio)`` fraction of |w| is made
from the initial (or loaded) value and applied to it; every update then
masks the gradient, so pruned weights stay zero for the whole run.  The
masks are tensors on the parameters' device; masking a gradient is one
multiply in the step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

Masks = Optional[Dict[str, torch.Tensor]]


def static_pruning_mask(value: torch.Tensor,
                        sparsity_ratio: float) -> torch.Tensor:
    """Mask keeping exactly ``int(size * (1 - ratio))`` largest-|w|
    entries, truncating like the reference's ``size_t nonZeroNum``;
    ties go to the lower flat index, as the JAX package's stable
    ``argsort`` of ``-|w|`` breaks them."""
    flat = value.detach().abs().reshape(-1)
    size = flat.shape[0]
    keep = int(size * (1.0 - sparsity_ratio))
    mask = torch.zeros((size,), dtype=value.dtype, device=value.device)
    if keep > 0:
        idx = torch.argsort(-flat, stable=True)[:keep]
        mask.index_fill_(0, idx, 1)
    return mask.reshape(value.shape)


def build_prune_masks(param_specs: Dict[str, Any],
                      params: Dict[str, torch.Tensor]) -> Masks:
    """Masks for every parameter whose spec carries a pruning hook; None
    when no parameter is hooked."""
    masks: Dict[str, torch.Tensor] = {}
    for name, spec in param_specs.items():
        for hook in getattr(spec, "update_hooks", []) or []:
            if hook.get("type") == "pruning" and name in params:
                ratio = hook.get("sparsity_ratio")
                masks[name] = static_pruning_mask(
                    params[name], 0.6 if ratio is None else float(ratio))
    return masks or None


def apply_prune_init(params: Dict[str, torch.Tensor],
                     masks: Masks) -> Dict[str, torch.Tensor]:
    """``StaticPruningHook::init``: value *= mask."""
    if not masks:
        return params
    return {n: (p * masks[n] if n in masks else p)
            for n, p in params.items()}


def apply_prune_grads(grads: Dict[str, torch.Tensor],
                      masks: Masks) -> Dict[str, torch.Tensor]:
    """``StaticPruningHook::update``: grad *= mask."""
    if not masks:
        return grads
    return {n: (g * masks[n] if n in masks else g)
            for n, g in grads.items()}
