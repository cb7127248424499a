"""Dense math under the precision policy (counterpart of
``paddle_tpu/ops/math_ops.py``, ``matmul`` only)."""

from __future__ import annotations

import torch

from ..core.dtypes import current_policy


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` with floating operands in the policy compute dtype and
    the result in the policy output dtype, as ``jnp.matmul(...,
    preferred_element_type=output_dtype)`` gives it.

    Where the two dtypes differ (bf16 compute, fp32 output), the
    bf16-rounded operands are multiplied in fp32: their products are
    exact in fp32 and the sum is taken in fp32, with no bf16 rounding
    of the result.  ``torch.matmul`` of two bf16 tensors would round
    the result to bf16, a different number.  Where they agree, it is
    ``torch.matmul`` in that dtype (a bf16 product accumulates in fp32
    and rounds once)."""
    pol = current_policy()
    if not x.is_floating_point():
        return x @ y
    x = x.to(pol.compute_dtype)
    y = y.to(pol.compute_dtype)
    if pol.compute_dtype == pol.output_dtype:
        return torch.matmul(x, y)
    return torch.matmul(x.to(pol.output_dtype), y.to(pol.output_dtype))
