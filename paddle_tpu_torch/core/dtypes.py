"""Precision policy (counterpart of ``paddle_tpu/core/dtypes.py``, its
policy part).

A :class:`Policy` carries the three dtypes of mixed precision (param,
compute, output); ops and layers read :func:`current_policy` instead of
hard-coding dtypes.  The resolution order is the JAX package's: an open
:func:`policy_scope` wins, then ``--precision=bf16``, then
``--use_bf16`` / ``--bf16_activations``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch

from ..utils import FLAGS


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


_f32 = Policy(torch.float32, torch.float32, torch.float32)
_bf16 = Policy(torch.float32, torch.bfloat16, torch.float32)
# full-bf16 activations (--bf16_activations): layer outputs stay bf16;
# params and losses stay fp32
_bf16_act = Policy(torch.float32, torch.bfloat16, torch.bfloat16)

_override: list = []


def resolve_precision(opt_config=None) -> str:
    """The end-to-end precision policy name, "fp32" or "bf16": an
    explicit ``OptimizationConfig.precision`` wins, empty inherits
    ``--precision``."""
    prec = getattr(opt_config, "precision", "") or FLAGS.get("precision")
    if prec not in ("fp32", "bf16"):
        raise ValueError(f"precision must be 'fp32' or 'bf16', got {prec!r}")
    return prec


def policy_for(precision: str) -> Policy:
    """Op policy of a named precision: bf16 = bf16 compute with fp32
    outputs (bf16 outputs when --bf16_activations also opts in); fp32 =
    fp32 everywhere."""
    if precision == "bf16":
        return _bf16_act if FLAGS.get("bf16_activations") else _bf16
    return _f32


def current_policy() -> Policy:
    if _override:
        return _override[-1]
    if FLAGS.get("precision") == "bf16":
        return policy_for("bf16")
    if not FLAGS.get("use_bf16"):
        return _f32
    return _bf16_act if FLAGS.get("bf16_activations") else _bf16


@contextlib.contextmanager
def policy_scope(policy: Policy) -> Iterator[None]:
    _override.append(policy)
    try:
        yield
    finally:
        _override.pop()


@contextlib.contextmanager
def full_precision() -> Iterator[None]:
    """fp32 everywhere."""
    with policy_scope(_f32):
        yield
