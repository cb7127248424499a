"""Precision policy (counterpart of ``paddle_tpu/core/dtypes.py``).

A :class:`Policy` carries the three dtypes of mixed precision (param,
compute, output); ops and layers read :func:`current_policy` instead of
hard-coding dtypes.  The resolution order is the JAX package's: an open
:func:`policy_scope` wins, then ``--precision=bf16``, then
``--use_bf16`` / ``--bf16_activations``.

:func:`np_dtype` / :func:`dtype_name` map dtype names to numpy and back;
:func:`record_op_precision` counts which compute dtype each op family
dispatched with (:data:`precision_dispatch_total`), and
:func:`dispatch_dtypes` is the per-op-tier stamp of the active policy.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..utils import FLAGS


#: dtype names → numpy dtypes.  Plain numpy has no bfloat16 (the JAX
#: package takes it from ``ml_dtypes``, which this package does not
#: need), so :func:`np_dtype` refuses that name rather than guess.
_NP_DTYPES: Dict[str, np.dtype] = {
    name: np.dtype(t) for name, t in {
        "float32": np.float32, "float64": np.float64,
        "float16": np.float16, "int8": np.int8, "int16": np.int16,
        "int32": np.int32, "int64": np.int64, "uint8": np.uint8,
        "bool": np.bool_}.items()}


def np_dtype(name) -> np.dtype:
    """Dtype name, torch dtype or dtype-like → numpy dtype; bfloat16
    raises by name (numpy has no such type here)."""
    if isinstance(name, torch.dtype):
        name = dtype_name(name)
    if isinstance(name, str) and name in _NP_DTYPES:
        return _NP_DTYPES[name]
    if isinstance(name, str) and name == "bfloat16":
        raise TypeError("np_dtype: numpy has no bfloat16 without ml_dtypes; "
                        "keep bfloat16 data as torch tensors")
    return np.dtype(name)


def dtype_name(dt) -> str:
    """Canonical name of a torch or numpy dtype (``torch.bfloat16`` →
    ``"bfloat16"``): the inverse of :func:`np_dtype`."""
    if isinstance(dt, torch.dtype):
        return str(dt).split(".", 1)[1]
    if isinstance(dt, str) and dt == "bfloat16":
        return dt
    return str(np.dtype(dt))


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


#: ``precision_dispatch_total`` of the JAX package, keyed ``(op, dtype)``:
#: the compute dtype each op family dispatched with.  The JAX counter
#: ticks once per traced program (ops run at trace time under ``jit``);
#: this one ticks once per call.
precision_dispatch_total: "collections.Counter" = collections.Counter()


def record_op_precision(op: str) -> None:
    """Tick :data:`precision_dispatch_total` and the registry's
    ``precision_dispatch_total{op,dtype}`` for ``op`` under the active
    policy's compute dtype."""
    from ..observe import counter  # lazy: keeps core import-light

    dtype = dtype_name(current_policy().compute_dtype)
    precision_dispatch_total[(op, dtype)] += 1
    counter(
        "precision_dispatch_total",
        "op dispatches by resolved compute dtype (trace-time: one tick "
        "per compiled program per shape, labels op + policy compute "
        "dtype)",
    ).inc(op=op, dtype=dtype)


def dispatch_dtypes(opt_config=None) -> Dict[str, str]:
    """The active policy's dtype of each op tier, by name (the precision
    stamp the JAX package's bench lines carry)."""
    prec = resolve_precision(opt_config)
    pol = policy_for(prec) if prec == "bf16" else current_policy()
    cd, od = dtype_name(pol.compute_dtype), dtype_name(pol.output_dtype)
    return {
        "policy": prec,
        "matmul": cd, "conv": cd, "rnn_gates": cd, "attention": cd,
        # accumulators and carries pinned fp32 whatever the compute dtype
        "bn_stats": "float32", "fused_rnn_state": "float32",
        "attention_accum": "float32",
        "scan_carry": od, "activations": od,
        "master_params": "float32", "optimizer_state": "float32",
    }
