"""Error type and the ``enforce`` check (counterpart of
``paddle_tpu/utils/error.py``)."""

from __future__ import annotations

from typing import Any


class PaddleTpuError(RuntimeError):
    """Base error for the framework."""


def enforce(cond: Any, msg: str = "", *args: Any) -> None:
    """Raise :class:`PaddleTpuError` with ``msg % args`` unless ``cond``."""
    if not cond:
        raise PaddleTpuError(msg % args if args else msg)
