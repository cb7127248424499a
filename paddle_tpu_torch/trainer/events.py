"""Trainer events (counterpart of ``paddle_tpu/trainer/events.py``, the
reference's ``python/paddle/v2/event.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass
class WithMetric:
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BeginPass:
    pass_id: int


@dataclasses.dataclass
class EndPass(WithMetric):
    pass_id: int = 0
    evaluator: Any = None


@dataclasses.dataclass
class BeginIteration:
    pass_id: int = 0
    batch_id: int = 0


@dataclasses.dataclass
class EndIteration(WithMetric):
    pass_id: int = 0
    batch_id: int = 0
    cost: float = 0.0


@dataclasses.dataclass
class TestResult(WithMetric):
    pass_id: int = 0
    cost: float = 0.0
