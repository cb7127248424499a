"""``paddle.v2.event`` (counterpart of ``paddle_tpu/v2/event.py``): the
trainer's events."""

from ..trainer.events import (  # noqa: F401
    BeginIteration,
    BeginPass,
    EndIteration,
    EndPass,
    TestResult,
)
