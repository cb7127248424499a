"""Streaming evaluators over Executor fetches
(``python/paddle/v2/framework/evaluator.py`` Accuracy accumulation).

Counterpart of ``paddle_tpu/framework/evaluator.py``, the same code.
"""

from __future__ import annotations

from . import layers


class Accuracy:
    """Build the per-batch accuracy node and accumulate host-side."""

    def __init__(self, input, label, k: int = 1, main_program=None,
                 **kw):
        self.acc = layers.accuracy(input, label, k=k,
                                   main_program=main_program)
        self.reset()

    def reset(self):
        self._correct = 0.0
        self._total = 0.0

    def metrics(self):
        return [self.acc]

    def update(self, acc_value, batch_size: int):
        self._correct += float(acc_value) * batch_size
        self._total += batch_size

    def eval(self) -> float:
        return self._correct / max(self._total, 1.0)
