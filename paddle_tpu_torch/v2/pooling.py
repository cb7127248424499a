"""``paddle.v2.pooling`` (counterpart of ``paddle_tpu/v2/pooling.py``):
the DSL's pooling types under their v2 names."""

from ..config.dsl import (  # noqa: F401
    AvgPooling as Avg,
    MaxPooling as Max,
    SqrtPooling as Sqrt,
    SumPooling as Sum,
)
