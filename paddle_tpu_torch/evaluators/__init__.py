"""Streaming evaluators (counterpart of ``paddle_tpu/evaluators``)."""
from .evaluators import (
    EVALUATORS,
    AucEvaluator,
    ChunkEvaluator,
    ClassificationErrorEvaluator,
    ColumnSumEvaluator,
    CTCErrorEvaluator,
    Evaluator,
    PnpairEvaluator,
    PrecisionRecallEvaluator,
    RankAucEvaluator,
    SumEvaluator,
    create_evaluator,
)

__all__ = [
    "EVALUATORS",
    "AucEvaluator",
    "ChunkEvaluator",
    "ClassificationErrorEvaluator",
    "ColumnSumEvaluator",
    "CTCErrorEvaluator",
    "Evaluator",
    "PnpairEvaluator",
    "PrecisionRecallEvaluator",
    "RankAucEvaluator",
    "SumEvaluator",
    "create_evaluator",
]
