"""``paddle.v2.evaluator`` (counterpart of ``paddle_tpu/v2/evaluator.py``):
factories of the port's evaluators by their v2 names."""

from ..evaluators import create_evaluator


def classification_error(**kw):
    return create_evaluator("classification_error", **kw)


def auc(**kw):
    return create_evaluator("auc", **kw)


def precision_recall(**kw):
    return create_evaluator("precision_recall", **kw)


def chunk(**kw):
    return create_evaluator("chunk", **kw)


def sum(**kw):  # noqa: A001 (reference name)
    return create_evaluator("sum", **kw)


def column_sum(**kw):
    return create_evaluator("column_sum", **kw)


def pnpair(**kw):
    return create_evaluator("pnpair", **kw)


def rankauc(**kw):
    return create_evaluator("rankauc", **kw)


def ctc_error(**kw):
    return create_evaluator("ctc_edit_distance", **kw)
