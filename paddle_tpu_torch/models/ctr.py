"""The CTR-shaped net of ``bench.py``'s sparse embedding lane
(counterpart of ``bench.py``'s ``_sparse_trainer``, whose config DSL
calls it makes through the port's DSL).

``ctr_classifier``: data ``ids`` (an integer sequence over V) →
embedding through the ``sparse_update`` table ``_slot_emb.w`` (std
0.02) → sum pooling → fc 32 relu → fc 2 softmax → classification cost.
The lane's optimizer is :data:`CTR_OPT` (Adam lr 1e-3, clip 25).
"""

from __future__ import annotations

from ..config import dsl
from ..config.model_config import ModelConfig
from ..data.feeder import integer_value, integer_value_sequence

#: ``_sparse_trainer``'s OptimizationConfig fields
CTR_OPT = dict(learning_method="adam", learning_rate=1e-3,
               gradient_clipping_threshold=25.0)


def ctr_classifier(vocab_size: int, emb_dim: int) -> ModelConfig:
    """The sparse lane's net over a ``vocab_size`` × ``emb_dim`` table."""
    with dsl.config_scope():
        x = dsl.data("ids", integer_value_sequence(vocab_size))
        lab = dsl.data("label", integer_value(2))
        emb = dsl.embedding(x, size=emb_dim, param_attr=dsl.ParamAttr(
            name="_slot_emb.w", sparse_update=True, initial_std=0.02))
        pooled = dsl.pooling(emb, pooling_type=dsl.SumPooling())
        tower = dsl.fc(pooled, size=32, act=dsl.ReluActivation())
        pred = dsl.fc(tower, size=2, act=dsl.SoftmaxActivation())
        return dsl.topology(dsl.classification_cost(pred, lab))
