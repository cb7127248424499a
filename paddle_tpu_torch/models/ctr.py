"""The CTR-shaped net of ``bench.py``'s sparse embedding lane
(counterpart of ``bench.py``'s ``_sparse_trainer``, which builds it with
the JAX package's config DSL).

``ctr_classifier``: data ``ids`` (an integer sequence over V) →
embedding through the ``sparse_update`` table ``_slot_emb.w`` (std
0.02) → sum pooling → fc 32 relu → fc 2 softmax → classification cost.
It builds the same ``ModelConfig`` as the DSL, layer for layer and name
for name, so parameters carry across by name.  The lane's optimizer is
:data:`CTR_OPT` (Adam lr 1e-3, clip 25).
"""

from __future__ import annotations

from ..config.model_config import ModelConfig, ParameterConfig
from .text import _data, _layer

#: ``_sparse_trainer``'s OptimizationConfig fields
CTR_OPT = dict(learning_method="adam", learning_rate=1e-3,
               gradient_clipping_threshold=25.0)


def ctr_classifier(vocab_size: int, emb_dim: int) -> ModelConfig:
    """The sparse lane's net over a ``vocab_size`` × ``emb_dim`` table."""
    emb, pool, tower, pred, cost = (
        "__embedding_1__", "__average_2__", "__fc_3__", "__fc_4__",
        "__multi-class-cross-entropy_5__")
    table = _layer(emb, "embedding", emb_dim, ["ids"],
                   attrs={"vocab_size": vocab_size, "sharded": False})
    table.inputs[0].input_parameter_name = "_slot_emb.w"
    layers = [
        _data("ids", vocab_size, 1), table,
        _layer(pool, "average", emb_dim, [emb],
               attrs={"stride": -1, "average_strategy": "sum"}),
        _layer(tower, "fc", 32, [pool], act="relu", with_bias=True),
        _layer(pred, "fc", 2, [tower], act="softmax", with_bias=True),
        _data("label", 2, 0),
        _layer(cost, "multi-class-cross-entropy", 1, [pred, "label"],
               attrs={"coeff": 1.0}),
    ]
    return ModelConfig(
        layers=layers,
        parameters=[ParameterConfig(name="_slot_emb.w", initial_std=0.02,
                                    sparse_update=True)],
        input_layer_names=["ids", "label"], output_layer_names=[cost])
