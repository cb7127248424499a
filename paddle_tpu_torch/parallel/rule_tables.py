"""Committed FSDP rule tables for the model zoo (data-axis sharding;
counterpart of ``paddle_tpu/parallel/rule_tables.py``, the same tables).

One literal :class:`~paddle_tpu_torch.parallel.sharding.ShardingRules` table
per zoo family — LSTM text classifier, ResNet (cifar/50 block family),
transformer encoder classifier, and the wide&deep CTR/recommender
shape — mapping the layer engine's parameter naming
(``_<layer>.w<i>`` / ``.wbias`` / ``.wo``) to ``data``-axis
PartitionSpecs.  These are the FSDP half of the placement story: the
batch is already sharded over ``data``; these tables additionally
shard every large parameter (and, through the trainer, its Adam/moment
slots) over the SAME axis, so per-device memory for params + optimizer
state drops by the data-axis extent; the trainer gathers each sharded
parameter before use and reduce-scatters its gradient.

Authoring rules:

- first match wins — put narrow exceptions (norms, biases, heads)
  BEFORE broad catch-alls;
- shard a dim that stays divisible across the family's configured
  sizes (embedding rows, gate-stacked hidden columns, conv output
  channels); replicate 1-D norm/bias params — sharding a 64-float
  LayerNorm gain fragments collectives for no memory win;
- every table here is verified per topology by
  ``ShardingRules.verify`` in the test suite.
"""

from __future__ import annotations

from ..core.device import DATA_AXIS, P
from .sharding import ShardingRules


def lstm_fsdp_rules() -> ShardingRules:
    """LSTM text classifier (``models.text.lstm_text_classifier``):
    embedding rows, gate-stacked ``[in, 4H]`` weight columns, and the
    classifier head's input dim shard over ``data``; biases replicate
    (the fused-gate bias is the only >1 KiB one and it rides the
    recurrent scan — replication keeps the carry local)."""
    return ShardingRules([
        (r"embedding.*\.w\d*$", P(DATA_AXIS, None)),
        (r"\.wbias$", P()),
        (r"(lstm|gru)\d*(_transform)?\.w\d*$", P(None, DATA_AXIS)),
        (r"fc.*\.w\d*$", P(DATA_AXIS, None)),
    ])


def resnet_fsdp_rules() -> ShardingRules:
    """ResNet block family (``models.image.resnet`` /
    ``resnet_cifar10``): conv kernels ``[kh, kw, cin, cout]`` shard the
    output-channel dim, the final fc shards its input dim; batch-norm
    scale/shift and biases replicate (tiny, and BN folding wants them
    whole)."""
    return ShardingRules([
        (r"batch_norm.*\.(w\d*|wbias)$", P()),
        (r"\.wbias$", P()),
        (r"conv.*\.w\d*$", P(None, None, None, DATA_AXIS)),
        (r"fc.*\.w\d*$", P(DATA_AXIS, None)),
    ])


def transformer_fsdp_rules() -> ShardingRules:
    """Transformer encoder classifier
    (``models.text.transformer_text_classifier``): token/position
    embedding rows and the classifier head's input dim shard over
    ``data``; attention QKV/out projections and both ffn matmuls shard
    their output dim (stays divisible across the family's
    ``model_dim``/``ffn_dim`` sizes); LayerNorm params and biases
    replicate."""
    return ShardingRules([
        (r"_ln.*\.(w\d*|wbias)$", P()),
        (r"\.wbias$", P()),
        (r"embedding.*\.w\d*$", P(DATA_AXIS, None)),
        (r"_cls\.w\d*$", P(DATA_AXIS, None)),
        (r"\.(wo|w\d*)$", P(None, DATA_AXIS)),
    ])


def ctr_fsdp_rules() -> ShardingRules:
    """Wide&deep CTR / recommender shape (``demo/ctr``,
    ``demo/recommender``): THE memory is the sparse embedding table —
    shard its rows over ``data``; the dense tower fcs stay replicated
    (a 13-wide dense input and a 2-wide softmax head leave no dim that
    divides across the family, and the tower is KiB-scale anyway)."""
    return ShardingRules([
        (r"emb.*\.w\d*$", P(DATA_AXIS, None)),
        (r".", P()),
    ])


def recommender_fsdp_rules() -> ShardingRules:
    """Dual-tower MovieLens recommender (``demo/recommender``): the
    user-id and movie-id tables (``_usr_emb.w`` / ``_mov_emb.w``, the
    demo's named sparse-update params) carry the memory at production
    row counts — shard their rows over ``data``; the feature embeddings
    (gender/age/job/category bags — tens of rows) and the KiB-scale
    tower fcs replicate, both too small to divide across topologies."""
    return ShardingRules([
        (r"_(usr|mov)_emb\.w\d*$", P(DATA_AXIS, None)),
        (r".", P()),
    ])


#: Zoo-family name → table factory, the lookup ``Trainer(fsdp=True,
#: fsdp_rules=zoo_fsdp_rules("transformer"))`` callers use.
ZOO_FSDP_RULES = {
    "lstm": lstm_fsdp_rules,
    "resnet": resnet_fsdp_rules,
    "transformer": transformer_fsdp_rules,
    "ctr": ctr_fsdp_rules,
    "recommender": recommender_fsdp_rules,
}


def zoo_fsdp_rules(family: str) -> ShardingRules:
    """The committed FSDP table for a zoo ``family`` (KeyError lists
    the known families)."""
    try:
        return ZOO_FSDP_RULES[family]()
    except KeyError:
        raise KeyError(
            f"no committed FSDP rule table for {family!r}; known "
            f"families: {sorted(ZOO_FSDP_RULES)}") from None
