"""Parallelism toolkit (counterpart of ``paddle_tpu/parallel``).

Replaces the reference's intra-node parallel machinery (SURVEY §2.5):

- ``MultiGradientMachine`` thread-per-GPU data parallelism
  (``MultiGradientMachine.h:45``) → one process a device, the batch
  split over the mesh's ``data`` axis and the gradients all-reduced
  (the ``Trainer`` on a mesh);
- ``ParallelNeuralNetwork`` per-layer device placement (``--parallel_nn``,
  per-layer ``device=`` in ModelConfig) → per-parameter PartitionSpec
  rules over the ``model`` axis (:class:`ShardingRules`);
- sparse-remote parameter sharding → embedding tables sharded on the
  vocab dim.

:mod:`.collectives` holds the exchanges; :mod:`.local_sgd` (imported by
name: it builds on the trainer) the K-step local SGD.
"""

from .sharding import (ShardingRules, tp_rules, shard_params,
                       constraint, param_dims_of,
                       verify_rules_or_raise,
                       match_partition_rules, fsdp_spec,
                       fsdp_rules_for, make_shard_and_gather_fns,
                       spec_shard_info, FSDP_MIN_SIZE)  # noqa: F401
from .rule_tables import (lstm_fsdp_rules, resnet_fsdp_rules,
                          transformer_fsdp_rules, ctr_fsdp_rules,
                          recommender_fsdp_rules,
                          zoo_fsdp_rules, ZOO_FSDP_RULES)  # noqa: F401
from .ring_attention import (ring_attention, ulysses_attention,
                             full_attention)  # noqa: F401
from ..ops.attention import flash_attention  # noqa: F401
from .sparse import (SelectedRows, unique_rows, row_gather,
                     row_scatter_add, row_scatter_set, touched_row_mask,
                     prefetch_rows, sparse_embedding_lookup,
                     unique_rows_sorted, lookup_rows, exchange_scope,
                     exchange_entry,
                     exchange_payload_bytes)  # noqa: F401
