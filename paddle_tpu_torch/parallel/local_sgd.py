"""Local SGD — the re-expression of async-SGD (counterpart of
``paddle_tpu/parallel/local_sgd.py``).

Reference: ``paddle/pserver/ParameterServer2.h:468`` applies trainer
gradients lock-free and asynchronously, and the server exposes
``AVERAGE_PARAMETER`` (``ParameterService.proto`` :24-110) to average
parameter copies: both decouple workers from the global barrier.  The
capability maps to **K-step local SGD with periodic parameter
averaging** (Stich, "Local SGD Converges Fast and Communicates
Little"): every data shard applies K optimizer steps on its own copy
with no cross-shard traffic, then the copies are averaged.  K=1 with
plain SGD is numerically synchronous all-reduce DP (tested).

Mechanics: the JAX package stacks D copies on a leading axis and vmaps
the step in one program.  The port runs one process a device, so each
rank holds its own copy: it steps on its rows of the global batch with
no gradient exchange (its batch-norm statistics its rows'), and every
K-th step the parameters and buffers are averaged over the ``data`` axis
(one all-reduce, the JAX program's ``mean`` over the replica axis; the
optimizer slots stay each rank's, as there).  The reported loss is the
ranks' mean.  Each rank draws its own dropout masks: its ``data``
coordinate is folded into the step's seed, as the JAX package folds the
replica index into each shard's key (neither package's masks reproduce
the other's).  Every feed leaf's batch must divide over ``data``, as
the JAX package's ``_shard_feed_local`` requires.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.device import DATA_AXIS
from ..core.sequence import NestedSequenceBatch, SequenceBatch
from ..trainer.trainer import Trainer
from ..utils import PaddleTpuError, enforce, get_logger, warn_once
from . import collectives as coll

log = get_logger("local_sgd")


class LocalSGDTrainer(Trainer):
    """Trainer whose DP shards run K local steps between parameter
    averages (``OptimizationConfig.local_sgd_steps``)."""

    def __init__(self, network, opt_config=None, optimizer=None, **kwargs):
        super().__init__(network, opt_config=opt_config,
                         optimizer=optimizer, **kwargs)
        if self._resolve_specs() is not None:
            raise PaddleTpuError(
                "local SGD keeps a whole copy of the parameters on every "
                "rank: --fsdp and sharding_rules do not apply")
        if self.precision == "bf16":
            # the master-cast/loss-scaling machinery only wraps the base
            # Trainer step (the JAX package's note, kept)
            warn_once(
                "local_sgd_bf16",
                "precision=bf16 with local_sgd_steps: bf16 compute "
                "applies, but dynamic loss scaling / skipped-step "
                "semantics are not wired into the local-SGD step",
                logger=log)
            self._ls_state = None
        # the JAX local-SGD step carries no health aux: health is ignored
        self._health = None
        self.local_steps = max(
            1, getattr(opt_config, "local_sgd_steps", 1) or 1)
        self.n_shards = self._data_n
        self._step_count = 0
        self._sync_grads = False

    @property
    def _stacked(self) -> bool:
        """True once a step ran: the copies may differ from then on;
        eval/save before that must not reduce (the copies are one)."""
        return self._step_count > 0

    def _average(self, tree: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Each floating leaf's mean over the data axis."""
        names = [n for n, x in tree.items() if x.is_floating_point()]
        if self.n_shards <= 1 or not names:
            return dict(tree)
        sums = coll.all_reduce_sum([tree[n] for n in names],
                                   self.mesh.group(DATA_AXIS))
        out = dict(tree)
        for n, s in zip(names, sums):
            out[n] = (s / self.n_shards).to(tree[n].dtype)
        return out

    def _step_seed(self) -> int:
        """The step's seed with this rank's ``data`` coordinate folded in:
        each shard draws its own dropout masks."""
        base = super()._step_seed()
        if self.n_shards <= 1:
            return base
        return (base * 1000003 + 1 + self.mesh.coordinate(DATA_AXIS)) \
            % (2 ** 31)

    def _shard_feed(self, feed: Dict[str, Any]):
        """This rank's rows of every leaf; a batch that does not divide
        over ``data`` raises (the synchronous trainer would run it whole
        on every rank)."""
        def check(x):
            if isinstance(x, SequenceBatch):
                return check(x.data)
            if isinstance(x, NestedSequenceBatch):
                return check(x.data)
            if isinstance(x, torch.Tensor) and x.dim() >= 1:
                b = x.shape[0]
                enforce(b % self.n_shards == 0,
                        f"local SGD: batch {b} not divisible by "
                        f"{self.n_shards} shards")

        for v in feed.values():
            check(v)
        return super()._shard_feed(feed)

    def _step(self, feed: Dict[str, Any]) -> torch.Tensor:
        loss = super()._step(feed)
        self._step_count += 1
        if self._step_count % self.local_steps == 0:
            # AVERAGE_PARAMETER: the copies' mean, on every rank
            self.params = self._average(self.params)
            self.buffers = self._average(self.buffers)
        return self._reduce_mean(loss)

    # ------------------------------------------------------ consolidation
    def consolidated_params(self) -> Dict[str, torch.Tensor]:
        """Replica-averaged parameters (for eval/save)."""
        if not self._stacked:
            return dict(self.params)
        return self._average(self.params)

    def _full_params(self) -> Dict[str, torch.Tensor]:
        return self.consolidated_params()

    def save(self, save_dir: str, pass_id: int) -> str:
        from ..trainer.checkpoint import save_checkpoint

        if not self._stacked:
            return super().save(save_dir, pass_id)
        count, slots = self.opt_state
        names = sorted(slots)
        flat = {f"{n}/{i}": x for n in names for i, x in enumerate(slots[n])}
        avg = self._average(flat)
        mean_slots = {n: tuple(avg[f"{n}/{i}"] for i in range(len(slots[n])))
                      for n in names}
        return save_checkpoint(
            save_dir, pass_id, self.consolidated_params(),
            (count, mean_slots), self.buffers,
            meta={"samples_seen": self.samples_seen}, mesh=self.mesh)


def make_trainer(network, opt_config, **kwargs) -> Trainer:
    """Factory honoring ``OptimizationConfig.local_sgd_steps``."""
    cls = LocalSGDTrainer if getattr(opt_config, "local_sgd_steps", 0) \
        else Trainer
    return cls(network, opt_config=opt_config, **kwargs)
