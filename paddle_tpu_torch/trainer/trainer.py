"""The trainer (counterpart of ``paddle_tpu/trainer/trainer.py``, its
fp32 step, its ``--precision=bf16`` mixed step and its mesh).

``Trainer.train_one_batch(feed)`` runs forward, autograd backward and
the optimizer update: the JAX package's jitted step.

On a mesh (``mesh=``, default ``core.device.get_mesh()``: one process a
device, ``{data: 1}`` without a process group) every rank is given the
global batch and takes its rows of each feed leaf whose batch dim
divides over ``data`` (:meth:`Trainer._shard_feed`); when a leaf was
split the forward runs in ``data_parallel_scope`` (batch-norm statistics
and dropout masks of the global batch), else it is the one-device
forward on every rank; the gradients of the global batch are summed over
``data`` and divided by its size, in each parameter's layout
(:meth:`Trainer._reduce_grads`), before the finite check's global flag,
clipping, the lazy rows' masks (the union of the ranks' rows) and the
update; the reported loss is the ranks' mean.  Under FSDP (``fsdp`` /
``--fsdp`` on a data axis of more than one member, placed by
``fsdp_rules`` or ``parallel.sharding.fsdp_spec``) or ``sharding_rules``
(tensor parallel) parameters and their param-shaped slots rest as
DTensors holding this rank's shard: each is gathered whole before the
forward (a kernel's operands are always whole), its gradient
reduce-scattered (``data``) or cut to this rank's chunk (``model``), and
each rank updates its own shard.  ``test`` evaluates the whole batch on
every rank with the whole parameters.  With nothing placed and one
member on ``data`` every collective is skipped: the one-device step,
byte for byte.  The optimizer and the learning-rate schedule come
from ``optimizer_from_config`` (the ten rules of the reference's
registry, L1 and L2, clipping, the seven schedules, evaluated on the
host on ``samples_seen``), or an ``optimizer=`` given with the constant
schedule.  The step carries the network's buffers (batch-norm running
statistics): it starts from ``network.init_buffers()`` and keeps the
buffers each step returns, in sorted-name order as the JAX step returns
them.

Static pruning hooks (``ParameterConfig.update_hooks`` of type
``"pruning"``, ``optimizer/hooks.py``): the masks are made from the
initial value (or the one ``--init_model_path`` loads) and applied to
it, every gradient of both steps is masked before the update, a pruned
table stays out of the sparse exchange, and ``load`` makes the masks
anew from the loaded values, as the reference does.

Checkpoints (``trainer/checkpoint.py``, format 2): ``save`` writes the
parameters, buffers, optimizer state, ``samples_seen`` and, under
``--precision=bf16``, the loss-scale state, in files the JAX package
reads and writes alike; ``load`` places them on the trainer's device;
``resume`` loads the newest valid one.  ``train`` saves every
``--saving_period`` passes into ``--save_dir``.

The precision is ``resolve_precision(opt_config)``.  fp32 (the default)
runs the step under ``current_policy()``, so the legacy ``--use_bf16`` /
``--bf16_activations`` flags apply to its ops.  bf16 runs the mixed
step of ``_build_mixed_train_step``: fp32 masters cast to bf16 at the
step boundary (the backward through the cast gives fp32 gradients), the
forward under ``policy_for("bf16")``, the loss multiplied by the dynamic
scale and the gradients divided by it in fp32, and a step with a
non-finite gradient skipped — params, optimizer state and buffers
bit-identical, the scale halved (``optimizer/loss_scale.py``).  The skip is a
``torch.where`` on the device: the step never reads a value back.

``ParameterConfig.sparse_update`` tables get the reference's lazy
row-sparse update in both steps: rows the batch does not touch keep
their value and their optimizer slots bit-identical.  With
``--sparse_grads`` (the default) an eligible table takes the sparse
gradient exchange (:meth:`Trainer._sparse_exchange_plan`): its batch
ids deduped once, the touched rows gathered into a block
(``ops/embedding.gather_rows``, kernel 22 where the reference's gate
allows it), the lookups routed through the block, the gradient taken
with respect to the block — the table stays out of the autograd inputs,
so no dense ``[V, D]`` gradient is formed — and the rows updated in
place by ``Optimizer.apply_rows``.  The other ``sparse_update`` tables,
and all of them under ``--sparse_grads=false``, take the dense gradient
and the ``touched_row_mask`` masked update.

Around the step, the reference's loop and jobs (``Trainer.train``,
``test``, ``time_job``, ``check_gradients``): the events of
``trainer/events.py`` in the reference's order, the model config's
evaluators, and the feeding path — ``DataFeeder.convert`` on the step's
thread, or with ``--prefetch_depth`` > 0 the async pipeline
(``data/pipeline.py``), whose workers convert each batch and issue its
host-to-device copy (:meth:`Trainer._place_feed`).  A feed is copied
from pinned memory without blocking, on the device's current stream:
the step's kernels are queued behind it on the same stream, so no event
or ``record_stream`` is needed.

Telemetry (``observe/``, the JAX trainer's wiring): the step runs under
a ``train_step`` span with ``feed``, ``step_dispatch`` and ``fence``
children and records ``train_host_feed_seconds``, ``train_step_seconds``,
``train_steps`` and ``train_samples``; the dispatch is timed under the
``train_batch`` timer of ``utils/stat.global_stat``.  Only when someone
is listening — a metrics sink (``observe.active()``) or an explicitly
opened trace (``trace.fences_steps()``) — the step waits for its loss
(an event recorded on the current stream) and records
``train_device_blocked_seconds`` and ``train_samples_per_sec``; with
neither, the step adds no synchronization and no device-to-host copy.
``train`` starts the flag-configured surfaces
(``observe.start_from_flags``), runs each pass under a ``train_pass``
span with an ``input_wait`` span a batch, records
``data_reader_wait_seconds`` and ``input_bound_ratio``, samples the HBM
gauges at pass boundaries while a sink or the endpoint is live, and logs
``utils/profiler.parameter_stats`` every
``--show_parameter_stats_period`` batches; ``test`` runs under a
``test_pass`` span.  The JAX trainer's ``jit_recompiles`` counter has no
counterpart in an eager step.  What the loop reaches and the port lacks
refuses by name before a step runs: ``--roofline_dump`` (A10b part 3).

Training health (``--health_interval N > 0``, ``observe/health.py``, as
the JAX trainer wires it): a :class:`~..observe.health.HealthSession`
built with the trainer folds each step's per-layer gradient, parameter
and update norms and non-finite flags into device tensors inside
``_apply`` (under ``--precision=bf16`` the flags come from the loss
scale's own sweep, and a skipped step's non-finites count as benign);
every N steps and at pass ends the state is drained — one
device-to-host copy with the step's loss — into the ``health_*``
metrics, the detectors, ``/health`` and the ``train_step`` span.  The
sparse gradient exchange is vetoed while it is on (the health path reads
dense per-parameter gradients).  At 0 the step is unchanged.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config.model_config import OptimizationConfig
from ..core.device import (DATA_AXIS, Mesh, P, data_parallel_scope,
                           get_mesh, resolve_device)
from ..core.dtypes import (full_precision, policy_for, policy_scope,
                           resolve_precision)
from ..core.sequence import NestedSequenceBatch, SequenceBatch, value_of
from ..layers.network import NeuralNetwork
from ..ops.embedding import gather_rows
from ..optimizer import loss_scale as ls
from ..optimizer.hooks import (apply_prune_grads, apply_prune_init,
                               build_prune_masks)
from ..optimizer.optimizers import Optimizer, create_optimizer
from ..optimizer.schedules import make_schedule
from .. import observe
from ..observe import trace
from ..parallel import collectives as coll
from ..parallel import sparse as psparse
from ..parallel.sharding import (full_tensor, like_placed, local_tensor,
                                 shard_tensor)
from ..parallel.sharding import shard_dims as _shard_dims
from ..utils import FLAGS, PaddleTpuError, enforce, get_logger, warn_once
from ..utils.stat import block_until_ready, global_stat
from . import events as ev
from .checkpoint import (latest_checkpoint, latest_valid_checkpoint,
                         load_buffers, load_manifest, load_opt_state,
                         load_params, save_checkpoint, verify_checkpoint)

_log = get_logger("trainer")

#: end-of-pass sentinel of the loop's reader iterator (so the last wait
#: is not an error span)
_PASS_END = object()


def optimizer_from_config(oc: OptimizationConfig
                          ) -> Tuple[Optimizer, Callable[[float], float]]:
    """OptimizationConfig → (optimizer, lr schedule), as the reference
    merges them (``TrainerConfigHelper``): sgd with a momentum is the
    momentum rule.  ``local_sgd_steps`` is read by
    ``parallel.local_sgd.make_trainer``; the parameter server's
    exchange periods (``num_batches_per_send_parameter`` /
    ``num_batches_per_get_parameter``) are accepted and unused, as in
    the JAX package."""
    kw: Dict[str, Any] = dict(
        learning_rate=oc.learning_rate,
        weight_decay=oc.l2_weight_decay,
        l1_decay=oc.l1_weight_decay,
        gradient_clipping_threshold=oc.gradient_clipping_threshold,
    )
    name = oc.learning_method or "sgd"
    if name in ("momentum", "sgd") and oc.momentum:
        name = "momentum"
        kw["momentum"] = oc.momentum
    if name in ("adam", "adamax"):
        kw.update(beta1=oc.adam_beta1, beta2=oc.adam_beta2,
                  epsilon=oc.adam_epsilon)
    if name in ("adadelta", "rmsprop", "decayed_adagrad"):
        kw.update(rho=oc.ada_rou, epsilon=oc.ada_epsilon)
    if name == "adagrad":
        kw.update(epsilon=oc.ada_epsilon)
    sched = make_schedule(oc.learning_rate_schedule, oc.learning_rate,
                          oc.learning_rate_decay_a, oc.learning_rate_decay_b,
                          oc.learning_rate_args)
    return create_optimizer(name, **kw), sched


def _to_device(v, dev: torch.device):
    """A feed value (tensor, numpy array, or a SequenceBatch or
    NestedSequenceBatch of either) as tensors on ``dev``.  A host tensor
    goes to the card through a pinned copy queued on the current stream
    without blocking the host (from pageable memory the copy would wait
    for every kernel queued before it)."""
    if isinstance(v, SequenceBatch):
        return SequenceBatch(_to_device(v.data, dev),
                             _to_device(v.length, dev))
    if isinstance(v, NestedSequenceBatch):
        return NestedSequenceBatch(_to_device(v.data, dev),
                                   _to_device(v.num_subseq, dev),
                                   _to_device(v.sub_length, dev))
    t = torch.as_tensor(v)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _to_host(v):
    """A value (tensor or SequenceBatch, on any device) with its tensors
    on the CPU."""
    if isinstance(v, SequenceBatch):
        return SequenceBatch(v.data.detach().cpu(), v.length.cpu())
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return v


class Trainer:
    """Owns the parameters and optimizer state of one network on one
    device (default CUDA; raises when CUDA is absent and the CPU was not
    asked for).  Parameters are drawn by ``network.init_params(seed)``
    (``--seed`` when ``seed`` is None),
    or loaded from ``--init_model_path``; assign ``trainer.params``
    (same names and shapes) to start from others.  ``optimizer``, when
    given, replaces the one ``opt_config`` describes (with the constant
    schedule at its learning rate, as the reference does)."""

    def __init__(self, network: NeuralNetwork,
                 opt_config: Optional[OptimizationConfig] = None,
                 seed: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 optimizer: Optional[Optimizer] = None,
                 mesh: Optional[Mesh] = None, sharding_rules=None,
                 fsdp: Optional[bool] = None, fsdp_rules=None):
        self.network = network
        self.seed = FLAGS.get("seed") if seed is None else seed
        self.device = resolve_device(device)
        self.mesh = mesh or get_mesh()
        self.sharding_rules = sharding_rules
        # FSDP over the data axis (--fsdp): parameters AND optimizer
        # slots sharded per _resolve_specs(); inert on a one-member data
        # axis (the replicated path, byte-for-byte)
        self.fsdp = bool(FLAGS.get("fsdp")) if fsdp is None else bool(fsdp)
        self.fsdp_rules = fsdp_rules
        self._specs: Optional[Dict[str, Any]] = None
        if optimizer is None:
            optimizer, self.schedule = optimizer_from_config(
                opt_config or OptimizationConfig())
        else:
            self.schedule = make_schedule("constant",
                                          optimizer.learning_rate)
        self.optimizer = optimizer
        self.precision = resolve_precision(opt_config)
        self.params = network.init_params(self.seed, self.device)
        self.buffers = network.init_buffers(self.device)
        self.opt_state = self.optimizer.init_state(self.params)
        self._lr_scales = network.lr_scales(self.params)
        self.samples_seen = 0
        # the dynamic loss scale of the bf16 step (None under fp32)
        self._ls_state = ls.init_state(device=self.device) \
            if self.precision == "bf16" else None
        self._skipped_reported = 0
        self._sparse_plan: Optional[Dict[str, List[str]]] = None
        self._eval_step: Optional[Callable] = None
        # reduce gradients over the data axis (local SGD turns it off)
        self._sync_grads = True
        self._prune_masks: Optional[Dict[str, torch.Tensor]] = None
        # --health_interval N > 0: the per-layer health telemetry
        # (observe/health.py) folded into the step, drained every N steps
        self._health = None
        if int(FLAGS.get("health_interval")) > 0:
            from ..observe.health import HealthSession
            self._health = HealthSession(network,
                                         int(FLAGS.get("health_interval")))
        if FLAGS.get("init_model_path"):
            self.load(FLAGS.get("init_model_path"))
        # static pruning hooks (ParameterUpdaterHook.cpp:39): masks from
        # the initial or loaded values, applied to the values now and to
        # every gradient in the step
        self._prune_masks = build_prune_masks(network.param_specs,
                                              self.params)
        self.params = apply_prune_init(self.params, self._prune_masks)
        self._place_state()
        if self._health is not None:
            self._bind_health()

    # ------------------------------------------------------- the mesh
    @property
    def _data_n(self) -> int:
        return self.mesh.shape.get(DATA_AXIS, 1)

    def _resolve_specs(self) -> Optional[Dict[str, Any]]:
        """Each parameter's PartitionSpec, resolved once: under FSDP
        (``fsdp`` on a data axis of more than one member) from
        ``fsdp_rules`` else the largest-divisible-dim heuristic
        (``parallel.sharding.fsdp_spec``, ``--fsdp_min_size``), an
        indivisible table entry replicated with a warning; else from
        ``sharding_rules`` on a mesh of more than one member (tensor
        parallel).  None when nothing is placed — every call site then
        takes the one-device path."""
        if self._specs is None:
            from ..parallel.sharding import fsdp_spec, spec_shard_info
            specs: Dict[str, Any] = {}
            n = self._data_n
            if self.fsdp and n > 1:
                min_size = int(FLAGS.get("fsdp_min_size"))
                for name, value in self.params.items():
                    shape = tuple(value.shape)
                    if self.fsdp_rules is not None:
                        spec = self.fsdp_rules.spec_for(name, len(shape))
                        info = spec_shard_info(spec, self.mesh)
                        if info is not None and shape[info[0]] % info[1]:
                            warn_once(
                                f"trainer.fsdp_indivisible:{name}",
                                "FSDP rule spec %s for %r does not divide "
                                "shape %s on a %d-way data axis — "
                                "replicating this parameter",
                                tuple(spec), name, shape, n, logger=_log)
                            spec = P()
                    else:
                        spec = fsdp_spec(shape, n, min_size=min_size)
                    specs[name] = spec
            elif self.sharding_rules is not None and self.mesh.size > 1:
                specs = {name: self.sharding_rules.spec_for(name, v.dim())
                         for name, v in self.params.items()}
            self._specs = specs if any(tuple(sp) for sp in specs.values()) \
                else {}
        return self._specs or None

    def _place_state(self) -> None:
        """Parameters and their param-shaped optimizer slots at rest in
        their spec's layout (DTensors holding this rank's shard); the
        rest stays whole."""
        specs = self._resolve_specs()
        if specs is None:
            return
        self.params = {n: shard_tensor(full_tensor(p), specs[n], self.mesh)
                       for n, p in self.params.items()}
        count, slots = self.opt_state
        self.opt_state = (count, {
            n: tuple(shard_tensor(full_tensor(x), specs[n], self.mesh)
                     if tuple(x.shape) == tuple(self.params[n].shape)
                     else x for x in slot)
            for n, slot in slots.items()})

    def _bind_health(self) -> None:
        """The health session on this trainer's device; on a mesh of more
        than one member it folds only the parameters (shards) this rank
        owns — a parameter's replicated part belongs to the rank at
        coordinate 0 of the axes it is not sharded on — and its drain
        gathers over the job in one collective."""
        if self.mesh.size <= 1:
            self._health.bind(self.device)
            return
        import torch.distributed as dist
        owned = []
        for name, p in self.params.items():
            sharded = {self.mesh.axis_names[m] for m, _ in _shard_dims(p)}
            if all(self.mesh.coordinate(a) == 0
                   for a in self.mesh.axis_names if a not in sharded):
                owned.append(name)
        self._health.bind(self.device, owned, world=dist.group.WORLD)

    def _full_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole (placed ones gathered)."""
        return {n: full_tensor(p) for n, p in self.params.items()}

    def _shard_feed(self, feed: Dict[str, Any]
                    ) -> Tuple[Dict[str, Any], bool]:
        """This rank's rows of every feed leaf whose batch dim divides
        over the data axis; other leaves whole (the JAX package's
        per-leaf rule).  The flag says whether any leaf was split: a
        feed left whole on every rank (a last partial batch) runs the
        one-device forward, one dropout mask and local statistics."""
        n = self._data_n
        if n <= 1:
            return feed, False
        i = self.mesh.coordinate(DATA_AXIS)
        split = []

        def take(x):
            if isinstance(x, SequenceBatch):
                return SequenceBatch(take(x.data), take(x.length))
            if isinstance(x, NestedSequenceBatch):
                return NestedSequenceBatch(take(x.data), take(x.num_subseq),
                                           take(x.sub_length))
            if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                    and x.shape[0] % n == 0:
                split.append(True)
                return coll.local_chunk(x, 0, i, n)
            return x

        out = {k: take(v) for k, v in feed.items()}
        return out, bool(split)

    def _reduce_grads(self, grads: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The global batch's gradients, each in its parameter's layout:
        summed over the data axis and divided by its size (each rank's
        loss is its rows' mean, the global one their mean) — a
        reduce-scatter for a parameter sharded over ``data``, one
        all-reduce for the rest — then cut to this rank's chunk along
        any other sharded axis."""
        n = self._data_n
        group = self.mesh.group(DATA_AXIS)
        out: Dict[str, torch.Tensor] = {}
        rest = []
        for name, g in grads.items():
            ref = self.params[name]
            dims = [(self.mesh.axis_names[m], d)
                    for m, d in _shard_dims(ref)]
            data_dim = [d for a, d in dims if a == DATA_AXIS]
            if n > 1 and data_dim:
                g = coll.reduce_scatter_dim(g, data_dim[0], group) / n
            elif n > 1:
                rest.append(name)
            for a, d in dims:
                if a != DATA_AXIS:
                    g = coll.local_chunk(g, d, self.mesh.coordinate(a),
                                         self.mesh.shape[a])
            out[name] = g
        if rest:
            for name, s in zip(rest, coll.all_reduce_sum(
                    [out[k] for k in rest], group)):
                out[name] = s / n
        return out

    def _reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """A per-rank scalar's mean over the data axis."""
        n = self._data_n
        if n <= 1:
            return x
        return coll.all_reduce_sum([x.detach()],
                                   self.mesh.group(DATA_AXIS))[0] / n

    # ------------------------------------------------- sparse tables
    def _sparse_exchange_plan(self) -> Dict[str, List[str]]:
        """Sparse gradient exchange plan (``--sparse_grads``, read at the
        first step, as the reference builds its step then): param name →
        the feed keys (data layers) whose ids touch it.

        A ``sparse_update`` table is eligible when it is a 2-D table, not
        static, not pruned, used outside recurrent groups, and only by
        embedding layers fed directly by a data layer.  An ineligible
        table keeps the masked update, with a one-time notice.  While
        ``--health_interval`` is on no table is exchanged (the reference's
        other veto: the health path reads dense per-parameter
        gradients)."""
        if self._sparse_plan is None:
            self._sparse_plan = self._build_sparse_exchange_plan()
        return self._sparse_plan

    def _build_sparse_exchange_plan(self) -> Dict[str, List[str]]:
        net = self.network
        sparse_names = {n for n, s in net.param_specs.items()
                        if s.sparse_update and n not in net.static_params}
        if not FLAGS.get("sparse_grads") or not sparse_names:
            return {}
        if self._health is not None:
            warn_once(
                "trainer.sparse_exchange:health",
                "sparse gradient exchange disabled while "
                "--health_interval is active (health telemetry reads "
                "dense per-parameter gradients) — sparse tables take "
                "the lazy dense-masked update", logger=_log)
            return {}
        data_layers = {n for n, lyr in net.layers.items()
                       if lyr.conf.type == "data"}
        group_specs = {spec.name for g in net.groups.values()
                       for lyr in g.layers.values()
                       for spec in lyr.param_specs()}
        plan = {}
        for name in sorted(sparse_names):
            uses = [lyr for lyr in net.layers.values()
                    if any(spec.name == name for spec in lyr.param_specs())]
            eligible = (
                name not in (self._prune_masks or {})
                and name not in group_specs
                and self.params[name].dim() == 2
                and bool(uses)
                and all(lyr.conf.type == "embedding" and lyr.conf.inputs
                        and lyr.conf.inputs[0].input_layer_name
                        in data_layers for lyr in uses))
            if not eligible:
                warn_once(
                    f"trainer.sparse_exchange:ineligible:{name}",
                    "sparse_update parameter %r is not exchange-eligible "
                    "(used outside a directly-fed embedding layer, pruned, "
                    "or not a plain [V, D] table) — taking the lazy "
                    "dense-masked update", name, logger=_log)
                continue
            plan[name] = sorted({lyr.conf.inputs[0].input_layer_name
                                 for lyr in uses})
        return plan

    def _exchange_prefetch(self, ex_plan, feed):
        """Each exchanged table's batch: its ids deduped once into a
        sorted row set of ``--sparse_grad_rows`` slots (0: the batch's
        id count, which never overflows) and the touched rows gathered
        → ``(rows, blocks)`` by name."""
        cap_flag = int(FLAGS.get("sparse_grad_rows"))
        ex_rows, ex_blocks = {}, {}
        for name, keys in ex_plan.items():
            table = full_tensor(self.params[name])
            ids = torch.cat([value_of(feed[k]).to(torch.int32).reshape(-1)
                             for k in keys])
            if self._data_n > 1:
                # the union of every rank's rows: one row set for all
                ids = coll.all_gather_dim(ids, 0,
                                          self.mesh.group(DATA_AXIS))
            cap = cap_flag if cap_flag > 0 else ids.numel()
            rows = psparse.unique_rows_sorted(ids, cap, table.shape[0])
            ex_rows[name] = rows
            ex_blocks[name] = gather_rows(table, rows)
        return ex_rows, ex_blocks

    def _exchange_apply(self, ex_plan, ex_rows, block_grads, count, lr,
                        keep=None) -> Dict[str, tuple]:
        """The exchanged ``(rows, values)`` gradients applied as row
        updates of each table and its slots, in place
        (``Optimizer.apply_rows``), from the step's starting ``count``.
        Rows whose gradient is exactly zero are routed out first, as the
        masked path's inferred ``touched_row_mask`` leaves them, so both
        settings of ``--sparse_grads`` move the same rows.  Returns the
        new slots by name."""
        _, slots = self.opt_state
        new_slots = {}
        for name in ex_plan:
            ref = self.params[name]
            table = local_tensor(ref)
            row_g = block_grads[name].to(table.dtype)
            touched = (row_g != 0).flatten(1).any(dim=1)
            rows = ex_rows[name]
            dims = _shard_dims(ref)
            if dims:
                # a row-sharded table: this rank updates its own rows
                enforce([d for _, d in dims] == [0],
                        f"sparse exchange of {name!r}: the table must be "
                        "sharded on its rows only")
                axis = self.mesh.axis_names[dims[0][0]]
                off = self.mesh.coordinate(axis) * table.shape[0]
                rows = rows - off
                touched = touched & (rows >= 0) & (rows < table.shape[0])
            rows_eff = torch.where(touched, rows, table.shape[0])
            slot = tuple(local_tensor(x) for x in slots[name])
            table, (_, new_slot) = self.optimizer.apply_rows(
                table, rows_eff, row_g, (count, slot),
                lr * self._lr_scales[name], keep=keep)
            self.params[name] = like_placed(table, ref)
            new_slots[name] = tuple(like_placed(x, r) for x, r in
                                    zip(new_slot, slots[name]))
        return new_slots

    # ---------------------------------------------------------- the step
    def _place_feed(self, feed: Dict[str, Any]) -> Dict[str, Any]:
        """The feed's tensors on the trainer's device, placed on the
        calling thread (the input pipeline's workers call it, so the
        copy is issued while the step runs)."""
        return {k: _to_device(v, self.device) for k, v in feed.items()}

    def train_one_batch(self, feed: Dict[str, Any],
                        placed: bool = False) -> torch.Tensor:
        """One step; returns the loss as a 0-d tensor on the device (read
        it with ``float()`` when the host needs it).  ``placed=True``
        marks a feed already on the device (:meth:`_place_feed`).

        Telemetry: the ``train_step`` span and the histograms and
        counters of the module docstring; the step waits for its loss
        only while a metrics sink or an opened trace listens, or at a
        health drain."""
        with trace.span("train_step",
                        samples_seen=self.samples_seen) as sp:
            t0, t_feed, t_done, batch, loss = \
                self._traced_step_body(feed, placed)
            if self._health is not None and self._health.step_done():
                # drain due: its one device-to-host copy (the loss rides
                # it) is the health path's only fence; its summary lands
                # on this step's span
                report = self._health.drain(loss=loss)
                if report is not None \
                        and isinstance(getattr(sp, "attrs", None), dict):
                    sp.attrs.update(self._health.span_summary(report))
        observe.histogram(
            "train_host_feed_seconds",
            "host time sharding/placing the feed per step"
        ).observe(t_feed - t0)
        observe.histogram(
            "train_step_seconds",
            "end-to-end train_one_batch latency (unfenced = dispatch "
            "time unless a sink is attached)").observe(t_done - t0)
        observe.counter("train_steps", "train steps executed").inc()
        observe.counter("train_samples", "samples trained").inc(batch)
        self.samples_seen += batch
        return loss

    def _traced_step_body(self, feed: Dict[str, Any], placed: bool):
        """The span-covered phases of one step: feed -> dispatch ->
        fence.  The fence waits for an event recorded on the current
        stream after the step's launches, and runs only while a metrics
        sink (``observe.active()``) or an explicitly opened trace
        (``trace.fences_steps()``; not the ring a ``/trace`` scrape
        opens) listens."""
        t0 = time.perf_counter()
        with trace.span("feed", placed=placed):
            if not placed:
                feed = self._place_feed(feed)
            batch = _batch_size(feed)
        t_feed = time.perf_counter()
        with trace.span("step_dispatch"), global_stat.timer("train_batch"):
            loss = self._step(feed)
        t_dispatch = time.perf_counter()
        if observe.active() or trace.fences_steps():
            with trace.span("fence"):
                block_until_ready(loss)
            t_done = time.perf_counter()
            self._sync_precision_metrics()   # fenced anyway: keep fresh
            observe.histogram(
                "train_device_blocked_seconds",
                "time blocked on the device per step (fenced; only "
                "recorded while a metrics sink or trace is attached)"
            ).observe(t_done - t_dispatch)
            if t_done > t0:
                observe.gauge(
                    "train_samples_per_sec",
                    "fenced per-step training throughput"
                ).set(batch / (t_done - t0))
        else:
            t_done = t_dispatch
        return t0, t_feed, t_done, batch, loss

    def _sync_precision_metrics(self) -> None:
        """The loss-scale state into observe: the ``loss_scale`` gauge
        and the ``loss_scale_skipped_steps_total`` counter delta.  Reads
        the device, so the loop calls it at pass boundaries and on
        fenced steps only; no-op under ``--precision=fp32``."""
        if self._ls_state is None:
            return
        observe.gauge(
            "loss_scale",
            "current dynamic loss scale (--precision=bf16; grows 2x "
            "per overflow-free growth interval, halves on inf/nan "
            "gradients)").set(float(self._ls_state.scale))
        skipped = int(self._ls_state.skipped_total)
        delta = skipped - self._skipped_reported
        if delta > 0:
            observe.counter(
                "loss_scale_skipped_steps_total",
                "train steps skipped on non-finite gradients "
                "(parameters and optimizer state left untouched)"
            ).inc(delta)
            self._skipped_reported = skipped

    def _step_seed(self) -> int:
        """The step's dropout seed, as the JAX trainer derives its key."""
        return (self.seed * 1000003 + self.samples_seen) % (2 ** 31)

    def _step(self, feed: Dict[str, Any]) -> torch.Tensor:
        """Forward, backward and update on a placed feed; returns the
        loss (``samples_seen`` is advanced by the caller)."""
        lr = self.schedule(self.samples_seen)
        # a data-parallel step: this rank's rows, the parameters whole
        feed, split = self._shard_feed(feed)
        ex_plan = self._sparse_exchange_plan()
        ex_rows, ex_blocks = self._exchange_prefetch(ex_plan, feed)
        dense = {n: full_tensor(p).detach().requires_grad_(True)
                 for n, p in self.params.items() if n not in ex_plan}
        blocks = {n: b.requires_grad_(True) for n, b in ex_blocks.items()}
        # the exchanged tables enter the forward without a gradient: the
        # layers read their blocks
        tables = {n: full_tensor(self.params[n]) for n in ex_plan}
        inputs = [*dense.values(), *blocks.values()]
        rng = torch.Generator(device=self.device).manual_seed(
            self._step_seed())
        state = self._ls_state
        scope = data_parallel_scope(self.mesh) \
            if split and self._sync_grads else contextlib.nullcontext()
        if state is None:
            with psparse.exchange_scope(
                    {n: (ex_rows[n], blocks[n]) for n in ex_plan}), scope:
                loss, (_, buffers) = self.network.loss(
                    {**dense, **tables}, feed, self.buffers, rng=rng)
                raw = torch.autograd.grad(loss, inputs)
        else:
            # the ``--precision=bf16`` step (``_build_mixed_train_step``);
            # the blocks are cast inside, so their gradients come back f32
            pol = policy_for("bf16")
            with policy_scope(pol), scope:
                cparams = {n: p.to(pol.compute_dtype)
                           if p.is_floating_point() else p
                           for n, p in dense.items()}
                with psparse.exchange_scope(
                        {n: (ex_rows[n], b.to(pol.compute_dtype))
                         for n, b in blocks.items()}):
                    loss, (_, buffers) = self.network.loss(
                        {**cparams, **tables}, feed, self.buffers, rng=rng)
                scaled = loss * state.scale.to(loss.dtype)
                raw = torch.autograd.grad(scaled, inputs)
        grads = dict(zip(dense, raw[:len(dense)]))
        block_grads = dict(zip(blocks, raw[len(dense):]))
        finite = flags = None
        if state is not None:
            grads = ls.unscale(grads, state.scale)
            block_grads = ls.unscale(block_grads, state.scale)
            leaves = {**grads, **{f"{n}/block": g
                                  for n, g in block_grads.items()}}
            # one isfinite sweep, a flag a leaf: the skip decision is
            # their all(); with health on they come in its order (it
            # names every dense parameter, and no table is exchanged)
            flags = ls.leaf_finite_flags(
                leaves, list(leaves) if self._health is None
                else self._health.names)
            if self.mesh.size > 1 and self._sync_grads:
                # the global batch's flags in one all-reduce: one rank's
                # Inf skips every rank's step
                flags = coll.all_reduce_sum(
                    [(~flags).to(torch.int32)], None)[0] == 0
            finite = flags.all()
        grads = apply_prune_grads(grads, self._prune_masks)
        if self._sync_grads:
            # the global batch's gradients (clipping, the lazy rows'
            # masks and the update all read these)
            grads = self._reduce_grads(grads)
            if block_grads and self._data_n > 1:
                block_grads = dict(zip(block_grads, (
                    g / self._data_n for g in coll.all_reduce_sum(
                        list(block_grads.values()),
                        self.mesh.group(DATA_AXIS)))))
            loss = self._reduce_mean(loss)
        self._apply(dense, grads, ex_plan, ex_rows, block_grads, lr, finite,
                    flags)
        # sorted, as the reference's jitted step returns its buffers
        new_buffers = {n: buffers[n].detach() for n in sorted(buffers)}
        if state is None:
            self.buffers = new_buffers
        else:
            self.buffers = ls.select(finite, new_buffers, self.buffers)
            self._ls_state = ls.update(state, finite)
        return loss.detach()

    def _apply(self, dense, grads, ex_plan, ex_rows, block_grads, lr,
               finite, health_flags=None) -> None:
        """The update: the dense parameters through ``Optimizer.apply``,
        ``sparse_update`` tables outside the exchange with their touched
        rows' masks, the exchanged tables row by row; under the mixed
        step a non-finite ``finite`` keeps everything as it was.  With
        health on, the step's stats are folded in after the select (a
        skipped step reports a zero update and benign non-finites)."""
        masks = {n: psparse.touched_row_mask(grads[n])
                 for n, s in self.network.param_specs.items()
                 if s.sparse_update and n in grads}
        # the update runs on each parameter's resting layout: this
        # rank's shard of a placed one (its gradient reduce-scattered)
        old = {n: local_tensor(self.params[n]).detach() for n in dense}
        count, slots = self.opt_state
        old_opt = (count, {n: tuple(local_tensor(x) for x in slots[n])
                           for n in old})
        new_params, new_opt = self.optimizer.apply(
            old, grads, old_opt, lr, self._lr_scales,
            sparse_masks=masks or None)
        if finite is not None:
            new_params = ls.select(finite, new_params, old)
            new_opt = ls.select(finite, new_opt, old_opt)
        if self._health is not None:
            self._health.fold(grads, old, new_params,
                              applied=True if finite is None else finite,
                              finite_flags=health_flags)
        new_slots = dict(slots)
        new_slots.update({n: tuple(like_placed(x, r) for x, r in
                                   zip(slot, slots[n]))
                          for n, slot in new_opt[1].items()})
        new_slots.update(self._exchange_apply(ex_plan, ex_rows, block_grads,
                                              count, lr, keep=finite))
        self.params = {n: like_placed(new_params[n], p) if n in new_params
                       else p for n, p in self.params.items()}
        self.opt_state = (new_opt[0], new_slots)

    # ------------------------------------------------------ eval step
    def _eval_output_names(self) -> List[str]:
        """Layers whose values evaluators should see: a declared output
        that is a cost layer stands in for its first input (the
        prediction), as the reference wires evaluators."""
        names: List[str] = []
        for n in self.network.output_names:
            lyr = self.network.layers.get(n)
            if lyr is not None and getattr(lyr, "is_cost", False) \
                    and lyr.conf.inputs:
                names.append(lyr.conf.inputs[0].input_layer_name)
            else:
                names.append(n)
        return names

    def _build_eval_step(self) -> Callable:
        """The forward of ``test``: ``is_training=False`` under
        ``torch.no_grad()`` (and the bf16 policy under
        ``--precision=bf16``) → (loss, the declared outputs plus the
        evaluators' input layers)."""
        net = self.network
        eval_names = list(self._eval_output_names())
        # config-declared evaluators read their own input layers
        eval_names += [e["input_layer_name"]
                       for e in net.config.evaluators
                       if e.get("input_layer_name")]
        pol = policy_for("bf16") if self.precision == "bf16" else None

        def step(params, buffers, feed):
            scope = policy_scope(pol) if pol is not None \
                else contextlib.nullcontext()
            with torch.no_grad(), scope:
                loss, (values, _) = net.loss(params, feed, buffers,
                                             is_training=False)
            outs = dict(net.outputs(values))
            for n in eval_names:
                if n in values:
                    outs[n] = values[n]
            return loss, outs

        return step

    def _config_evaluators(self) -> list:
        """The model config's EvaluatorConfig entries, instantiated
        (reference: ``Evaluator::create`` from ``ModelConfig``)."""
        from ..evaluators import create_evaluator

        out = []
        for e in self.network.config.evaluators:
            extra = {k: v for k, v in e.items()
                     if k not in ("type", "name", "input_layer_name",
                                  "label_layer_name",
                                  "weight_layer_name")}
            evaluator = create_evaluator(e["type"], **extra)
            evaluator._config_entry = e
            out.append(evaluator)
        return out

    # ---------------------------------------------------- feed source
    def _pipeline_or_sync(self, reader, feeder):
        """This pass's batch source: an :class:`AsyncPipeline` (convert
        and device placement on worker threads) when
        ``--prefetch_depth`` > 0, else the raw reader iterator.  Returns
        ``(iterable, pipe)``; ``pipe`` is None on the synchronous path
        and must be ``close()``d otherwise."""
        depth = max(0, int(FLAGS.get("prefetch_depth")))
        if depth == 0:
            return iter(reader()), None
        from ..data.pipeline import AsyncPipeline
        pipe = AsyncPipeline(
            reader(),
            convert_fn=feeder.convert if feeder else None,
            place_fn=self._place_feed,
            depth=depth, workers=int(FLAGS.get("reader_workers")))
        return pipe, pipe

    @staticmethod
    def _refuse_unported() -> None:
        """Refuse, before any step, what ``train`` would reach and the
        port lacks."""
        if FLAGS.get("roofline_dump"):
            raise PaddleTpuError(
                "--roofline_dump is not ported yet (the cost attribution "
                "of observe/costmodel.py, queue A10b part 3); leave it "
                "empty")

    def _pass_boundary_observability(self) -> None:
        """Once-per-pass telemetry kept off the step: the health drain of
        a partial interval, and the HBM gauges (``observe/memory.sample``),
        sampled only when a metrics sink or the ``/metrics`` endpoint is
        live."""
        from ..observe import http as ohttp
        from ..observe import memory as omem

        if self._health is not None and self._health.pending():
            # end-of-pass drain: whatever accumulated since the last
            # interval boundary is published before the pass closes
            self._health.drain()
        if observe.active() or ohttp.serving():
            omem.sample(self)

    # ------------------------------------------------------ the loops
    def train(self, reader, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeder=None, test_reader=None,
              evaluators: Sequence = ()) -> None:
        """Passes over ``reader`` (raw minibatches, converted by
        ``feeder``): ``BeginPass``, then a ``BeginIteration`` and a step
        a batch (an ``EndIteration`` with the loss every
        ``--log_period`` batches), ``test`` on ``test_reader``, a
        checkpoint into ``--save_dir`` every ``--saving_period`` passes,
        and ``EndPass`` with the pass's last cost and the test
        metrics."""
        event_handler = event_handler or _default_event_handler
        self._refuse_unported()
        observe.start_from_flags()
        wait_hist = observe.histogram(
            "data_reader_wait_seconds",
            "host time blocked on input per batch: the raw reader on "
            "the synchronous path, the prefetch queue when the async "
            "pipeline is on (--prefetch_depth > 0) — an input-pipeline "
            "stall either way")
        start = int(FLAGS.get("start_pass"))
        for pass_id in range(start, start + num_passes):
            event_handler(ev.BeginPass(pass_id))
            last_loss = None
            batch_id = 0
            # input wait vs train time per pass: the input-bound ratio
            wait_s, busy_s = 0.0, 0.0
            # the pass span is the trace root of the pass: the step spans
            # nest under it, and the pipeline's workers (created inside
            # it) adopt its context
            with trace.span("train_pass", pass_id=pass_id):
                src, pipe = self._pipeline_or_sync(reader, feeder)
                batches = iter(src)
                try:
                    while True:
                        t0 = time.perf_counter()
                        with trace.span("input_wait"):
                            batch = next(batches, _PASS_END)
                        if batch is _PASS_END:
                            break
                        dt = time.perf_counter() - t0
                        wait_s += dt
                        wait_hist.observe(dt)
                        event_handler(ev.BeginIteration(pass_id, batch_id))
                        t1 = time.perf_counter()
                        if pipe is not None:    # converted+placed upstream
                            feed = batch
                        else:
                            feed = feeder.convert(batch) if feeder \
                                else batch
                        loss = self.train_one_batch(feed,
                                                    placed=pipe is not None)
                        busy_s += time.perf_counter() - t1
                        last_loss = loss
                        log_period = FLAGS.get("log_period")
                        if log_period and (batch_id + 1) % log_period == 0:
                            event_handler(ev.EndIteration(
                                pass_id=pass_id, batch_id=batch_id,
                                cost=float(loss)))
                        stats_period = FLAGS.get(
                            "show_parameter_stats_period")
                        if stats_period and \
                                (batch_id + 1) % stats_period == 0:
                            from ..utils.profiler import parameter_stats
                            _log.info("parameter stats:\n%s",
                                      parameter_stats(self._full_params()))
                        batch_id += 1
                finally:
                    if pipe is not None:
                        pipe.close()
            self._sync_precision_metrics()   # pass boundary: one sync
            self._pass_boundary_observability()
            if wait_s + busy_s > 0:
                observe.gauge(
                    "input_bound_ratio",
                    "input wait / (input wait + train time) of the "
                    "last completed pass — reader wait on the sync "
                    "path, prefetch-queue wait with the async "
                    "pipeline; ~0 compute-bound, →1 input-bound"
                ).set(wait_s / (wait_s + busy_s))
            metrics = {}
            if test_reader is not None:
                metrics.update(self.test(test_reader, feeder, evaluators))
            save_dir, period = FLAGS.get("save_dir"), \
                FLAGS.get("saving_period")
            if save_dir and period and (pass_id + 1) % period == 0:
                self.save(save_dir, pass_id)
            event_handler(ev.EndPass(
                pass_id=pass_id,
                metrics={"cost": float(last_loss) if last_loss is not None
                         else float("nan"), **metrics}))

    def test(self, reader, feeder=None, evaluators: Sequence = (),
             label_name: str = "label") -> Dict[str, float]:
        """``Tester::test``: the eval step over ``reader``, ``test_cost``
        (the per-sample mean loss) and the evaluators' metrics; with no
        explicit ``evaluators``, the model config's.  Each batch's
        evaluator inputs are moved to the host once and shared."""
        if self._eval_step is None:
            self._eval_step = self._build_eval_step()
        if not evaluators:
            evaluators = self._config_evaluators()
        total, n = 0.0, 0
        eval_names = self._eval_output_names() if evaluators else []
        for e in evaluators:
            e.start()
        # every rank evaluates the whole batch with the whole parameters:
        # the loss and the evaluators see the global batch
        params = self._full_params()
        with trace.span("test_pass"):
            src, pipe = self._pipeline_or_sync(reader, feeder)
            try:
                for batch in src:
                    if pipe is not None:    # converted+placed upstream
                        feed = batch
                    else:
                        feed = feeder.convert(batch) if feeder else batch
                        feed = self._place_feed(feed)
                    loss, outputs = self._eval_step(params, self.buffers,
                                                    feed)
                    b = _batch_size(feed)
                    total += float(loss) * b
                    n += b
                    if evaluators:
                        self._eval_batch(evaluators, eval_names, outputs,
                                         feed, label_name)
            finally:
                if pipe is not None:
                    pipe.close()
        metrics = {"test_cost": total / max(n, 1)}
        for e in evaluators:
            vals = e.finish()
            entry = getattr(e, "_config_entry", None)
            ename = (entry or {}).get("name", "")
            if ename and not ename.startswith("__"):
                # explicit evaluator names always prefix their metrics
                vals = {f"{ename}.{k}": v for k, v in vals.items()}
            else:
                # auto-named evaluators prefix only on collision
                vals = {(k if k not in metrics
                         else f"{ename.strip('_')}.{k}"): v
                        for k, v in vals.items()}
            metrics.update(vals)
        return metrics

    @staticmethod
    def _eval_batch(evaluators, eval_names, outputs, feed,
                    label_name) -> None:
        """One batch into every evaluator: a config evaluator reads its
        entry's layers, the others the prediction (the first of
        ``eval_names`` present) and ``feed[label_name]``."""
        hosted: Dict[int, Any] = {}

        def host(v):
            if v is None:
                return None
            if id(v) not in hosted:
                hosted[id(v)] = _to_host(v)
            return hosted[id(v)]

        out0 = outputs.get(eval_names[0]) if eval_names else None
        if out0 is None:
            out0 = next(iter(outputs.values()))
        for e in evaluators:
            entry = getattr(e, "_config_entry", None)
            if not entry:
                e.eval_batch(host(out0), host(feed.get(label_name)))
                continue
            ein = outputs.get(entry["input_layer_name"])
            if ein is None:
                _log.warning("evaluator %s: input layer %r not in eval "
                             "outputs; skipping", entry.get("name"),
                             entry["input_layer_name"])
                continue
            elab = feed.get(entry.get("label_layer_name", label_name))
            w = feed.get(entry["weight_layer_name"]) \
                if entry.get("weight_layer_name") else None
            if w is not None and \
                    "weight" in e.eval_batch.__code__.co_varnames:
                e.eval_batch(host(ein), host(elab), weight=host(w))
            else:
                e.eval_batch(host(ein), host(elab))

    def time_job(self, reader, feeder=None, warmup: int = 3,
                 batches: int = 20) -> Dict[str, float]:
        """``--job=time`` (``TrainerBenchmark.cpp``): steady-state
        ms/batch and samples/s after ``warmup`` steps.  Every feed is on
        the device before the clock starts."""
        it = iter(reader())
        feeds = []
        for _ in range(warmup + batches):
            try:
                batch = next(it)
            except StopIteration:
                break
            feeds.append(self._place_feed(
                feeder.convert(batch) if feeder else batch))
        enforce(len(feeds) > warmup, "not enough batches to time")
        loss = None
        for f in feeds[:warmup]:
            loss = self.train_one_batch(f, placed=True)
        if loss is not None:
            float(loss)
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        samples = 0
        for f in feeds[warmup:]:
            loss = self.train_one_batch(f, placed=True)
            samples += _batch_size(f)
        float(loss)
        dt = time.perf_counter() - t0
        timed = len(feeds) - warmup
        return {
            "ms_per_batch": dt / timed * 1e3,
            "samples_per_sec": samples / dt,
            "batches": timed,
        }

    def check_gradients(self, feed: Dict[str, Any],
                        eps: Optional[float] = None,
                        max_checks_per_param: int = 4,
                        rtol: float = 5e-2) -> bool:
        """``--job=checkgrad`` (``Trainer::checkGradient``): True when no
        check of :meth:`gradient_misses` misses."""
        return not any(self.gradient_misses(
            feed, eps, max_checks_per_param, rtol).values())

    def gradient_misses(self, feed: Dict[str, Any],
                        eps: Optional[float] = None,
                        max_checks_per_param: int = 4,
                        rtol: float = 5e-2) -> Dict[str, int]:
        """Every parameter's autograd gradient at up to
        ``max_checks_per_param`` elements (drawn by
        ``np.random.RandomState(5)``, as the reference draws them)
        against central differences of step ``eps``
        (``--checkgrad_eps``) on one batch, in fp32 with
        ``is_training=False``: each parameter's number of misses, by
        sorted name.  Each miss logs a warning."""
        eps = eps or FLAGS.get("checkgrad_eps")
        feed = self._place_feed(feed)
        misses: Dict[str, int] = {}
        whole = self._full_params()
        with full_precision():
            def loss_fn(p):
                return self.network.loss(p, feed, self.buffers,
                                         is_training=False)[0]

            params = {n: p.detach().requires_grad_(True)
                      for n, p in whole.items()}
            grads = dict(zip(params, torch.autograd.grad(
                loss_fn(params), list(params.values()),
                allow_unused=True)))
            with torch.no_grad():
                # sorted: the order of the reference's gradient dict
                for name in sorted(grads):
                    p, g = whole[name], grads[name]
                    idxs = np.random.RandomState(5).choice(
                        p.numel(), size=min(max_checks_per_param,
                                            p.numel()), replace=False)
                    auto = (torch.zeros(len(idxs)) if g is None else
                            g.reshape(-1)[torch.as_tensor(
                                idxs, device=g.device)].cpu())
                    misses[name] = 0
                    for j, idx in enumerate(idxs):
                        lp = float(loss_fn({**whole,
                                            name: _bump(p, idx, eps)}))
                        lm = float(loss_fn({**whole,
                                            name: _bump(p, idx, -eps)}))
                        fd = (lp - lm) / (2 * eps)
                        ag = float(auto[j])
                        if abs(ag - fd) > rtol * max(abs(fd), 1e-3):
                            _log.warning(
                                "checkgrad FAIL %s[%d]: auto=%g fd=%g",
                                name, idx, ag, fd)
                            misses[name] += 1
        return misses

    # ---------------------------------------------------- persistence
    def save(self, save_dir: str, pass_id: int) -> str:
        """Write ``<save_dir>/pass-%05d`` (``checkpoint.save_checkpoint``)
        with ``samples_seen`` and, under ``--precision=bf16``, the loss
        scale's state in the manifest; returns the dir.  Reads the
        state back from the device."""
        meta: Dict[str, Any] = {"samples_seen": self.samples_seen}
        if self._ls_state is not None:
            meta["loss_scale"] = {
                "scale": float(self._ls_state.scale),
                "growth_count": int(self._ls_state.growth_count),
                "skipped_total": int(self._ls_state.skipped_total),
            }
        return save_checkpoint(save_dir, pass_id, self.params,
                               self.opt_state, self.buffers, meta=meta,
                               shard=self.fsdp and self._data_n > 1,
                               mesh=self.mesh)

    def load(self, ckpt_dir: str, _verified: bool = False) -> None:
        """Load a checkpoint dir (of either package) onto the trainer's
        device: the parameters (one the dir lacks raises unless
        ``--load_missing_parameter_strategy`` is not ``fail``, and then
        keeps its value), the buffers, the optimizer state, and from the
        manifest ``samples_seen`` and the loss scale.  Under
        ``--ckpt_verify`` the digests are checked first (``_verified``:
        ``resume`` has checked them).  Pruning masks are made anew from
        the loaded values."""
        if FLAGS.get("ckpt_verify") and not _verified \
                and not verify_checkpoint(ckpt_dir):
            raise PaddleTpuError(
                f"checkpoint {ckpt_dir!r} failed integrity verification "
                "(manifest digest mismatch or torn files); pass "
                "--ckpt_verify=false to force the legacy blind load")
        loaded = load_params(ckpt_dir)
        missing = set(self.params) - set(loaded)
        if missing:
            strategy = FLAGS.get("load_missing_parameter_strategy")
            if strategy == "fail":
                raise KeyError(f"checkpoint missing parameters: {missing}")
            _log.warning("checkpoint missing %s (strategy=%s)", missing,
                         strategy)
        self.params = {k: self._placed(loaded[k]) if k in loaded else v
                       for k, v in self.params.items()}
        bufs = load_buffers(ckpt_dir)
        if bufs:
            self.buffers = {k: self._placed(v) for k, v in bufs.items()}
        opt = load_opt_state(ckpt_dir, self.opt_state)
        if opt is not None:
            count, slots = opt
            self.opt_state = (self._placed(count), {
                n: tuple(self._placed(x) for x in s)
                for n, s in slots.items()})
        try:
            man = load_manifest(ckpt_dir)
        except FileNotFoundError:
            man = None
        if man is not None:
            self.samples_seen = man.get("samples_seen", 0)
            if self._ls_state is not None and "loss_scale" in man:
                m = man["loss_scale"]
                dev = self.device
                self._ls_state = ls.LossScaleState(
                    scale=torch.tensor(float(m["scale"]),
                                       dtype=torch.float32, device=dev),
                    growth_count=torch.tensor(
                        int(m.get("growth_count", 0)), dtype=torch.int32,
                        device=dev),
                    skipped_total=torch.tensor(
                        int(m.get("skipped_total", 0)), dtype=torch.int32,
                        device=dev))
        if self._prune_masks:
            # masks from the LOADED values (the reference's hook inits
            # after any --init_model_path load)
            self._prune_masks = build_prune_masks(
                self.network.param_specs, self.params)
            self.params = apply_prune_init(self.params, self._prune_masks)
        if self._specs is not None:   # constructed: back at rest
            self._place_state()

    def _placed(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.require(arr, requirements="C")).to(
            self.device)

    def resume(self, save_dir: str) -> bool:
        """Load the newest checkpoint under ``save_dir`` that passes
        digest verification, scanning back past (and quarantining)
        corrupt dirs; ``--ckpt_verify=false`` loads the newest blindly.
        False when there is none."""
        if self.mesh.size > 1:
            # one rank scans (and quarantines) the directory, every rank
            # loads what it found
            import torch.distributed as dist
            found = [self._latest(save_dir) if dist.get_rank() == 0
                     else None]
            dist.broadcast_object_list(found, src=0)
            ckpt = found[0]
        else:
            ckpt = self._latest(save_dir)
        if ckpt is None:
            return False
        self.load(ckpt, _verified=FLAGS.get("ckpt_verify"))
        return True


    @staticmethod
    def _latest(save_dir: str) -> Optional[str]:
        if FLAGS.get("ckpt_verify"):
            return latest_valid_checkpoint(save_dir)
        return latest_checkpoint(save_dir)


def _bump(p: torch.Tensor, idx: int, delta: float) -> torch.Tensor:
    """``p`` with ``delta`` added to its ``idx``-th element (flat)."""
    q = p.detach().clone()
    q.view(-1)[int(idx)] += delta
    return q


def _batch_size(feed: Dict[str, Any]) -> int:
    for v in feed.values():
        return value_of(v).shape[0]
    return 0


def _default_event_handler(event) -> None:
    if isinstance(event, ev.EndIteration):
        _log.info("pass %d batch %d cost=%.6f",
                  event.pass_id, event.batch_id, event.cost)
    elif isinstance(event, ev.EndPass):
        _log.info("pass %d done: %s", event.pass_id, event.metrics)
