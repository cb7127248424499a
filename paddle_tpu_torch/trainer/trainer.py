"""Single-device trainer (counterpart of ``paddle_tpu/trainer/trainer.py``,
its fp32 step and its ``--precision=bf16`` mixed step).

``Trainer.train_one_batch(feed)`` runs forward, autograd backward and
the optimizer update: the JAX package's jitted step without its FSDP,
health and pruning branches.  The schedule is the constant one.
The step carries the network's buffers (batch-norm running statistics):
it starts from ``network.init_buffers()`` and keeps the buffers each
step returns.

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
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..config.model_config import OptimizationConfig
from ..core.device import resolve_device
from ..core.dtypes import policy_for, policy_scope, resolve_precision
from ..core.sequence import SequenceBatch, value_of
from ..layers.network import NeuralNetwork
from ..ops.embedding import gather_rows
from ..optimizer import loss_scale as ls
from ..optimizer.optimizers import Optimizer, create_optimizer
from ..parallel import sparse as psparse
from ..utils import FLAGS, enforce, get_logger, warn_once

_log = get_logger("trainer")


def optimizer_from_config(oc: OptimizationConfig) -> Tuple[Optimizer, Any]:
    """OptimizationConfig → (optimizer, lr schedule)."""
    enforce((oc.learning_rate_schedule or "constant") == "constant",
            f"learning_rate_schedule {oc.learning_rate_schedule!r} is not "
            "ported; only 'constant'")
    kw: Dict[str, Any] = dict(
        learning_rate=oc.learning_rate,
        weight_decay=oc.l2_weight_decay,
        gradient_clipping_threshold=oc.gradient_clipping_threshold,
    )
    name = oc.learning_method or "sgd"
    if name == "adam":
        kw.update(beta1=oc.adam_beta1, beta2=oc.adam_beta2,
                  epsilon=oc.adam_epsilon)
    lr = oc.learning_rate
    return create_optimizer(name, **kw), (lambda progress: lr)


def _to_device(v, dev: torch.device):
    """A feed value (tensor, numpy array or SequenceBatch of either) as
    tensors on ``dev``."""
    if isinstance(v, SequenceBatch):
        return SequenceBatch(torch.as_tensor(v.data).to(dev),
                             torch.as_tensor(v.length).to(dev))
    return torch.as_tensor(v).to(dev)


class Trainer:
    """Owns the parameters and optimizer state of one network on one
    device (default CUDA; raises when CUDA is absent and the CPU was not
    asked for).  Parameters are drawn by ``network.init_params(seed)``;
    assign ``trainer.params`` (same names and shapes) to start from
    others."""

    def __init__(self, network: NeuralNetwork,
                 opt_config: Optional[OptimizationConfig] = None,
                 seed: int = 1,
                 device: Optional[Union[str, torch.device]] = None):
        self.network = network
        self.device = resolve_device(device)
        oc = opt_config or OptimizationConfig()
        self.optimizer, self.schedule = optimizer_from_config(oc)
        self.precision = resolve_precision(oc)
        self.params = network.init_params(seed, self.device)
        self.buffers = network.init_buffers(self.device)
        self.opt_state = self.optimizer.init_state(self.params)
        self._lr_scales = network.lr_scales(self.params)
        self.samples_seen = 0
        # the dynamic loss scale of the bf16 step (None under fp32)
        self._ls_state = ls.init_state(device=self.device) \
            if self.precision == "bf16" else None
        self._sparse_plan: Optional[Dict[str, List[str]]] = None

    # ------------------------------------------------- sparse tables
    def _sparse_exchange_plan(self) -> Dict[str, List[str]]:
        """Sparse gradient exchange plan (``--sparse_grads``, read at the
        first step, as the reference builds its step then): param name →
        the feed keys (data layers) whose ids touch it.

        A ``sparse_update`` table is eligible when it is a 2-D table, not
        static, used outside recurrent groups, and only by embedding
        layers fed directly by a data layer.  An ineligible table keeps
        the masked update, with a one-time notice.  The reference's
        other vetoes (pruned tables, ``--health_interval``) have no
        counterpart: the port has neither pruning nor health
        telemetry."""
        if self._sparse_plan is None:
            self._sparse_plan = self._build_sparse_exchange_plan()
        return self._sparse_plan

    def _build_sparse_exchange_plan(self) -> Dict[str, List[str]]:
        net = self.network
        sparse_names = {n for n, s in net.param_specs.items()
                        if s.sparse_update and n not in net.static_params}
        if not FLAGS.get("sparse_grads") or not sparse_names:
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
                name not in group_specs
                and self.params[name].dim() == 2
                and bool(uses)
                and all(lyr.conf.type == "embedding" and lyr.conf.inputs
                        and lyr.conf.inputs[0].input_layer_name
                        in data_layers for lyr in uses))
            if not eligible:
                warn_once(
                    f"trainer.sparse_exchange:ineligible:{name}",
                    "sparse_update parameter %r is not exchange-eligible "
                    "(used outside a directly-fed embedding layer, or not "
                    "a plain [V, D] table) — taking the lazy dense-masked "
                    "update", name, logger=_log)
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
            table = self.params[name]
            ids = torch.cat([value_of(feed[k]).to(torch.int32).reshape(-1)
                             for k in keys])
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
            table = self.params[name]
            row_g = block_grads[name].to(table.dtype)
            touched = (row_g != 0).flatten(1).any(dim=1)
            rows_eff = torch.where(touched, ex_rows[name], table.shape[0])
            _, (_, new_slots[name]) = self.optimizer.apply_rows(
                table, rows_eff, row_g, (count, slots[name]),
                lr * self._lr_scales[name], keep=keep)
        return new_slots

    # ---------------------------------------------------------- the step
    def train_one_batch(self, feed: Dict[str, Any]) -> torch.Tensor:
        """One step; returns the loss as a 0-d tensor on the device (read
        it with ``float()`` when the host needs it)."""
        feed = {k: _to_device(v, self.device) for k, v in feed.items()}
        lr = self.schedule(self.samples_seen)
        ex_plan = self._sparse_exchange_plan()
        ex_rows, ex_blocks = self._exchange_prefetch(ex_plan, feed)
        dense = {n: p.detach().requires_grad_(True)
                 for n, p in self.params.items() if n not in ex_plan}
        blocks = {n: b.requires_grad_(True) for n, b in ex_blocks.items()}
        # the exchanged tables enter the forward without a gradient: the
        # layers read their blocks
        tables = {n: self.params[n] for n in ex_plan}
        inputs = [*dense.values(), *blocks.values()]
        state = self._ls_state
        if state is None:
            with psparse.exchange_scope(
                    {n: (ex_rows[n], blocks[n]) for n in ex_plan}):
                loss, (_, buffers) = self.network.loss(
                    {**dense, **tables}, feed, self.buffers)
            raw = torch.autograd.grad(loss, inputs)
        else:
            # the ``--precision=bf16`` step (``_build_mixed_train_step``);
            # the blocks are cast inside, so their gradients come back f32
            pol = policy_for("bf16")
            with policy_scope(pol):
                cparams = {n: p.to(pol.compute_dtype)
                           if p.is_floating_point() else p
                           for n, p in dense.items()}
                with psparse.exchange_scope(
                        {n: (ex_rows[n], b.to(pol.compute_dtype))
                         for n, b in blocks.items()}):
                    loss, (_, buffers) = self.network.loss(
                        {**cparams, **tables}, feed, self.buffers)
                scaled = loss * state.scale.to(loss.dtype)
            raw = torch.autograd.grad(scaled, inputs)
        grads = dict(zip(dense, raw[:len(dense)]))
        block_grads = dict(zip(blocks, raw[len(dense):]))
        finite = None
        if state is not None:
            grads = ls.unscale(grads, state.scale)
            block_grads = ls.unscale(block_grads, state.scale)
            finite = ls.all_finite({**grads, **{
                f"{n}/block": g for n, g in block_grads.items()}})
        self._apply(dense, grads, ex_plan, ex_rows, block_grads, lr, finite)
        new_buffers = {n: b.detach() for n, b in buffers.items()}
        if state is None:
            self.buffers = new_buffers
        else:
            self.buffers = ls.select(finite, new_buffers, self.buffers)
            self._ls_state = ls.update(state, finite)
        self.samples_seen += value_of(next(iter(feed.values()))).shape[0]
        return loss.detach()

    def _apply(self, dense, grads, ex_plan, ex_rows, block_grads, lr,
               finite) -> None:
        """The update: the dense parameters through ``Optimizer.apply``,
        ``sparse_update`` tables outside the exchange with their touched
        rows' masks, the exchanged tables row by row; under the mixed
        step a non-finite ``finite`` keeps everything as it was."""
        masks = {n: psparse.touched_row_mask(grads[n])
                 for n, s in self.network.param_specs.items()
                 if s.sparse_update and n in grads}
        old = {n: p.detach() for n, p in dense.items()}
        count, slots = self.opt_state
        old_opt = (count, {n: slots[n] for n in old})
        new_params, new_opt = self.optimizer.apply(
            old, grads, old_opt, lr, self._lr_scales,
            sparse_masks=masks or None)
        if finite is not None:
            new_params = ls.select(finite, new_params, old)
            new_opt = ls.select(finite, new_opt, old_opt)
        new_slots = dict(slots)
        new_slots.update(new_opt[1])
        new_slots.update(self._exchange_apply(ex_plan, ex_rows, block_grads,
                                              count, lr, keep=finite))
        self.params = {n: new_params.get(n, p)
                       for n, p in self.params.items()}
        self.opt_state = (new_opt[0], new_slots)
