"""Single-device trainer (counterpart of ``paddle_tpu/trainer/trainer.py``,
its fp32 step and its ``--precision=bf16`` mixed step).

``Trainer.train_one_batch(feed)`` runs forward, autograd backward and
the optimizer update: the JAX package's jitted step without its sparse,
FSDP, health and pruning branches.  The schedule is the constant one.
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
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..config.model_config import OptimizationConfig
from ..core.device import resolve_device
from ..core.dtypes import policy_for, policy_scope, resolve_precision
from ..core.sequence import SequenceBatch, value_of
from ..layers.network import NeuralNetwork
from ..optimizer import loss_scale as ls
from ..optimizer.optimizers import Optimizer, create_optimizer
from ..utils import enforce


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

    def train_one_batch(self, feed: Dict[str, Any]) -> torch.Tensor:
        """One step; returns the loss as a 0-d tensor on the device (read
        it with ``float()`` when the host needs it)."""
        feed = {k: _to_device(v, self.device) for k, v in feed.items()}
        params = {n: p.detach().requires_grad_(True)
                  for n, p in self.params.items()}
        lr = self.schedule(self.samples_seen)
        if self._ls_state is None:
            loss, (_, buffers) = self.network.loss(params, feed,
                                                   self.buffers)
            grads = torch.autograd.grad(loss, list(params.values()))
            self.buffers = {n: b.detach() for n, b in buffers.items()}
            self.params, self.opt_state = self.optimizer.apply(
                {n: p.detach() for n, p in params.items()},
                dict(zip(params, grads)), self.opt_state, lr,
                self._lr_scales)
        else:
            loss = self._mixed_step(params, feed, lr)
        self.samples_seen += value_of(next(iter(feed.values()))).shape[0]
        return loss.detach()

    def _mixed_step(self, params, feed, lr) -> torch.Tensor:
        """The ``--precision=bf16`` step (``_build_mixed_train_step`` of
        the JAX trainer); updates params, optimizer and loss-scale state
        and returns the unscaled loss."""
        pol = policy_for("bf16")
        state = self._ls_state
        with policy_scope(pol):
            cparams = {n: p.to(pol.compute_dtype) if p.is_floating_point()
                       else p for n, p in params.items()}
            loss, (_, buffers) = self.network.loss(cparams, feed,
                                                   self.buffers)
            scaled = loss * state.scale.to(loss.dtype)
        grads = ls.unscale(dict(zip(params, torch.autograd.grad(
            scaled, list(params.values())))), state.scale)
        finite = ls.all_finite(grads)
        old = {n: p.detach() for n, p in params.items()}
        new_params, new_opt = self.optimizer.apply(
            old, grads, self.opt_state, lr, self._lr_scales)
        self.params = ls.select(finite, new_params, old)
        self.opt_state = ls.select(finite, new_opt, self.opt_state)
        self.buffers = ls.select(finite, {n: b.detach() for n, b in
                                          buffers.items()}, self.buffers)
        self._ls_state = ls.update(state, finite)
        return loss
