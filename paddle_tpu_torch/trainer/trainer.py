"""Single-device trainer (counterpart of ``paddle_tpu/trainer/trainer.py``,
its fp32 step).

``Trainer.train_one_batch(feed)`` runs forward, autograd backward and
the optimizer update: the JAX package's jitted step without its sparse,
FSDP, health and pruning branches.  The schedule is the constant one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..config.model_config import OptimizationConfig
from ..core.device import resolve_device
from ..core.sequence import SequenceBatch, value_of
from ..layers.network import NeuralNetwork
from ..optimizer.optimizers import Optimizer, create_optimizer
from ..utils import enforce


def optimizer_from_config(oc: OptimizationConfig) -> Tuple[Optimizer, Any]:
    """OptimizationConfig → (optimizer, lr schedule)."""
    enforce((oc.learning_rate_schedule or "constant") == "constant",
            f"learning_rate_schedule {oc.learning_rate_schedule!r} is not "
            "ported; only 'constant'")
    enforce(oc.precision in ("", "fp32"),
            f"precision {oc.precision!r} is not ported; only fp32")
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
        self.optimizer, self.schedule = optimizer_from_config(
            opt_config or OptimizationConfig())
        self.params = network.init_params(seed, self.device)
        self.opt_state = self.optimizer.init_state(self.params)
        self._lr_scales = network.lr_scales(self.params)
        self.samples_seen = 0

    def train_one_batch(self, feed: Dict[str, Any]) -> torch.Tensor:
        """One step; returns the loss as a 0-d tensor on the device (read
        it with ``float()`` when the host needs it)."""
        feed = {k: _to_device(v, self.device) for k, v in feed.items()}
        params = {n: p.detach().requires_grad_(True)
                  for n, p in self.params.items()}
        loss, _ = self.network.loss(params, feed)
        grads = torch.autograd.grad(loss, list(params.values()))
        lr = self.schedule(self.samples_seen)
        self.params, self.opt_state = self.optimizer.apply(
            {n: p.detach() for n, p in params.items()},
            dict(zip(params, grads)), self.opt_state, lr, self._lr_scales)
        self.samples_seen += value_of(next(iter(feed.values()))).shape[0]
        return loss.detach()
