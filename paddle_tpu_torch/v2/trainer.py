"""``paddle.v2.trainer`` (counterpart of ``paddle_tpu/v2/trainer.py``): the
SGD event-loop trainer.

Reference: ``python/paddle/v2/trainer.py:24`` — ``SGD(cost, parameters,
update_equation).train(reader, num_passes, event_handler, feeding)``.
A thin layer over the port's ``trainer.Trainer``: ``device`` (default
CUDA; raises when CUDA is absent and the CPU was not asked for) goes to
it, and ``feeding`` becomes a ``DataFeeder`` built from the data layers'
sizes and input-type attrs, as in the JAX package.  ``is_local=False``
(the parameter server's remote updater) refuses by name (queue A9).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..config.dsl import topology
from ..data.feeder import DataFeeder, InputType
from ..layers.network import NeuralNetwork
from ..trainer.trainer import Trainer as _CoreTrainer
from ..utils import PaddleTpuError
from .optimizer import Optimizer


class SGD:
    def __init__(self, cost, parameters=None, update_equation: Optimizer = None,
                 extra_layers=None, is_local: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        if not is_local:
            raise PaddleTpuError(
                "v2.trainer.SGD(is_local=False): the remote (parameter "
                "server) updater is not ported yet (queue A9)")
        self.model_config = topology(cost, extra_layers)
        self.network = NeuralNetwork(self.model_config)
        opt_conf = update_equation.conf if update_equation else None
        self.core = _CoreTrainer(self.network, opt_config=opt_conf,
                                 device=device)
        if parameters is not None:
            parameters.attach(self.core)

    def _feeder(self, feeding) -> Optional[DataFeeder]:
        if feeding is None:
            return None
        lmap = {l.name: l for l in self.model_config.layers}
        order = sorted(feeding, key=lambda n: feeding[n]) \
            if isinstance(feeding, dict) else list(feeding)
        pairs = []
        for name in order:
            conf = lmap[name]
            pairs.append((name, InputType(
                dim=conf.size,
                seq_level=conf.attrs.get("seq_level", 0),
                kind=conf.attrs.get("kind", "dense"))))
        return DataFeeder(pairs)

    def train(self, reader, num_passes: int = 1, event_handler=None,
              feeding=None, test_reader=None, evaluators: Sequence = ()):
        self.core.train(reader, num_passes=num_passes,
                        event_handler=event_handler,
                        feeder=self._feeder(feeding),
                        test_reader=test_reader, evaluators=evaluators)

    def test(self, reader, feeding=None, evaluators: Sequence = ()):
        return self.core.test(reader, self._feeder(feeding), evaluators)

    @property
    def parameters(self):
        from .parameters import Parameters

        p = Parameters()
        p.attach(self.core)
        return p
