"""``paddle.v2.inference`` (counterpart of ``paddle_tpu/v2/inference.py``;
reference ``Inference:10``, ``infer():111``).

The network runs in eval mode under ``torch.no_grad()`` on ``device``
(default CUDA; raises when CUDA is absent and the CPU was not asked
for): each parameter given is written there as a float32 tensor, each
feed placed there.  Outputs come back as numpy.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..config.dsl import topology
from ..core.device import resolve_device
from ..core.sequence import value_of
from ..layers.network import NeuralNetwork
from ..trainer.trainer import _to_device


def _np(v) -> np.ndarray:
    return value_of(v).detach().cpu().numpy()


class Inference:
    def __init__(self, output_layer, parameters=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.model_config = topology(output_layer)
        self.network = NeuralNetwork(self.model_config)
        self.device = resolve_device(device)
        self.params = self.network.init_params(device=self.device)
        self.buffers = self.network.init_buffers(self.device)
        if parameters is not None:
            for name in parameters.names():
                if name in self.params:
                    self.params[name] = torch.from_numpy(np.array(
                        parameters.get(name), dtype=np.float32)).to(
                            self.device)

    def iter_infer(self, input, feeding=None, field=None):
        from .trainer import SGD

        feeder = SGD._feeder(self, feeding) if feeding else None
        for batch in input:
            feed = feeder.convert(batch) if feeder else batch
            feed = {k: _to_device(v, self.device) for k, v in feed.items()}
            with torch.no_grad():
                values, _ = self.network.forward(
                    self.params, feed, self.buffers, is_training=False)
            outs = self.network.outputs(values)
            if field is None:
                yield [_np(v) for v in outs.values()]
                continue
            # generation fields (SWIG SequenceGenerator parity):
            # "id" → generated token ids, "prob"/"score" → beam scores,
            # "len" → sequence lengths, "value" → the raw output value
            row = []
            for name in outs:
                for f in (field if isinstance(field, (list, tuple))
                          else [field]):
                    if f in ("prob", "score"):
                        row.append(_np(values[f"{name}.scores"]))
                    elif f == "len":
                        row.append(_np(values[f"{name}.lengths"]))
                    else:   # "id" / "value"
                        row.append(_np(values[name]))
            yield row

    def infer(self, input, feeding=None, field=None):
        results = []
        for out in self.iter_infer(input, feeding, field=field):
            results.append(out[0] if len(out) == 1 else out)
        if len(results) == 1:
            return results[0]
        if not results:
            return results
        if isinstance(results[0], list):
            # multi-output net: concatenate each output across batches
            return [np.concatenate(per_out) if per_out[0].ndim > 0
                    else np.asarray(per_out)
                    for per_out in zip(*results)]
        return np.concatenate(results) if results[0].ndim > 0 else results


def infer(output_layer, parameters=None, input=None, feeding=None,
          field=None, device: Optional[Union[str, torch.device]] = None):
    return Inference(output_layer, parameters, device=device).infer(
        input, feeding, field=field)
