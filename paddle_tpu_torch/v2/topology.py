"""``paddle.v2.topology`` (counterpart of ``paddle_tpu/v2/topology.py``).

Reference: ``python/paddle/v2/topology.py:27`` — Topology wraps output
layers and exposes the parsed ModelConfig plus input-type plumbing for
the DataFeeder.
"""

from __future__ import annotations

from ..config.dsl import LayerOutput, topology as _parse
from ..utils import enforce


class Topology:
    def __init__(self, layers, extra_layers=None):
        def check(ls):
            ls = list(ls) if isinstance(ls, (list, tuple)) else [ls]
            for l in ls:
                enforce(isinstance(l, LayerOutput),
                        f"Topology expects LayerOutput, got {type(l)}")
            return ls

        self.layers = check(layers)
        extra = check(extra_layers) if extra_layers is not None else None
        self.__model_config__ = _parse(self.layers, extra)

    def proto(self):
        """The parsed model config (the reference returns the protobuf;
        here it is the dataclass IR with the same field names)."""
        return self.__model_config__

    def get_layer_proto(self, name: str):
        for l in self.__model_config__.layers:
            if l.name == name:
                return l
        return None

    def data_layers(self) -> dict:
        """name → LayerConfig for every data layer, in input order."""
        cfg = self.__model_config__
        by_name = {l.name: l for l in cfg.layers}
        return {n: by_name[n] for n in cfg.input_layer_names
                if n in by_name}
