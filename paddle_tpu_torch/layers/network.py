"""NeuralNetwork: config-driven executor over the layer registry
(counterpart of ``paddle_tpu/layers/network.py``).

:meth:`NeuralNetwork.forward` runs the layers in topological order on
tensors; the backward is autograd over the whole forward.  This slice
covers plain layer graphs: the conv/BN fusion plan, recurrent groups and
beam search wait for their slices, and a config that needs them is
refused at build time.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..config.model_config import ModelConfig, ParameterConfig
from ..core.device import resolve_device
from ..core.sequence import value_of
from ..utils import PaddleTpuError, enforce
from .base import Layer, cast_layer_output, get_layer_class, init_parameter
from . import common, cost, rnn, seq  # noqa: F401  (register layers)


class NeuralNetwork:
    """Builds and executes a ModelConfig as a graph of tensor functions."""

    def __init__(self, config: ModelConfig):
        enforce(not config.sub_models,
                "recurrent-group sub-models are not ported")
        self.config = config
        self.layers: Dict[str, Layer] = {}
        self.order: List[str] = []
        for lconf in config.layers:
            self.layers[lconf.name] = get_layer_class(lconf.type)(lconf,
                                                                  config)
            self.order.append(lconf.name)

        # parameter specs: layer-declared, merged with config-declared
        declared = {p.name: p for p in config.parameters}
        self.param_specs: Dict[str, ParameterConfig] = {}
        for layer in self.layers.values():
            for spec in layer.param_specs():
                if spec.name in declared:
                    d = declared[spec.name]
                    if not d.dims:
                        d.dims = spec.dims
                    d.size = d.size or spec.size
                    spec = d
                if spec.name in self.param_specs:
                    enforce(self.param_specs[spec.name].dims == spec.dims,
                            f"shared parameter {spec.name} shape mismatch: "
                            f"{self.param_specs[spec.name].dims} vs "
                            f"{spec.dims}")
                    continue
                self.param_specs[spec.name] = spec
        self.static_params = {n for n, s in self.param_specs.items()
                              if s.is_static}
        self.cost_layers = [n for n in self.order
                            if getattr(self.layers[n], "is_cost", False)]
        # classification-cost logits peephole: a multi-class CE reading a
        # softmax fc gets the fc's '.logits' sub-output (fused CE path)
        lmap = config.layer_map()
        self._cost_logit_alias: Dict[str, str] = {}
        for cname in self.cost_layers:
            conf = self.layers[cname].conf
            if conf.type != "multi-class-cross-entropy" or not conf.inputs:
                continue
            pname = conf.inputs[0].input_layer_name
            pconf = lmap.get(pname)
            if pconf is not None and pconf.type == "fc" \
                    and pconf.active_type == "softmax":
                self._cost_logit_alias[cname] = pname + ".logits"

    # ------------------------------------------------------------- params
    def init_params(self, seed: int = 1,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
        """Every parameter, drawn on the CPU from one ``torch.Generator``
        seeded with ``seed`` in sorted-name order, then moved to
        ``device`` (default CUDA; raises when CUDA is absent and the CPU
        was not asked for).  Same distributions as the JAX package, not
        the same draws."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        return {name: init_parameter(gen, spec).to(dev)
                for name, spec in sorted(self.param_specs.items())}

    def lr_scales(self, params: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Per-parameter learning-rate scale; 0 for static parameters."""
        return {n: 0.0 if n in self.static_params
                else self.param_specs[n].learning_rate for n in params}

    # ------------------------------------------------------------ forward
    def forward(self, params: Dict[str, torch.Tensor], feed: Dict[str, Any]
                ) -> Dict[str, Any]:
        """Run all layers; returns every output by name (sub-outputs as
        ``name.key``)."""
        values: Dict[str, Any] = {}
        for name in self.order:
            layer = self.layers[name]
            if layer.conf.type == "data":
                if name not in feed:
                    raise PaddleTpuError(
                        f"missing feed for data layer {name!r}")
                values[name] = feed[name]
                continue
            inputs = [values[i] for i in layer.conf.input_names()]
            if name in self._cost_logit_alias:
                layer.logits_value = values.get(self._cost_logit_alias[name])
            out = cast_layer_output(layer, layer.forward(params, inputs))
            if isinstance(out, dict):
                for k, v in out.items():
                    values[name if k == "out" else f"{name}.{k}"] = v
            else:
                values[name] = out
        return values

    def loss(self, params: Dict[str, torch.Tensor], feed: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Scalar objective = mean per-example total cost
        (``Argument::sum`` / batch size)."""
        values = self.forward(params, feed)
        enforce(self.cost_layers, "network has no cost layer")
        total = None
        for cname in self.cost_layers:
            v = value_of(values[cname])
            c = torch.sum(v) / v.shape[0]
            total = c if total is None else total + c
        return total, values
