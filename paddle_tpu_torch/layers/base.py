"""Layer base class and registry (counterpart of
``paddle_tpu/layers/base.py``).

A layer declares its parameter specs from its :class:`LayerConfig` and
computes ``forward(params, inputs, ctx)`` on tensors; autograd through
the whole network's forward gives the backward.  Batch-norm running
statistics live in a separate ``buffers`` dict threaded through the
:class:`ForwardContext` (a layer reads ``ctx.buffers`` and writes
``ctx.new_buffers``).  Dropout and error clipping have no layer in this
slice: a config that asks for them is refused when the network is built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..config.model_config import LayerConfig, ModelConfig, ParameterConfig
from ..core.dtypes import current_policy
from ..core.sequence import SequenceBatch, like, value_of
from ..ops.activations import get_activation
from ..utils import PaddleTpuError, enforce

LAYERS: Dict[str, type] = {}


@dataclasses.dataclass
class ForwardContext:
    """Per-call context threaded through layer forwards."""

    is_training: bool = True
    buffers: Dict[str, Any] = dataclasses.field(default_factory=dict)
    new_buffers: Dict[str, Any] = dataclasses.field(default_factory=dict)


def register_layer(*names: str):
    def deco(cls):
        for n in names:
            enforce(n not in LAYERS, f"layer type {n!r} registered twice")
            LAYERS[n] = cls
        cls.layer_type = names[0]
        return cls

    return deco


def get_layer_class(ltype: str) -> type:
    if ltype not in LAYERS:
        raise PaddleTpuError(f"layer type {ltype!r} is not ported; have "
                             f"{sorted(LAYERS)}")
    return LAYERS[ltype]


class Layer:
    """Base layer.  Subclasses override ``param_specs`` and ``forward``."""

    layer_type = ""

    def __init__(self, conf: LayerConfig, model: ModelConfig):
        enforce(conf.drop_rate == 0 and conf.error_clipping_threshold == 0,
                f"layer {conf.name!r}: dropout and error clipping are not "
                "ported")
        self.conf = conf
        self.name = conf.name
        self.model = model

    # ---- parameters ------------------------------------------------------
    def param_specs(self) -> List[ParameterConfig]:
        """Parameter configs this layer owns (weights then bias)."""
        return []

    def weight_name(self, i: int = 0) -> str:
        inp = self.conf.inputs[i]
        return inp.input_parameter_name or f"_{self.name}.w{i}"

    def bias_name(self) -> str:
        return self.conf.bias_parameter_name or f"_{self.name}.wbias"

    def _weight_spec(self, i: int, shape: Sequence[int],
                     **kw) -> ParameterConfig:
        return ParameterConfig(name=self.weight_name(i),
                               size=int(np.prod(shape)), dims=list(shape),
                               **kw)

    def _bias_spec(self, shape: Sequence[int], **kw) -> ParameterConfig:
        return ParameterConfig(name=self.bias_name(),
                               size=int(np.prod(shape)), dims=list(shape),
                               initial_std=0.0, **kw)

    # ---- execution -------------------------------------------------------
    def forward(self, params: Dict[str, torch.Tensor], inputs: List[Any],
                ctx: ForwardContext) -> Any:
        raise NotImplementedError

    def finalize(self, out: Any) -> Any:
        """The layer's activation (``Layer::forwardActivation``); a
        sequence softmax of a sequence takes its length mask."""
        act = get_activation(self.conf.active_type or None)
        if isinstance(out, SequenceBatch):
            if self.conf.active_type == "sequence_softmax":
                return out.with_data(act(out.data, mask=out.mask()))
            return out.with_data(act(out.data))
        return act(out)


def cast_layer_output(layer: Layer, out: Any) -> Any:
    """A layer's float outputs in the policy output dtype (under
    ``--bf16_activations``, bf16: a layer that promoted to fp32 is cast
    back at the engine boundary).  Cost layers are exempt: losses stay
    fp32."""
    odt = current_policy().output_dtype
    if odt == torch.float32 or getattr(layer, "is_cost", False):
        return out

    def cast(v):
        data = value_of(v)
        if isinstance(data, torch.Tensor) and data.is_floating_point() \
                and data.dtype != odt:
            return like(v, data.to(odt))
        return v

    if isinstance(out, dict):
        return {k: cast(v) for k, v in out.items()}
    return cast(out)


def init_parameter(gen: torch.Generator, spec: ParameterConfig
                   ) -> torch.Tensor:
    """Initialise one parameter per ``ParameterConfig`` semantics on the
    CPU, drawing from ``gen``: the reference's distribution
    (initial_strategy/mean/std/smart), not its draws."""
    shape = tuple(spec.dims) if spec.dims else (spec.size,)
    std = spec.initial_std
    if spec.initial_smart and len(shape) >= 2:
        # fan-in = all dims but the output (last) one
        std = 1.0 / np.sqrt(np.prod(shape[:-1]))
    if std == 0.0:
        base = torch.zeros(shape, dtype=torch.float32)
    elif spec.initial_strategy == 1:
        base = (torch.rand(shape, generator=gen, dtype=torch.float32)
                * 2.0 - 1.0) * std
    else:
        base = std * torch.randn(shape, generator=gen, dtype=torch.float32)
    return base + spec.initial_mean
