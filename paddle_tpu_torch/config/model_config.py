"""Model configuration IR (counterpart of
``paddle_tpu/config/model_config.py``): plain dataclasses with the
reference proto's field vocabulary, serialisable to JSON.

The port keeps its own copy, with the same field names and defaults, so
a config built here dumps to the same JSON as one built by the JAX
package.  Recurrent-group sub-models (:class:`SubModelConfig`) are
ported; projections and evaluators have no layer yet, and their list
fields stay, empty, for that equality.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils import PaddleTpuError


@dataclass
class ParameterConfig:
    """Mirror of ``proto/ParameterConfig.proto`` (the trainable-weight spec)."""

    name: str = ""
    size: int = 0
    dims: List[int] = field(default_factory=list)
    learning_rate: float = 1.0          # per-parameter lr scale
    momentum: float = 0.0
    decay_rate: float = 0.0             # L2
    decay_rate_l1: float = 0.0          # L1
    initial_mean: float = 0.0
    initial_std: float = 0.01
    initial_strategy: int = 0           # 0: normal, 1: uniform
    initial_smart: bool = False         # std = 1/sqrt(fan_in)
    is_static: bool = False
    is_sparse: bool = False
    sparse_update: bool = False
    sharded: bool = False
    update_hooks: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class LayerInput:
    """One input edge of a layer (``LayerInputConfig``)."""

    input_layer_name: str = ""
    input_parameter_name: str = ""
    proj: Optional[Any] = None
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class LayerConfig:
    """Mirror of ``proto/ModelConfig.proto`` LayerConfig."""

    name: str = ""
    type: str = ""
    size: int = 0
    active_type: str = ""
    inputs: List[LayerInput] = field(default_factory=list)
    bias_parameter_name: str = ""
    with_bias: bool = False
    drop_rate: float = 0.0
    error_clipping_threshold: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)
    device: int = -1

    def input_names(self) -> List[str]:
        return [i.input_layer_name for i in self.inputs]


@dataclass
class SubModelConfig:
    """Recurrent-group sub-model (``SubModelConfig``: in/out links,
    memories; reference ``config_parser.py:367``).  A memory is a dict
    ``{"layer_name", "link_name", "size", "boot_layer_name"}``."""

    name: str = ""
    layer_names: List[str] = field(default_factory=list)
    in_links: List[str] = field(default_factory=list)
    out_links: List[str] = field(default_factory=list)
    memories: List[Dict[str, Any]] = field(default_factory=list)
    reversed: bool = False
    is_generating: bool = False
    generator: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelConfig:
    """Mirror of ``proto/ModelConfig.proto`` ModelConfig."""

    layers: List[LayerConfig] = field(default_factory=list)
    parameters: List[ParameterConfig] = field(default_factory=list)
    input_layer_names: List[str] = field(default_factory=list)
    output_layer_names: List[str] = field(default_factory=list)
    sub_models: List[SubModelConfig] = field(default_factory=list)
    evaluators: List[Dict[str, Any]] = field(default_factory=list)

    def layer_map(self) -> Dict[str, LayerConfig]:
        return {l.name: l for l in self.layers}

    def find_size(self, name: str) -> int:
        """Size of a layer output or of a recurrent-group memory link."""
        for l in self.layers:
            if l.name == name:
                return l.size
        for sm in self.sub_models:
            for mem in sm.memories:
                if name in (mem.get("link_name"),
                            mem["layer_name"] + "@pre"):
                    return mem.get("size", 0) or \
                        self.find_size(mem["layer_name"])
        raise PaddleTpuError(f"no layer or memory link named {name!r}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)


@dataclass
class OptimizationConfig:
    """Mirror of ``proto/TrainerConfig.proto`` OptimizationConfig: the
    fields this slice's trainer reads, with the JAX package's names and
    defaults (momentum, L1, other schedules and bf16 are not ported, so
    they cannot be asked for)."""

    learning_rate: float = 0.01
    learning_method: str = "sgd"
    learning_rate_schedule: str = "constant"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    l2_weight_decay: float = 0.0
    gradient_clipping_threshold: float = 0.0
    precision: str = ""
