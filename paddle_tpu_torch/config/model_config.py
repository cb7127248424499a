"""Model configuration IR (counterpart of
``paddle_tpu/config/model_config.py``): plain dataclasses with the
reference proto's field vocabulary, serialisable to JSON.

The port keeps its own copy, with the same field names and defaults, so
a config built here dumps to the same JSON as one built by the JAX
package, and :meth:`ModelConfig.from_json` reads what either wrote,
projections (:class:`ProjConfig`) and recurrent-group sub-models
(:class:`SubModelConfig`) included.  The config DSL (:mod:`.dsl`) and
the config-file parser (:mod:`.config_parser`) build these records; a
layer type no package registers refuses when ``NeuralNetwork`` builds
it, not here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..utils import ConfigError


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
    # ParameterUpdaterHookConfig list, e.g.
    # [{"type": "pruning", "sparsity_ratio": 0.6}]
    update_hooks: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class ProjConfig:
    """Projection/operator inside a mixed layer (``ProjectionConfig``)."""

    type: str = "fc"                    # fc|identity|dot_mul|scaling|table|context|slice
    input_size: int = 0
    output_size: int = 0
    context_start: int = 0
    context_length: int = 0
    trainable_padding: bool = False
    slice_begin: int = 0
    slice_end: int = 0
    # multi-slice form (SliceProjection concatenates selected ranges)
    slices: Optional[List[Tuple[int, int]]] = None

    def resolved_output_size(self) -> int:
        """Projection output width, derived from the type when
        ``output_size`` is unset; 0 when underdetermined (an unsized
        fc/trans_fc/table)."""
        if self.output_size:
            return self.output_size
        if self.type == "context":
            return self.context_length * self.input_size
        if self.type == "slice":
            slices = self.slices or [(self.slice_begin, self.slice_end)]
            return sum(e - b for b, e in slices)
        if self.type in ("identity", "dot_mul", "scaling"):
            return self.input_size
        return 0


@dataclass
class LayerInput:
    """One input edge of a layer (``LayerInputConfig``)."""

    input_layer_name: str = ""
    input_parameter_name: str = ""
    proj: Optional[ProjConfig] = None
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
        raise ConfigError(f"no layer or memory link named {name!r}")

    def to_json(self) -> str:
        # a beam-search candidate hook (or any other callable a config
        # carries) is code, not configuration: it is written as a marker
        def scrub(v):
            if callable(v):
                return f"<callable {getattr(v, '__name__', 'fn')}>"
            if isinstance(v, dict):
                return {k: scrub(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [scrub(x) for x in v]
            return v

        return json.dumps(scrub(dataclasses.asdict(self)), indent=1)

    @staticmethod
    def from_json(text: str) -> "ModelConfig":
        """The config :meth:`to_json` (of either package) wrote,
        projections included."""
        raw = json.loads(text)

        def mk_input(d):
            proj = ProjConfig(**d["proj"]) if d.get("proj") else None
            return LayerInput(
                input_layer_name=d.get("input_layer_name", ""),
                input_parameter_name=d.get("input_parameter_name", ""),
                proj=proj, attrs=d.get("attrs", {}))

        return ModelConfig(
            layers=[
                LayerConfig(**{**l, "inputs": [mk_input(i) for i in
                                               l.get("inputs", [])]})
                for l in raw.get("layers", [])],
            parameters=[ParameterConfig(**p)
                        for p in raw.get("parameters", [])],
            input_layer_names=raw.get("input_layer_names", []),
            output_layer_names=raw.get("output_layer_names", []),
            sub_models=[SubModelConfig(**m)
                        for m in raw.get("sub_models", [])],
            evaluators=raw.get("evaluators", []))


@dataclass
class OptimizationConfig:
    """Mirror of ``proto/TrainerConfig.proto`` OptimizationConfig +
    ``OptimizerConfig.proto``: the JAX package's fields, names, defaults
    and order.  ``local_sgd_steps`` > 0 selects
    ``parallel.local_sgd.LocalSGDTrainer`` (``make_trainer``); the
    parameter server's ``num_batches_per_*`` periods are kept and
    unused, as in the JAX package."""

    batch_size: int = 32
    learning_rate: float = 0.01
    learning_method: str = "sgd"
    learning_rate_schedule: str = "constant"
    learning_rate_decay_a: float = 0.0
    learning_rate_decay_b: float = 0.0
    learning_rate_args: str = ""
    momentum: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    ada_epsilon: float = 1e-6
    ada_rou: float = 0.95
    l1_weight_decay: float = 0.0
    l2_weight_decay: float = 0.0
    gradient_clipping_threshold: float = 0.0
    average_window: float = 0.0
    max_average_window: int = 0
    num_batches_per_send_parameter: int = 1
    num_batches_per_get_parameter: int = 1
    # "fp32" | "bf16" | "" (inherit --precision)
    precision: str = ""
    local_sgd_steps: int = 0

