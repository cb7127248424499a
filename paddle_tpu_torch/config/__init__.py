"""Model and optimisation configs (counterpart of ``paddle_tpu/config``):
the IR (:mod:`.model_config`), the config DSL (:mod:`.dsl`, with
:mod:`.layer_math` and :mod:`.recurrent_units`) and the config-file
parser (:mod:`.config_parser`)."""
from .model_config import (LayerConfig, LayerInput, ModelConfig,  # noqa: F401
                           OptimizationConfig, ParameterConfig, ProjConfig,
                           SubModelConfig)
