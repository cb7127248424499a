"""Model and optimisation configs (counterpart of ``paddle_tpu/config``)."""
from .model_config import (LayerConfig, LayerInput, ModelConfig,  # noqa: F401
                           OptimizationConfig, ParameterConfig,
                           SubModelConfig)
