"""Static analysis of model configs (counterpart of ``paddle_tpu/analysis``)."""
