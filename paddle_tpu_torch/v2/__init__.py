"""The v2-API namespace (counterpart of ``paddle_tpu/v2``).

The port holds only :mod:`.networks`, the DSL composites a config
file's namespace holds (``simple_lstm``, ``simple_gru``,
``simple_attention``, ``img_conv_group``, ...).  The rest of ``v2/``
(``trainer``, ``inference``, ``parameters``, ``dataset``, ...) comes with
queue A8; ``import paddle.v2`` through the port's aliases refuses by
name until then.
"""

from . import networks  # noqa: F401

__all__ = ["networks"]
