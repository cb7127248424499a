"""Which device the port runs on (the "which device" role of
``paddle_tpu/core/device.py``, whose mesh code has no counterpart yet).

Entry points resolve their ``device`` argument here: ``None`` means
CUDA, and a CUDA request with no CUDA device raises — the port never
moves to the CPU on its own.  The CPU runs only when the caller names
it (the tests do).

Numerics: fp32 matrix products and convolutions run in full fp32.
PyTorch already keeps ``torch.backends.cuda.matmul.allow_tf32`` False,
but cuDNN convolutions default to TF32; both are set to False here so a
comparison against the JAX reference compares fp32 with fp32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..utils import PaddleTpuError


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; raise :class:`PaddleTpuError` when CUDA is
    asked for (explicitly or by default) and no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise PaddleTpuError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise PaddleTpuError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
