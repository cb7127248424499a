"""The forward kernels an exported net meets, as ``torch.library``
custom ops (``ptpu::*``).

A kernel wrapper launches through ctypes (``ops/_build.py``), which
``torch.export`` cannot see into: a fake tensor has no data pointer, and
a traced wrapper would record its plain version's ops in the program —
a program exported on the CPU would then never launch the kernel on the
card.  Registered as custom ops, the kernels appear in the graph by
name, as the JAX package's single StableHLO artifact carries its Pallas
kernels for every platform it lowers for (``serving/export.py:205``):

- ``ptpu::lstm_fwd`` — kernel 8, the fused tier's LSTM forward
  (``csrc/lstm_fwd.cu``, :func:`ops.lstm.lstm_fwd`);
- ``ptpu::flash_fwd`` — kernel 1, training form, the block-sparse
  attention forward (``csrc/flash_fwd.cu``, :func:`ops.attention.
  flash_fwd`);
- ``ptpu::flash_fwd_legacy`` — kernel 2, the legacy full grid's forward
  under ``--flash_block_sparse=false`` (:func:`ops.attention.
  flash_fwd_legacy`).

Each op's implementation is its wrapper: the plain version on CPU
tensors, the CUDA kernel on CUDA tensors (which launches or raises, and
counts its launch); its fake implementation gives the output shapes.
The layers' inference path calls these ops when no gradient is needed
(:func:`ops.lstm.lstm_fused_sequence`, :func:`ops.attention.
flash_attention`, :func:`ops.attention.flash_attention_packed`);
training keeps the autograd functions ``_LstmCore`` and
``_FlashAttention``.

Any other forward kernel refuses inside an export
(:func:`refuse_export`): kernels 10, 13 and 15, the conv/BN fusions
(18-21), 22, and the serving kernels 1 and 7.  They are queue A6b.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor
from torch.library import custom_op

from ..utils import PaddleTpuError


def refuse_export(what: str) -> None:
    """Raise while ``torch.export`` traces a kernel that is not a custom
    op yet: never bake its plain version into a program silently."""
    if torch.compiler.is_exporting():
        raise PaddleTpuError(f"{what} is not exportable yet, ROADMAP A6b "
                             "(only kernels 8, 1-train and 2 are custom "
                             "ops: ops/export_ops.py)")


def needs_grad(*tensors: Optional[Tensor]) -> bool:
    """Whether autograd would record through ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


@custom_op("ptpu::lstm_fwd", mutates_args=())
def lstm_fwd(xw: Tensor, mask: Tensor, w_hh: Tensor, checks: Tensor,
             h0: Tensor, c0: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Kernel 8 (:func:`ops.lstm.lstm_fwd`): (H, C, gates)."""
    from . import lstm
    return lstm.lstm_fwd(xw, mask, w_hh, checks, h0, c0)


@lstm_fwd.register_fake
def _(xw, mask, w_hh, checks, h0, c0):
    b, t, hd4 = xw.shape
    state = xw.new_empty((b, t, hd4 // 4))
    return state, torch.empty_like(state), torch.empty_like(xw)


@custom_op("ptpu::flash_fwd", mutates_args=())
def flash_fwd(q: Tensor, k: Tensor, v: Tensor, lengths: Optional[Tensor],
              segments: Optional[Tensor], causal: bool
              ) -> Tuple[Tensor, Tensor]:
    """Kernel 1, training form (:func:`ops.attention.flash_fwd`): (out,
    lse); the live windows are computed on the card."""
    from . import attention
    return attention.flash_fwd(q, k, v, lengths, segments, causal)


@flash_fwd.register_fake
def _(q, k, v, lengths, segments, causal):
    b, tq, h, d = q.shape
    return (q.new_empty((b, tq, h, d)),
            q.new_empty((b, h, tq), dtype=torch.float32))


@custom_op("ptpu::flash_fwd_legacy", mutates_args=())
def flash_fwd_legacy(q: Tensor, k: Tensor, v: Tensor,
                     lengths: Optional[Tensor], causal: bool
                     ) -> Tuple[Tensor, Tensor]:
    """Kernel 2 (:func:`ops.attention.flash_fwd_legacy`): (out, lse)."""
    from . import attention
    return attention.flash_fwd_legacy(q, k, v, lengths, causal)


@flash_fwd_legacy.register_fake
def _(q, k, v, lengths, causal):
    b, tq, h, d = q.shape
    return (q.new_empty((b, tq, h, d)),
            q.new_empty((b, h, tq), dtype=torch.float32))
