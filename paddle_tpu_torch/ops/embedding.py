"""Embedding row gather (counterpart of ``paddle_tpu/ops/pallas_embedding.py``).

:func:`gather_rows` gathers ``table[rows]`` → ``[K, D]`` for the sparse
gradient exchange (``parallel/sparse.py``), with pad rows (``-1``, or
``>= V`` from ``unique_rows_sorted``) clamped to a real row whose value
every caller discards.  It takes the reference's gate
(:func:`_kernel_fallback_reason`): the kill switch ``--embedding_kernel``,
the ``sharded`` veto, a 2-D table and 1-D rows, D a multiple of 128 and
an fp32 table.  Where the gate says ``kernel`` it runs
:func:`embedding_gather`, kernel 22 (``csrc/embedding_gather.cu``, one
warp a row); else the plain gather :func:`gather_rows_reference`, which
is the reference's path at those decisions, on the card too.  Every
decision is counted in :data:`embedding_dispatch_total` with the
reference's ``(path, reason)`` labels.  The reference's ``no_tpu``
decision has no counterpart: :func:`embedding_gather` takes its plain
version on CPU tensors, as every wrapper of the port does, and on a
CUDA tensor launches the kernel or raises.

The backward (only taken by a caller that differentiates through the
gather; the trainer's exchange differentiates with respect to the
gathered block) is the reference's plain scatter-add of the row
cotangents, pads dropped.
"""

from __future__ import annotations

import collections

import torch

from ..utils import FLAGS, enforce, get_logger, warn_once
from . import _build

_log = get_logger("ops.embedding")

#: ``(path, reason)`` → count: the labels of the JAX package's
#: ``embedding_dispatch_total`` counter (which counts once per traced
#: call; this one once per call).
embedding_dispatch_total: "collections.Counter" = collections.Counter()


def record_embedding_dispatch(path: str, reason: str = "") -> None:
    """Count one embedding-gather decision; ``reason`` is set when a
    kernel-capable call took the plain gather, with the labels the
    one-time fallback warning uses."""
    embedding_dispatch_total[(path, reason)] += 1


def gather_rows_reference(table: torch.Tensor, rows: torch.Tensor
                          ) -> torch.Tensor:
    """Plain gather: pad rows (-1 or >= V) clamp to a valid row."""
    return table[rows.to(torch.int64).clamp(0, table.shape[0] - 1)]


def _on_card(tensors) -> bool:
    """True when the tensors are on CUDA (launch the kernel), False when
    all lie on the CPU (plain version); raises on anything else."""
    devs = {x.device for x in tensors}
    enforce(len(devs) == 1, f"tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    enforce(dev.type == "cuda", f"unsupported device {dev}")
    return True


def _launch(symbol: str, device, *args) -> None:
    err = _build.kernel(symbol)(
        *args, torch.cuda.current_stream(device).cuda_stream)
    enforce(err == 0, f"{symbol} launch failed (cudaError {err})")


def embedding_gather(table: torch.Tensor, rows: torch.Tensor
                     ) -> torch.Tensor:
    """Kernel 22 (``csrc/embedding_gather.cu``): ``table[rows]`` for an
    fp32 ``[V, D]`` table with D a multiple of 128 and int32 ``[K]``
    rows, pads clamped.  Plain version: :func:`gather_rows_reference`."""
    enforce(isinstance(table, torch.Tensor) and table.dim() == 2
            and table.dtype == torch.float32 and table.is_contiguous(),
            f"table: expected a contiguous float32 [V, D] tensor, got "
            f"{getattr(table, 'dtype', type(table))} "
            f"{tuple(getattr(table, 'shape', ()))}")
    v, d = table.shape
    enforce(d % 128 == 0, f"the gather kernel takes D % 128 == 0, got {d}")
    enforce(v > 0, "table has no rows")
    enforce(isinstance(rows, torch.Tensor) and rows.dim() == 1
            and rows.dtype == torch.int32 and rows.is_contiguous(),
            f"rows: expected contiguous int32 [K], got "
            f"{getattr(rows, 'dtype', type(rows))} "
            f"{tuple(getattr(rows, 'shape', ()))}")
    if not _on_card((table, rows)):
        return gather_rows_reference(table, rows)
    enforce(table.data_ptr() % 16 == 0,
            "the gather kernel needs a 16-byte aligned table")
    out = torch.empty((rows.shape[0], d), dtype=table.dtype,
                      device=table.device)
    if rows.shape[0] == 0:
        return out
    _launch("embedding_gather", table.device, table.data_ptr(),
            rows.data_ptr(), out.data_ptr(), rows.shape[0], v, d)
    embedding_gather.launches += 1
    return out


embedding_gather.launches = 0


def _kernel_fallback_reason(table: torch.Tensor, rows: torch.Tensor,
                            allow_kernel: bool) -> str:
    """Why this gather does not run the kernel ('' = it does): the
    reference's gate without its ``no_tpu`` step."""
    if not FLAGS.get("embedding_kernel"):
        return "flag_off"
    if not allow_kernel:
        # caller-side veto: the table is sharded over devices
        return "sharded"
    if table.dim() != 2 or rows.dim() != 1:
        return "rank"
    if table.shape[1] % 128 != 0:
        return "unaligned"
    if table.dtype != torch.float32:
        return "dtype"
    return ""


class _GatherRows(torch.autograd.Function):
    """The reference's ``custom_vjp``: the gate and the gather forward,
    a scatter-add of the row cotangents backward."""

    @staticmethod
    def forward(ctx, table, rows, allow_kernel):
        reason = _kernel_fallback_reason(table, rows, allow_kernel)
        ctx.save_for_backward(rows)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        if not reason:
            record_embedding_dispatch("kernel")
            return embedding_gather(table.contiguous(),
                                    rows.to(torch.int32).contiguous())
        record_embedding_dispatch("dense", reason=reason)
        if reason not in ("flag_off", "sharded"):
            warn_once(
                f"embedding_gather_dense_fallback:{reason}:"
                f"{tuple(table.shape)}",
                "embedding row gather: dense fallback taken for table %s "
                "rows [%d]: %s", tuple(table.shape), rows.shape[0], reason,
                logger=_log)
        return gather_rows_reference(table, rows)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        shape = ctx.table_shape
        rows = rows.reshape(-1).to(torch.int64)
        valid = (rows >= 0) & (rows < shape[0])
        # pads add a zero to row 0: an index V would be a device-side
        # assert on CUDA
        vals = g.reshape((-1,) + tuple(shape[1:])).to(ctx.table_dtype)
        vals = torch.where(valid.reshape((-1,) + (1,) * (vals.dim() - 1)),
                           vals, torch.zeros_like(vals))
        dt = torch.zeros(shape, dtype=ctx.table_dtype, device=g.device)
        dt.index_add_(0, torch.where(valid, rows, 0), vals)
        return dt, None, None


def gather_rows(table: torch.Tensor, rows: torch.Tensor,
                allow_kernel: bool = True) -> torch.Tensor:
    """Gather ``table[rows]`` → ``[K, D]``: kernel 22 on capable shapes
    (2-D fp32 table, D % 128 == 0, ``allow_kernel``), the plain gather
    otherwise.  Pad rows (-1 or >= V) yield a clamped row whose value
    every caller discards."""
    return _GatherRows.apply(table, rows, bool(allow_kernel))


#: Every kernel wrapper of this module (for counters and reports).
KERNEL_WRAPPERS = (embedding_gather,)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
