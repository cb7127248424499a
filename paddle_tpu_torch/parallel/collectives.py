"""The collectives the port's multi-device code runs (the exchanges
XLA's partitioner inserts in the JAX package's programs).

Every function takes a process group (an axis of ``core.device.Mesh``)
and runs on the tensors' own device: NCCL for CUDA tensors, gloo for CPU
tensors, or gloo for CUDA tensors where the job named gloo (two
processes sharing one card).  A collective the backend does not carry
raises; nothing is staged through the host to get round a backend.

- :func:`all_reduce_sum` — sums a list of tensors over the group in one
  call (one flat buffer a dtype);
- :func:`all_reduce_autograd` — a differentiable sum (its backward sums
  the incoming gradients): the global batch-norm statistics;
- :func:`all_gather_dim` / :func:`reduce_scatter_dim` — the FSDP pair
  along any dim: gather a parameter's shards before use, sum its
  gradient and keep this rank's shard;
- :func:`local_chunk` — this rank's chunk of a replicated tensor along
  a dim (no communication).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group
                   ) -> List[torch.Tensor]:
    """The element-wise sums of ``tensors`` over ``group`` (new tensors,
    the inputs untouched): one all-reduce a dtype over the tensors
    flattened into one buffer."""
    out: List[torch.Tensor] = [None] * len(tensors)  # type: ignore
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def all_reduce_flag(ok: torch.Tensor, group) -> torch.Tensor:
    """True on every rank iff ``ok`` (a bool scalar) is True on every
    rank: one rank's Inf skips every rank's mixed-precision step."""
    bad = (~ok).to(torch.int32).reshape(1)
    dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=group)
    return bad[0] == 0


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the backward sums the incoming
    gradient over the group (each rank's loss reaches every rank's
    ``x``)."""
    return _AllReduceSum.apply(x, group)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in rank order."""
    n = _size(group)
    front = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] * n,) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over ``group`` and cut into equal chunks along
    ``dim``: this rank's chunk."""
    n = _size(group)
    front = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // n,) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, front, op=dist.ReduceOp.SUM,
                               group=group)
    return out.movedim(0, dim).contiguous()


def local_chunk(x: torch.Tensor, dim: int, index: int, n: int
                ) -> torch.Tensor:
    """Chunk ``index`` of ``n`` equal chunks of ``x`` along ``dim``."""
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size).contiguous()
