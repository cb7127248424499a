"""Long-context attention: ring attention and Ulysses-style all-to-all
sequence parallelism over a mesh axis (counterpart of
``paddle_tpu/parallel/ring_attention.py``).

Each process holds one block of the sequence, ``[B, T/P, H, D]`` for P
processes on the axis, and gets back its block of the output:

- :func:`ring_attention` — each step adds a flash-style streaming block
  (running max, normalizer and unnormalized output in fp32:
  :func:`_block_attn`) against the resident k/v block, then passes k/v
  to the next process with point-to-point sends.  The JAX package
  differentiates through its ``lax.ppermute``; torch autograd does not
  differentiate through ``send`` / ``recv``, so the ring is one
  ``torch.autograd.Function`` whose backward runs the ring the other
  way, carrying each block's dk / dv with it until they are home.
  Memory per process is O(T/P); the result is exact.
- :func:`ulysses_attention` — ``all_to_all`` re-shards from sequence
  blocks to head groups, runs the dense block math locally, and
  re-shards back (the differentiable
  ``torch.distributed.nn.functional.all_to_all_single``).

Both are plain torch, as the JAX bodies are plain ``jnp``: they route
into no kernel.  :func:`full_attention` is the single-device reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import Mesh, get_mesh
from ..utils import PaddleTpuError, enforce

NEG_INF = -1e30


def _block_attn(q, k, v, m_prev, l_prev, o_prev, mask):
    """One flash-attention block update.

    q: [B, Tq, H, D]; k/v: [B, Tk, H, D]; mask: [Tq, Tk] additive or None.
    Carries the running max ``m``, normalizer ``l`` and unnormalized
    output ``o`` (all fp32).
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores + mask[None, None, :, :]
    m_cur = scores.amax(dim=-1)                             # [B, H, Tq]
    m_new = torch.maximum(m_prev, m_cur)
    # guard fully-masked rows (max = -inf)
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(scores <= NEG_INF / 2, 0.0, p)
    l_cur = p.sum(dim=-1)
    alpha = torch.where(m_prev <= NEG_INF / 2, 0.0,
                        torch.exp(m_prev - m_safe))
    l_new = alpha * l_prev + l_cur
    o_new = alpha[..., None] * o_prev + torch.einsum("bhqk,bkhd->bhqd", p, vf)
    return m_new, l_new, o_new


def _finalize(m, l, o, dtype):
    out = o / torch.clamp_min(l, 1e-20)[..., None]          # [B, H, Tq, D]
    return out.permute(0, 2, 1, 3).to(dtype)                # [B, Tq, H, D]


def _causal_mask(pos_q, pos_k):
    return torch.where(pos_q[:, None] >= pos_k[None, :], 0.0, NEG_INF)


def _axis_group(mesh: Optional[Mesh], axis: str):
    mesh = mesh or get_mesh()
    return mesh.group(axis), mesh.shape.get(axis, 1), mesh.coordinate(axis)


def _rotate(tensors, group, n: int, idx: int, step: int):
    """Send each tensor to the process ``step`` places on along the ring
    and receive the one ``step`` places back; returns the received.
    gloo carries no point-to-point transfer of CUDA tensors (PyTorch
    2.11 aborts the process in the attempt), so that pairing raises."""
    if tensors[0].is_cuda and dist.get_backend(group) == "gloo":
        raise PaddleTpuError(
            "ring_attention: the gloo backend sends no CUDA tensors point "
            "to point; run the ring over NCCL (one process a card)")
    dst = dist.get_global_rank(group, (idx + step) % n)
    src = dist.get_global_rank(group, (idx - step) % n)
    outs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n, idx, causal):
        b, tl, h, d = q.shape
        dev = q.device
        m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, tl), dtype=torch.float32, device=dev)
        o = torch.zeros((b, h, tl, d), dtype=torch.float32, device=dev)
        pos_q = idx * tl + torch.arange(tl, device=dev)
        k_r, v_r = k, v
        for r in range(n):
            # k_r holds the block of ring source (idx - r) mod n
            src = (idx - r) % n
            mask = _causal_mask(pos_q, src * tl + torch.arange(
                tl, device=dev)) if causal else None
            m, l, o = _block_attn(q, k_r, v_r, m, l, o, mask)
            if r + 1 < n:
                k_r, v_r = _rotate([k_r, v_r], group, n, idx, 1)
        out = _finalize(m, l, o, q.dtype)
        # per-query log-sum-exp (fully masked rows: l = 0, lse -inf-ish)
        lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)),
                          torch.full_like(m, -NEG_INF))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, n, idx, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, n, idx, causal = ctx.ring
        b, tl, h, d = q.shape
        dev = q.device
        scale = 1.0 / math.sqrt(d)
        qf = q.float()
        do = dout.float()
        # D_i = rowsum(dO * O), [B, H, Tq]
        delta = torch.einsum("bqhd,bqhd->bhq", do, out.float())
        pos_q = idx * tl + torch.arange(tl, device=dev)
        dq = torch.zeros_like(qf)
        k_r, v_r = k.float(), v.float()
        dk_r, dv_r = torch.zeros_like(k_r), torch.zeros_like(v_r)
        # the other way round: at step r this process holds block
        # (idx + r) mod n, with the dk / dv summed for it so far
        for r in range(n):
            src = (idx + r) % n
            s = torch.einsum("bqhd,bkhd->bhqk", qf, k_r) * scale
            if causal:
                s = s + _causal_mask(pos_q, src * tl + torch.arange(
                    tl, device=dev))[None, None]
            p = torch.exp(s - lse[..., None])
            p = torch.where(s <= NEG_INF / 2, 0.0, p)
            dv_r = dv_r + torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, v_r)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_r)
            dk_r = dk_r + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            # pass the block and its sums on; after n passes every
            # block's dk / dv are back with their owner
            k_r, v_r, dk_r, dv_r = _rotate([k_r, v_r, dk_r, dv_r], group,
                                           n, idx, -1)
        return (dq.to(q.dtype), dk_r.to(k.dtype), dv_r.to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, mesh: Optional[Mesh] = None, axis: str = "data",
                   causal: bool = False):
    """Exact attention over a sequence split on ``axis``: this process's
    blocks q/k/v ``[B, T/P, H, D]`` (block i of the sequence on the
    axis's process i) → this block of the output, differentiable."""
    group, n, idx = _axis_group(mesh, axis)
    if n <= 1:
        return full_attention(q, k, v, causal)
    return _Ring.apply(q, k, v, group, n, idx, causal)


def ulysses_attention(q, k, v, mesh: Optional[Mesh] = None,
                      axis: str = "data", causal: bool = False):
    """Sequence-parallel attention via head re-sharding (all-to-all):
    this process's blocks ``[B, T/P, H, D]`` → its output block.  Heads
    must be divisible by the axis size."""
    from torch.distributed.nn.functional import all_to_all_single

    group, p, idx = _axis_group(mesh, axis)
    if p <= 1:
        return full_attention(q, k, v, causal)
    b, tl, h, d = q.shape
    enforce(h % p == 0, f"H={h} not divisible by mesh axis {axis}")

    def seq2head(x):
        # [B, Tl, H, D] → chunk j (head group j) to process j → [B, T, H/P, D]
        send = x.reshape(b, tl, p, h // p, d).permute(2, 0, 1, 3, 4) \
            .contiguous()
        recv = all_to_all_single(torch.empty_like(send), send, group=group)
        return recv.permute(1, 0, 2, 3, 4).reshape(b, p * tl, h // p, d)

    def head2seq(x):
        # [B, T, H/P, D] → sequence block j to process j → [B, Tl, H, D]
        send = x.reshape(b, p, tl, h // p, d).permute(1, 0, 2, 3, 4) \
            .contiguous()
        recv = all_to_all_single(torch.empty_like(send), send, group=group)
        return recv.permute(1, 2, 0, 3, 4).reshape(b, tl, h, d)

    qh, kh, vh = seq2head(q), seq2head(k), seq2head(v)
    t = p * tl
    mask = None
    if causal:
        pos = torch.arange(t, device=q.device)
        mask = _causal_mask(pos, pos)
    hh = h // p
    m0 = torch.full((b, hh, t), NEG_INF, dtype=torch.float32, device=q.device)
    l0 = torch.zeros((b, hh, t), dtype=torch.float32, device=q.device)
    o0 = torch.zeros((b, hh, t, d), dtype=torch.float32, device=q.device)
    m, l, o = _block_attn(qh, kh, vh, m0, l0, o0, mask)
    return head2seq(_finalize(m, l, o, q.dtype))


def full_attention(q, k, v, causal: bool = False):
    """Single-device reference: softmax(q·kᵀ/√d)·v."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[1]
        pos = torch.arange(t, device=q.device)
        scores = scores + _causal_mask(pos, pos)[None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", w, v.float())
    return out.permute(0, 2, 1, 3).to(q.dtype)
