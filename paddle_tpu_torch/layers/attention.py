"""Attention-family layers (counterpart of ``paddle_tpu/layers/
attention.py``): multi-head attention over the flash kernels
(:mod:`paddle_tpu_torch.ops.attention`), ``layer_norm`` and
``position_embedding`` — a transformer block's layers."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config.model_config import ParameterConfig
from ..core.dtypes import current_policy
from ..core.sequence import SequenceBatch, like, value_of
from ..ops.attention import (flash_attention, flash_attention_packed,
                             packed_tileable, record_attention_dispatch,
                             segments_from_lengths)
from ..utils import FLAGS, enforce
from .base import Layer, register_layer


def _seq_parts(x):
    """(data [B, T, D], lengths [B] or None) from a layer input."""
    if isinstance(x, SequenceBatch):
        return x.data, x.length
    return value_of(x), None


@register_layer("scaled_dot_product_attention", "multi_head_attention",
                "flash_attention")
class MultiHeadAttentionLayer(Layer):
    """Multi-head scaled-dot-product attention over padded sequences.

    One input = self-attention through one packed ``[D_in, 3·size]`` q/k/v
    projection; three inputs = (query, key, value) cross-attention with a
    projection each.  ``_{name}.wo`` ``[size, size]`` merges the heads;
    the bias (if any) is added after it.  Attrs: ``num_heads``,
    ``causal``, ``block_q`` / ``block_k`` (the reference's tile sizes,
    which here only steer the dispatch gate).  The projections and the
    attention inputs are in the policy's compute dtype.

    Padded keys are masked through the key sequence's lengths; the output
    keeps the query sequence's lengths.  ``packed=True`` (self-attention)
    flattens the batch to one ``[1, B·T]`` row with per-token segment ids
    (slot T) through :func:`flash_attention_packed`: padding positions of
    its output are exact zeros before ``wo``.  ``--attention_packing=
    false``, a disabled flash / block-sparse kernel, or an untileable
    flatten reverts to the padded per-row lowering, with the reference's
    dispatch labels.
    """

    def param_specs(self):
        size = self.conf.size
        heads = self.conf.attrs.get("num_heads", 1)
        enforce(size % heads == 0,
                f"attention size {size} not divisible by num_heads {heads}")
        ins = self.conf.inputs
        enforce(len(ins) in (1, 3),
                "attention takes 1 input (self) or 3 (q, k, v), got "
                f"{len(ins)}")
        if len(ins) == 1:
            din = self.model.find_size(ins[0].input_layer_name)
            specs = [self._weight_spec(0, (din, 3 * size),
                                       initial_smart=True)]
        else:
            specs = [self._weight_spec(
                i, (self.model.find_size(inp.input_layer_name), size),
                initial_smart=True) for i, inp in enumerate(ins)]
        specs.append(ParameterConfig(
            name=f"_{self.name}.wo", size=size * size, dims=[size, size],
            initial_smart=True))
        if self.conf.with_bias:
            specs.append(self._bias_spec((size,)))
        return specs

    def _packed(self, n_inputs: int, b: int, tq: int, pbq: int,
                pbk: int) -> bool:
        """Whether the ``packed`` attr holds for this call, recording the
        reference's label when it reverts."""
        if not self.conf.attrs.get("packed", False):
            return False
        enforce(n_inputs == 1, "packed attention requires self-attention "
                f"(1 input), layer {self.name} has {n_inputs}")
        if not FLAGS.get("attention_packing"):
            record_attention_dispatch("unpacked",
                                      "kill_switch:attention_packing")
            return False
        if not FLAGS.get("flash_block_sparse") or \
                not FLAGS.get("flash_kernel"):
            flag = "flash_kernel" if not FLAGS.get("flash_kernel") \
                else "flash_block_sparse"
            record_attention_dispatch("unpacked",
                                      f"kill_switch:{flag}(packed)")
            return False
        if not packed_tileable(b * tq, pbq, pbk):
            record_attention_dispatch("unpacked",
                                      "untileable(packed flatten)")
            return False
        return True

    def forward(self, params, inputs, ctx):
        size = self.conf.size
        heads = self.conf.attrs.get("num_heads", 1)
        dh = size // heads
        pol = current_policy()
        cd = pol.compute_dtype
        if len(inputs) == 1:
            x, q_len = _seq_parts(inputs[0])
            qkv = x.to(cd) @ params[self.weight_name(0)].to(cd)
            q, k, v = qkv.split(size, dim=-1)      # views of [B, T, 3·size]
            kv_len = q_len
        else:
            xq, q_len = _seq_parts(inputs[0])
            xk, kv_len = _seq_parts(inputs[1])
            xv, _ = _seq_parts(inputs[2])     # value lengths follow the keys
            q, k, v = (x.to(cd) @ params[self.weight_name(i)].to(cd)
                       for i, x in enumerate((xq, xk, xv)))
        b, tq, tk = q.shape[0], q.shape[1], k.shape[1]
        causal = bool(self.conf.attrs.get("causal", False))
        block_q = int(self.conf.attrs.get("block_q", 512))
        block_k = int(self.conf.attrs.get("block_k", 512))
        # packed blocks clamp to the slot width (one row's T)
        pbq, pbk = min(block_q, tq), min(block_k, tq)
        if self._packed(len(inputs), b, tq, pbq, pbk):
            lengths = kv_len if kv_len is not None else torch.full(
                (b,), tq, dtype=torch.int32, device=q.device)
            seg = segments_from_lengths(lengths, b, tq)
            out = flash_attention_packed(
                *(a.reshape(1, b * tq, heads, dh) for a in (q, k, v)), seg,
                causal, pbq, pbk, tq)
        else:
            out = flash_attention(q.reshape(b, tq, heads, dh),
                                  k.reshape(b, tk, heads, dh),
                                  v.reshape(b, tk, heads, dh), kv_len,
                                  causal, block_q, block_k)
        out = (out.reshape(b, tq, size) @ params[f"_{self.name}.wo"].to(cd)) \
            .to(pol.output_dtype)
        if self.conf.with_bias:
            out = out + params[self.bias_name()].to(out.dtype)
        return self.finalize(like(inputs[0], out))


@register_layer("layer_norm")
class LayerNormLayer(Layer):
    """Layer normalization of the last (feature) dim with learned gain
    (the weight of input 0) and bias: statistics in f32, ε from the
    ``epsilon`` attr, the output in the input's dtype."""

    def param_specs(self):
        specs = [self._weight_spec(0, (self.conf.size,), initial_mean=1.0,
                                   initial_std=0.0)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((self.conf.size,)))
        return specs

    def forward(self, params, inputs, ctx):
        x = value_of(inputs[0])
        bias = params[self.bias_name()] if self.conf.with_bias else None
        y = F.layer_norm(x.float(), (x.shape[-1],),
                         params[self.weight_name(0)], bias,
                         self.conf.attrs.get("epsilon", 1e-5))
        return self.finalize(like(inputs[0], y.to(x.dtype)))


@register_layer("position_embedding")
class PositionEmbeddingLayer(Layer):
    """Adds a learned ``[max_len, size]`` position table to a sequence
    input, sliced to the batch's T and added in the input's dtype."""

    def param_specs(self):
        return [self._weight_spec(0, (self.conf.attrs["max_len"],
                                      self.conf.size), initial_std=0.01)]

    def forward(self, params, inputs, ctx):
        x = value_of(inputs[0])
        table = params[self.weight_name(0)]
        t = x.shape[1]
        enforce(t <= table.shape[0],
                f"sequence length {t} exceeds position_embedding max_len "
                f"{table.shape[0]}")
        return self.finalize(like(inputs[0], x + table[:t][None].to(x.dtype)))
