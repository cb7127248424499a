"""Beam-search generation (counterpart of
``paddle_tpu/layers/beam_search.py``: the reference's
``RecurrentGradientMachine::generateSequence`` and ``SequenceGenerator``).

:class:`BeamSearchDecoder` runs a generating group: the [B, K] beams are
the batch of one group step (:meth:`RecurrentGroup.step`), which feeds
the previous token's id to the group's generated-input embedding; each
step scores the K·V candidates of a sequence, keeps the K best
(``math_ops.top_k``: the lower flat index first among equal scores, as
``lax.top_k``), regathers the memories and tokens by parent beam, and
freezes a finished beam by allowing it only EOS at zero cost.  The loop
runs ``max_length`` steps, as the JAX scan does.  ``beam_gen`` exposes
the ids ``[B, K, T]`` with ``.scores`` ``[B, K]`` and ``.lengths``
``[B, K]`` (the first EOS, inclusive, else ``max_length``).

:func:`eos_frozen_logits` is also the serving decode loop's freeze.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..config.model_config import ModelConfig, SubModelConfig
from ..core.sequence import SequenceBatch, value_of
from ..ops.math_ops import top_k
from ..utils import enforce
from .base import ForwardContext, Layer, register_layer
from .recurrent_group import RecurrentGroup

#: Cost of every non-EOS continuation of a frozen row.  Not attention's
#: -1e30: this is the reference's own constant, kept for equal logits.
NEG_INF = -1e9


def eos_frozen_logits(logp: torch.Tensor, alive: torch.Tensor,
                      eos_id: int) -> torch.Tensor:
    """Freeze finished rows: a row whose ``alive`` flag dropped may only
    continue with EOS at zero cost.  ``logp`` is ``[..., V]``, ``alive``
    its leading shape (bool).  Finished or padded decode slots thus
    sample EOS deterministically, never garbage from an inactive row."""
    eos_only = torch.full((logp.shape[-1],), NEG_INF, dtype=logp.dtype,
                          device=logp.device)
    eos_only[eos_id] = 0.0
    return torch.where(alive[..., None], logp, eos_only)


def _tile_beams(v: Any, k: int) -> Any:
    """``[B, ...]`` → ``[B*K, ...]``, each row repeated K times."""
    if isinstance(v, SequenceBatch):
        return SequenceBatch(torch.repeat_interleave(v.data, k, 0),
                             torch.repeat_interleave(v.length, k, 0))
    if isinstance(v, torch.Tensor) and v.dim() >= 1:
        return torch.repeat_interleave(v, k, 0)
    return v


def _by_parent(x: torch.Tensor, batch_idx: torch.Tensor,
               parent: torch.Tensor) -> torch.Tensor:
    """Rows ``[B*K, ...]`` regathered by parent beam ``[B, K]``."""
    b, k = parent.shape
    shaped = x.reshape((b, k) + tuple(x.shape[1:]))
    return shaped[batch_idx, parent].reshape((b * k,) + tuple(x.shape[1:]))


class BeamSearchDecoder:
    """Executes a generating SubModelConfig."""

    def __init__(self, sub: SubModelConfig, model: ModelConfig):
        enforce(sub.is_generating and sub.generator,
                f"{sub.name} is not a generating group")
        self.sub = sub
        self.gen = sub.generator
        self.group = RecurrentGroup(sub, model)
        # the outer values a step reads: inputs of the step layers that
        # the step itself does not produce
        inner = {self.gen["placeholder"]} | set(self.group.layers) \
            | {self.group._link(m) for m in self.group.memories}
        self.outer_names: List[str] = sorted({
            n for layer in self.group.layers.values()
            for n in layer.conf.input_names()
            if n not in inner and self.group._producer_of(n) is None})

    def generate(self, params: Dict[str, torch.Tensor],
                 values: Dict[str, Any], ctx: ForwardContext
                 ) -> Dict[str, Any]:
        """Decode from the outer ``values`` → ``{"ids": [B, K, T] int32,
        "lengths": [B, K] int32, "scores": [B, K] fp32, "beam_size":
        K}``.  The candidate hooks of the config (``candidate_adjust``,
        ``candidate_drop``) take torch tensors and the step as a Python
        int; a hook that is not callable (a config read back from JSON
        carries a marker) is not used."""
        g = self.gen
        k, vocab = int(g["beam_size"]), int(g["vocab_size"])
        max_len, eos_id = int(g["max_length"]), int(g["eos_id"])
        group = self.group

        # the batch from a boot layer or a static input
        ref = None
        for m in group.memories:
            boot = m.get("boot_layer_name")
            if boot and boot in values:
                ref = value_of(values[boot])
                break
        if ref is None:
            for name in g.get("static_inputs", ()):
                if name in values:
                    ref = value_of(values[name])
                    break
        enforce(ref is not None, "beam search needs a boot or static input "
                                 "to infer the batch size")
        b, dev = ref.shape[0], ref.device

        outer = {n: _tile_beams(values[n], k) for n in self.outer_names
                 if n in values}
        # memories at fp32 whatever the policy, as the JAX decoder
        mems = [_tile_beams(group._memory_init(m, values, b, torch.float32,
                                               dev), k)
                for m in group.memories]
        adjust = g.get("candidate_adjust")
        adjust = adjust if callable(adjust) else None
        drop = g.get("candidate_drop")
        drop = drop if callable(drop) else None

        batch_idx = torch.arange(b, device=dev)[:, None]
        tokens = torch.zeros((b, k, max_len), dtype=torch.int32, device=dev)
        # beam 0 starts live, the others at NEG_INF: step 1 yields K
        # distinct beams
        scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        alive = torch.ones((b, k), dtype=torch.bool, device=dev)
        last = torch.full((b, k), int(g["bos_id"]), dtype=torch.int32,
                          device=dev)
        for t in range(max_len):
            new_mems, step_vals = group.step(
                params, {g["placeholder"]: last.reshape(-1)}, mems, outer,
                ctx)
            probs = value_of(step_vals[g["prob_layer"]])       # [B*K, V]
            logp = torch.log(torch.clamp(probs, min=1e-20)).reshape(
                b, k, vocab)
            # the hooks act on live candidates before the freeze, so a
            # hook never reopens a closed beam
            if adjust is not None:
                logp = adjust(logp, tokens, t)
            if drop is not None:
                logp = torch.where(drop(logp, tokens, t),
                                   torch.full_like(logp, NEG_INF), logp)
            logp = eos_frozen_logits(logp, alive, eos_id)
            cand = scores[:, :, None] + logp                    # [B, K, V]
            scores, flat = top_k(cand.reshape(b, k * vocab), k)
            flat = flat.to(torch.int64)
            parent = flat // vocab
            token = (flat % vocab).to(torch.int32)

            mems = [_by_parent(m, batch_idx, parent) for m in new_mems]
            tokens = tokens[batch_idx, parent]
            tokens[:, :, t] = token
            alive = alive[batch_idx, parent] & (token != eos_id)
            last = token

        # the length: the first EOS (inclusive), else max_length
        is_eos = (tokens == eos_id).to(torch.int32)
        lengths = torch.where(is_eos.any(-1), torch.argmax(is_eos, -1) + 1,
                              torch.full_like(is_eos[..., 0], max_len,
                                              dtype=torch.int64))
        return {"ids": tokens, "lengths": lengths.to(torch.int32),
                "scores": scores, "beam_size": k}


@register_layer("beam_gen")
class BeamGenLayer(Layer):
    """Root-visible handle of a generating group: its first input is the
    bundle the decoder wrote; its value is the ids ``[B, K, T]``, with
    ``.scores`` and ``.lengths`` beside it."""

    def forward(self, params, inputs, ctx):
        bundle = inputs[0]
        enforce(isinstance(bundle, dict) and "ids" in bundle,
                f"layer {self.name!r}: beam_gen's input must be the "
                "generation bundle")
        return {"out": bundle["ids"], "scores": bundle["scores"],
                "lengths": bundle["lengths"]}
