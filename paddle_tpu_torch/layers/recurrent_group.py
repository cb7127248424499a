"""Recurrent layer groups (counterpart of
``paddle_tpu/layers/recurrent_group.py``, the ``RecurrentGradientMachine``
equivalent): a :class:`SubModelConfig` run once per timestep over
variable-length sequences.

The JAX package traces the step once and drives it with ``lax.scan``;
here the time loop is a Python loop over steps on tensors, and autograd
through it is the backward.  Memories are the loop's carries (a memory
reads a layer's previous-step output through its link name, booted from
a boot layer cast to the policy output dtype, or zeros); in-links are
sliced per step; out-links are stacked.  A padded step keeps every
carry, ``m·new + (1−m)·old``, and its out-link rows are 0.  Outer values
a step reads that are neither in-links nor memories (the encoder
sequence of an attention decoder) are static inputs.

Epilogue hoisting (:meth:`RecurrentGroup._split_scan_epilogue`, on by
default through the class attribute ``HOIST``): step layers that no
memory depends on and that are pointwise over time run once, after the
loop, over the stacked ``[B, T, ...]`` sequence — the decoder's softmax
projection becomes one ``[B·T, H] × [H, V]`` product instead of T.  The
hoisted out-link producer's ``.logits`` sub-output is exposed, so a
classification cost takes the fused logits path.

Nested groups (nested-sequence in-links), generating groups and beam
search are not ported; :func:`check_supported` refuses them when the
network is built.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from ..config.model_config import ModelConfig, SubModelConfig
from ..core.dtypes import current_policy
from ..core.sequence import SequenceBatch, value_of
from ..utils import PaddleTpuError, enforce
from .base import ForwardContext, cast_layer_output, get_layer_class


def check_supported(config: ModelConfig) -> None:
    """Refuse, at build time, the groups this slice does not run:
    generating groups (beam search) and nested groups — a group stepping
    over subsequences, i.e. an in-link that depends on a nested-sequence
    (``seq_level`` 2) data layer."""
    lmap = config.layer_map()

    def nested_source(name: str, seen: Set[str]) -> Optional[str]:
        conf = lmap.get(name)
        if conf is None or name in seen:
            return None
        seen.add(name)
        if conf.type == "data":
            return name if conf.attrs.get("seq_level", 0) >= 2 else None
        for iname in conf.input_names():
            hit = nested_source(iname, seen)
            if hit:
                return hit
        return None

    for sm in config.sub_models:
        if sm.name == "root":
            continue
        if sm.is_generating:
            raise PaddleTpuError(
                f"recurrent group {sm.name!r} is a generating group (beam "
                "search), which is not ported")
        for link in sm.in_links:
            src = nested_source(link, set())
            if src:
                raise PaddleTpuError(
                    f"recurrent group {sm.name!r} is a nested group: its "
                    f"in-link {link!r} reads the nested-sequence data layer "
                    f"{src!r}; nested groups are not ported")


class RecurrentGroup:
    """Executes one SubModelConfig with a time loop."""

    # Epilogue hoisting; a class attribute so tests can compare hoisted
    # and in-loop execution.
    HOIST = True

    # Layer types whose forward is pointwise over leading axes (they act
    # on the trailing feature dim only), so running them once on a
    # stacked [B, T, ...] SequenceBatch equals running them per step:
    # the JAX package's set, restricted to the layer types the port has.
    # Sequence-aware types (pooling, expand, ...) must NOT be hoisted.
    POINTWISE_TYPES = frozenset({"fc", "addto", "scaling"})

    def __init__(self, sub: SubModelConfig, model: ModelConfig):
        self.sub = sub
        self.model = model
        self.layers: Dict[str, Any] = {}
        self.order: List[str] = []
        lmap = model.layer_map()
        for ln in sub.layer_names:
            conf = lmap[ln]
            if conf.type == "data":
                continue
            self.layers[ln] = get_layer_class(conf.type)(conf, model)
            self.order.append(ln)
        self.in_links = list(sub.in_links)
        self.out_links = list(sub.out_links)
        self.memories = list(sub.memories)

    # ------------------------------------------------- epilogue hoisting
    def _producer_of(self, iname: str) -> Optional[str]:
        """Group layer that produces value ``iname`` (a ``layer.subkey``
        value is produced by ``layer``), else None."""
        if iname in self.layers:
            return iname
        head = iname.split(".", 1)[0]
        return head if "." in iname and head in self.layers else None

    def _split_scan_epilogue(self) -> Tuple[Set[str], List[str]]:
        """Split the step layers into (loop set, hoisted suffix): a layer
        runs inside the loop iff a memory depends on it (transitively) or
        its type is not pointwise over time; the rest run once after the
        loop, over the stacked time axis."""
        need: Set[str] = set()
        for m in self.memories:
            p = self._producer_of(m["layer_name"])
            if p is None:
                raise PaddleTpuError(
                    f"group {self.sub.name}: memory layer "
                    f"{m['layer_name']!r} is not produced by the group")
            need.add(p)
        need |= {n for n in self.order
                 if self.layers[n].conf.type not in self.POINTWISE_TYPES}
        stack = list(need)
        while stack:
            for iname in self.layers[stack.pop()].conf.input_names():
                p = self._producer_of(iname)
                if p is not None and p not in need:
                    need.add(p)
                    stack.append(p)
        return need, [n for n in self.order if n not in need]

    def _memory_init(self, mem: Dict[str, Any], values: Dict[str, Any],
                     batch: int, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
        boot = mem.get("boot_layer_name")
        if boot:
            return value_of(values[boot]).to(dtype)
        size = mem.get("size", 0) or \
            self.model.find_size(mem["layer_name"].split(".", 1)[0])
        return torch.zeros((batch, size), dtype=dtype, device=device)

    def _forward_layers(self, names: List[str], values: Dict[str, Any],
                        outer: Dict[str, Any], params: Dict[str, Any],
                        ctx: ForwardContext) -> None:
        """Run ``names`` (topologically ordered) in place over ``values``;
        an input found neither there nor in ``outer`` is an error."""
        for name in names:
            layer = self.layers[name]
            inputs = []
            for iname in layer.conf.input_names():
                if iname in values:
                    inputs.append(values[iname])
                elif iname in outer:       # static (read-only) outer input
                    inputs.append(outer[iname])
                else:
                    raise PaddleTpuError(
                        f"group {self.sub.name}: input {iname!r} not found")
            out = cast_layer_output(layer, layer.forward(params, inputs, ctx))
            if isinstance(out, dict):
                for k, v in out.items():
                    values[name if k == "out" else f"{name}.{k}"] = v
            else:
                values[name] = out

    def _link(self, mem: Dict[str, Any]) -> str:
        return mem.get("link_name", mem["layer_name"] + "@pre")

    def run(self, params: Dict[str, Any], values: Dict[str, Any],
            ctx: ForwardContext) -> None:
        """Loop the group over its in-link sequences; writes the out-link
        sequences (and the hoisted producers' sub-outputs) into
        ``values``."""
        enforce(self.in_links, f"group {self.sub.name} has no in_links")
        seqs = []
        for link in self.in_links:
            s = values[link]
            enforce(isinstance(s, SequenceBatch),
                    f"group {self.sub.name}: in_link {link!r} must be a "
                    "(level-1) sequence")
            seqs.append(s)
        t, b = seqs[0].max_len, seqs[0].data.shape[0]
        length = seqs[0].length
        # carries and mask in the policy output dtype (bf16 under
        # --bf16_activations, as the JAX scan keeps its carry dtype)
        fdt = current_policy().output_dtype
        mask = seqs[0].mask(fdt)                       # [B, T]
        dev = seqs[0].data.device
        mems = [self._memory_init(m, values, b, fdt, dev)
                for m in self.memories]

        scan_set, hoisted = (self._split_scan_epilogue() if self.HOIST
                             else (set(self.order), []))
        hoist_set = set(hoisted)
        hoist_outs = [o for o in self.out_links
                      if (self._producer_of(o) or o) in hoist_set]
        # hoisted layers feeding a hoisted out-link; the rest are dead
        # past the loop
        live = {self._producer_of(o) or o for o in hoist_outs}
        for n in reversed(hoisted):
            if n in live:
                for iname in self.layers[n].conf.input_names():
                    p = self._producer_of(iname)
                    if p is not None and p in hoist_set:
                        live.add(p)
        hoisted = [n for n in hoisted if n in live]
        hoist_set = set(hoisted)
        # values the epilogue reads out of the loop: in-loop layer
        # outputs and memory pre-values; in-link frames it reads whole
        mem_links = {self._link(m) for m in self.memories}
        boundary: Set[str] = set()
        frames_used: Set[str] = set()
        for n in hoisted:
            for iname in self.layers[n].conf.input_names():
                p = self._producer_of(iname)
                if (p is not None and p in scan_set) or iname in mem_links:
                    boundary.add(iname)
                elif iname in self.in_links:
                    frames_used.add(iname)
        loop_order = [n for n in self.order if n in scan_set]
        loop_outs = [o for o in self.out_links if o not in set(hoist_outs)]

        outs: Dict[str, List[Any]] = {o: [None] * t for o in loop_outs}
        bvals: Dict[str, List[Any]] = {n: [None] * t for n in boundary}
        steps = range(t - 1, -1, -1) if self.sub.reversed else range(t)
        for s in steps:
            step_vals: Dict[str, Any] = {
                link: seq.data[:, s] for link, seq in zip(self.in_links, seqs)}
            for mem, mval in zip(self.memories, mems):
                step_vals[self._link(mem)] = mval
            self._forward_layers(loop_order, step_vals, values, params, ctx)
            m = mask[:, s, None]
            mems = [m * value_of(step_vals[mem["layer_name"]]) + (1 - m) * old
                    for mem, old in zip(self.memories, mems)]
            valid = mask[:, s] > 0
            for o in loop_outs:
                d = value_of(step_vals[o])
                mb = valid.reshape((b,) + (1,) * (d.dim() - 1))
                # where, not multiply: integer out-links keep their dtype
                outs[o][s] = torch.where(mb, d, torch.zeros((), dtype=d.dtype,
                                                            device=d.device))
            for n in boundary:
                bvals[n][s] = value_of(step_vals[n])

        for o in loop_outs:
            values[o] = SequenceBatch(data=torch.stack(outs[o], 1),
                                      length=length)
        if not hoisted:
            return
        # the pointwise suffix, once over the stacked [B, T, ...] values
        vals: Dict[str, Any] = {
            n: SequenceBatch(data=torch.stack(bvals[n], 1), length=length)
            for n in boundary}
        for link in frames_used:
            vals[link] = values[link]
        self._forward_layers(hoisted, vals, values, params, ctx)
        valid = mask > 0
        for o in hoist_outs:
            d = value_of(vals[o])
            mb = valid.reshape(valid.shape + (1,) * (d.dim() - 2))
            values[o] = SequenceBatch(
                data=torch.where(mb, d, torch.zeros((), dtype=d.dtype,
                                                    device=d.device)),
                length=length)
        # expose the hoisted out-link producers' sub-outputs (e.g.
        # 'dec_prob.logits' for the fused-CE path), unmasked: their
        # consumers mask by length
        producers = {self._producer_of(o) or o for o in hoist_outs}
        for k, v in vals.items():
            if "." in k and k.split(".", 1)[0] in producers \
                    and k not in values:
                values[k] = v
