"""Recurrent layer groups (counterpart of
``paddle_tpu/layers/recurrent_group.py``, the ``RecurrentGradientMachine``
equivalent): a :class:`SubModelConfig` run once per timestep over
variable-length sequences.

The JAX package traces the step once and drives it with ``lax.scan``;
here the time loop is a Python loop over steps on tensors, and autograd
through it is the backward.  Memories are the loop's carries (a memory
reads a layer's previous-step output through its link name, booted from
a boot layer cast to the policy output dtype, or zeros plus the memory's
``boot_bias``); in-links are sliced per step; out-links are stacked.  A
padded step keeps every carry, ``m·new + (1−m)·old``, and its out-link
rows are 0.  Outer values a step reads that are neither in-links nor
memories (the encoder sequence of an attention decoder) are static
inputs.

Epilogue hoisting (:meth:`RecurrentGroup._split_scan_epilogue`, on by
default through the class attribute ``HOIST``): step layers that no
memory depends on and that are pointwise over time run once, after the
loop, over the stacked ``[B, T, ...]`` sequence — the decoder's softmax
projection becomes one ``[B·T, H] × [H, V]`` product instead of T.  The
hoisted out-link producer's ``.logits`` sub-output is exposed, so a
classification cost takes the fused logits path.

:meth:`RecurrentGroup.step` runs one timestep; the beam-search decoder
of a generating group (``layers/beam_search.py``) drives the group with
it.

A nested group (its in-links are nested sequences,
:class:`NestedSequenceBatch`, LoD level 2) steps over subsequence slots
instead (:meth:`RecurrentGroup._run_nested`, the JAX ``_run_nested``):
each step's frame is a whole ``SequenceBatch`` of one slot, which the
step's sequence layers (pools, ``last_seq``, ``lstmemory``,
``recurrent``, …) consume; memories carry ``[B, size]`` state from slot
to slot, kept by the outer mask.  Every one of the S slots runs, an
empty one too, as the JAX scan runs them; the step's layers are not
hoisted.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from ..config.model_config import ModelConfig, SubModelConfig
from ..core.dtypes import current_policy
from ..core.sequence import NestedSequenceBatch, SequenceBatch, value_of
from ..utils import PaddleTpuError, enforce
from .base import ForwardContext, cast_layer_output, get_layer_class


def check_supported(config: ModelConfig) -> None:
    """Refuse, at build time, a group flagged generating whose config
    carries no generator (the beam-search settings)."""
    for sm in config.sub_models:
        if sm.name != "root" and sm.is_generating and not sm.generator:
            raise PaddleTpuError(
                f"recurrent group {sm.name!r} is flagged as a generating "
                "group but has no generator (beam_search settings)")


class RecurrentGroup:
    """Executes one SubModelConfig with a time loop."""

    # Epilogue hoisting; a class attribute so tests can compare hoisted
    # and in-loop execution.
    HOIST = True

    # Layer types whose forward is pointwise over leading axes (they act
    # on the trailing feature dim only), so running them once on a
    # stacked [B, T, ...] SequenceBatch equals running them per step:
    # the JAX package's set.  Sequence-aware types (pooling, expand, ...)
    # must NOT be hoisted.
    POINTWISE_TYPES = frozenset({
        "fc", "mkldnn_fc", "mixed", "addto", "scaling", "clip",
        "slope_intercept", "power", "get_output", "maxid", "print",
        "dot_prod", "interpolation"})

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

    def _is_pointwise(self, conf) -> bool:
        """A pointwise type; a mixed layer only without a context
        projection, which looks across the time axis."""
        if conf.type not in self.POINTWISE_TYPES:
            return False
        return conf.type != "mixed" or not any(
            inp.proj is not None and inp.proj.type == "context"
            for inp in conf.inputs)

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
                 if not self._is_pointwise(self.layers[n].conf)}
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
        init = torch.zeros((batch, size), dtype=dtype, device=device)
        bias = mem.get("boot_bias")
        if bias is not None:
            init = init + torch.as_tensor(bias, dtype=dtype, device=device)
        return init

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

    def step(self, params: Dict[str, Any], frame: Dict[str, Any],
             mems: List[torch.Tensor], outer: Dict[str, Any],
             ctx: ForwardContext, order: Optional[List[str]] = None
             ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        """One timestep: the frame's values and each memory's previous
        value in, every step layer (or ``order``'s) run → (the memories'
        new values, every value of the step)."""
        values: Dict[str, Any] = dict(frame)
        for mem, mval in zip(self.memories, mems):
            values[self._link(mem)] = mval
        self._forward_layers(self.order if order is None else order,
                             values, outer, params, ctx)
        return [value_of(values[m["layer_name"]]) for m in self.memories], \
            values

    def run(self, params: Dict[str, Any], values: Dict[str, Any],
            ctx: ForwardContext) -> None:
        """Loop the group over its in-link sequences; writes the out-link
        sequences (and the hoisted producers' sub-outputs) into
        ``values``."""
        enforce(self.in_links, f"group {self.sub.name} has no in_links")
        if isinstance(values[self.in_links[0]], NestedSequenceBatch):
            return self._run_nested(params, values, ctx)
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
        # hoisted layers feeding a hoisted out-link, and print layers (a
        # side effect); the rest are dead past the loop
        live = {self._producer_of(o) or o for o in hoist_outs}
        live |= {n for n in hoisted if self.layers[n].conf.type == "print"}
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
            new_mems, step_vals = self.step(
                params, {link: seq.data[:, s]
                         for link, seq in zip(self.in_links, seqs)},
                mems, values, ctx, order=loop_order)
            m = mask[:, s, None]
            mems = [m * new + (1 - m) * old
                    for new, old in zip(new_mems, mems)]
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

    def _run_nested(self, params: Dict[str, Any], values: Dict[str, Any],
                    ctx: ForwardContext) -> None:
        """Nested in-links: one step per subsequence slot (the
        reference's ``RecurrentGradientMachine`` over
        ``subSequenceStartPositions``; ``sequence_nest_rnn.conf``).  A
        step's frame is the slot's ``SequenceBatch`` (an invalid slot's
        rows of length 0); a sequence out-link comes back as a
        ``NestedSequenceBatch``, any other as a ``SequenceBatch`` over
        the slots."""
        seqs = []
        for link in self.in_links:
            s = values[link]
            enforce(isinstance(s, NestedSequenceBatch),
                    f"group {self.sub.name}: in_link {link!r}: all in-links "
                    "of a nested group must be nested sequences")
            seqs.append(s)
        b, n_sub = seqs[0].data.shape[:2]
        num_subseq = seqs[0].num_subseq
        fdt = current_policy().output_dtype
        outer = seqs[0].subseq_mask(fdt)                  # [B, S]
        valid = outer > 0
        mems = [self._memory_init(m, values, b, fdt, seqs[0].data.device)
                for m in self.memories]
        lengths = [s.sub_length * s.subseq_mask(s.sub_length.dtype)
                   for s in seqs]
        outs: Dict[str, List[Any]] = {o: [None] * n_sub
                                      for o in self.out_links}
        slots = range(n_sub - 1, -1, -1) if self.sub.reversed \
            else range(n_sub)
        for j in slots:
            frame = {link: SequenceBatch(data=s.data[:, j], length=ln[:, j])
                     for link, s, ln in zip(self.in_links, seqs, lengths)}
            new_mems, step_vals = self.step(params, frame, mems, values, ctx)
            m = outer[:, j, None]
            mems = [m * new + (1 - m) * old
                    for new, old in zip(new_mems, mems)]
            for o in self.out_links:
                v = step_vals[o]
                d = value_of(v)
                mb = valid[:, j].reshape((b,) + (1,) * (d.dim() - 1))
                d = torch.where(mb, d, torch.zeros((), dtype=d.dtype,
                                                   device=d.device))
                outs[o][j] = (d, v.length * valid[:, j].to(v.length.dtype)) \
                    if isinstance(v, SequenceBatch) else d
        for o in self.out_links:
            if isinstance(outs[o][0], tuple):
                values[o] = NestedSequenceBatch(
                    data=torch.stack([d for d, _ in outs[o]], 1),
                    num_subseq=num_subseq,
                    sub_length=torch.stack([ln for _, ln in outs[o]], 1))
            else:
                values[o] = SequenceBatch(data=torch.stack(outs[o], 1),
                                          length=num_subseq)
