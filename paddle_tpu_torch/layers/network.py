"""NeuralNetwork: config-driven executor over the layer registry
(counterpart of ``paddle_tpu/layers/network.py``).

:meth:`NeuralNetwork.forward` runs the layers in topological order on
tensors; the backward is autograd over the whole forward.  Batch-norm
running statistics are a separate ``buffers`` dict: :meth:`init_buffers`
makes it, :meth:`forward` and :meth:`loss` return the updated one.

The conv/BN fusion peepholes are built once from the static config by
:func:`paddle_tpu_torch.analysis.netcheck.fusion_plan` (kill switches
``--conv_bn_fuse``, ``--conv_bn_fuse_fwd``): a batch norm whose sole
producer is a linear 3×3 stride-1 pad-1 conv runs that conv itself
(``nn_ops.conv2d_bn``, the conv is skipped in the walk), and a batch
norm whose sole consumer is a fusable conv publishes its folded affine
instead of its output (``nn_ops.affine_act_conv2d``).  The ops re-gate
on shapes and fall back to the exact unfused composition.

Recurrent-group sub-models run through
:class:`~paddle_tpu_torch.layers.recurrent_group.RecurrentGroup`: a
group runs when one of its out-links is first needed, reading the outer
values it needs as static inputs.  A generating group is decoded there
by its :class:`~paddle_tpu_torch.layers.beam_search.BeamSearchDecoder`
(built with the network), whose bundle the ``beam_gen`` layer exposes.
A nested group steps over its in-links' subsequence slots.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

import torch

from ..analysis import netcheck
from ..config.model_config import ModelConfig, ParameterConfig
from ..core.device import resolve_device
from ..core.sequence import value_of
from ..utils import FLAGS, PaddleTpuError, enforce
from .base import (ForwardContext, Layer, cast_layer_output,
                   get_layer_class, init_parameter)
# register the layer types
from . import (attention, common, conv, cost, detection,  # noqa: F401
               image3d, rnn, seq)
from .beam_search import BeamSearchDecoder
from .recurrent_group import RecurrentGroup, check_supported


class NeuralNetwork:
    """Builds and executes a ModelConfig as a graph of tensor functions."""

    def __init__(self, config: ModelConfig):
        check_supported(config)
        self.config = config
        # recurrent groups: their step layers run inside the group
        self.group_of: Dict[str, str] = {}
        self.groups: Dict[str, RecurrentGroup] = {}
        self.decoders: Dict[str, BeamSearchDecoder] = {}
        for sm in config.sub_models:
            if sm.name == "root":
                continue
            self.group_of.update({ln: sm.name for ln in sm.layer_names})
            if sm.is_generating:
                self.decoders[sm.name] = BeamSearchDecoder(sm, config)
            else:
                self.groups[sm.name] = RecurrentGroup(sm, config)
        self.layers: Dict[str, Layer] = {}
        self.order: List[str] = []
        for lconf in config.layers:
            if lconf.name in self.group_of and lconf.type != "data":
                continue            # executed inside its recurrent group
            self.layers[lconf.name] = get_layer_class(lconf.type)(lconf,
                                                                  config)
            self.order.append(lconf.name)

        # parameter specs: layer-declared, merged with config-declared
        declared = {p.name: p for p in config.parameters}
        self.param_specs: Dict[str, ParameterConfig] = {}
        for layer in self._all_layers():
            self._collect_specs(layer, declared)
        self.static_params = {n for n, s in self.param_specs.items()
                              if s.is_static}
        self.cost_layers = [n for n in self.order
                            if getattr(self.layers[n], "is_cost", False)]
        self.output_names = config.output_layer_names or self.order[-1:]
        # classification-cost logits peephole: a multi-class CE reading a
        # softmax fc gets the fc's '.logits' sub-output (fused CE path),
        # unless dropout or an error clip stands between the two
        lmap = config.layer_map()
        self._cost_logit_alias: Dict[str, str] = {}
        for cname in self.cost_layers:
            conf = self.layers[cname].conf
            if conf.type != "multi-class-cross-entropy" or not conf.inputs:
                continue
            pname = conf.inputs[0].input_layer_name
            pconf = lmap.get(pname)
            if pconf is not None \
                    and pconf.type in ("fc", "mkldnn_fc") \
                    and pconf.active_type == "softmax" \
                    and pconf.drop_rate == 0 \
                    and pconf.error_clipping_threshold == 0:
                self._cost_logit_alias[cname] = pname + ".logits"

        # conv/BN fusion peepholes: bn -> the conv it runs (backward
        # fusion), conv -> the bn whose apply it takes (forward fusion)
        self._conv_bn_fuse, self._bn_conv_fuse = netcheck.fusion_plan(
            config, root_layers=set(self.layers),
            output_names=self.output_names,
            fuse_bwd=bool(FLAGS.get("conv_bn_fuse")),
            fuse_fwd=bool(FLAGS.get("conv_bn_fuse_fwd")))
        fwd3 = sum(1 for cv in self._bn_conv_fuse
                   if lmap[cv].attrs.get("filter_size") == 3)
        #: the pairs this topology resolved at build time, keyed as the
        #: JAX package's ``network_conv_bn_fused_pairs`` gauge
        self.fused_pair_census = {
            "bwd_3x3": len(self._conv_bn_fuse), "fwd_3x3": fwd3,
            "fwd_1x1": len(self._bn_conv_fuse) - fwd3}
        # the same census in the registry (gauges reflect the most
        # recently built network), and the build-time precision census
        from ..core.dtypes import current_policy, dtype_name
        from ..observe import counter, gauge
        pairs = gauge("network_conv_bn_fused_pairs",
                      "conv/BN pairs resolved by the build-time fusion "
                      "peepholes of the last-built network")
        pairs.set(len(self._conv_bn_fuse), direction="bwd", kernel="3x3")
        pairs.set(fwd3, direction="fwd", kernel="3x3")
        pairs.set(len(self._bn_conv_fuse) - fwd3,
                  direction="fwd", kernel="1x1")
        pol = current_policy()
        counter("network_builds_total",
                "networks built, labeled by the op-policy dtypes "
                "resolved at build time").inc(
            compute=dtype_name(pol.compute_dtype),
            output=dtype_name(pol.output_dtype))

    def _all_layers(self) -> List[Layer]:
        """The root's layers, then each group's and each decoder's."""
        groups = [*self.groups.values(),
                  *(d.group for d in self.decoders.values())]
        return [*self.layers.values(),
                *(lyr for g in groups for lyr in g.layers.values())]

    def _collect_specs(self, layer: Layer,
                       declared: Dict[str, ParameterConfig]) -> None:
        for spec in layer.param_specs():
            if spec.name in declared:
                d = declared[spec.name]
                if not d.dims:
                    d.dims = spec.dims
                d.size = d.size or spec.size
                spec = d
            if spec.name in self.param_specs:
                enforce(self.param_specs[spec.name].dims == spec.dims,
                        f"shared parameter {spec.name} shape mismatch: "
                        f"{self.param_specs[spec.name].dims} vs {spec.dims}")
                continue
            self.param_specs[spec.name] = spec

    # ------------------------------------------------------------- params
    def init_params(self, seed: int = 1,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
        """Every parameter, drawn on the CPU from one ``torch.Generator``
        seeded with ``seed`` in sorted-name order, then moved to
        ``device`` (default CUDA; raises when CUDA is absent and the CPU
        was not asked for).  Same distributions as the JAX package, not
        the same draws."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        return {name: init_parameter(gen, spec).to(dev)
                for name, spec in sorted(self.param_specs.items())}

    def init_buffers(self, device: Optional[Union[str, torch.device]] = None
                     ) -> Dict[str, torch.Tensor]:
        """Every layer's buffers (batch-norm running mean 0 and var 1,
        f32) on ``device`` (default CUDA, as :meth:`init_params`)."""
        dev = resolve_device(device)
        buffers: Dict[str, torch.Tensor] = {}
        for layer in self._all_layers():
            if hasattr(layer, "buffer_specs"):
                buffers.update({k: v.to(dev) for k, v in
                                layer.buffer_specs().items()})
        return buffers

    def lr_scales(self, params: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Per-parameter learning-rate scale; 0 for static parameters."""
        return {n: 0.0 if n in self.static_params
                else self.param_specs[n].learning_rate for n in params}

    # ------------------------------------------------------------ forward
    def _ancestors(self, targets) -> Set[str]:
        """Main-graph layers (transitively) needed to produce ``targets``
        (the reference's inference pruning).  A group out-link pulls in
        the whole group: its in-links, memory boot layers, and every
        outer value its step layers read."""
        needed: Set[str] = set()
        stack = list(targets)
        seen: Set[str] = set()
        while stack:
            v = stack.pop()
            if v in seen:
                continue
            seen.add(v)
            base = v.split(".", 1)[0]
            if base not in self.layers:
                base = v
            if base in self.layers:
                needed.add(base)
                stack.extend(self.layers[base].conf.input_names())
                continue
            gname = self.group_of.get(v)
            if gname is None:
                continue
            grp = self.groups.get(gname) or self.decoders[gname].group
            sub = grp.sub
            stack.extend(sub.in_links)
            stack.extend((sub.generator or {}).get("static_inputs", ()))
            inner = set(grp.layers) | set(sub.layer_names)
            mem_links = set()
            for m in sub.memories:
                mem_links.add(m.get("link_name", m["layer_name"] + "@pre"))
                if m.get("boot_layer_name"):
                    stack.append(m["boot_layer_name"])
            for lyr in grp.layers.values():
                for iname in lyr.conf.input_names():
                    head = iname.split(".", 1)[0]
                    if head not in inner and iname not in mem_links \
                            and iname not in sub.in_links:
                        stack.append(iname)
        return needed

    def forward(self, params: Dict[str, torch.Tensor], feed: Dict[str, Any],
                buffers: Optional[Dict[str, torch.Tensor]] = None,
                is_training: bool = True,
                rng: Optional[torch.Generator] = None,
                only: Optional[Sequence[str]] = None
                ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """Run all layers; returns (every output by name, sub-outputs as
        ``name.key``; the buffers with this call's updates).  Dropout
        draws from ``rng`` (each layer from a generator of its own,
        :meth:`ForwardContext.layer_rng`; None: seed 0).  ``only``:
        restrict execution to the ancestors of these value names, so
        data layers outside them need no feed (inference on a training
        config, the serving export)."""
        ctx = ForwardContext(is_training=is_training, rng=rng,
                             buffers=dict(buffers or {}))
        values: Dict[str, Any] = {}
        done_groups: Set[str] = set()
        needed = self._ancestors(only) if only is not None else None

        def gather(names):
            """Input values, running a group when an out-link is first
            needed."""
            for iname in names:
                if iname not in values:
                    self._run_group(iname, params, values, ctx, done_groups)
            return [values[i] for i in names]

        fused_convs = set(self._conv_bn_fuse.values())
        defer = set(self._bn_conv_fuse.values())
        for name in self.order:
            if needed is not None and name not in needed:
                continue
            if name in fused_convs:
                continue            # produced inside its batch-norm partner
            layer = self.layers[name]
            if layer.conf.type == "data":
                if name not in feed:
                    raise PaddleTpuError(
                        f"missing feed for data layer {name!r}")
                values[name] = feed[name]
                continue
            if name in defer:
                # forward conv+BN fusion: publish (z, a, c) for the
                # consuming conv, no activation materialised here
                inputs = gather(layer.conf.input_names())
                values[name] = layer.forward_deferred(params, inputs, ctx)
                continue
            src = self._conv_bn_fuse.get(name)
            if src is not None:
                cv = self.layers[src]
                cinputs = gather(cv.conf.input_names())
                out = cast_layer_output(
                    layer, layer.forward_fused(params, cv, cinputs, ctx))
            else:
                inputs = gather(layer.conf.input_names())
                if name in self._cost_logit_alias:
                    layer.logits_value = values.get(
                        self._cost_logit_alias[name])
                out = cast_layer_output(layer,
                                        layer.forward(params, inputs, ctx))
            if isinstance(out, dict):
                for k, v in out.items():
                    values[name if k == "out" else f"{name}.{k}"] = v
            else:
                values[name] = out
        # declared outputs that are group out-links no layer consumes
        for name in (self.output_names if only is None else only):
            gname = self.group_of.get(name)
            if name not in values and gname is not None \
                    and gname not in done_groups \
                    and name in self._out_links(gname):
                self._run_group(name, params, values, ctx, done_groups)
        ctx.buffers.update(ctx.new_buffers)
        return values, ctx.buffers

    def _out_links(self, gname: str) -> List[str]:
        group = self.groups.get(gname) or self.decoders[gname].group
        return group.out_links

    def _run_group(self, name: str, params, values, ctx,
                   done_groups: Set[str]) -> None:
        """Produce ``name``, an out-link of a recurrent group not yet run,
        by running its group (a generating group: decoding it, each
        out-link then holding the generation bundle)."""
        gname = self.group_of.get(name)
        if gname is None or gname in done_groups:
            raise PaddleTpuError(f"layer input {name!r} has no producer")
        if gname in self.decoders:
            bundle = self.decoders[gname].generate(params, values, ctx)
            values.update(dict.fromkeys(self._out_links(gname), bundle))
        else:
            self.groups[gname].run(params, values, ctx)
        done_groups.add(gname)

    def loss(self, params: Dict[str, torch.Tensor], feed: Dict[str, Any],
             buffers: Optional[Dict[str, torch.Tensor]] = None,
             is_training: bool = True,
             rng: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Tuple[Dict[str, Any],
                                            Dict[str, torch.Tensor]]]:
        """Scalar objective = mean per-example total cost
        (``Argument::sum`` / rows: B, or B·T for the per-token cost of
        a sequence, as the JAX package divides) → (loss, (values,
        buffers)).  Only the cost layers enter it, as in the JAX
        package: a layer that combines costs downstream (the VAE's
        ``mixed`` sum of its two costs, the 0.5 its KL term takes on
        the way) is an output, not the objective."""
        values, new_buffers = self.forward(params, feed, buffers,
                                           is_training, rng)
        enforce(self.cost_layers, "network has no cost layer")
        total = None
        for cname in self.cost_layers:
            v = value_of(values[cname])
            c = torch.sum(v) / v.shape[0]
            total = c if total is None else total + c
        return total, (values, new_buffers)

    def outputs(self, values: Dict[str, Any]) -> Dict[str, Any]:
        """The declared output layers' values, by name."""
        return {n: values[n] for n in self.output_names if n in values}
