"""The conv/BN fusion plan (the part of
``paddle_tpu/analysis/netcheck.py`` the port needs, as its own copy):
:func:`fusion_plan` resolves, from the static config, which batch norms
run fused with the 3×3 conv that produces them and which defer their
apply pass into the conv that consumes them; :func:`fused_pair_census`
counts the pairs.  The sharding verifier (:func:`check_sharding`,
:func:`errors`, :class:`Issue`) is the JAX module's too: what
``parallel.sharding.verify_rules_or_raise`` reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: conv/BN layer-type families (the ``register_layer`` names of the conv
#: and batch-norm layers).
CONV_TYPES = ("exconv", "cudnn_conv", "conv", "mkldnn_conv")
BN_TYPES = ("batch_norm", "cudnn_batch_norm", "mkldnn_batch_norm")


def _root_and_outputs(config: Any) -> Tuple[Set[str], List[str]]:
    sub_layer_names: Set[str] = set()
    for sm in getattr(config, "sub_models", []) or []:
        if sm.name != "root":
            sub_layer_names.update(sm.layer_names)
    order = [l.name for l in config.layers
             if l.name not in sub_layer_names or l.type == "data"]
    outputs = list(getattr(config, "output_layer_names", []) or []) \
        or (order[-1:] if order else [])
    return set(order), outputs


def fusion_plan(config: Any, root_layers: Optional[Set[str]] = None,
                output_names: Optional[Sequence[str]] = None,
                fuse_bwd: bool = True, fuse_fwd: bool = True
                ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """The build-time conv/BN fusion resolution, as a pure function of
    the config: returns ``(bwd, fwd)`` where ``bwd`` maps a batch-norm
    to the 3×3 conv it back-fuses (``conv2d_bn``) and ``fwd`` maps a
    consuming conv to the batch-norm whose apply pass defers into it
    (``affine_act_conv2d``).  :class:`~paddle_tpu_torch.layers.network.
    NeuralNetwork` builds its peephole tables by calling THIS function,
    so a static census computed here is the runtime census by
    construction.
    """
    lmap = {l.name: l for l in config.layers}
    if root_layers is None or output_names is None:
        derived_root, derived_out = _root_and_outputs(config)
        root_layers = root_layers if root_layers is not None \
            else derived_root
        output_names = output_names if output_names is not None \
            else derived_out

    n_consumers: Dict[str, int] = {}
    for lc in config.layers:
        for iname in (i.input_layer_name for i in lc.inputs):
            n_consumers[iname] = n_consumers.get(iname, 0) + 1
    # consumers that read values by name OUTSIDE layer input lists:
    # group in/out links, memory boot layers, generator static inputs,
    # and evaluator inputs — a conv referenced by any of these must
    # keep its standalone value
    extra: Set[str] = set()
    for sm in getattr(config, "sub_models", []) or []:
        if sm.name == "root":
            continue
        extra.update(sm.in_links)
        extra.update(sm.out_links)
        for m in sm.memories:
            if m.get("boot_layer_name"):
                extra.add(m["boot_layer_name"])
        extra.update(sm.generator.get("static_inputs", ()))
    for ev in getattr(config, "evaluators", []) or []:
        for key in ("input_layer_name", "label_layer_name"):
            if ev.get(key):
                extra.add(ev[key])
    outputs = set(output_names) | extra

    bwd: Dict[str, str] = {}
    if fuse_bwd:
        for lconf in config.layers:
            if lconf.type not in BN_TYPES or len(lconf.inputs) != 1 \
                    or lconf.name not in root_layers:
                continue
            pname = lconf.inputs[0].input_layer_name
            pconf = lmap.get(pname)
            if pconf is None or pconf.type not in CONV_TYPES \
                    or pname not in root_layers:
                continue
            a = pconf.attrs
            f = a.get("filter_size")
            s = a.get("stride", 1)
            p = a.get("padding", 0)
            if (f == 3 and a.get("filter_size_y", f) == 3
                    and s == 1 and a.get("stride_y", s) == 1
                    and p == 1 and a.get("padding_y", p) == 1
                    and a.get("groups", 1) == 1
                    and len(pconf.inputs) == 1
                    and pconf.active_type in ("", "linear")
                    and pconf.drop_rate == 0
                    and pconf.error_clipping_threshold == 0
                    and n_consumers.get(pname, 0) == 1
                    and pname not in outputs):
                bwd[lconf.name] = pname

    fwd: Dict[str, str] = {}
    if fuse_fwd:
        for lconf in config.layers:        # lconf = the consuming conv
            if lconf.type not in CONV_TYPES \
                    or len(lconf.inputs) != 1 \
                    or lconf.name not in root_layers:
                continue
            a = lconf.attrs
            f = a.get("filter_size")
            fy = a.get("filter_size_y", f)
            s = a.get("stride", 1)
            sy = a.get("stride_y", s)
            p = a.get("padding", 0)
            py = a.get("padding_y", p)
            geom3 = (f == 3 and fy == 3 and s == 1 and sy == 1
                     and p == 1 and py == 1)
            geom1 = (f == 1 and fy == 1 and s == 1 and sy == 1
                     and p == 0 and py == 0)
            if not (geom3 or geom1) or a.get("groups", 1) != 1:
                continue
            pname = lconf.inputs[0].input_layer_name
            pconf = lmap.get(pname)
            if pconf is None or pconf.type not in BN_TYPES \
                    or pname not in root_layers:
                continue
            if (pconf.active_type not in ("", "linear", "relu")
                    or pconf.drop_rate != 0
                    or pconf.error_clipping_threshold != 0
                    or len(pconf.inputs) != 1
                    or pconf.attrs.get("img_size") is None):
                continue
            if n_consumers.get(pname, 0) != 1 or pname in outputs:
                continue
            fwd[lconf.name] = pname
        # a deferred BN publishes (z, a, c) instead of its applied
        # output, so it can no longer be the OUTPUT of a backward-fused
        # pair — its upstream conv reverts to a standalone value.  (A
        # bwd entry whose CONV is a fwd consumer stays: that pair runs
        # as the chain op with the deferred affine as its prologue.)
        for bn in fwd.values():
            bwd.pop(bn, None)
    return bwd, fwd


def fused_pair_census(config: Any, fuse_bwd: bool = True,
                      fuse_fwd: bool = True) -> Dict[str, int]:
    """Static census of the fused pairs per direction and kernel family
    (the JAX package's ``network_conv_bn_fused_pairs`` gauge keys)."""
    bwd, fwd = fusion_plan(config, fuse_bwd=fuse_bwd, fuse_fwd=fuse_fwd)
    lmap = {l.name: l for l in config.layers}
    fwd3 = sum(1 for cv in fwd
               if lmap[cv].attrs.get("filter_size") == 3)
    return {"bwd_3x3": len(bwd), "fwd_3x3": fwd3,
            "fwd_1x1": len(fwd) - fwd3}


# ------------------------------------------------ the sharding verifier
@dataclasses.dataclass(frozen=True)
class Issue:
    """One verifier finding.  ``path`` is the layer-path provenance:
    the producer chain that feeds the offending layer (innermost
    last), prefixed with the sub-model name for group layers."""

    kind: str                # "shape" | "dtype" | "shard"
    severity: str            # "error" | "warn"
    where: str               # layer name or rule/param identity
    message: str
    path: Tuple[str, ...] = ()

    def render(self) -> str:
        prov = " -> ".join(self.path)
        loc = f"{self.where}" + (f" (via {prov})" if prov else "")
        return f"[{self.kind}/{self.severity}] {loc}: {self.message}"


def _spec_axes(spec: Any) -> List[List[str]]:
    """PartitionSpec-like → per-dim list of mesh-axis names (a dim may
    carry one axis, a tuple of axes, or None = replicated)."""
    dims: List[List[str]] = []
    for entry in tuple(spec):
        if entry is None:
            dims.append([])
        elif isinstance(entry, (tuple, list)):
            dims.append([str(a) for a in entry])
        else:
            dims.append([str(entry)])
    return dims


def check_sharding(rules: Any, param_dims: Dict[str, Sequence[int]],
                   mesh_axes: Dict[str, int],
                   strict: bool = False) -> List[Issue]:
    """Verify a ShardingRules table against a model's parameter tree.

    ``rules``: a ``ShardingRules`` (duck-typed: ``.rules`` list of
    ``(compiled_pattern, PartitionSpec)``) or the list itself.
    ``param_dims``: parameter name → dims.  ``mesh_axes``: axis name →
    size for ONE topology; call once per topology.

    Errors (preflight-fatal): a resolved spec names an unknown mesh
    axis, or a sharded dim is not divisible by the product of its mesh
    axes; in ``strict`` mode an unmatched parameter too.  Warnings:
    unmatched parameters (silently replicated — the table has no
    opinion), rules that match nothing in this model, higher-priority
    matches excluded by rank, and multi-matches that first-match-wins
    resolves (ambiguity worth an explicit pattern).
    """
    table = list(getattr(rules, "rules", rules))
    issues: List[Issue] = []
    matched_any = [False] * len(table)

    for pname in sorted(param_dims):
        dims = [int(d) for d in param_dims[pname]]
        ndim = len(dims)
        matching = [(i, pat, spec) for i, (pat, spec) in enumerate(table)
                    if pat.search(pname)]
        applicable = [(i, pat, spec) for i, pat, spec in matching
                      if len(tuple(spec)) <= ndim]
        for i, _, _ in matching:
            matched_any[i] = True
        if not matching:
            issues.append(Issue(
                "shard", "error" if strict else "warn", pname,
                f"parameter matches NO sharding rule — silently "
                f"replicated over the {dict(mesh_axes)} mesh"))
            continue
        if not applicable:
            issues.append(Issue(
                "shard", "error", pname,
                f"every matching rule's spec rank exceeds the "
                f"parameter rank {ndim} (dims {dims}) — the table "
                "cannot place this parameter (rank-excluded rules: "
                + ", ".join(f"#{i} {pat.pattern!r}"
                            for i, pat, _ in matching) + ")"))
            continue
        first_i, first_pat, spec = applicable[0]
        if matching[0][0] != first_i:
            i, pat, s = matching[0]
            issues.append(Issue(
                "shard", "warn", pname,
                f"highest-priority match #{i} {pat.pattern!r} is "
                f"rank-excluded (spec rank {len(tuple(s))} > param "
                f"rank {ndim}); rule #{first_i} {first_pat.pattern!r} "
                "applies instead — tighten the pattern if unintended"))
        distinct = {tuple(s) for _, _, s in applicable}
        if len(distinct) > 1:
            issues.append(Issue(
                "shard", "warn", pname,
                "ambiguous coverage: rules "
                + ", ".join(f"#{i} {p.pattern!r}→{tuple(s)}"
                            for i, p, s in applicable)
                + f" all match; first-match-wins resolves to "
                  f"#{first_i} {first_pat.pattern!r}"))
        # divisibility + axis existence of the RESOLVED spec
        for d, axes in enumerate(_spec_axes(spec)):
            shard = 1
            for ax in axes:
                if ax not in mesh_axes:
                    issues.append(Issue(
                        "shard", "error", pname,
                        f"rule #{first_i} {first_pat.pattern!r} "
                        f"shards dim {d} over mesh axis {ax!r} which "
                        f"does not exist in {dict(mesh_axes)}"))
                    shard = 0
                    break
                shard *= int(mesh_axes[ax])
            if shard > 1 and dims[d] % shard:
                issues.append(Issue(
                    "shard", "error", pname,
                    f"dim {d} of size {dims[d]} is not divisible by "
                    f"the {'×'.join(axes)} mesh extent {shard} "
                    f"(rule #{first_i} {first_pat.pattern!r}, dims "
                    f"{dims}) — this table cannot compile on "
                    f"{dict(mesh_axes)}"))
    for i, hit in enumerate(matched_any):
        if not hit and param_dims:
            pat, spec = table[i]
            issues.append(Issue(
                "shard", "warn", f"rule #{i}",
                f"pattern {pat.pattern!r} matches no parameter of "
                "this model — dead rule (or a typo shadowing a real "
                "one)"))
    return issues


def errors(issues: Iterable[Issue]) -> List[Issue]:
    return [i for i in issues if i.severity == "error"]
