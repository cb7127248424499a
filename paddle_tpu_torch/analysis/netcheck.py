"""The conv/BN fusion plan (the part of
``paddle_tpu/analysis/netcheck.py`` the port needs, as its own copy):
:func:`fusion_plan` resolves, from the static config, which batch norms
run fused with the 3×3 conv that produces them and which defer their
apply pass into the conv that consumes them; :func:`fused_pair_census`
counts the pairs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

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
