"""save/load persistables + inference model export
(``python/paddle/v2/framework/io.py``; save/load ops
``paddle/operators/save_op.cc``/``load_op.cc``; counterpart of
``paddle_tpu/framework/io.py``).

Format: the JAX package's versioned JSON manifest
(``"paddle-tpu-inference-program"``, version 1) + ``.npz`` tensor
archive, so a directory written by either package loads into the other.
No pickle anywhere: the artifact is inspectable, diffable, and loading
untrusted files cannot execute code.  Loaded values land on the
executor's device.  This format still requires the framework's executor
to run; a model served without it is :mod:`paddle_tpu_torch.serving`'s.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Sequence

import numpy as np

import torch

from ..utils import enforce
from .executor import Executor, Scope, _host_array, global_scope
from .program import Program, Variable, default_main_program

FORMAT_VERSION = 1


def _encode_attr(v: Any) -> Any:
    """JSON-encode an op attribute, tagging the non-JSON types."""
    if isinstance(v, (type(None), bool, int, float, str)):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, tuple):
        return {"__t__": "tuple", "v": [_encode_attr(x) for x in v]}
    if isinstance(v, list):
        return [_encode_attr(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode_attr(x) for k, x in v.items()}
    if isinstance(v, np.dtype):
        return {"__t__": "dtype", "v": str(v)}
    if isinstance(v, np.ndarray):
        return {"__t__": "ndarray", "dtype": str(v.dtype),
                "shape": list(v.shape), "v": v.ravel().tolist()}
    raise TypeError(f"op attribute of type {type(v).__name__} is not "
                    f"serializable: {v!r}")


def _decode_attr(v: Any) -> Any:
    if isinstance(v, list):
        return [_decode_attr(x) for x in v]
    if isinstance(v, dict):
        tag = v.get("__t__")
        if tag == "tuple":
            return tuple(_decode_attr(x) for x in v["v"])
        if tag == "dtype":
            return np.dtype(v["v"])
        if tag == "ndarray":
            return np.asarray(v["v"], dtype=v["dtype"]).reshape(v["shape"])
        return {k: _decode_attr(x) for k, x in v.items()}
    return v


def _persistable_params(program: Program) -> List[Variable]:
    return [p for p in program.parameters()]


def save_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None,
                      scope: Optional[Scope] = None) -> None:
    program = main_program or default_main_program()
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    data = {}
    for b in program.blocks:
        for name, var in b.vars.items():
            if var.persistable and scope.has(name):
                data[name] = _host_array(scope.find(name))
    np.savez(os.path.join(dirname, "persistables.npz"), **data)
    with open(os.path.join(dirname, "persistables.json"), "w") as f:
        json.dump({"version": FORMAT_VERSION,
                   "names": sorted(data)}, f, indent=2)


save_params = save_persistables


def load_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None,
                      scope: Optional[Scope] = None) -> None:
    scope = scope or global_scope()
    with np.load(os.path.join(dirname, "persistables.npz")) as data:
        for name in data.files:
            scope.set(name, torch.from_numpy(data[name]).to(executor.place))


load_params = load_persistables


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable],
                         executor: Executor,
                         main_program: Optional[Program] = None,
                         scope: Optional[Scope] = None) -> None:
    """Prune to the inference subgraph + save params
    (reference: ``io.py`` save_inference_model uses ``core.prune``)."""
    program = main_program or default_main_program()
    pruned = program.prune([v.name for v in target_vars])
    save_persistables(executor, dirname, program, scope)

    def _block_meta(block, ops):
        return {
            "parent_idx": block.parent_idx,
            "ops": [{"type": op.type, "inputs": op.inputs,
                     "outputs": op.outputs,
                     "attrs": {k: _encode_attr(v)
                               for k, v in op.attrs.items()}}
                    for op in ops],
            "vars": {n: {"shape": list(v.shape), "dtype": str(v.dtype),
                         "persistable": bool(v.persistable),
                         "lod_level": int(v.lod_level)}
                     for n, v in block.vars.items()},
        }

    # all blocks travel so recurrent/cond sub_block indices stay valid
    meta = {
        "format": "paddle-tpu-inference-program",
        "version": FORMAT_VERSION,
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name for v in target_vars],
        "blocks": [_block_meta(b, pruned.global_block.ops if b.idx == 0
                               else b.ops)
                   for b in program.blocks],
    }
    with open(os.path.join(dirname, "inference_model.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_inference_model(dirname: str, executor: Executor,
                         scope: Optional[Scope] = None):
    """Returns (program, feed_names, fetch_vars)."""
    path = os.path.join(dirname, "inference_model.json")
    with open(path) as f:
        meta = json.load(f)
    enforce(meta.get("version", 0) <= FORMAT_VERSION,
            f"{path}: written by a newer version ({meta.get('version')})")
    program = Program()
    for i, bm in enumerate(meta["blocks"]):
        block = program.global_block if i == 0 else \
            program.create_block(bm["parent_idx"])
        for n, vm in bm["vars"].items():
            block.create_var(name=n, shape=tuple(vm["shape"]),
                             dtype=vm["dtype"],
                             persistable=vm["persistable"],
                             lod_level=vm["lod_level"])
        for om in bm["ops"]:
            block.append_op(om["type"], inputs=om["inputs"],
                            outputs=om["outputs"],
                            attrs={k: _decode_attr(v)
                                   for k, v in om["attrs"].items()})
    load_persistables(executor, dirname, program, scope)
    gb = program.global_block
    fetch_vars = [gb.var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars
