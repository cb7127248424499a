"""Per-parameter sharding rules (regex → PartitionSpec) and their
placement (counterpart of ``paddle_tpu/parallel/sharding.py``).

The reference expresses model placement imperatively (a layer's
``device=`` attribute routes it to a compute thread,
``ParallelNeuralNetwork.h:34``).  The JAX package gives parameters
``NamedSharding``s and lets XLA's partitioner derive the rest.  The
port keeps the rule tables, their resolution and their verification as
they are — they work on parameter names, dims and a mesh *shape*, so
they need no processes — and places a parameter as a DTensor: ``Shard(d)``
on the mesh dim of the axis its spec names for dim ``d``, ``Replicate``
on the others.  A placed parameter is gathered whole before a layer
reads it (:func:`full_tensor`); the port partitions the parameters'
memory and their update, not the products that read them.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import (DATA_AXIS, MODEL_AXIS, Mesh, NamedSharding, P,
                           PartitionSpec, get_mesh)
from ..utils import PaddleTpuError, get_logger, warn_once
from . import collectives

log = get_logger("sharding")


class ShardingRules:
    """Ordered (regex, PartitionSpec) rules; first match wins."""

    def __init__(self, rules: Sequence[Tuple[str, PartitionSpec]] = ()):
        self.rules: List[Tuple[re.Pattern, PartitionSpec]] = [
            (re.compile(pat), P(*spec)) for pat, spec in rules]

    def add(self, pattern: str, spec: PartitionSpec) -> "ShardingRules":
        self.rules.append((re.compile(pattern), P(*spec)))
        return self

    def spec_for(self, name: str, ndim: int) -> PartitionSpec:
        for pat, spec in self.rules:
            if pat.search(name):
                if len(spec) <= ndim:
                    return spec
                # a matching rule whose spec rank exceeds the param's
                # falls through to the next rule (or replication) — say
                # so once, or a typo'd table quietly replicates a
                # 10^8-row embedding and the "win" is silence
                warn_once(
                    f"sharding.rank_excluded:{pat.pattern}:{name}",
                    "sharding rule %r matches parameter %r but its "
                    "spec %s has rank %d > param rank %d — rule "
                    "skipped (next rule or replication applies)",
                    pat.pattern, name, tuple(spec), len(spec), ndim,
                    logger=log)
        return P()  # replicated

    def sharding_for(self, name: str, ndim: int,
                     mesh: Optional[Mesh] = None) -> NamedSharding:
        mesh = mesh or get_mesh()
        return NamedSharding(mesh, self.spec_for(name, ndim))

    def verify(self, param_dims: Dict[str, Sequence[int]],
               mesh_axes: Optional[Dict[str, int]] = None,
               strict: bool = False) -> list:
        """Statically verify this table against a model's parameter
        tree on one mesh shape (``analysis.netcheck.check_sharding``):
        unmatched and ambiguously-matched params are flagged, spec ranks
        checked against param ranks, and every sharded dim checked for
        mesh-axis divisibility.  Returns the issue list."""
        from ..analysis import netcheck

        if mesh_axes is None:
            mesh_axes = dict(get_mesh().shape)
        return netcheck.check_sharding(self, param_dims, mesh_axes,
                                       strict=strict)


def param_dims_of(net) -> Dict[str, List[int]]:
    """A NeuralNetwork's parameter tree as name → dims, the shape
    :meth:`ShardingRules.verify` consumes (no tensors made)."""
    return {n: list(s.dims) if s.dims else [s.size]
            for n, s in net.param_specs.items()}


def verify_rules_or_raise(rules: "ShardingRules",
                          param_dims: Dict[str, Sequence[int]],
                          mesh_axes: Dict[str, int]) -> None:
    """Preflight: raise ``PaddleTpuError`` listing every error-severity
    finding (a bad rule fails fast, before a step runs)."""
    from ..analysis import netcheck

    errs = netcheck.errors(rules.verify(param_dims, mesh_axes))
    if errs:
        raise PaddleTpuError(
            f"sharding preflight failed on mesh {mesh_axes} "
            f"({len(errs)} error(s)):\n"
            + "\n".join("  " + e.render() for e in errs))


def tp_rules(model_axis: str = MODEL_AXIS) -> ShardingRules:
    """Default tensor-parallel ruleset for the layer engine's parameter
    naming (``_<layer>.w<i>`` / ``_<layer>.wbias``):

    - embedding tables: shard the vocab (row) dim;
    - fc/projection weights: shard the output (col) dim;
    - recurrent/batch-norm/bias: replicated (latency-bound, tiny).
    """
    return ShardingRules([
        (r"emb|__table|lookup", P(model_axis, None)),
        (r"\.wbias$|\.b$|bn|batch_norm", P()),
        (r"lstm|gru|recurrent", P()),
        (r"\.w\d*$", P(None, model_axis)),
    ])


# ------------------------------------------------------------ placement
def _sharded_dims(spec: PartitionSpec, mesh: Mesh
                  ) -> List[Tuple[str, int]]:
    """``(axis, dim)`` for every dim ``spec`` shards over an axis of
    ``mesh`` with more than one member."""
    out = []
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        live = [a for a in names if mesh.shape.get(a, 1) > 1]
        if len(live) > 1:
            raise PaddleTpuError(
                f"spec {tuple(spec)} shards dim {d} over {live}: the port "
                "places one mesh axis a dim")
        if live:
            out.append((live[0], d))
    return out


def shard_tensor(x: torch.Tensor, spec: PartitionSpec,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` (whole, the same on every rank) placed per ``spec``: a
    DTensor holding this rank's shard, or ``x`` itself when nothing is
    sharded."""
    mesh = mesh or get_mesh()
    dims = _sharded_dims(spec, mesh)
    if not dims or mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    local = x.detach()
    placements = [Replicate()] * len(mesh.axis_names)
    for axis, d in dims:
        n = mesh.shape[axis]
        if x.shape[d] % n:
            raise PaddleTpuError(
                f"dim {d} of shape {tuple(x.shape)} does not divide over "
                f"the {n}-way {axis!r} axis")
        local = collectives.local_chunk(local, d, mesh.coordinate(axis), n)
        placements[mesh.axis_names.index(axis)] = Shard(d)
    return DTensor.from_local(local, mesh.device_mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def is_placed(x) -> bool:
    """True for a DTensor (a sharded parameter or slot)."""
    return hasattr(x, "to_local") and hasattr(x, "placements")


def local_tensor(x) -> torch.Tensor:
    """This rank's shard of a placed tensor (``x`` when not placed)."""
    return x.to_local() if is_placed(x) else x


def shard_dims(x) -> List[Tuple[int, int]]:
    """``(mesh dim, tensor dim)`` of every ``Shard`` of a placed
    tensor."""
    if not is_placed(x):
        return []
    return [(i, p.dim) for i, p in enumerate(x.placements)
            if p.is_shard()]


def full_tensor(x) -> torch.Tensor:
    """The whole tensor of a placed ``x``, gathered over each sharded
    mesh dim (``x`` when not placed)."""
    if not is_placed(x):
        return x
    out = x.to_local()
    for mdim, d in shard_dims(x):
        out = collectives.all_gather_dim(out, d,
                                         x.device_mesh.get_group(mdim))
    return out


def like_placed(local: torch.Tensor, ref) -> torch.Tensor:
    """``local`` (a shard shaped like ``ref``'s) placed as ``ref`` is;
    ``local`` when ``ref`` is not placed."""
    if not is_placed(ref):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def shard_params(params: Dict[str, torch.Tensor], rules: ShardingRules,
                 mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """Place every parameter according to the rules."""
    mesh = mesh or get_mesh()
    return {name: shard_tensor(x, rules.spec_for(name, x.dim()), mesh)
            for name, x in params.items()}


def constraint(x, *spec, mesh: Optional[Mesh] = None):
    """The JAX package's ``with_sharding_constraint`` helper: the port
    computes on whole tensors, so a layout hint on an activation is the
    identity."""
    return x


# ===================================================== FSDP (data axis)
#: Parameters smaller than this many ELEMENTS stay replicated under the
#: auto heuristic: sharding a 64-float LayerNorm gain buys nothing and
#: fragments the all-gather schedule.
FSDP_MIN_SIZE = 1024


def match_partition_rules(rules: ShardingRules,
                          param_dims: Dict[str, Sequence[int]]
                          ) -> Dict[str, PartitionSpec]:
    """Resolve a rule table against a parameter tree: name → the
    PartitionSpec first-match-wins assigns.  Scalars always resolve
    replicated."""
    return {name: rules.spec_for(name, len(dims))
            for name, dims in param_dims.items()}


def fsdp_spec(shape: Sequence[int], n_shards: int,
              axis: str = DATA_AXIS,
              min_size: int = FSDP_MIN_SIZE) -> PartitionSpec:
    """FSDP auto heuristic for one parameter: shard the LARGEST dim
    divisible by ``n_shards`` over ``axis`` (the first of equal ones);
    replicate when nothing divides or the param is below ``min_size``
    elements."""
    shape = tuple(int(d) for d in shape)
    if n_shards <= 1 or not shape \
            or int(np.prod(shape)) < max(min_size, 1):
        return P()
    best = -1
    for d, size in enumerate(shape):
        if size % n_shards == 0 and size > 0 \
                and (best < 0 or size > shape[best]):
            best = d
    if best < 0:
        return P()
    entries: List[Optional[str]] = [None] * len(shape)
    entries[best] = axis
    return P(*entries)


def fsdp_rules_for(param_dims: Dict[str, Sequence[int]],
                   n_shards: int, axis: str = DATA_AXIS,
                   min_size: int = FSDP_MIN_SIZE
                   ) -> Dict[str, PartitionSpec]:
    """Auto-derived FSDP placement for a whole parameter tree: name →
    :func:`fsdp_spec`.  The committed per-zoo tables of
    :mod:`paddle_tpu_torch.parallel.rule_tables` take precedence when
    the model is a known zoo member."""
    return {name: fsdp_spec(dims, n_shards, axis, min_size)
            for name, dims in param_dims.items()}


def make_shard_and_gather_fns(specs: Dict[str, PartitionSpec],
                              mesh: Optional[Mesh] = None):
    """Per-name (shard_fn, gather_fn) pairs for a resolved spec dict:
    ``shard_fns[name](x)`` places a whole ``x`` per its spec;
    ``gather_fns[name](x)`` brings it back whole (checkpoint writers and
    debuggers use it)."""
    mesh = mesh or get_mesh()

    def _shard(spec):
        return lambda x: shard_tensor(x, spec, mesh)

    shard_fns = {name: _shard(spec) for name, spec in specs.items()}
    gather_fns = {name: full_tensor for name in specs}
    return shard_fns, gather_fns


def spec_shard_info(spec: PartitionSpec, mesh: Mesh
                    ) -> Optional[Tuple[int, int]]:
    """``(dim, n_shards)`` of the FIRST sharded dim of ``spec`` on
    ``mesh`` (None when fully replicated) — the shape sharded
    checkpoints record per parameter so a loader can reassemble the
    global array without a mesh."""
    axes_by_name = dict(mesh.shape)
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for ax in names:
            n *= int(axes_by_name.get(ax, 1))
        if n > 1:
            return d, n
    return None
