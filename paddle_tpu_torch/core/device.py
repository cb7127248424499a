"""Devices and the device mesh (counterpart of
``paddle_tpu/core/device.py``).

Which device: entry points resolve their ``device`` argument here:
``None`` means CUDA, and a CUDA request with no CUDA device raises — the
port never moves to the CPU on its own.  The CPU runs only when the
caller names it (the tests do).

The mesh: the JAX package drives every device of a host from one
process through one ``jax.sharding.Mesh``; the port runs **one process
per device** (PyTorch's idiom), so its :class:`Mesh` names axes over
the processes of the job (``PADDLE_NUM_NODES`` of them, joined by
``distributed.launch.initialize_cluster``).  A mesh holds the axis sizes
in order and, when the job has more than one process, a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names,
whose per-axis process groups carry the collectives.  With no process
group the mesh is ``{data: 1}`` and nothing is communicated: single-card
training is the same program as before the mesh existed.

Axis conventions (used across ``paddle_tpu_torch.parallel``):
  ``data``  — batch (data parallel / DP, and FSDP's parameter shards)
  ``model`` — weight sharding (tensor parallel)

:func:`data_parallel_scope` marks the forward of a data-parallel step:
inside it :func:`data_shard` says which rows of the global batch this
process holds, so the ops whose result depends on the whole batch
(batch-norm statistics, dropout masks) compute the global batch's.

Numerics: fp32 matrix products and convolutions run in full fp32.
PyTorch already keeps ``torch.backends.cuda.matmul.allow_tf32`` False,
but cuDNN convolutions default to TF32; both are set to False here so a
comparison against the JAX reference compares fp32 with fp32.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Union

import torch

from ..utils import FLAGS, PaddleTpuError, get_logger

log = get_logger("device")

DATA_AXIS = "data"
MODEL_AXIS = "model"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; raise :class:`PaddleTpuError` when CUDA is
    asked for (explicitly or by default) and no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise PaddleTpuError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise PaddleTpuError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


# ------------------------------------------------------------ the mesh
class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry a tensor dim,
    a mesh axis name (or a tuple of names) or None (not sharded)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """Named axes over the job's processes, one device each.

    ``shape`` (axis → size, in order), ``axis_names`` and ``size`` read as
    the JAX mesh's; ``device_mesh`` is the ``DeviceMesh`` (None in a
    one-process job).  :meth:`group` is an axis's process group and
    :meth:`coordinate` this process's index along the axis."""

    def __init__(self, axes: Dict[str, int], device_mesh=None):
        self.shape: Dict[str, int] = {k: int(v) for k, v in axes.items()}
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values()) if self.shape else 1
        self.device_mesh = device_mesh

    def group(self, axis: str):
        """The process group of ``axis`` (None when the axis has one
        member or the mesh no processes)."""
        if self.device_mesh is None or self.shape.get(axis, 1) <= 1:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This process's index along ``axis`` (0 without processes)."""
        if self.device_mesh is None or axis not in self.shape:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec


_mesh: Optional[Mesh] = None


def parse_mesh_shape(spec: str) -> Dict[str, int]:
    """Parse ``'data=4,model=2'`` into an ordered axis→size dict."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise PaddleTpuError(f"bad mesh_shape component {part!r}")
        k, v = part.split("=", 1)
        out[k.strip()] = int(v)
    return out


def _world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def build_mesh(axes: Optional[Dict[str, int]] = None,
               device_type: Optional[str] = None) -> Mesh:
    """A mesh over the job's processes: ``axes`` (default every process
    on ``data``) must multiply to the process count.  ``device_type``
    (default the one ``initialize_cluster`` recorded) names the
    ``DeviceMesh``'s device."""
    world = _world()
    if not axes:
        axes = {DATA_AXIS: world}
    n = math.prod(int(v) for v in axes.values())
    if n != world:
        raise PaddleTpuError(
            f"mesh {axes} needs {n} devices, have {world} (one process "
            "a device: start as many processes as the mesh has devices)")
    if world == 1:
        return Mesh(axes)
    from torch.distributed.device_mesh import DeviceMesh

    from ..distributed import launch
    dtype = device_type or launch.device_type()
    dm = DeviceMesh(dtype, torch.arange(world).reshape(
        tuple(int(v) for v in axes.values())),
        mesh_dim_names=tuple(axes))
    return Mesh(axes, dm)


def get_mesh(refresh: bool = False) -> Mesh:
    """The process-global mesh: ``--mesh_shape`` if set, else every
    process on ``data`` (``{data: 1}`` with no process group)."""
    global _mesh
    if _mesh is None or refresh:
        axes = parse_mesh_shape(FLAGS.get("mesh_shape")) \
            if FLAGS.get("mesh_shape") else None
        _mesh = build_mesh(axes)
        log.info("mesh: %s over %d process(es)", _mesh.shape, _mesh.size)
    return _mesh


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _mesh
    _mesh = mesh


def data_sharding(mesh: Optional[Mesh] = None,
                  rank: int = 2) -> NamedSharding:
    """Batch-dim sharded over ``data``, rest replicated."""
    mesh = mesh or get_mesh()
    return NamedSharding(mesh, P(DATA_AXIS, *(None,) * (rank - 1)))


def replicated(mesh: Optional[Mesh] = None) -> NamedSharding:
    mesh = mesh or get_mesh()
    return NamedSharding(mesh, P())


def num_data_shards(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or get_mesh()
    return mesh.shape.get(DATA_AXIS, 1)


# ------------------------------------------- the data-parallel forward
@dataclasses.dataclass(frozen=True)
class DataShard:
    """This process's rows of the global batch: shard ``index`` of
    ``size`` equal shards, reduced over ``group``."""

    index: int
    size: int
    group: Any


_DATA_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "ptpu_data_shard", default=None)


@contextlib.contextmanager
def data_parallel_scope(mesh: Mesh) -> Iterator[Optional[DataShard]]:
    """Mark the forward (and its backward, run inside) of a step whose
    batch is split over ``mesh``'s data axis; a no-op on one shard."""
    n = mesh.shape.get(DATA_AXIS, 1)
    shard = DataShard(mesh.coordinate(DATA_AXIS), n,
                      mesh.group(DATA_AXIS)) if n > 1 else None
    token = _DATA_SHARD.set(shard)
    try:
        yield shard
    finally:
        _DATA_SHARD.reset(token)


def data_shard() -> Optional[DataShard]:
    """The current step's :class:`DataShard`, or None outside a
    data-parallel step."""
    return _DATA_SHARD.get()
