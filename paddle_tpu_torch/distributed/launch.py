"""Multi-process launch — the ``cluster_train`` equivalent (counterpart
of ``paddle_tpu/distributed/launch.py``).

Reference: ``paddle/scripts/cluster_train/paddle.py`` and
``cluster_train_v2/openmpi`` — infrastructure whose only job is to start
N trainer processes that find each other.  The port runs one process
per device, each the same program:

    PADDLE_COORDINATOR=host0:1234 PADDLE_NUM_NODES=4 PADDLE_NODE_ID=$i \\
        python -m paddle_tpu_torch train --config ... --mesh_shape data=4

or ``initialize_cluster(...)`` before the first trainer.  The three
variables keep the JAX package's names; ``PADDLE_NUM_NODES`` counts
processes in both packages (one a device here).  They become
``torch.distributed.init_process_group(init_method="tcp://<coordinator>",
world_size, rank)``: NCCL for a CUDA device, gloo when the caller names
the CPU, or the ``backend`` the caller names (two processes sharing one
card run gloo: NCCL puts one communicator's ranks on distinct devices).
Nothing tells a process of a cluster on its own: without the
coordinator's address :func:`initialize_cluster` joins nothing.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Union

import torch

from ..utils import PaddleTpuError, get_logger

log = get_logger("launch")

ENV_COORDINATOR = "PADDLE_COORDINATOR"
ENV_NUM_NODES = "PADDLE_NUM_NODES"
ENV_NODE_ID = "PADDLE_NODE_ID"

#: the device type of this process's mesh (``initialize_cluster`` sets it)
_device_type: Optional[str] = None


def cluster_env() -> Optional[Dict[str, str]]:
    """The launch-relevant environment, or None when single-process."""
    if ENV_COORDINATOR not in os.environ:
        return None
    return {
        "coordinator_address": os.environ[ENV_COORDINATOR],
        "num_processes": os.environ.get(ENV_NUM_NODES),
        "process_id": os.environ.get(ENV_NODE_ID),
    }


def device_type() -> str:
    """The device type the job's ``DeviceMesh`` is built on: the one
    :func:`initialize_cluster` was given, else ``cuda`` when a CUDA
    device exists."""
    if _device_type is not None:
        return _device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       device: Optional[Union[str, torch.device]] = None,
                       backend: Optional[str] = None,
                       timeout_s: float = 600.0) -> bool:
    """Join the job's process group.  Returns True when a multi-process
    group was initialized (a one-process job joins none and returns
    False).  Arguments default to the ``PADDLE_*`` variables; ``device``
    (default CUDA, raising without it) picks the backend — NCCL for CUDA,
    gloo for the CPU — unless ``backend`` names one.  On CUDA the
    process's current device becomes ``device`` (``cuda:<index>``, or
    ``cuda:<id mod card count>`` when no index is given).  Collectives
    that wait longer than ``timeout_s`` raise."""
    global _device_type
    import torch.distributed as dist

    from ..core.device import resolve_device

    env = cluster_env() or {}
    coordinator_address = coordinator_address or \
        env.get("coordinator_address")
    if num_processes is None and env.get("num_processes"):
        num_processes = int(env["num_processes"])
    if process_id is None and env.get("process_id"):
        process_id = int(env["process_id"])
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise PaddleTpuError(
            f"{ENV_COORDINATOR} requires {ENV_NUM_NODES} and "
            f"{ENV_NODE_ID} (or num_processes and process_id)")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.is_available():
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dist.is_initialized():
        raise PaddleTpuError("a process group is already initialized")
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    _device_type = dev.type
    log.info("cluster: process %d/%d via %s (%s on %s)",
             dist.get_rank(), dist.get_world_size(), coordinator_address,
             backend, dev)
    return dist.get_world_size() > 1


def shutdown_cluster() -> None:
    """Leave the process group (a no-op without one) and forget the
    global mesh."""
    global _device_type
    import torch.distributed as dist

    from ..core import device

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _device_type = None
    device.set_mesh(None)


def global_mesh(axes: Dict[str, int]):
    """A mesh over ALL processes (the multi-process ``--mesh_shape``);
    axis sizes must multiply to the process count."""
    import math

    from ..core.device import Mesh, _world, build_mesh

    world = _world()
    if math.prod(axes.values()) != world:
        raise ValueError(f"mesh {axes} needs {math.prod(axes.values())} "
                         f"devices, cluster has {world}")
    return build_mesh(dict(axes)) if world > 1 else Mesh(dict(axes))
