"""Multi-process runs of the port on the CPU, for the
``tests/test_torch_*`` files of the multi-device slice.

:func:`run_ranks` starts N spawned processes that import only torch and
``paddle_tpu_torch`` (never JAX or the JAX package), joins them into one
gloo process group on a free loopback port with a collective timeout,
runs ``fn(rank, world, *args)`` in each and returns the ranks' results.
Every run has a deadline: a rank still alive at it is killed and the
call raises, so a collective that waits forever costs the deadline, not
the test run.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List

import numpy as np


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(fn, rank, world, port, out, args, collective_s):
    import torch
    torch.set_num_threads(2)
    from paddle_tpu_torch.distributed import launch
    try:
        launch.initialize_cluster(f"127.0.0.1:{port}", world, rank,
                                  device="cpu", timeout_s=collective_s)
        res = fn(rank, world, *args)
        out.put((rank, "ok", res))
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))
    finally:
        launch.shutdown_cluster()


def run_ranks(fn: Callable, world: int, *args, deadline_s: float = 60.0,
              collective_s: float = 30.0) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    in its own process; raises on a rank's error or at the deadline."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(fn, r, world, port, out, args, collective_s))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    end = time.monotonic() + deadline_s
    try:
        while len(results) + len(errors) < world:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world}-rank run passed its {deadline_s:.0f} s "
                    f"deadline ({len(results)} rank(s) done)")
            try:
                rank, status, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and out.empty():
                    raise RuntimeError(
                        f"rank process died: exit codes "
                        f"{[p.exitcode for p in procs]}")
                continue
            if status == "ok":
                results[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(5.0, end - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


def host(x) -> np.ndarray:
    """A tensor (a DTensor gathered whole) as a numpy array."""
    from paddle_tpu_torch.parallel.sharding import full_tensor
    return full_tensor(x).detach().cpu().numpy()


# ------------------------------------------------------- training cases
def to_feed(feed):
    """A feed of numpy leaves (a ``("seq", data, lengths)`` tuple for a
    sequence) as the port's tensors."""
    import torch
    from paddle_tpu_torch.core.sequence import SequenceBatch
    out = {}
    for k, v in feed.items():
        if isinstance(v, tuple):
            out[k] = SequenceBatch(torch.from_numpy(v[1]),
                                   torch.from_numpy(v[2]))
        else:
            out[k] = torch.from_numpy(v)
    return out


def make_trainer(spec, device="cpu"):
    """A trainer from a case ``spec``: ``config`` (a ModelConfig's JSON),
    ``opt`` (OptimizationConfig fields), ``mesh`` (axes, None for a
    one-process ``{data: 1}``), ``ckpt`` (a checkpoint to start from),
    ``fsdp``, ``fsdp_rules`` (a zoo family), ``tp`` (tp_rules),
    ``seed``."""
    from paddle_tpu_torch.config.model_config import (ModelConfig,
                                                      OptimizationConfig)
    from paddle_tpu_torch.core.device import Mesh, build_mesh
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.parallel import tp_rules, zoo_fsdp_rules
    from paddle_tpu_torch.parallel.local_sgd import make_trainer as mk
    from paddle_tpu_torch.utils import FLAGS
    mesh = build_mesh(spec["mesh"]) if spec.get("mesh") \
        else Mesh({"data": 1})
    FLAGS.set("init_model_path", spec.get("ckpt") or "")
    try:
        return mk(NeuralNetwork(ModelConfig.from_json(spec["config"])),
                  OptimizationConfig(**spec.get("opt", {})), device=device,
                  mesh=mesh, seed=spec.get("seed", 1),
                  fsdp=spec.get("fsdp", False),
                  fsdp_rules=zoo_fsdp_rules(spec["fsdp_rules"])
                  if spec.get("fsdp_rules") else None,
                  sharding_rules=tp_rules() if spec.get("tp") else None)
    finally:
        FLAGS.set("init_model_path", "")


def state_of(tr) -> dict:
    """What a case compares: parameters, buffers and optimizer slots
    whole, this rank's bytes of parameters and slots, the placements."""
    from paddle_tpu_torch.observe import memory
    from paddle_tpu_torch.parallel.sharding import is_placed
    count, slots = tr.opt_state
    return {
        "params": {n: host(p) for n, p in tr.params.items()},
        "buffers": {n: host(b) for n, b in tr.buffers.items()},
        "slots": {n: [host(x) for x in s] for n, s in slots.items()},
        "count": int(count),
        "bytes": {"params": sum(memory.per_chip_bytes(p)
                                for p in tr.params.values()),
                  "opt_state": sum(memory.per_chip_bytes(x)
                                   for s in slots.values() for x in s)},
        "placed": sorted(n for n, p in tr.params.items() if is_placed(p)),
        "placed_slots": sorted(n for n, s in slots.items()
                               if any(is_placed(x) for x in s)),
    }


def train_case(spec) -> dict:
    """Build a trainer, take a step a feed (``feeds``), and return the
    losses with :func:`state_of`; ``flags`` are set for the case and put
    back; ``test_feeds`` runs ``Trainer.test`` after; ``save_dir`` saves
    the trainer (pass 0) after the steps; ``single`` runs the same steps
    in this process alone as well (a ``{data: 1}`` trainer)."""
    from paddle_tpu_torch.utils import FLAGS
    flags = spec.get("flags", {})
    old = {k: FLAGS.get(k) for k in flags}
    try:
        for k, v in flags.items():
            FLAGS.set(k, v)
        tr = make_trainer(spec)
        losses = [float(tr.train_one_batch(to_feed(f)))
                  for f in spec["feeds"]]
        out = {"losses": losses, **state_of(tr)}
        if tr._ls_state is not None:
            out["loss_scale"] = float(tr._ls_state.scale)
        if spec.get("test_feeds"):
            out["test"] = tr.test(lambda: iter([to_feed(f) for f in
                                                spec["test_feeds"]]))
        if spec.get("save_dir"):
            out["saved"] = tr.save(spec["save_dir"], 0)
        if spec.get("single"):
            one = make_trainer({**spec, "mesh": None})
            out["single"] = {"losses": [float(one.train_one_batch(
                to_feed(f))) for f in spec["feeds"]], **state_of(one)}
        return out
    finally:
        for k, v in old.items():
            FLAGS.set(k, v)


def fsdp_case(spec) -> dict:
    """:func:`train_case`, then the ``hbm_category_bytes`` gauges the
    memory sampler publishes for this rank, a second save (pass 1) after
    one more step, and ``load``: a sharded checkpoint loaded onto this
    mesh, its parameters whole and their placements."""
    from paddle_tpu_torch.observe import REGISTRY
    from paddle_tpu_torch.observe import memory
    out = train_case({**spec, "save_dir": None})
    tr = make_trainer(spec)
    for f in spec["feeds"]:
        tr.train_one_batch(to_feed(f))
    memory.sample(tr)
    g = REGISTRY.gauge("hbm_category_bytes")
    out["gauges"] = {c: g.value(category=c) for c in ("params", "opt_state")}
    if spec.get("save_dir"):
        out["saved"] = tr.save(spec["save_dir"], 0)
        tr.train_one_batch(to_feed(spec["feeds"][0]))
        out["saved_1"] = tr.save(spec["save_dir"], 1)
        out["after_1"] = state_of(tr)
    if spec.get("load"):
        other = make_trainer({**spec, "ckpt": None, "seed": 99})
        other.load(spec["load"])
        out["loaded"] = state_of(other)
        out["loaded_loss"] = float(other.train_one_batch(
            to_feed(spec["feeds"][0])))
    return out


def local_sgd_case(spec) -> dict:
    """A local-SGD (or, without ``local_sgd_steps``, synchronous) run:
    the losses, this rank's own parameters after each step, the
    consolidated parameters at the end, and a save and a test before
    the first step."""
    tr = make_trainer(spec)
    out = {"type": type(tr).__name__, "own": []}
    if spec.get("save_dir"):
        out["saved_before"] = tr.save(spec["save_dir"], 0)
        out["test_before"] = tr.test(lambda: iter([to_feed(spec["feeds"][0])]))
    losses = []
    for f in spec["feeds"]:
        losses.append(float(tr.train_one_batch(to_feed(f))))
        if spec.get("trace"):
            out["own"].append({n: p.detach().numpy().copy()
                               for n, p in tr.params.items()})
    out["losses"] = losses
    out["params"] = {n: p.detach().numpy()
                     for n, p in tr._full_params().items()}
    return out


def attention_case(spec) -> dict:
    """Ring or Ulysses attention over this rank's sequence block of the
    global ``q``/``k``/``v`` (``[B, T, H, D]``) on a ``{data: world}``
    mesh: this rank's output block and the gradients of
    ``sum(out * cot)`` (``cot`` the cotangent; ``sum(out ** 2)`` when
    absent) with respect to its q/k/v blocks."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.core.device import build_mesh
    from paddle_tpu_torch.parallel import ring_attention, ulysses_attention
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = build_mesh({"data": world})
    tl = spec["q"].shape[1] // world
    blk = slice(rank * tl, (rank + 1) * tl)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(spec[n][:, blk]))
               .requires_grad_(True) for n in ("q", "k", "v"))
    fn = ring_attention if spec["kind"] == "ring" else ulysses_attention
    out = fn(q, k, v, mesh, axis="data", causal=spec["causal"])
    if spec.get("cot") is not None:
        loss = (out * torch.from_numpy(
            np.ascontiguousarray(spec["cot"][:, blk]))).sum()
    else:
        loss = (out ** 2).sum()
    dq, dk, dv = torch.autograd.grad(loss, [q, k, v])
    return {"out": out.detach().numpy(), "dq": dq.numpy(),
            "dk": dk.numpy(), "dv": dv.numpy()}


def dropout_mask_case(spec) -> dict:
    """The dropout op on this rank's rows of a ``[b, d]`` tensor of ones
    inside a data-parallel step's scope (``out``), and the same draw on
    the whole tensor outside it (``whole``): both from one seed."""
    import torch

    from paddle_tpu_torch.core.device import build_mesh, data_parallel_scope
    from paddle_tpu_torch.ops import nn_ops
    b, d = spec["shape"]
    mesh = build_mesh()
    n, i = mesh.shape["data"], mesh.coordinate("data")
    x = torch.ones(b, d)
    with data_parallel_scope(mesh):
        out = nn_ops.dropout(x[i * b // n:(i + 1) * b // n],
                             torch.Generator().manual_seed(spec["seed"]),
                             spec["rate"])
    whole = nn_ops.dropout(x, torch.Generator().manual_seed(spec["seed"]),
                           spec["rate"])
    return {"out": out.numpy(), "whole": whole.numpy()}


def run_cases(rank, world, cases) -> dict:
    """Every case of ``cases`` (name → spec) in turn; rank 0's results
    are the whole arrays (each rank returns its own, for the rank
    checks)."""
    return {name: globals()[spec.get("fn", "train_case")](spec)
            for name, spec in cases.items()}


os.environ.setdefault("PADDLE_TPU_USE_BF16", "0")
