"""Device memory accounting: gauges + category attribution (counterpart of
``paddle_tpu/observe/memory.py``).

The gauges keep the JAX package's names — ``hbm_in_use_bytes``,
``hbm_peak_bytes``, ``hbm_category_bytes{category=...}``,
``hbm_shard_bytes{category,shard}`` — and on the H100 they read its HBM3
through PyTorch's caching allocator:

- ``hbm_in_use_bytes`` is ``torch.cuda.memory_allocated(device)``: the
  bytes of live tensors, not the allocator's reserved pool (the figure
  the reference's ``bytes_in_use`` gives);
- ``hbm_peak_bytes`` is ``torch.cuda.max_memory_allocated(device)``,
  since the process started or the last :func:`reset_peak`;
- ``hbm_category_bytes`` attributes tensors to the trainer's known state
  — params, opt_state, buffers (batch-norm statistics), loss_scale,
  data (the feed) — by summing each tensor's ``nbytes`` once (by
  identity), and ``other`` is what is left of the in-use figure
  (activations held by queued work, the autograd graph, workspaces).

A tensor's bytes on this process's device are its ``nbytes``, a
sharded parameter's (a DTensor) its local shard's
(:func:`per_chip_bytes`), and :func:`shard_categories` reports this
process's device (one process drives one device).  On the CPU (``device="cpu"`` trainers) there is no allocator to
ask: the in-use figure is the sum of the categories, the peak a running
maximum of the samples, and ``source`` says ``"tensors"``.

Sampling discipline: nothing here runs per step.  The trainer samples at
pass boundaries — and only when someone is listening (a metrics sink is
attached or the ``/metrics`` endpoint is live).  Torch is imported
inside the calls, so importing :mod:`paddle_tpu_torch.observe` stays
torch-free.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

from .metrics import gauge

#: Running peak for the CPU, which reports no allocator statistics: the
#: max of the in-use figure across samples taken this process.
_live_peak = 0


def _cuda_device(device=None):
    """The CUDA device to read: ``device`` when it is one, the current
    device when ``device`` is None and CUDA is initialized, else None."""
    import torch

    if device is None:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.type == "cuda" else None


def device_stats(device=None) -> Optional[Dict[str, Any]]:
    """``torch.cuda.memory_stats`` of ``device`` (the current CUDA device
    by default); None when the device is not a CUDA device or CUDA is
    not initialized."""
    try:
        dev = _cuda_device(device)
        if dev is None:
            return None
        import torch

        return dict(torch.cuda.memory_stats(dev))
    except Exception:  # noqa: BLE001 — telemetry never kills the host
        return None


def tree_leaves(tree) -> Iterator[Any]:
    """The tensors (or arrays) of a nested dict / list / tuple /
    NamedTuple / dataclass (``SequenceBatch``), in order."""
    if tree is None:
        return
    if hasattr(tree, "nbytes") and hasattr(tree, "dtype"):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from tree_leaves(getattr(tree, name))


def tree_bytes(tree) -> int:
    """Total bytes of a tree's tensor leaves (0 for None)."""
    return sum(int(getattr(leaf, "nbytes", 0) or 0)
               for leaf in tree_leaves(tree))


def per_chip_bytes(leaf) -> int:
    """Bytes of ``leaf`` resident on this process's device: a tensor's
    ``nbytes``, or for a sharded parameter or slot (a DTensor) its local
    shard's — one process drives one device, as the reference reads a
    sharded array's per-device shard here."""
    if hasattr(leaf, "to_local") and hasattr(leaf, "placements"):
        leaf = leaf.to_local()
    return int(getattr(leaf, "nbytes", 0) or 0)


def _category_trees(trainer, feed=None) -> Dict[str, Any]:
    cats: Dict[str, Any] = {}
    if trainer is not None:
        cats["params"] = getattr(trainer, "params", None)
        cats["opt_state"] = getattr(trainer, "opt_state", None)
        cats["buffers"] = getattr(trainer, "buffers", None)
        ls = getattr(trainer, "_ls_state", None)
        if ls is not None:
            cats["loss_scale"] = ls
    if feed is not None:
        cats["data"] = feed
    return cats


def account(trainer=None, feed=None, device=None) -> Dict[str, Any]:
    """One memory accounting snapshot.

    Returns ``{"in_use_bytes", "peak_bytes", "source", "categories":
    {name: bytes}, "attributed_frac"}``.  A tensor that belongs to two
    categories (or twice to one) counts once, under the first.  The
    device is ``device``, else the trainer's, else the current CUDA
    device."""
    global _live_peak
    if device is None and trainer is not None:
        device = getattr(trainer, "device", None)
    cat_ids: Dict[int, str] = {}
    cat_bytes: Dict[str, int] = {}
    for name, tree in _category_trees(trainer, feed).items():
        n = 0
        for leaf in tree_leaves(tree):
            nb = per_chip_bytes(leaf)
            if nb and id(leaf) not in cat_ids:
                cat_ids[id(leaf)] = name
                n += nb
        cat_bytes[name] = n
    attributed = sum(cat_bytes.values())
    dev = None
    try:
        dev = _cuda_device(device)
    except Exception:  # noqa: BLE001 — telemetry never kills the host
        dev = None
    if dev is not None:
        import torch

        in_use = int(torch.cuda.memory_allocated(dev))
        peak = int(torch.cuda.max_memory_allocated(dev))
        source = "device"
    else:
        in_use = attributed
        _live_peak = max(_live_peak, in_use)
        peak = _live_peak
        source = "tensors"
    cat_bytes["other"] = max(in_use - attributed, 0)
    return {
        "in_use_bytes": in_use,
        "peak_bytes": peak,
        "source": source,
        "categories": cat_bytes,
        "attributed_frac": round(attributed / in_use, 4) if in_use
        else 0.0,
    }


def shard_categories(trainer=None, feed=None) -> Dict[str, Dict[str, int]]:
    """Per-device category attribution: category → {device index (str)
    → bytes}.  On one card every category has one entry, the trainer's
    device (``"0"`` for ``cuda:0``, ``"cpu"`` on the CPU)."""
    out: Dict[str, Dict[str, int]] = {}
    for name, tree in _category_trees(trainer, feed).items():
        per_dev: Dict[str, int] = {}
        seen = set()
        for leaf in tree_leaves(tree):
            nb = per_chip_bytes(leaf)
            if not nb or id(leaf) in seen:
                continue
            seen.add(id(leaf))
            dev = getattr(leaf, "device", None)
            key = str(dev.index if getattr(dev, "index", None) is not None
                      else getattr(dev, "type", "cpu"))
            per_dev[key] = per_dev.get(key, 0) + nb
        if per_dev:
            out[name] = per_dev
    return out


def sample(trainer=None, feed=None, device=None) -> Dict[str, Any]:
    """Take one accounting snapshot AND publish it as gauges — the
    ``/metrics`` surface (``hbm_in_use_bytes``, ``hbm_peak_bytes``,
    ``hbm_category_bytes{category=...}``, and the per-device
    ``hbm_shard_bytes{category,shard}`` family).  Returns the
    snapshot (with the per-device breakdown under ``"shards"``)."""
    snap = account(trainer, feed, device)
    shards = shard_categories(trainer, feed)
    snap["shards"] = shards
    if shards:
        sg = gauge("hbm_shard_bytes",
                   "bytes of each accounting category resident on each "
                   "device (sharded leaves count one shard per device, "
                   "replicated leaves their full size on every device) "
                   "— a per-(category,shard) label-explosion family; "
                   "consoles render it as a top-k summary")
        for cname, per_dev in shards.items():
            for dev_id, nbytes in per_dev.items():
                sg.set(nbytes, category=cname, shard=dev_id)
    gauge("hbm_in_use_bytes",
          "device memory currently in use (allocator stats when the "
          "backend reports them, else total live committed arrays)"
          ).set(snap["in_use_bytes"])
    gauge("hbm_peak_bytes",
          "peak device memory (allocator peak_bytes_in_use; running "
          "max of samples on stat-less backends)").set(snap["peak_bytes"])
    cat = gauge("hbm_category_bytes",
                "PER-CHIP bytes attributed to the trainer's known "
                "pytrees by buffer identity (sharded leaves count "
                "their one-device shard — the FSDP win reads "
                "directly); 'other' = unclaimed (activations in "
                "flight, allocator slack)")
    for name, nbytes in snap["categories"].items():
        cat.set(nbytes, category=name)
    return snap


def reset_peak(device=None) -> None:
    """Reset the peak: ``torch.cuda.reset_peak_memory_stats`` on the
    CUDA device (when CUDA is initialized) and the CPU's running
    maximum."""
    global _live_peak
    _live_peak = 0
    try:
        dev = _cuda_device(device)
    except Exception:  # noqa: BLE001 — telemetry never kills the host
        dev = None
    if dev is not None:
        import torch

        torch.cuda.reset_peak_memory_stats(dev)
