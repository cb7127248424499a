"""Checkpoint save / load (counterpart of
``paddle_tpu/trainer/checkpoint.py``, format 2), numpy and the standard
library only.

Reference surfaces: per-pass parameter dirs ``pass-%05d``
(``paddle/trainer/ParamUtil.cpp:71-92``) with optimizer state and
batch-norm buffers checkpointed too (as the Go pserver does,
``go/pserver/service.go:146``).  A dir holds ``params.npz``,
``buffers.npz`` (when there are buffers), ``opt_state.npz`` and a JSON
manifest (``"format": 2``, ``pass_id``, the trainer's ``meta``, the
optimizer-state structure ``opt_treedef``, and with ``--ckpt_verify``
each file's SHA-256 digest and byte size), written into a temp dir and
moved into place with ``os.replace``, so a killed job never leaves a
torn checkpoint.

The files are the JAX package's, byte for byte: arrays in the same key
order, C-contiguous, with the same dtypes (``np.savez`` of equal arrays
in equal order gives equal bytes, so equal files carry equal digests).
The optimizer state ``(count, slots by name)`` is written as the JAX
package's ``leaf_i`` list in its flatten order -- ``leaf_0`` the count,
then each parameter's slot elements in sorted-name order -- with the
``PyTreeDef`` text JAX prints for that structure.  So a checkpoint one
package writes loads in the other.

:func:`verify_checkpoint` re-checks the digests,
:func:`latest_valid_checkpoint` scans backward past corrupt or torn dirs
(renaming them ``.corrupt-*``), :func:`sweep_retention` keeps the newest
``--ckpt_keep`` dirs after each save (never one an export lease pins),
and ``--ckpt_verify=false`` restores the blind load.  A sharded
checkpoint (the ``--fsdp`` layout, the manifest's ``shards``) is written
by the ranks of a mesh together, each its own shard files, and read by
reassembling them, on any mesh shape and in either package.

Telemetry (``observe/``, the JAX package's names): the spans
``ckpt_save``, ``ckpt_verify``, ``ckpt_quarantine`` and
``ckpt_retention``; the counters ``ckpt_saves``, ``ckpt_quarantined``,
``ckpt_retention_pinned`` and ``ckpt_retention_removed``; the
histograms ``ckpt_save_seconds`` and ``ckpt_verify_seconds``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..observe import counter, histogram, trace
from ..utils import FLAGS, PaddleTpuError, get_logger

log = get_logger("checkpoint")


def _host(x) -> np.ndarray:
    """A tensor or array as a C-contiguous numpy array on the host, 0-d
    kept 0-d (a transposed view would otherwise be written in Fortran
    order)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.require(x, requirements="C")


# ------------------------------------------- optimizer-state layout
def _slot_def(slot: tuple) -> str:
    """JAX's text for one tuple of leaves: ``()``, ``(*,)``, ``(*, *)``."""
    if len(slot) == 1:
        return "(*,)"
    return "(" + ", ".join("*" for _ in slot) + ")"


def flatten_opt_state(opt_state: Tuple[Any, Dict[str, tuple]]
                      ) -> Tuple[List[Any], str]:
    """``(count, slots by name)`` → (leaves in the JAX package's flatten
    order, its ``PyTreeDef`` text): the count, then each parameter's
    slot elements, parameters in sorted-name order."""
    count, slots = opt_state
    names = sorted(slots)
    leaves = [count] + [leaf for n in names for leaf in slots[n]]
    treedef = "PyTreeDef((*, [" + ", ".join(
        _slot_def(tuple(slots[n])) for n in names) + "]))"
    return leaves, treedef


def unflatten_opt_state(leaves: List[np.ndarray],
                        template: Tuple[Any, Dict[str, tuple]]
                        ) -> Tuple[np.ndarray, Dict[str, tuple]]:
    """The inverse of :func:`flatten_opt_state` into ``template``'s
    structure (its slot counts by name), as numpy arrays."""
    _, slots = template
    names = sorted(slots)
    want = 1 + sum(len(slots[n]) for n in names)
    if len(leaves) != want:
        raise PaddleTpuError(
            f"optimizer state has {len(leaves)} leaves, the trainer's "
            f"optimizer {want} (a checkpoint of another optimizer?)")
    out, i = {}, 1
    for n in names:
        k = len(slots[n])
        out[n] = tuple(leaves[i:i + k])
        i += k
    return leaves[0], out


# ----------------------------------------------------- sharded layout
def _shard_file(kind: str, i: int, n: int) -> str:
    return f"{kind}.shard-{i:05d}-of-{n:05d}.npz"


def _read_sharded(ckpt_dir: str, kind: str,
                  layout: Dict[str, Dict[str, int]]) -> Dict[str, np.ndarray]:
    """Reassemble the whole arrays of one sharded collection by
    concatenating its shard files along each leaf's recorded dim."""
    files: Dict[str, Any] = {}
    out: Dict[str, np.ndarray] = {}
    try:
        for key, info in layout.items():
            d, n = int(info["dim"]), int(info["shards"])
            parts = []
            for i in range(n):
                fname = _shard_file(kind, i, n)
                if fname not in files:
                    path = os.path.join(ckpt_dir, fname)
                    if not os.path.exists(path):
                        raise PaddleTpuError(
                            f"sharded checkpoint {ckpt_dir!r} is "
                            f"missing {fname} (manifest lists "
                            f"{key!r} as {n}-way sharded)")
                    files[fname] = np.load(path)
                parts.append(files[fname][key])
            out[key] = np.concatenate(parts, axis=d) if n > 1 \
                else parts[0]
    finally:
        for z in files.values():
            z.close()
    return out


def _manifest_shards(ckpt_dir: str, kind: str) -> Dict[str, Dict[str, int]]:
    """The manifest's shard layout of one collection (``{}`` when the
    checkpoint is not sharded)."""
    try:
        man = load_manifest(ckpt_dir)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}
    return (man.get("shards") or {}).get(kind, {})


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _shard_layout(x, mesh) -> Optional[Tuple[int, int, int, bool]]:
    """``(dim, shards, index, writer)`` when ``x`` is a DTensor sharded
    over the ``data`` axis of ``mesh`` (the FSDP placement): its dim, the
    axis size, this rank's shard index, and whether this rank writes that
    index (the one whose other mesh coordinates are all 0).  None
    otherwise."""
    from ..core.device import DATA_AXIS
    from ..parallel.sharding import shard_dims

    if DATA_AXIS not in mesh.axis_names:
        return None
    mdim = mesh.axis_names.index(DATA_AXIS)
    for m, d in shard_dims(x):
        if m == mdim:
            writer = all(mesh.coordinate(a) == 0 for a in mesh.axis_names
                         if a != DATA_AXIS)
            return d, mesh.shape[DATA_AXIS], mesh.coordinate(DATA_AXIS), \
                writer
    return None


def _split_sharded(arrays: Dict[str, Any], mesh, shard: bool
                   ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, int]],
                              Dict[int, Dict[str, np.ndarray]]]:
    """Split ``arrays`` (name → tensor, DTensors among them) into the
    base archive's whole host arrays (every other placed tensor gathered
    — a collective every rank runs in the same order), the manifest's
    layout of the data-sharded ones (under ``shard``), and the shard
    files this rank writes: shard count → {name: this rank's shard}."""
    from ..parallel.sharding import full_tensor

    base: Dict[str, Any] = {}
    layout: Dict[str, Dict[str, int]] = {}
    own: Dict[int, Dict[str, np.ndarray]] = {}
    for key, x in arrays.items():
        info = _shard_layout(x, mesh) if shard else None
        if info is None:
            base[key] = _host(full_tensor(x))
            continue
        d, n, _i, writer = info
        layout[key] = {"dim": int(d), "shards": int(n)}
        if writer:
            own.setdefault(n, {})[key] = _host(x.to_local())
    return base, layout, own


def save_checkpoint(save_dir: str, pass_id: int, params: Dict[str, Any],
                    opt_state: Any = None, buffers: Optional[Dict] = None,
                    meta: Optional[Dict] = None,
                    keep: Optional[int] = None,
                    shard: bool = False, mesh=None) -> str:
    """Write ``<save_dir>/pass-%05d`` atomically; returns its path.

    ``params`` / ``buffers``: name → tensor or array, written in their
    dict order; ``opt_state``: ``(count, slots by name)``.  The manifest
    carries per-file SHA-256 digests (``files``) under
    ``--ckpt_verify``; a save then sweeps retention (the newest ``keep``
    dirs, default ``--ckpt_keep``).  A failed save raises and leaves no
    dir.

    On a ``mesh`` of more than one process every rank calls this with
    its state (DTensors for placed tensors).  ``shard=True`` (the trainer
    passes it under ``--fsdp``) writes the JAX package's **sharded
    checkpoint**: each leaf sharded over ``data`` lands in per-index
    files (``params.shard-i-of-n.npz`` / ``opt_state.shard-i-of-n.npz``,
    each rank writing its own index) while the rest, gathered whole,
    stays in the base archives; after a barrier rank 0 writes the base
    archives and the manifest (the layout under ``"shards"``, the
    digests over the shard files too) and moves the dir into place.  A
    loader reassembles whole arrays from the layout, so a load onto any
    mesh shape, in either package, re-places cleanly."""
    multi = mesh is not None and mesh.size > 1
    if multi:
        import torch.distributed as dist
        rank = dist.get_rank()
    else:
        dist, rank = None, 0
    final = os.path.join(save_dir, f"pass-{pass_id:05d}")
    t0 = time.perf_counter()
    with trace.span("ckpt_save", pass_id=pass_id):
        tmp = None
        if rank == 0:
            os.makedirs(save_dir, exist_ok=True)
            tmp = tempfile.mkdtemp(dir=save_dir, prefix=".tmp-ckpt-")
        try:
            if multi:
                box = [tmp]
                dist.broadcast_object_list(box, src=0)
                tmp = box[0]
            manifest = {"pass_id": pass_id, "format": 2, **(meta or {})}
            shards: Dict[str, Dict] = {}
            owned: List[Tuple[str, Dict[int, Dict[str, np.ndarray]]]] = []
            if multi:
                p_base, layout, own = _split_sharded(params, mesh, shard)
            else:
                p_base, layout, own = \
                    {k: _host(v) for k, v in params.items()}, {}, {}
            if layout:
                shards["params"] = layout
            owned.append(("params", own))
            o_base = None
            if opt_state is not None:
                leaves, treedef = flatten_opt_state(opt_state)
                o_arrays = {f"leaf_{i}": leaf
                            for i, leaf in enumerate(leaves)}
                if multi:
                    o_base, layout, own = _split_sharded(o_arrays, mesh,
                                                         shard)
                else:
                    o_base, layout, own = \
                        {k: _host(v) for k, v in o_arrays.items()}, {}, {}
                if layout:
                    shards["opt_state"] = layout
                owned.append(("opt_state", own))
                manifest["opt_treedef"] = treedef
            for kind, own in owned:
                for n, chunk in own.items():
                    np.savez(os.path.join(tmp, _shard_file(
                        kind, mesh.coordinate("data"), n)), **chunk)
            if multi:
                dist.barrier()
            if rank == 0:
                np.savez(os.path.join(tmp, "params.npz"), **p_base)
                if buffers:
                    np.savez(os.path.join(tmp, "buffers.npz"),
                             **{k: _host(v) for k, v in buffers.items()})
                if o_base is not None:
                    np.savez(os.path.join(tmp, "opt_state.npz"), **o_base)
                if shards:
                    manifest["shards"] = shards
                # the manifest is written last: its presence certifies
                # the .npz files were flushed; --ckpt_verify=false skips
                # the hashing
                if FLAGS.get("ckpt_verify"):
                    manifest["files"] = {
                        fname: {"sha256": _sha256_file(
                                    os.path.join(tmp, fname)),
                                "bytes": os.path.getsize(
                                    os.path.join(tmp, fname))}
                        for fname in sorted(os.listdir(tmp))}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f, indent=1)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
        except Exception:
            if tmp is not None and rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        if multi:
            dist.barrier()
    histogram("ckpt_save_seconds",
              "wall time of one atomic checkpoint save (serialize + "
              "digest + rename)").observe(time.perf_counter() - t0)
    counter("ckpt_saves", "checkpoints saved").inc()
    if rank == 0:
        log.info("saved checkpoint %s", final)
        sweep_retention(save_dir, keep)
    return final


def load_params(ckpt_dir: str) -> Dict[str, np.ndarray]:
    path = os.path.join(ckpt_dir, "params.npz")
    if not os.path.exists(path):
        raise PaddleTpuError(f"no params.npz under {ckpt_dir!r}")
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    layout = _manifest_shards(ckpt_dir, "params")
    if layout:
        out.update(_read_sharded(ckpt_dir, "params", layout))
    return out


def load_buffers(ckpt_dir: str) -> Dict[str, np.ndarray]:
    path = os.path.join(ckpt_dir, "buffers.npz")
    if not os.path.exists(path):
        return {}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_opt_state(ckpt_dir: str, template: Any) -> Any:
    """The optimizer state in ``template``'s structure ``(count, slots
    by name)``, as numpy arrays (any leaves a sharded save split
    reassembled); None when the dir has none."""
    path = os.path.join(ckpt_dir, "opt_state.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        by_key = {k: z[k] for k in z.files}
    layout = _manifest_shards(ckpt_dir, "opt_state")
    if layout:
        by_key.update(_read_sharded(ckpt_dir, "opt_state", layout))
    leaves = [by_key[f"leaf_{i}"] for i in range(len(by_key))]
    return unflatten_opt_state(leaves, template)


def load_manifest(ckpt_dir: str) -> Dict:
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        return json.load(f)


def _verify_result(ckpt_dir: str) -> str:
    """``"ok"`` | ``"corrupt"`` (a definitive mismatch or torn state) |
    ``"unreadable"`` (a transient read fault, EIO/ESTALE on a shared
    filesystem, that proved nothing about the data)."""
    if not os.path.isdir(ckpt_dir):
        return "corrupt"
    try:
        manifest = load_manifest(ckpt_dir)
    except (FileNotFoundError, json.JSONDecodeError):
        manifest = None
    except OSError:
        return "unreadable"
    files = (manifest or {}).get("files")
    if files:
        for fname, info in files.items():
            path = os.path.join(ckpt_dir, fname)
            if not os.path.exists(path):
                log.warning("checkpoint %s: %s missing", ckpt_dir, fname)
                return "corrupt"
            try:
                if os.path.getsize(path) != info.get("bytes"):
                    log.warning("checkpoint %s: %s size mismatch",
                                ckpt_dir, fname)
                    return "corrupt"
                if _sha256_file(path) != info.get("sha256"):
                    log.warning("checkpoint %s: %s digest mismatch",
                                ckpt_dir, fname)
                    return "corrupt"
            except OSError as e:
                log.warning("checkpoint %s: %s unreadable (%s)",
                            ckpt_dir, fname, e)
                return "unreadable"
        return "ok"
    # no digests recorded (an older or foreign dir): the archives must
    # exist and open
    if not os.path.exists(os.path.join(ckpt_dir, "params.npz")):
        return "corrupt"
    for fname in ("params.npz", "buffers.npz", "opt_state.npz"):
        p = os.path.join(ckpt_dir, fname)
        if not os.path.exists(p):
            continue
        try:
            with np.load(p):
                pass
        except OSError:
            return "unreadable"
        except Exception:
            log.warning("checkpoint %s: %s does not open", ckpt_dir, fname)
            return "corrupt"
    return "ok"


def verify_checkpoint(ckpt_dir: str) -> bool:
    """True iff ``ckpt_dir`` passes its integrity checks: every file the
    manifest lists at its recorded size and SHA-256, or, with no digests
    recorded, the archives open as zips."""
    with trace.span("ckpt_verify", dir=ckpt_dir), \
            histogram("ckpt_verify_seconds",
                      "wall time of one checkpoint integrity "
                      "verification (digest re-hash or structural "
                      "check)").time():
        return _verify_result(ckpt_dir) == "ok"


def _pass_dirs(save_dir: str) -> List[str]:
    return sorted(d for d in os.listdir(save_dir) if d.startswith("pass-"))


def latest_checkpoint(save_dir: str) -> Optional[str]:
    if not os.path.isdir(save_dir):
        return None
    passes = _pass_dirs(save_dir)
    return os.path.join(save_dir, passes[-1]) if passes else None


def quarantine_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Rename a corrupt checkpoint dir to ``.corrupt-<name>[-N]`` so
    backward scans never re-read it; returns the new path."""
    parent, name = os.path.split(os.path.normpath(ckpt_dir))
    target = os.path.join(parent, f".corrupt-{name}")
    n = 0
    while os.path.exists(target):
        n += 1
        target = os.path.join(parent, f".corrupt-{name}-{n}")
    try:
        with trace.span("ckpt_quarantine", dir=ckpt_dir):
            os.rename(ckpt_dir, target)
    except OSError as e:
        log.warning("could not quarantine %s (%s)", ckpt_dir, e)
        return None
    counter("ckpt_quarantined",
            "corrupt checkpoint dirs renamed to .corrupt-*").inc()
    log.warning("quarantined corrupt checkpoint %s -> %s", ckpt_dir, target)
    return target


def latest_valid_checkpoint(save_dir: str,
                            quarantine: bool = True) -> Optional[str]:
    """Newest ``pass-*`` dir that passes :func:`verify_checkpoint`,
    scanning backward past corrupt or torn dirs (renamed ``.corrupt-*``
    when ``quarantine``; a transient read fault renames nothing)."""
    if not os.path.isdir(save_dir):
        return None
    for name in reversed(_pass_dirs(save_dir)):
        path = os.path.join(save_dir, name)
        verdict = _verify_result(path)
        if verdict == "ok":
            return path
        log.warning("checkpoint %s failed verification (%s); falling "
                    "back", path, verdict)
        if quarantine and verdict == "corrupt":
            quarantine_checkpoint(path)
    return None


def checkpoint_digest(ckpt_dir: str) -> Optional[str]:
    """A checkpoint's content identity: SHA-256 over its manifest's
    sorted per-file digests (equal bytes under another pass id give the
    same digest).  None when the manifest is unreadable or records no
    digests (``--ckpt_verify=false`` saves)."""
    try:
        files = load_manifest(ckpt_dir).get("files")
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None
    if not files:
        return None
    h = hashlib.sha256()
    for fname in sorted(files):
        h.update(fname.encode())
        h.update(str(files[fname].get("sha256")).encode())
    return h.hexdigest()


# ------------------------------------------------- export pin / lease
def _export_markers(ckpt_dir: str) -> List[str]:
    try:
        return [os.path.join(ckpt_dir, n) for n in os.listdir(ckpt_dir)
                if n.startswith(".exporting-")]
    except OSError:
        return []


def export_pinned(ckpt_dir: str) -> bool:
    """True when a live export lease pins ``ckpt_dir`` against the
    retention sweep: some ``.exporting-<pid>`` marker in it is fresher
    than ``--ckpt_export_lease_s`` (a killed exporter's marker expires)."""
    lease_s = FLAGS.get("ckpt_export_lease_s")
    now = time.time()
    for path in _export_markers(ckpt_dir):
        try:
            if now - os.path.getmtime(path) < lease_s:
                return True
        except OSError:
            continue        # the marker went between listdir and stat
    return False


@contextlib.contextmanager
def export_lease(ckpt_dir: str) -> Iterator[str]:
    """Pin ``ckpt_dir`` for the duration of an export: a
    ``.exporting-<pid>`` marker inside it, removed on exit, which
    :func:`sweep_retention` honours."""
    marker = os.path.join(ckpt_dir, f".exporting-{os.getpid()}")
    with open(marker, "w") as f:
        f.write(str(time.time()))
    try:
        yield marker
    finally:
        try:
            os.remove(marker)
        except OSError:
            pass        # the dir was reaped after the lease expired


# a .tmp-ckpt-* dir older than this is an orphan of a save killed
# mid-write; no live save takes this long
_TMP_STALE_S = 3600.0


def _stale_tmp_dirs(save_dir: str) -> List[str]:
    out = []
    now = time.time()
    for name in os.listdir(save_dir):
        if not name.startswith(".tmp-ckpt-"):
            continue
        try:
            if now - os.path.getmtime(os.path.join(save_dir, name)) \
                    > _TMP_STALE_S:
                out.append(name)
        except OSError:
            pass
    return out


def sweep_retention(save_dir: str, keep: Optional[int] = None) -> List[str]:
    """Delete the oldest ``pass-*`` dirs beyond the newest ``keep``
    (default ``--ckpt_keep``; 0 or negative keeps everything), the
    quarantined ``.corrupt-*`` dirs beyond ``keep`` and orphaned temp
    dirs; a dir an export lease pins stays.  Returns the removed
    paths."""
    keep = FLAGS.get("ckpt_keep") if keep is None else keep
    if keep is None or keep <= 0 or not os.path.isdir(save_dir):
        return []
    removed = []
    with trace.span("ckpt_retention", keep=keep):
        corrupt = sorted(d for d in os.listdir(save_dir)
                         if d.startswith(".corrupt-"))
        for name in _pass_dirs(save_dir)[:-keep] + corrupt[:-keep] \
                + _stale_tmp_dirs(save_dir):
            path = os.path.join(save_dir, name)
            if export_pinned(path):
                counter("ckpt_retention_pinned",
                        "retention-eligible checkpoint dirs skipped "
                        "because a live export lease pins them").inc()
                log.info("retention sweep: %s pinned by export lease, "
                         "skipping", name)
                continue
            try:
                shutil.rmtree(path)
            except OSError as e:
                log.warning("retention sweep could not remove %s (%s)",
                            path, e)
                continue
            removed.append(path)
    if removed:
        counter("ckpt_retention_removed",
                "checkpoint/quarantine/orphan dirs reaped by the "
                "retention sweep").inc(len(removed))
        log.info("retention sweep (keep=%d): removed %s", keep,
                 [os.path.basename(p) for p in removed])
    return removed
