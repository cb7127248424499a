"""The numpy half of the artifact loader that decoder artifacts need
(counterpart of ``paddle_tpu/serving/loader.py``; the StableHLO
``ServedModel`` has no counterpart in the port)."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


class TornArtifact(ValueError):
    """An artifact whose payload does not match its manifest digests —
    truncated, bit-flipped, or mid-write."""


def _np_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"weight dtype {name!r} is not supported by the "
                         "port's loader (numpy has no such type)") from None


def _dequantize(q: np.ndarray, scale: np.ndarray, axis: int,
                dtype: np.dtype) -> np.ndarray:
    shape = [1] * q.ndim
    shape[axis % q.ndim] = -1
    return (q.astype(np.float32) * scale.reshape(shape)).astype(dtype)


def verify_artifact(dirname: str,
                    manifest: Optional[Dict[str, Any]] = None) -> bool:
    """Re-hash every payload file against the manifest ``files`` section.
    True when all match, False when the manifest has no digests; raises
    :class:`TornArtifact` on a missing, short, long, or corrupt file."""
    if manifest is None:
        manifest = read_manifest(dirname)
    files = manifest.get("files")
    if not files:
        return False
    for fn, meta in sorted(files.items()):
        path = os.path.join(dirname, fn)
        if not os.path.exists(path):
            raise TornArtifact(f"{dirname}: missing payload file {fn!r}")
        size = os.path.getsize(path)
        if size != meta["bytes"]:
            raise TornArtifact(
                f"{dirname}: {fn} is {size} bytes, manifest says "
                f"{meta['bytes']} (truncated or partially written)")
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != meta["sha256"]:
            raise TornArtifact(f"{dirname}: {fn} sha256 mismatch")
    return True


def read_manifest(dirname: str, max_version: int = 2) -> Dict[str, Any]:
    """Read and validate an artifact manifest (format + version gate)."""
    with open(os.path.join(dirname, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != "paddle-tpu-serving":
        raise ValueError(f"{dirname}: not a paddle-tpu-serving artifact")
    if manifest.get("version", 0) > max_version:
        raise ValueError(
            f"{dirname}: artifact version {manifest['version']} is newer "
            f"than this loader (supports <= {max_version})")
    return manifest


def load_weight_entries(dirname: str,
                        wsec: Dict[str, Any]) -> List[np.ndarray]:
    """Materialize a manifest ``weights`` section: dequantize int8
    entries once, pass raw entries through, in manifest order."""
    weights: List[np.ndarray] = []
    npz = np.load(os.path.join(dirname, wsec["file"]))
    for e in wsec["entries"]:
        dt = _np_dtype(e["dtype"])
        if e["quantized"]:
            ax = e.get("axis")
            w = _dequantize(npz["q::" + e["name"]], npz["s::" + e["name"]],
                            -1 if ax is None else ax, dt)
        else:
            w = np.asarray(npz["w::" + e["name"]], dtype=dt)
        weights.append(w)
    return weights
