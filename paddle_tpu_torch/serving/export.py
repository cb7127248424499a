"""The numpy half of artifact export that decoder artifacts need
(counterpart of ``paddle_tpu/serving/export.py``; the StableHLO module
export has no counterpart in the port).

Version-2 artifacts store every >=2-D float weight as int8 with
per-output-channel symmetric scales (last axis; ``scale_c =
max|w[..., c]| / 127``, no zero point) in ``weights.npz``; 1-D tensors
ship raw fp32.  Every manifest carries a ``files`` section (per-file
SHA-256 + size) and an ``exported_at_unix`` stamp, which
``loader.verify_artifact`` checks.  The layout is byte-compatible with
the JAX package's, so artifacts move between the two in both
directions.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

FORMAT_NAME = "paddle-tpu-serving"
QUANT_FORMAT_VERSION = 2
WEIGHTS_FILE = "weights.npz"
QUANT_SCHEME = "int8-weights-per-channel"
#: The port serves fp32, so int8 weights are dequantized to float32.
DEQUANT_DTYPE = "float32"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def artifact_file_digests(dirname: str, fnames: Sequence[str]
                          ) -> Dict[str, Dict[str, Any]]:
    """The manifest ``files`` section: per-file SHA-256 + size."""
    return {fn: {"sha256": _sha256_file(os.path.join(dirname, fn)),
                 "bytes": os.path.getsize(os.path.join(dirname, fn))}
            for fn in fnames}


def stamp_manifest(manifest: Dict[str, Any], dirname: str,
                   fnames: Sequence[str]) -> Dict[str, Any]:
    """Add per-file digests and the export time; call after every
    payload file is on disk, right before the manifest write."""
    manifest["files"] = artifact_file_digests(dirname, fnames)
    manifest["exported_at_unix"] = time.time()
    return manifest


def quantize_int8(arr: np.ndarray, axis: int = -1
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization along ``axis``.  Returns
    ``(q int8, scale f32[channels])`` with ``q = clip(round(w / scale),
    -127, 127)``."""
    a = np.asarray(arr, np.float32)
    ax = axis % a.ndim
    red = tuple(i for i in range(a.ndim) if i != ax)
    amax = np.max(np.abs(a), axis=red) if red else np.abs(a)
    scale = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    shape = [1] * a.ndim
    shape[ax] = -1
    q = np.clip(np.round(a / scale.reshape(shape)), -127, 127) \
        .astype(np.int8)
    return q, scale


def _quantizable(arr: np.ndarray) -> bool:
    return arr.ndim >= 2 and np.issubdtype(arr.dtype, np.floating)


def quantize_weight_store(params: Dict[str, Any]
                          ) -> Tuple[Dict[str, np.ndarray],
                                     List[Dict[str, Any]]]:
    """Build the version-2 ``weights.npz`` store + manifest entries:
    quantizable tensors as ``q::name`` / ``s::name`` (dequantized to
    :data:`DEQUANT_DTYPE`), the rest raw as ``w::name``, in sorted-name
    order (the loader's order contract)."""
    store: Dict[str, np.ndarray] = {}
    entries: List[Dict[str, Any]] = []
    for name in sorted(params):
        arr = np.asarray(params[name])
        if _quantizable(arr):
            q, scale = quantize_int8(arr, axis=-1)
            store["q::" + name] = q
            store["s::" + name] = scale
            entries.append({"name": name, "shape": list(arr.shape),
                            "dtype": DEQUANT_DTYPE,
                            "quantized": True, "axis": -1})
        else:
            raw = arr.astype(np.float32) \
                if np.issubdtype(arr.dtype, np.floating) else arr
            store["w::" + name] = raw
            entries.append({"name": name, "shape": list(arr.shape),
                            "dtype": str(raw.dtype),
                            "quantized": False, "axis": None})
    return store, entries
