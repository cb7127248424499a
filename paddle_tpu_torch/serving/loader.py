"""Standalone serving loader (counterpart of
``paddle_tpu/serving/loader.py``).

Imports only ``torch``, ``numpy``, the stdlib, ``core.device``, the
port's telemetry core (optional) and the kernel-op module
:mod:`paddle_tpu_torch.ops.export_ops` — never the layer engine, the
DSL, the trainer or the framework.  A
serving process ships the artifact directory and this much code:

    from paddle_tpu_torch.serving.loader import ServedModel
    model = ServedModel.load("exported_mnist/")        # on the card
    probs = model(img=batch)["prediction"]

The program is a ``torch.export`` program (``model.pt2``).  The forward
kernels an exported net meets are ``torch.library`` custom ops
(``ptpu::lstm_fwd``, ``ptpu::flash_fwd``, ``ptpu::flash_fwd_legacy``),
so importing the kernel-op module registers them before the program is
loaded; on the card they launch the CUDA kernels, on the CPU they run
their plain versions.  (The JAX loader needs no kernel module: its
StableHLO carries compiled code.)

Version-2 artifacts (int8 weights-only quantization, ``serving/
export.py``) carry their weights in ``weights.npz``: quantized entries
are dequantized ONCE at load — ``w = q.astype(f32) * scale`` per output
channel, cast to the manifest's ``dequant_dtype`` (bf16 by default for
networks) — put on the device once, and passed to the program ahead of
the feeds on every call.  Version-1 programs carry their weights.

Artifacts of the JAX package's module form (``model.stablehlo``) cannot
be read here and are refused by name; decoder artifacts
(``"kind": "decoder"``, weights only) move between the two packages in
both directions and load through ``DecoderModel.from_artifact``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device

# telemetry is optional here, as in the reference: a serving process
# that ships just this file runs without it
try:
    from ..observe import counter as _counter, gauge as _gauge
    from ..observe import histogram as _histogram
    from ..observe import fleet as _fleet, trace as _trace
except ImportError:  # pragma: no cover - standalone copy
    _counter = _gauge = _histogram = _trace = _fleet = None

#: The port's program file; the JAX package's is ``model.stablehlo``.
MODULE_FILE = "model.pt2"
JAX_MODULE_FILE = "model.stablehlo"

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class TornArtifact(ValueError):
    """An artifact whose payload does not match its manifest digests —
    truncated, bit-flipped, or mid-write.  The rollout pipeline treats
    this as "skip and keep serving the old model", never as fatal."""


def _np_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"dtype {name!r} has no numpy type") from None


def torch_dtype(name: str) -> torch.dtype:
    """Torch dtype by manifest name (``bfloat16`` included, which numpy
    lacks)."""
    if name in _TORCH_DTYPES:
        return _TORCH_DTYPES[name]
    return torch.from_numpy(np.zeros(0, _np_dtype(name))).dtype


def _dequantize(q: np.ndarray, scale: np.ndarray, axis: int) -> np.ndarray:
    shape = [1] * q.ndim
    shape[axis % q.ndim] = -1
    return q.astype(np.float32) * scale.reshape(shape)


def verify_artifact(dirname: str,
                    manifest: Optional[Dict[str, Any]] = None) -> bool:
    """Re-hash every payload file against the manifest ``files`` section.
    True when all match, False when the manifest has no digests (such
    artifacts still load, unverified); raises :class:`TornArtifact` on a
    missing, short, long, or corrupt file."""
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
            raise TornArtifact(f"{dirname}: {fn} sha256 mismatch "
                               f"(expected {meta['sha256'][:12]}…, got "
                               f"{h.hexdigest()[:12]}…)")
    return True


def artifact_digest(manifest: Dict[str, Any]) -> str:
    """Content-stable version id of an artifact: sha256 over the sorted
    per-file digests (the reference's, so an artifact has one id in both
    packages).  This is the ``model_version`` the server and the rollout
    pipeline speak."""
    files = manifest.get("files")
    if not files:
        return "unversioned"
    h = hashlib.sha256()
    for fn in sorted(files):
        h.update(fn.encode())
        h.update(files[fn]["sha256"].encode())
    return h.hexdigest()


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


def load_weight_tensors(dirname: str, wsec: Dict[str, Any],
                        device: Union[str, torch.device] = "cpu"
                        ) -> List[torch.Tensor]:
    """Materialize a manifest ``weights`` section (the reference's
    ``load_weight_entries``) as tensors on ``device`` in manifest order,
    each in its entry's dtype: int8 entries dequantized once, in f32,
    and rounded once to the dequant dtype (bfloat16 rounds to nearest
    even, as the reference's ml_dtypes cast does); raw entries passed
    through.  Tensors, because numpy has no bfloat16."""
    out: List[torch.Tensor] = []
    npz = np.load(os.path.join(dirname, wsec["file"]))
    for e in wsec["entries"]:
        dt = torch_dtype(e["dtype"])
        if e["quantized"]:
            ax = e.get("axis")
            arr = _dequantize(npz["q::" + e["name"]], npz["s::" + e["name"]],
                              -1 if ax is None else ax)
        else:
            arr = np.asarray(npz["w::" + e["name"]])
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dt)
        out.append(t.to(device))
    return out


class ServedModel:
    """A loaded ``torch.export`` inference artifact (a pure function of
    its feeds; reentrant)."""

    def __init__(self, manifest: Dict[str, Any], program,
                 weights: List[torch.Tensor], device: torch.device):
        self.manifest = manifest
        self.device = device
        self._module = program.module()
        # v2: dequantized weights in call order, on the device once
        self._weights = list(weights)
        self.feed_names = [f["name"] for f in manifest["feeds"]]
        self.fetch_names = list(manifest["fetches"])

    @classmethod
    def load(cls, dirname: str, verify: bool = True,
             device: Optional[Union[str, torch.device]] = None
             ) -> "ServedModel":
        """Load an artifact onto ``device`` (default the card; raises
        without CUDA unless ``device="cpu"``).  ``verify`` re-hashes the
        payload first (:class:`TornArtifact`)."""
        if _fleet is not None:
            # a process loading a serving artifact pushes (when
            # --fleet_addr is set) as role=serving; a dict write, free
            _fleet.set_identity(role="serving")
        dev = resolve_device(device)
        manifest = read_manifest(dirname)
        if verify:
            verify_artifact(dirname, manifest)
        if manifest.get("kind") == "decoder":
            raise ValueError(
                f"{dirname}: decoder artifact — load it with "
                "paddle_tpu_torch.serving.DecoderModel.from_artifact, not "
                "ServedModel (no program to call)")
        if manifest.get("module") != MODULE_FILE:
            raise ValueError(
                f"{dirname}: module {manifest.get('module')!r} is not a "
                f"torch.export program ({MODULE_FILE}); the JAX package's "
                f"{JAX_MODULE_FILE} artifacts are served by the JAX "
                "loader only (decoder artifacts load in both)")
        from ..ops import export_ops  # noqa: F401 - registers ptpu::*
        program = torch.export.load(os.path.join(dirname, MODULE_FILE))
        if dev.type != "cpu":
            from torch.export.passes import move_to_device_pass
            program = move_to_device_pass(program, dev)
        weights: List[torch.Tensor] = []
        wsec = manifest.get("weights")
        if wsec:   # v2 quantized artifact: dequantize once, at load
            weights = load_weight_tensors(dirname, wsec, dev)
        return cls(manifest, program, weights, dev)

    def __call__(self, n_requests: int = 1, **feeds) -> Dict[str, np.ndarray]:
        """Run one inference call carrying ``n_requests`` logical
        requests.  Telemetry is per REQUEST, not per launch:
        ``serve_requests`` ticks by N and ``serve_infer_seconds`` gets N
        observations, as in the reference."""
        if n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {n_requests}")
        args = []
        for spec in self.manifest["feeds"]:
            name = spec["name"]
            if name not in feeds:
                raise KeyError(f"missing feed {name!r} "
                               f"(expected {self.feed_names})")
            a = np.asarray(feeds[name], dtype=_np_dtype(spec["dtype"]))
            want = spec["shape"]
            got = list(a.shape)
            if len(want) != len(got) or any(
                    w is not None and w != g for w, g in zip(want, got)):
                raise ValueError(
                    f"feed {name!r}: shape {got} incompatible with {want}")
            args.append(torch.from_numpy(np.ascontiguousarray(a))
                        .to(self.device))
        t0 = time.perf_counter()
        infer_span = _trace.span("serve_infer") if _trace is not None \
            else contextlib.nullcontext()
        with infer_span, torch.no_grad():
            outs = self._module(*self._weights, *args)
            if isinstance(outs, torch.Tensor):
                outs = (outs,)
            # .cpu() synchronizes: the latency below is end to end
            result = {n: _host(v) for n, v in zip(self.fetch_names, outs)}
        if _histogram is not None:
            per_req = (time.perf_counter() - t0) / n_requests
            h = _histogram("serve_infer_seconds",
                           "per-request ServedModel inference latency")
            for _ in range(n_requests):
                h.observe(per_req)
            _counter("serve_requests", "requests served").inc(n_requests)
            _gauge("serve_batch_size",
                   "requests in the most recent inference launch").set(
                n_requests)
        return result


def _host(v: torch.Tensor) -> np.ndarray:
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:
        # numpy has no bfloat16: hand back the exact f32 widening
        v = v.float()
    return v.numpy()
