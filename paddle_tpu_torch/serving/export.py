"""Export an inference function to a standalone serving artifact
(counterpart of ``paddle_tpu/serving/export.py``).

Artifact layout — the JAX package's manifest with the port's program
format, ``torch.export`` in place of StableHLO:

    <dir>/manifest.json   {"format": "paddle-tpu-serving", "version": 1,
                           "feeds": [{name, shape, dtype}...],
                           "fetches": [name...],
                           "module": "model.pt2",
                           "batch_polymorphic": bool,
                           "files": {...}, "exported_at_unix": t}
    <dir>/model.pt2       torch.export.save of the program (weights in it)

The program is exported on the CPU.  The forward kernels it meets are
custom ops (``ops/export_ops.py``), so the same file runs their plain
versions on the CPU and launches the CUDA kernels when
:class:`~paddle_tpu_torch.serving.loader.ServedModel` loads it on the
card; a kernel that is no custom op yet refuses the export by name
(ROADMAP A6b).  With ``batch_polymorphic`` the leading axis of every feed
is a ``torch.export.Dim``; when that export fails (a shape decision that
depends on the batch) the export falls back to the example's fixed batch
with the reference's warning.

**Version 2 — int8 weights-only post-training quantization**
(``quantize="int8"``): every >=2-D float parameter is stored as int8
with per-output-channel symmetric scales (last axis; ``scale_c =
max|w[..., c]| / 127``, no zero point) in ``weights.npz``, and the
program takes the weights as runtime ARGUMENTS.  The loader dequantizes
to ``dequant_dtype`` (bf16 by default for networks) once at load, puts
them on the device once and passes them on every call; 1-D tensors ship
raw fp32.  The layers cast a weight to the compute dtype at the op, so
a bf16 weight against fp32 activations computes in fp32, as the JAX
package's type promotion does.  The manifest gains:

    "version": 2,
    "weights": {"file": "weights.npz",
                "scheme": "int8-weights-per-channel",
                "dequant_dtype": "bfloat16",
                "entries": [{name, shape, dtype, quantized, axis}...]}

Every manifest carries a ``files`` section (per-file SHA-256 + size,
written last) and an ``exported_at_unix`` stamp, which
``loader.verify_artifact`` checks.  The weights layout is byte-compatible
with the JAX package's, so decoder artifacts (weights only,
``serving/model.py``) move between the two in both directions; module
artifacts do not (``model.pt2`` against ``model.stablehlo``).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dtypes import dtype_name
from ..utils import PaddleTpuError, enforce, get_logger
from .loader import MODULE_FILE, torch_dtype

log = get_logger("serving")

FORMAT_NAME = "paddle-tpu-serving"
FORMAT_VERSION = 1
QUANT_FORMAT_VERSION = 2
WEIGHTS_FILE = "weights.npz"
QUANT_SCHEME = "int8-weights-per-channel"


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


def _write_manifest(dirname: str, manifest: Dict[str, Any],
                    fnames: Sequence[str]) -> None:
    stamp_manifest(manifest, dirname, fnames)
    with open(os.path.join(dirname, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def _feed_spec(name: str, arr: np.ndarray, poly_batch: bool) -> Dict[str, Any]:
    return {"name": name,
            "shape": [None if (poly_batch and i == 0) else int(d)
                      for i, d in enumerate(np.shape(arr))],
            "dtype": dtype_name(np.asarray(arr).dtype)}


# ------------------------------------------------------------ int8 PTQ
def quantize_int8(arr: np.ndarray, axis: int = -1
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization along ``axis``.  Returns
    ``(q int8, scale f32[channels])`` with ``q = clip(round(w / scale),
    -127, 127)`` — the dequant error is at most ``scale/2`` a channel."""
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


def dequantize_int8(q: np.ndarray, scale: np.ndarray, axis: int = -1,
                    dtype="float32"):
    """Inverse of :func:`quantize_int8` (the loader's load-time path):
    numpy for the dtypes numpy has, a CPU tensor for bfloat16."""
    shape = [1] * q.ndim
    shape[axis % q.ndim] = -1
    deq = q.astype(np.float32) * scale.reshape(shape)
    if dtype_name(dtype) == "bfloat16":
        return torch.from_numpy(deq).to(torch.bfloat16)
    return deq.astype(dtype_name(dtype))


def _quantizable(arr: np.ndarray) -> bool:
    """Weights-only: >=2-D float tensors.  1-D tensors (biases, BN
    statistics) ship raw fp32."""
    return arr.ndim >= 2 and np.issubdtype(arr.dtype, np.floating)


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().float().numpy() \
            if arr.dtype == torch.bfloat16 else arr.detach().cpu().numpy()
    return np.asarray(arr)


def quantize_weight_store(params: Dict[str, Any], dequant_dtype: str
                          ) -> Tuple[Dict[str, np.ndarray],
                                     List[Dict[str, Any]]]:
    """Build the version-2 ``weights.npz`` store + manifest entries:
    quantizable tensors as ``q::name`` / ``s::name`` (dequantized to
    ``dequant_dtype`` at load), the rest raw as ``w::name``, in
    sorted-name order (the loader's order contract).  Shared by the
    network int8 export and the decoder export (``serving/model.py``)."""
    deq = dtype_name(dequant_dtype)
    store: Dict[str, np.ndarray] = {}
    entries: List[Dict[str, Any]] = []
    for name in sorted(params):
        arr = _host(params[name])
        if _quantizable(arr):
            q, scale = quantize_int8(arr, axis=-1)
            store["q::" + name] = q
            store["s::" + name] = scale
            entries.append({"name": name, "shape": list(arr.shape),
                            "dtype": deq, "quantized": True, "axis": -1})
        else:
            raw = arr.astype(np.float32) \
                if np.issubdtype(arr.dtype, np.floating) else arr
            store["w::" + name] = raw
            entries.append({"name": name, "shape": list(arr.shape),
                            "dtype": dtype_name(raw.dtype),
                            "quantized": False, "axis": None})
    return store, entries


# ------------------------------------------------------------- export
class _Program(torch.nn.Module):
    """``fn`` over positional tensors, for ``torch.export``: the first
    ``len(weight_names)`` arguments are weights (version 2), the rest the
    feeds in sorted-name order; returns the fetches in order.  ``baked``
    weights (version 1) are buffers, which the program stores."""

    def __init__(self, fn, weight_names: Sequence[str],
                 feed_names: Sequence[str], fetch_names: Sequence[str],
                 baked: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.fn = fn
        self.weight_names = list(weight_names)
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.baked_names = sorted(baked or {})
        for i, name in enumerate(self.baked_names):
            self.register_buffer(f"w{i}", baked[name])

    def forward(self, *args):
        nw = len(self.weight_names)
        weights = dict(zip(self.weight_names, args[:nw]))
        weights.update({n: getattr(self, f"w{i}")
                        for i, n in enumerate(self.baked_names)})
        out = self.fn(weights, dict(zip(self.feed_names, args[nw:])))
        return tuple(out[n] for n in self.fetch_names)


def _export_program(program: _Program, weight_args: Sequence[torch.Tensor],
                    examples: Dict[str, np.ndarray],
                    batch_polymorphic: bool):
    """``torch.export`` with the batch-polymorphic-then-fixed fallback
    of the reference's ``_serialize_export``.  A kernel that refuses
    the export (:func:`ops.export_ops.refuse_export`) raises at once."""
    feeds = [torch.from_numpy(np.ascontiguousarray(examples[k]))
             for k in program.feed_names]
    args = tuple(weight_args) + tuple(feeds)

    def do_export(poly: bool):
        shapes = None
        if poly:
            b = torch.export.Dim("b", min=1)
            # one entry: the spec tuple of forward's *args
            shapes = (tuple([None] * len(weight_args)) + tuple(
                {0: b} if f.dim() >= 1 else None for f in feeds),)
        with torch.no_grad():
            return torch.export.export(program, args,
                                       dynamic_shapes=shapes)

    poly = batch_polymorphic
    if poly:
        try:
            return do_export(True), True
        except PaddleTpuError:
            raise
        except Exception as e:  # noqa: BLE001 - shapes depend on batch
            log.warning(
                "batch-polymorphic export failed (%s: %s); falling back "
                "to fixed batch %s", type(e).__name__,
                str(e).splitlines()[0] if str(e) else "",
                {k: np.shape(v) for k, v in examples.items()})
    return do_export(False), False


def _save_program(exported, dirname: str) -> None:
    """``torch.export.save`` without the example inputs the program
    keeps: the example feeds, and a version-2 program's zero weight
    arguments, are no part of the artifact."""
    os.makedirs(dirname, exist_ok=True)
    exported.example_inputs = None
    torch.export.save(exported, os.path.join(dirname, MODULE_FILE))


def _cpu_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def export_inference_fn(fn, example_feed: Dict[str, Any], dirname: str,
                        fetch_names: Sequence[str],
                        batch_polymorphic: bool = True) -> str:
    """Export ``fn(feed_dict) -> dict[name, tensor]`` to ``dirname``.

    ``fn`` must be traceable by ``torch.export`` (weights closed over
    are stored in the program).  With ``batch_polymorphic`` the leading
    axis of every feed is exported symbolically, so one artifact serves
    any batch size."""
    feed_names = sorted(example_feed)
    examples = {k: _host(example_feed[k]) for k in feed_names}
    program = _Program(lambda _w, feed: fn(feed), (), feed_names,
                       fetch_names)
    exported, poly = _export_program(program, (), examples,
                                     batch_polymorphic)
    _save_program(exported, dirname)
    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "feeds": [_feed_spec(k, examples[k], poly) for k in feed_names],
        "fetches": list(fetch_names),
        "module": MODULE_FILE,
        "batch_polymorphic": poly,
    }
    _write_manifest(dirname, manifest, [MODULE_FILE])
    return dirname


def _resolve_output_names(network, output_names):
    if output_names is None:
        output_names = []
        for n in network.output_names:
            lyr = network.layers.get(n)
            if lyr is not None and getattr(lyr, "is_cost", False) \
                    and lyr.conf.inputs:
                output_names.append(lyr.conf.inputs[0].input_layer_name)
            else:
                output_names.append(n)
    enforce(output_names, "export_network: no output names")
    return list(output_names)


def _flatten_example_feed(example_feed: Dict[str, Any]):
    """SequenceBatch feeds → two plain-array feeds (``<name>`` +
    ``<name>_len``); returns (flat examples, seq feed names)."""
    from ..core.sequence import SequenceBatch

    seq_feeds = {k for k, v in example_feed.items()
                 if isinstance(v, SequenceBatch)}
    for k in seq_feeds:
        enforce(k + "_len" not in example_feed,
                f"export_network: feed {k + '_len'!r} collides with the "
                f"flattened lengths of sequence feed {k!r}")
    flat: Dict[str, np.ndarray] = {}
    for k, v in example_feed.items():
        if k in seq_feeds:
            flat[k] = _host(v.data)
            flat[k + "_len"] = _host(v.length)
        else:
            flat[k] = _host(v)
    return flat, seq_feeds


def export_network(network, params: Dict[str, Any],
                   example_feed: Dict[str, Any], dirname: str,
                   output_names: Optional[Sequence[str]] = None,
                   buffers: Optional[Dict[str, Any]] = None,
                   batch_polymorphic: bool = True,
                   quantize: Optional[str] = None,
                   dequant_dtype: str = "bfloat16") -> str:
    """Export a layer-engine ``NeuralNetwork`` for inference.

    ``output_names`` defaults to the network's declared outputs (cost
    layers replaced by their prediction input, as ``v2.infer`` does).
    ``SequenceBatch`` feeds are flattened into TWO artifact feeds —
    ``<name>`` (padded data) and ``<name>_len`` (int32 lengths).
    ``quantize="int8"`` writes a version-2 artifact (module docstring);
    the default writes version 1, weights stored in the program.  The
    program is traced on the CPU whatever device ``params`` are on."""
    from ..core.sequence import SequenceBatch, value_of

    output_names = _resolve_output_names(network, output_names)
    bufs = {k: _cpu_tensor(v) for k, v in (
        buffers if buffers is not None
        else network.init_buffers(device="cpu")).items()}
    flat_examples, seq_feeds = _flatten_example_feed(example_feed)
    feed_keys = list(example_feed)

    def fwd(weights, feed):
        rebuilt = {k: SequenceBatch(feed[k], feed[k + "_len"])
                   if k in seq_feeds else feed[k] for k in feed_keys}
        values, _ = network.forward(weights, rebuilt, bufs,
                                    is_training=False, only=output_names)
        return {n: value_of(values[n]) for n in output_names}

    feed_names = sorted(flat_examples)
    cpu_params = {k: _cpu_tensor(v) for k, v in params.items()}
    if quantize is None:
        program = _Program(fwd, (), feed_names, output_names,
                           baked=cpu_params)
        exported, poly = _export_program(program, (), flat_examples,
                                         batch_polymorphic)
        _save_program(exported, dirname)
        manifest = {
            "format": FORMAT_NAME,
            "version": FORMAT_VERSION,
            "feeds": [_feed_spec(k, flat_examples[k], poly)
                      for k in feed_names],
            "fetches": list(output_names),
            "module": MODULE_FILE,
            "batch_polymorphic": poly,
        }
        _write_manifest(dirname, manifest, [MODULE_FILE])
        return dirname
    enforce(quantize == "int8",
            f"export_network: unknown quantize scheme {quantize!r} "
            "(supported: 'int8')")
    return _export_network_int8(fwd, cpu_params, flat_examples, dirname,
                                output_names, batch_polymorphic,
                                dequant_dtype)


def _export_network_int8(fwd, params, flat_examples, dirname,
                         output_names, batch_polymorphic: bool,
                         dequant_dtype: str) -> str:
    """The version-2 quantized export: weights become program ARGUMENTS
    (quantized entries at ``dequant_dtype``, raw 1-D tensors at their
    own dtype), stored int8 + scales / raw in ``weights.npz``."""
    wnames = sorted(params)
    feed_names = sorted(flat_examples)
    store, entries = quantize_weight_store(params, dequant_dtype)
    weight_args = [torch.zeros(e["shape"], dtype=torch_dtype(e["dtype"]))
                   for e in entries]
    program = _Program(fwd, wnames, feed_names, output_names)
    exported, poly = _export_program(program, weight_args, flat_examples,
                                     batch_polymorphic)
    _save_program(exported, dirname)
    np.savez(os.path.join(dirname, WEIGHTS_FILE), **store)
    manifest = {
        "format": FORMAT_NAME,
        "version": QUANT_FORMAT_VERSION,
        "feeds": [_feed_spec(k, flat_examples[k], poly)
                  for k in feed_names],
        "fetches": list(output_names),
        "module": MODULE_FILE,
        "batch_polymorphic": poly,
        "weights": {
            "file": WEIGHTS_FILE,
            "scheme": QUANT_SCHEME,
            "dequant_dtype": dtype_name(dequant_dtype),
            "entries": entries,
        },
    }
    _write_manifest(dirname, manifest, [MODULE_FILE, WEIGHTS_FILE])
    quant_bytes = sum(v.nbytes for k, v in store.items()
                      if k.startswith(("q::", "s::")))
    raw_bytes = sum(
        int(np.prod(e["shape"])) * 4 for e in entries if e["quantized"])
    log.info("int8 export: %d/%d tensors quantized, weight payload "
             "%.2f MB (fp32 would be %.2f MB)",
             sum(e["quantized"] for e in entries), len(entries),
             quant_bytes / 1e6, raw_bytes / 1e6)
    return dirname
