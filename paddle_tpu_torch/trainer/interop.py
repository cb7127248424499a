"""Model-file interop (counterpart of ``paddle_tpu/trainer/interop.py``):
merged single-file models and reference ``Parameter`` raw-buffer I/O,
numpy and the standard library only.

Reference surfaces:

- ``paddle_merge_model`` (``paddle/trainer/MergeModel.cpp``): config +
  trained parameters in ONE file -- ``int64 config_size``, the
  serialized config, then every parameter in declaration order, each as
  a ``Parameter::save`` stream.
- ``Parameter::save/load`` raw buffers
  (``paddle/parameter/Parameter.h:60,263-267``): a ``{int32 format;
  uint32 valueSize; uint64 size}`` header + fp32 data, the format of
  every ``pass-%05d/<param_name>`` file a reference-trained job writes
  (``ParamUtil.cpp:71-92``), read and written bit-compatibly.

The merged file keeps the reference's framing with the config as the
JSON of ``ModelConfig.to_json`` behind the magic ``PTPU``; a config and
parameters equal to the JAX package's give a byte-equal file.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..config.model_config import ModelConfig
from ..utils import PaddleTpuError, enforce, get_logger

log = get_logger("interop")

# Parameter.h:263-267 — int32 format, uint32 valueSize, uint64 size
_PARAM_HEADER = struct.Struct("<iIQ")
PARAM_FORMAT_ORIGINAL = 0          # PARAM_FORMAT_ORIGINAL in Parameter.h
MERGED_MAGIC = b"PTPU"


def write_parameter(f, value: Any,
                    fmt: int = PARAM_FORMAT_ORIGINAL) -> None:
    """``Parameter::save(ostream&)``: header + row-major fp32 buffer
    (``value`` an array, or a tensor on any device)."""
    if hasattr(value, "detach"):
        value = value.detach().float().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(value), dtype=np.float32)
    f.write(_PARAM_HEADER.pack(fmt, 4, arr.size))
    f.write(arr.tobytes())


def read_parameter(f, expect_size: Optional[int] = None) -> np.ndarray:
    """``Parameter::load(istream&)`` counterpart (flat fp32 vector)."""
    raw = f.read(_PARAM_HEADER.size)
    enforce(len(raw) == _PARAM_HEADER.size,
            "truncated parameter stream (short header)")
    fmt, value_size, size = _PARAM_HEADER.unpack(raw)
    enforce(fmt == PARAM_FORMAT_ORIGINAL,
            f"unsupported parameter format {fmt} (only "
            f"PARAM_FORMAT_ORIGINAL={PARAM_FORMAT_ORIGINAL}; MKLDNN "
            "packed formats are GPU/CPU-layout specific)")
    enforce(value_size == 4,
            f"parameter valueSize {value_size} != 4 (fp32); double builds "
            "(WITH_DOUBLE) are out of scope")
    if expect_size is not None:
        enforce(size == expect_size,
                f"parameter size {size} != expected {expect_size}")
    data = f.read(size * 4)
    enforce(len(data) == size * 4, "truncated parameter stream (short body)")
    return np.frombuffer(data, dtype=np.float32).copy()


def save_parameter_file(path: str, value: np.ndarray) -> None:
    with open(path, "wb") as f:
        write_parameter(f, value)


def load_parameter_file(path: str,
                        dims: Optional[List[int]] = None) -> np.ndarray:
    with open(path, "rb") as f:
        flat = read_parameter(f)
    return flat.reshape(dims) if dims else flat


def load_reference_model_dir(model_dir: str, model: ModelConfig,
                             strict: bool = False
                             ) -> Dict[str, np.ndarray]:
    """Load a reference ``pass-%05d`` directory (one ``Parameter::save``
    file per parameter, named by parameter name) against a parsed
    config: the reference-trained-model import path."""
    params: Dict[str, np.ndarray] = {}
    for spec in model.parameters:
        path = os.path.join(model_dir, spec.name)
        if not os.path.exists(path):
            if strict:
                raise PaddleTpuError(
                    f"{model_dir}: missing parameter file {spec.name!r}")
            log.warning("missing parameter file %s", spec.name)
            continue
        flat = load_parameter_file(path)
        if spec.dims and int(np.prod(spec.dims)) == flat.size:
            flat = flat.reshape(spec.dims)
        params[spec.name] = flat
    return params


def save_reference_model_dir(model_dir: str,
                             params: Dict[str, np.ndarray]) -> None:
    """Write params as a reference-layout model dir (round-trip tool)."""
    os.makedirs(model_dir, exist_ok=True)
    for name, value in params.items():
        save_parameter_file(os.path.join(model_dir, name), value)


def with_full_param_specs(model: ModelConfig) -> ModelConfig:
    """Return the config with ``parameters`` completed to the FULL
    layer-derived spec list (name-sorted, like ``init_params``) — config
    files usually declare only overrides, but the merged-file/model-dir
    formats need every parameter's name + dims."""
    from ..layers.network import NeuralNetwork

    net = NeuralNetwork(model)
    model.parameters = [net.param_specs[n]
                        for n in sorted(net.param_specs)]
    return model


# ------------------------------------------------------------ merge_model

def merge_model(model: ModelConfig, params: Dict[str, np.ndarray],
                out_path: str) -> None:
    """``paddle_merge_model``: one self-contained file = size-prefixed
    config + ``Parameter::save`` streams in config parameter order
    (``MergeModel.cpp:50-60`` framing, JSON config payload)."""
    blob = MERGED_MAGIC + model.to_json().encode("utf-8")
    with open(out_path, "wb") as f:
        f.write(struct.pack("<q", len(blob)))
        f.write(blob)
        for spec in model.parameters:
            enforce(spec.name in params,
                    f"merge_model: parameter {spec.name!r} not loaded")
            write_parameter(f, params[spec.name])


def load_merged_model(path: str) -> Tuple[ModelConfig,
                                          Dict[str, np.ndarray]]:
    with open(path, "rb") as f:
        (size,) = struct.unpack("<q", f.read(8))
        blob = f.read(size)
        enforce(blob[:4] == MERGED_MAGIC,
                f"{path}: not a paddle-tpu merged model (reference "
                "protobuf-config merged models need their original "
                "config .py; see README wire-compatibility note)")
        model = ModelConfig.from_json(blob[4:].decode("utf-8"))
        params: Dict[str, np.ndarray] = {}
        for spec in model.parameters:
            flat = read_parameter(f, expect_size=spec.size or None)
            if spec.dims and int(np.prod(spec.dims)) == flat.size:
                flat = flat.reshape(spec.dims)
            params[spec.name] = flat
    return model, params


def checkpoint_to_params(path: str) -> Dict[str, np.ndarray]:
    """Accept either our ``pass-%05d`` npz checkpoint or a reference
    raw-buffer model dir."""
    npz = os.path.join(path, "params.npz")
    if os.path.exists(npz):
        with np.load(npz) as data:
            return {k: data[k] for k in data.files}
    return {}
