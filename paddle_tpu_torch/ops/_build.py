"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` becomes one shared library with
a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so <name>.cu

(no PyTorch headers, so a build takes seconds).  All sources are
compiled in parallel, one ``nvcc`` each, the first time any kernel is
asked for.  The library name carries a hash of the sources and flags,
so an edited kernel is rebuilt and an unchanged one is reused.  The
build directory (``build/torch_kernels`` at the repository root) is
listed in ``.gitignore``.

Only sources in the repository are built.  Nothing here runs at import:
the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

from ..utils import PaddleTpuError

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)),
                         "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_C = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signature of every kernel entry point: (library stem, symbol, argtypes).
SIGNATURES = {
    "flash_packed_fwd": ("flash_packed_fwd",
                         [_C] * 6 + [_I] * 5 + [_F, _C]),
    "launch_floor": ("flash_packed_fwd", [_C]),
    "paged_decode_fwd": ("paged_decode",
                         [_C] * 6 + [_I] * 7 + [_F, _C]),
    "flash_fwd": ("flash_fwd", [_C] * 9 + [_I] * 6 + [_L] * 6 + [_I, _F, _C]),
    "flash_bwd_dq": ("flash_bwd_dq",
                     [_C] * 11 + [_I] * 6 + [_L] * 8 + [_I, _F, _C]),
    "flash_bwd_dkv": ("flash_bwd_dkv",
                      [_C] * 12 + [_I] * 6 + [_L] * 8 + [_I, _F, _C]),
    "flash_fwd_legacy": ("flash_fwd",
                         [_C] * 6 + [_I] * 6 + [_L] * 6 + [_I, _F, _C]),
    "flash_bwd_dq_legacy": ("flash_bwd_dq",
                            [_C] * 8 + [_I] * 6 + [_L] * 8 + [_I, _F, _C]),
    "flash_bwd_dkv_legacy": ("flash_bwd_dkv",
                             [_C] * 9 + [_I] * 6 + [_L] * 8 + [_I, _F, _C]),
    "embedding_gather": ("embedding_gather", [_C] * 3 + [_I] * 3 + [_C]),
    "lstm_fwd": ("lstm_fwd", [_C] * 10 + [_I] * 4 + [_C]),
    "lstm_bwd": ("lstm_bwd", [_C] * 24 + [_I] * 5 + [_C]),
    "lstm_fwd_blocked": ("lstm_fwd_blocked", [_C] * 13 + [_I] * 4 + [_C]),
    "lstm_bwd_blocked": ("lstm_bwd_blocked", [_C] * 17 + [_I] * 4 + [_C]),
    "lstm_dw_blocked": ("lstm_dw_blocked", [_C] * 7 + [_I] * 4 + [_C]),
    "lstm_dw_blocked_splits": ("lstm_dw_blocked", [_I] * 3),
    "conv3x3_dx": ("conv3x3_dx", [_C] * 6 + [_I] * 6 + [_C]),
    "conv3x3_fwd": ("conv3x3_fwd", [_C] * 4 + [_I] * 7 + [_C]),
    "conv3x3_fwd_bwd": ("conv3x3_fwd_bwd", [_C] * 8 + [_I] * 7 + [_C]),
    "conv3x3_chain_bwd": ("conv3x3_chain_bwd", [_C] * 11 + [_I] * 7 + [_C]),
    "gru_fwd": ("gru_fwd", [_C] * 7 + [_I] * 3 + [_C]),
    "gru_fwd_clusters": ("gru_fwd", [_I]),
    "gru_bwd": ("gru_bwd", [_C] * 22 + [_I] * 6 + [_C]),
    "gru_fwd_blocked": ("gru_fwd_blocked", [_C] * 13 + [_I] * 5 + [_C]),
    "gru_bwd_blocked": ("gru_bwd_blocked", [_C] * 18 + [_I] * 5 + [_C]),
    "gru_dw_blocked": ("gru_dw_blocked", [_C] * 8 + [_I] * 4 + [_C]),
    "gru_dw_blocked_splits": ("gru_dw_blocked", [_I] * 3),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: Seconds the last build took and what ptxas reported, per library.
build_info: Dict[str, Dict] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise PaddleTpuError("nvcc not found (set NVCC or put the CUDA "
                         "toolkit's bin/ on PATH)")


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` not yet built (all ``nvcc`` runs
    started together) and load them.  Returns ``{stem: library path}``;
    raises :class:`PaddleTpuError` with the compiler output on failure."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        jobs = []
        paths = {}
        for src in _sources():
            stem = os.path.splitext(os.path.basename(src))[0]
            so = os.path.join(BUILD_DIR, f"{stem}-{_digest(src)}.so")
            paths[stem] = so
            if stem in _libs:
                continue
            if not os.path.exists(so):
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = [_nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", tmp,
                                                src]
                jobs.append((stem, so, tmp, time.perf_counter(),
                             subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True)))
        for stem, so, tmp, t0, proc in jobs:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise PaddleTpuError(f"nvcc failed for {stem}.cu:\n{text}")
            os.replace(tmp, so)
            build_info[stem] = {"seconds": time.perf_counter() - t0,
                                "ptxas": text.strip()}
        for stem, so in paths.items():
            if stem not in _libs:
                _libs[stem] = ctypes.CDLL(so)
        return paths


def kernel(symbol: str):
    """The ctypes function ``symbol`` with its argtypes set, building
    the kernels first if needed."""
    stem, argtypes = SIGNATURES[symbol]
    lib: Optional[ctypes.CDLL] = _libs.get(stem)
    if lib is None:
        build_all()
        lib = _libs[stem]
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
