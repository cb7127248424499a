"""Profiling and FP-fault trapping (counterpart of
``paddle_tpu/utils/profiler.py``).

The reference aggregates RAII wall timers per named section
(``REGISTER_TIMER``/``StatSet``, ``paddle/utils/Stat.h:63-242``) and opens
nvprof windows via ``hl_profiler_start/end``
(``hl_cuda_device.cc:675-677``).  On the card:

- named wall timers: :mod:`paddle_tpu_torch.utils.stat`;
- device traces: :func:`trace` opens a ``torch.profiler`` window over the
  CPU and CUDA and writes it as a Chrome trace (Perfetto,
  ``chrome://tracing``) under its directory; while it is open every
  :mod:`~paddle_tpu_torch.observe.trace` span enters
  :func:`annotate`, so the step's spans enclose its kernels;
- FP-fault trapping (``feenableexcept`` in ``TrainerMain.cpp:49``; the
  JAX package flips ``jax_debug_nans``/``jax_debug_infs``):
  :func:`enable_fp_exceptions` checks the output of every PyTorch op the
  enabling thread dispatches through a ``TorchDispatchMode`` and raises
  ``FloatingPointError`` at the first op that produces a NaN or an Inf.
  What it does not see: ops of other threads (the input pipeline's
  workers), and the port's hand-written kernels, which are launched
  through ctypes and not through the dispatcher — a NaN one of them
  writes is caught at the first PyTorch op whose output it reaches.
  Each check reads a flag back to the host, so every op waits for the
  card while it is on.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..analysis.lockorder import named_lock
from .logger import get_logger, warn_once

log = get_logger("profiler")

# open-window bookkeeping: torch.profiler windows don't nest, so only
# the outermost trace() opens/closes one and inner uses are warn-once
# no-ops.  The depth doubles as the "is a profiler window open" signal
# observe.trace keys on to wrap spans in record_function ranges.
_depth_lock = named_lock("profiler.depth")
_trace_depth = 0
_windows = itertools.count()


def trace_active() -> bool:
    """True while a profiler window opened by :func:`trace` is live."""
    return _trace_depth > 0


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[Optional[str]]:
    """``with profiler.trace(dir) as path: ...`` — a ``torch.profiler``
    window over the CPU and (when available) CUDA; on exit the Chrome
    trace is written to ``path`` under ``dir`` (default: the process's
    temp directory).

    Re-entrancy-safe: a nested ``trace`` warns once and rides the
    already-open window (``path`` None) instead of opening a second.
    Windows are tick-counted (``profiler_trace_windows_total``)."""
    global _trace_depth
    with _depth_lock:
        nested = _trace_depth > 0
        _trace_depth += 1
    try:
        if nested:
            warn_once("profiler_trace_nested",
                      "nested profiler.trace(%r): torch.profiler windows "
                      "don't nest — riding the already-open window "
                      "(reported once)", logdir, logger=log)
            yield None
            return
        from .. import observe
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        logdir = logdir or os.path.join(tempfile.gettempdir(),
                                        "paddle_tpu_torch_trace")
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, "paddle_tpu_torch_trace_%d_%d.json"
                            % (os.getpid(), next(_windows)))
        prof = profile(activities=acts)
        prof.__enter__()
        observe.counter("profiler_trace_windows_total",
                        "xprof/jax.profiler trace windows opened"
                        ).inc()
        log.info("profiler trace started → %s", path)
        try:
            yield path
        finally:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(path)
            log.info("profiler trace written to %s", path)
    finally:
        with _depth_lock:
            _trace_depth -= 1


def annotate(name: str):
    """Named region in the profiler's timeline (``REGISTER_TIMER_INFO``
    equivalent): ``torch.profiler.record_function``."""
    return torch.profiler.record_function(name)


_fp_mode = None


def _float_tensors(value) -> Iterator[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        if value.is_floating_point() or value.is_complex():
            yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _float_tensors(v)


def _finite_check_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class FiniteCheck(TorchDispatchMode):
        """Raise at the first op whose floating output is not finite."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in _float_tensors(out):
                if t.numel() and not bool(torch.isfinite(t).all()):
                    raise FloatingPointError(
                        f"{func}: NaN or Inf in its output "
                        "(utils/profiler.enable_fp_exceptions)")
            return out

    return FiniteCheck()


def enable_fp_exceptions(enable: bool = True) -> None:
    """Trap NaN/Inf at the op that produces it, on the calling thread —
    the ``feenableexcept(FE_INVALID|FE_DIVBYZERO|FE_OVERFLOW)``
    equivalent (see the module docstring for what it does not see).
    ``enable=False`` turns it off again."""
    global _fp_mode
    if enable and _fp_mode is None:
        _fp_mode = _finite_check_mode()
        _fp_mode.__enter__()
    elif not enable and _fp_mode is not None:
        mode, _fp_mode = _fp_mode, None
        mode.__exit__(None, None, None)


def parameter_stats(params: Dict[str, torch.Tensor]) -> str:
    """Per-parameter |value| stats line (``--show_parameter_stats_period``,
    ``TrainerInternal.cpp:99-111``).  The parameters reach the host in
    one copy per dtype (one for fp32 masters): each parameter's
    per-tensor copy would wait for the card once per parameter."""
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for name in sorted(params):
        by_dtype.setdefault(params[name].dtype, []).append(name)
    values: Dict[str, np.ndarray] = {}
    with torch.no_grad():
        for names in by_dtype.values():
            flat = torch.cat([params[n].detach().reshape(-1)
                              for n in names]).cpu()
            if flat.dtype == torch.bfloat16:
                flat = flat.float()
            flat = flat.numpy()
            off = 0
            for n in names:
                k = params[n].numel()
                values[n] = flat[off:off + k].reshape(tuple(params[n].shape))
                off += k
    rows = []
    for name in sorted(values):
        v = values[name]
        rows.append(f"{name}: shape={tuple(v.shape)} "
                    f"absmax={np.abs(v).max():.4g} "
                    f"mean={v.mean():.4g} std={v.std():.4g}")
    return "\n".join(rows)
