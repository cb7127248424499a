"""paddle_tpu_torch.observe — the telemetry core (counterpart of
``paddle_tpu/observe/__init__.py``).

Typed metrics (Counter / Gauge / Histogram) in a process-wide registry,
exported together with the ``StatSet`` wall-timer table through one
reporter: a JSONL sink (``--metrics_jsonl PATH``, one self-describing
line per flush interval) and an on-demand Prometheus text dump, served
live by the ``--metrics_port`` endpoint; spans into a flight recorder
and a ``--trace_jsonl`` Chrome trace; the ``--debug_dump_signal``
SIGUSR2 dump and the ``--sigterm_flush`` SIGTERM hook.

Instrumented surfaces (all against :data:`REGISTRY`, under the JAX
package's metric names and label keys):

- trainer: step latency split host-feed vs device-blocked, samples/sec,
  the loss scale under ``--precision=bf16``, the pass, step, input-wait
  and test spans, HBM gauges at pass boundaries
  (``trainer/trainer.py``, ``observe/memory.py``);
- data path: input wait + feed-convert time → input-bound ratio; the
  async pipeline's queue depth, prefetch hit/stall census, worker
  convert time and spans (``data/pipeline.py``, ``data/feeder.py``);
- dispatch tiers: RNN, conv+BN, attention, embedding and precision
  decisions, and the build-time fused-pair census
  (``ops/recurrent_ops.py``, ``ops/nn_ops.py``, ``ops/attention.py``,
  ``ops/embedding.py``, ``core/dtypes.py``, ``layers/network.py``) —
  ticked once per call, where the JAX package ticks once per traced
  program;
- checkpoints: save/verify latency, quarantines, retention
  (``trainer/checkpoint.py``);
- serving: TTFT, request latency and counts, batch size, queue depth,
  page-pool census and the admit/prefill/decode spans
  (``serving/server.py``, ``serving/pagepool.py``); ``ServedModel``'s
  per-request latency (``serving/loader.py``); the hot swap's
  ``rollout_*`` family (``serving/rollout.py``);
- SLOs: ``--slo`` objectives evaluated on the reporter's interval
  (``observe/slo.py``), on ``/slo`` and ``/healthz``.

Overhead contract: with no sink attached every instrument is a dict
lookup + lock + add; anything more expensive (the step's fence) is
gated on :func:`active` or :func:`trace.fences_steps`.  Importing this
package imports no torch.

Not ported yet, and refused by name when reached through this package:
``fleet``, ``health``, ``benchgate`` and ``costmodel`` (queue A10b).
``slo`` is a submodule imported on first use (``from
paddle_tpu_torch.observe import slo``, or ``--slo`` through
:func:`start_from_flags`), as in the reference.
"""

from ..utils.error import PaddleTpuError
from .metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    counter,
    format_labels,
    gauge,
    histogram,
)
from .report import (  # noqa: F401
    MetricsReporter,
    active,
    attach,
    prometheus_dump,
)
from .report import start_from_flags as _start_reporter_from_flags
from .report import stop_global as _stop_reporter_global
from . import dump, http, memory, shutdown, trace  # noqa: F401

#: modules of the reference's observe/ that the port lacks, and the queue
#: that ports them
_UNPORTED = {"fleet": "A10b", "health": "A10b", "benchgate": "A10b",
             "costmodel": "A10b"}


def __getattr__(name: str):
    if name in _UNPORTED:
        raise PaddleTpuError(
            f"paddle_tpu_torch.observe.{name} is not ported yet (queue "
            f"{_UNPORTED[name]})")
    raise AttributeError(
        f"module 'paddle_tpu_torch.observe' has no attribute {name!r}")


def start_from_flags():
    """One call a long-running entry point makes (``Trainer.train``, the
    CLI): start every flag-configured observability surface — the
    ``--metrics_jsonl`` reporter, the ``--trace_jsonl`` span sink, the
    ``--metrics_port`` HTTP endpoint, the ``--debug_dump_signal``
    SIGUSR2 handler, and the SIGTERM flush hook (installed only once
    some surface above actually got configured).  Each piece is
    individually idempotent and a no-op when its flag is unset, so with
    nothing configured this is a few dict lookups and no thread
    starts.  The reference's fleet aggregator comes with queue A10b."""
    reporter = _start_reporter_from_flags()
    trace.start_from_flags()
    http.start_from_flags()
    dump.install_from_flags()
    shutdown.install_from_flags()
    return reporter


def stop_global():
    """Stop every process-wide observability surface (reporter + HTTP
    endpoint + trace sink + SIGTERM hook) — the mirror of
    :func:`start_from_flags`."""
    _stop_reporter_global()
    http.stop_global()
    trace.disable()
    shutdown.uninstall()


__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "REGISTRY", "counter", "gauge", "histogram",
    "format_labels", "MetricsReporter", "active", "attach",
    "prometheus_dump", "start_from_flags", "stop_global",
    "trace", "http", "dump", "memory", "shutdown",
]
