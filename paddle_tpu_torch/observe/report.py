"""Metrics export: JSONL sink + Prometheus text dump (counterpart of
``paddle_tpu/observe/report.py``).

One export path for BOTH telemetry families: the typed registry
(:mod:`paddle_tpu_torch.observe.metrics`) and the ``StatSet`` wall-timer
table (:mod:`paddle_tpu_torch.utils.stat` — the reference's ``Stat.h``
RAII timers).  A :class:`MetricsReporter` snapshots them together:

- **JSONL** (``--metrics_jsonl PATH``): one self-describing line per
  flush interval — ``{"ts", "seq", "metrics": [...], "timers": [...]}``
  — append-only, so a crash loses at most the last interval and any log
  shipper can tail it;
- **Prometheus text** (:meth:`MetricsReporter.prometheus_text`): the
  standard exposition format, rendered on demand (served by
  :mod:`paddle_tpu_torch.observe.http`).

:func:`start_from_flags` is the one call entry points make (the trainer,
the CLI): idempotent, starts the global background reporter iff
``--metrics_jsonl`` is set.  :func:`active` tells instrumentation
whether a sink is attached — callers use it to gate work that is NOT
near-zero-cost, e.g. the trainer's per-step fence that the host/device
time split needs.

The fleet push client (``fleet_addr``, ``observe/fleet.py``) comes with
queue A10b: a reporter asked for one refuses by name, and
:func:`start_from_flags` reads no ``--fleet_addr``.  ``--slo`` alone
starts the reporter (the SLO engine, ``observe/slo.py``, evaluates on
its interval thread); each interval the reporter finds the engine
through ``sys.modules`` as the reference does, so a process without
``--slo`` pays one dict lookup.
"""

from __future__ import annotations

import atexit
import json
import threading
import time
from typing import Any, Dict, List, Optional

from ..analysis.lockorder import named_lock
from ..utils.error import PaddleTpuError
from .metrics import REGISTRY, MetricsRegistry


def _timer_snapshot(stat) -> List[Dict[str, Any]]:
    """StatSet → list of per-timer dicts (lock-consistent reads)."""
    if stat is None:
        return []
    snap = stat.snapshot()
    return [snap[name] for name in sorted(snap)]


class MetricsReporter:
    """Periodic snapshot writer over (registry, stat-timer) state."""

    def __init__(self, path: Optional[str] = None,
                 interval_s: float = 10.0,
                 registry: Optional[MetricsRegistry] = None,
                 stat: Any = "global",
                 fleet_addr: Optional[str] = None):
        if fleet_addr:
            raise PaddleTpuError(
                f"MetricsReporter(fleet_addr={fleet_addr!r}): the fleet "
                "push client (observe/fleet.py) is not ported yet "
                "(queue A10b)")
        if stat == "global":
            from ..utils.stat import global_stat
            stat = global_stat
        self.path = path
        self.interval_s = interval_s
        self.registry = REGISTRY if registry is None else registry
        self.stat = stat
        # a sink that cannot be written is DEGRADED: snapshots are being
        # dropped, so active() must stop claiming someone is listening —
        # otherwise the trainer keeps paying its per-step fence for
        # telemetry that never lands.  A later successful flush (path
        # fixed, disk freed) clears the state.
        self.degraded = False
        self._seq = 0
        self._lock = named_lock("observe.reporter")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ snapshot
    def snapshot_line(self) -> Dict[str, Any]:
        """One self-describing export record (the JSONL line body)."""
        return {
            "ts": round(time.time(), 3),
            "seq": self._seq,
            "metrics": self.registry.snapshot(),
            "timers": _timer_snapshot(self.stat),
        }

    def flush(self) -> Optional[Dict[str, Any]]:
        """Append one snapshot line to the sink; returns the record
        (None when no path is configured)."""
        if not self.path:
            return None
        with self._lock:
            line = self.snapshot_line()
            self._seq += 1
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(line) + "\n")
            except Exception as e:   # noqa: BLE001 — mark + re-raise:
                self.degraded = True  # the loop warns-once, direct
                self._warn_flush_failure(e)  # callers see the error
                raise
            self.degraded = False
        return line

    # ---------------------------------------------------------- prometheus
    def prometheus_text(self) -> str:
        """Registry metrics + timer table in exposition format.  Timers
        render as a summary-style family (``_count``/``_sum`` plus
        ``_max``/``_min`` gauges) so one scrape covers both worlds."""
        out = [self.registry.prometheus_text()]
        timers = _timer_snapshot(self.stat)
        if timers:
            out.append("# HELP paddle_tpu_timer_seconds named wall "
                       "timers (StatSet)\n")
            out.append("# TYPE paddle_tpu_timer_seconds summary\n")
            for t in timers:
                lbl = '{name="%s"}' % t["name"]
                out.append(
                    f"paddle_tpu_timer_seconds_count{lbl} {t['count']}\n"
                    f"paddle_tpu_timer_seconds_sum{lbl} {t['total']}\n"
                    f"paddle_tpu_timer_seconds_max{lbl} {t['max']}\n"
                    f"paddle_tpu_timer_seconds_min{lbl} {t['min']}\n")
        return "".join(out)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "MetricsReporter":
        """Start the background flush thread (daemon; one per reporter)."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self._evaluate_slo()
                try:
                    self.flush()
                except Exception as e:  # noqa: BLE001 — telemetry never
                    # kills (or silently abandons) the process it
                    # observes: an unwritable sink or a non-JSON value
                    # is reported once, then the loop keeps retrying
                    self._warn_flush_failure(e)

        self._thread = threading.Thread(
            target=loop, name="ptpu-metrics-reporter", daemon=True)
        self._thread.start()
        return self

    def _evaluate_slo(self) -> None:
        """One SLO evaluation pass before the flush, through the
        reference's ``sys.modules`` probe: without ``--slo`` the engine
        module is never imported and this is one dict lookup."""
        import sys

        smod = sys.modules.get("paddle_tpu_torch.observe.slo")
        eng = smod.active_engine() if smod is not None else None
        if eng is not None:
            eng.evaluate()  # never raises (telemetry never kills)

    def _warn_flush_failure(self, e: Exception) -> None:
        from ..utils.logger import get_logger, warn_once

        warn_once(
            f"metrics_flush_failed:{self.path}",
            "metrics flush to %r failed (%s: %s); telemetry for this "
            "sink is being DROPPED — fix the path/payload (reported "
            "once)", self.path, type(e).__name__, e,
            logger=get_logger("observe"))

    def stop(self) -> None:
        """Stop the flush thread and write one final snapshot."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        try:
            self.flush()
        except Exception as e:  # noqa: BLE001 — see loop()
            self._warn_flush_failure(e)


# --------------------------------------------------------------- global
_global: Optional[MetricsReporter] = None
_global_lock = named_lock("observe.reporter.global")


def start_from_flags() -> Optional[MetricsReporter]:
    """Start the process-wide reporter from ``--metrics_jsonl`` /
    ``--metrics_interval_s`` / ``--slo``.  Idempotent; returns the
    reporter (None when no sink or SLO engine is configured — no thread
    starts, no work happens).  ``--slo`` alone starts the reporter too:
    the engine needs the interval thread to evaluate on.  Every
    long-running entry point calls this once (``Trainer.train``, the
    CLI)."""
    global _global
    from ..utils import FLAGS

    path = FLAGS.get("metrics_jsonl")
    slo_spec = str(FLAGS.get("slo") or "").strip()
    if not path and not slo_spec:
        return _global
    if slo_spec:
        # import (not a sys.modules probe): --slo set is the opt-in that
        # brings the engine into the process; every later surface
        # probes sys.modules and now finds it
        from . import slo as _slo

        _slo.configure_from_flags()
    with _global_lock:
        if _global is None:
            _global = MetricsReporter(
                path=path or None,
                interval_s=FLAGS.get("metrics_interval_s"))
            _global.start()
            atexit.register(stop_global)
            # probe the sink NOW: a typo'd path warns at startup, not
            # after a multi-hour run produced zero telemetry
            if path:
                try:
                    _global.flush()
                except Exception as e:  # noqa: BLE001
                    _global._warn_flush_failure(e)
    return _global


def attach(path: str, interval_s: float = 10.0,
           registry: Optional[MetricsRegistry] = None,
           stat: Any = "global") -> MetricsReporter:
    """Programmatic sink attach (tests, notebooks): replaces the global
    reporter."""
    global _global
    with _global_lock:
        if _global is not None:
            _global.stop()
        _global = MetricsReporter(path, interval_s, registry, stat)
        _global.start()
    return _global


def stop_global() -> None:
    global _global
    with _global_lock:
        r, _global = _global, None
    if r is not None:
        r.stop()


def active() -> bool:
    """True iff a sink is attached AND delivering — instrumentation
    whose cost is NOT negligible (the step's fence for the host/device
    split) keys on this, so telemetry is effectively free when nobody
    is listening.  A degraded sink (every flush failing — bad path,
    full disk) reports False: nobody IS listening, so the hot loop must
    not keep paying for snapshots that are being dropped."""
    r = _global
    return r is not None and bool(r.path) and not r.degraded


def prometheus_dump() -> str:
    """On-demand Prometheus text over the default registry + timers
    (works with or without a running reporter)."""
    # benign racy read: writes are _global_lock-guarded; a scrape
    # racing stop_global reads the old reporter or a fresh throwaway
    r = _global or MetricsReporter()
    return r.prometheus_text()
