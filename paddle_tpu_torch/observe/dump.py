"""Post-mortem debug dump: SIGUSR2 → metrics + flight recorder on disk
(counterpart of ``paddle_tpu/observe/dump.py``).

A wedged run (deadlocked input pipeline, a step that never finishes)
usually gets SIGKILLed before anyone attaches a debugger.  With
``--debug_dump_signal`` the process installs a SIGUSR2 handler that
snapshots the full observability state of the LIVE run to timestamped
files:

    kill -USR2 <pid>
    # -> <dir>/paddle_tpu_dump_<ts>_<pid>.metrics.prom   (Prometheus text)
    # -> <dir>/paddle_tpu_dump_<ts>_<pid>.trace.json     (flight recorder,
    #                                        Chrome trace-event array)

``<dir>`` is ``--debug_dump_dir``, or the process's temp directory
(``$TMPDIR``) when that is empty.  The handler runs in the main thread
(CPython delivers signals there), hands the file IO to a short-lived
thread, and never raises — a failed dump logs and returns, it must not
take down the run it was asked to diagnose.  Opt-in by flag because
library code must not steal process-wide signal dispositions by
default.  A process whose training-health observatory drained writes
its latest report as ``.health.json``; a process hosting a fleet
aggregator writes the rollup and topology as ``.fleet.json``.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import threading
import time
from typing import Optional, Tuple

from ..analysis.lockorder import named_lock
from . import trace
from .report import prometheus_dump

_installed = False
_install_lock = named_lock("observe.dump.install")


def debug_dump(out_dir: Optional[str] = None) -> Tuple[str, str]:
    """Write the dump files now; returns the (metrics, trace) paths.
    Usable directly (tests, a REPL on a live run) — the signal handler
    is just this plus plumbing.  When the training-health observatory
    has drained at least once this process, its latest structured
    report is dumped alongside as ``.health.json`` (resolved through
    ``sys.modules`` — a run that never enabled ``--health_interval``
    writes exactly the two files); when this process HOSTS a fleet
    aggregator (``--fleet_port``), the cluster rollup + topology land as
    ``.fleet.json`` too."""
    from ..utils import FLAGS

    out_dir = out_dir or FLAGS.get("debug_dump_dir") \
        or tempfile.gettempdir()
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.join(
        out_dir, "paddle_tpu_dump_%s_%d" % (
            time.strftime("%Y%m%d-%H%M%S"), os.getpid()))
    prom_path = stem + ".metrics.prom"
    trace_path = stem + ".trace.json"
    with open(prom_path, "w") as f:
        f.write(prometheus_dump())
    with open(trace_path, "w") as f:
        f.write(trace.flight_recorder_json())
    hmod = sys.modules.get("paddle_tpu_torch.observe.health")
    health_report = hmod.latest_report() if hmod is not None else None
    if health_report is not None:
        with open(stem + ".health.json", "w") as f:
            json.dump({"report": health_report,
                       "summary": hmod.status_summary()}, f, indent=1)
    # a process HOSTING the fleet aggregator dumps the cluster view
    # too: the rollup + topology of every registered peer at dump time
    # (resolved through sys.modules like health — the module is always
    # imported with the package, the gate is whether it is hosting)
    fmod = sys.modules.get("paddle_tpu_torch.observe.fleet")
    if fmod is not None and fmod.hosting():
        with open(stem + ".fleet.json", "w") as f:
            json.dump({"healthz": fmod.rollup(),
                       "topology": fmod.topology()}, f, indent=1)
    return prom_path, trace_path


def _do_dump() -> None:
    from ..utils.logger import get_logger

    log = get_logger("observe")
    try:
        prom, tr = debug_dump()
        log.warning("SIGUSR2 debug dump: %s + %s (%d trace events)",
                    prom, tr, len(trace.events()))
    except Exception as e:   # noqa: BLE001 — a diagnostics dump must
        log.warning("SIGUSR2 debug dump FAILED: %s: %s",  # never kill
                    type(e).__name__, e)                  # the run


def _handler(signum, frame) -> None:
    # CPython runs this on the main thread, possibly INSIDE one of the
    # non-reentrant critical sections the dump must read (the trace
    # ring lock in _Span.__exit__, the registry locks in counter.inc)
    # — acquiring them here would self-deadlock the run being
    # diagnosed.  Hand the dump to a short-lived thread instead: it
    # blocks until the main thread releases the lock, the handler
    # returns immediately.
    threading.Thread(target=_do_dump, name="ptpu-debug-dump",
                     daemon=True).start()


def install_from_flags() -> bool:
    """Install the SIGUSR2 handler iff ``--debug_dump_signal`` is set.
    Idempotent; returns True when the handler is (already) installed.
    Does NOT itself enable tracing (the flag is insurance on long
    production runs and must not buy per-step fencing): the trace half
    of the dump has spans when ``--trace_jsonl`` is set or ``/trace``
    was scraped, and is an empty array otherwise.  Signals can only be
    installed from the main thread — a worker-thread entry point
    degrades gracefully."""
    global _installed
    from ..utils import FLAGS

    if not FLAGS.get("debug_dump_signal"):
        return _installed
    with _install_lock:
        if _installed:
            return True
        try:
            signal.signal(signal.SIGUSR2, _handler)
        except (ValueError, OSError, AttributeError):
            # not the main thread / platform without SIGUSR2
            from ..utils.logger import get_logger, warn_once

            warn_once("debug_dump_signal_unavailable",
                      "--debug_dump_signal: SIGUSR2 handler could not "
                      "be installed from this thread/platform",
                      logger=get_logger("observe"))
            return False
        _installed = True
    return True
