"""Graceful-shutdown telemetry flush: SIGTERM → final flush → chain
(counterpart of ``paddle_tpu/observe/shutdown.py``).

A preempted/descheduled process gets SIGTERM and a grace window.  The
default SIGTERM disposition terminates immediately — ``atexit`` never
runs — so without this hook the last metrics interval, the closing
``]`` of the ``--trace_jsonl`` array and the fleet's final frame are
lost.

:func:`install_from_flags` installs a SIGTERM hook (``--sigterm_flush``,
default on, only when a telemetry surface is actually configured —
otherwise the process's signal dispositions are left untouched) that:

1. flushes the reporter's final snapshot line and pushes a final
   **going-down** fleet frame (so the aggregator's rollup records a
   clean ``down``, not a staleness ``missing``),
2. finalizes the ``--trace_jsonl`` Chrome trace array (writes ``]``),
3. then **chains**: a previously-installed Python handler is called;
   otherwise the default disposition is restored and the signal
   re-raised, so the process still dies *by SIGTERM* (exit status and
   orchestrator semantics preserved).

Deadlock discipline (as ``observe/dump.py``): the handler body runs on
the MAIN thread, possibly inside one of the very locks the flush needs
(registry lock in ``counter.inc``, ring lock in ``_Span.__exit__``).
So the handler only *starts* a short-lived ``ptpu-sigterm-flush``
thread and returns; that thread performs the flush (blocking until the
main thread releases whatever it holds) and then re-raises SIGTERM,
whose second delivery — again on the main thread, as CPython requires
for ``signal.signal`` — performs the chaining.  Repeat SIGTERMs during
the flush are coalesced.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional

from ..analysis.lockorder import named_lock

#: Flush-thread name (exempt from the tests' thread-leak guards —
#: short-lived by construction, but named for auditability).
FLUSH_THREAD_NAME = "ptpu-sigterm-flush"

_lock = named_lock("observe.shutdown")
_prev_handler = None       # disposition we chain to
_installed = False
# 0 = armed, 1 = flush in flight, 2 = flushed (next delivery chains)
_phase = 0


def installed() -> bool:
    return _installed


def flush_for_shutdown() -> None:
    """The actual goodbye: final reporter flush + going-down fleet
    frame (``report.stop_global``), then finalize the trace sink (writes
    the closing ``]``).  Best-effort on every leg — a failing
    sink must not block the termination path."""
    from ..utils.logger import get_logger
    from . import trace
    from .report import stop_global as stop_reporter

    log = get_logger("observe")
    try:
        stop_reporter()          # final JSONL line + going-down frame
    except Exception as e:       # noqa: BLE001 — dying anyway; the
        log.warning("SIGTERM flush: reporter stop failed: %s: %s",
                    type(e).__name__, e)    # flush is best-effort
    try:
        trace.disable()          # join writer, close the JSON array
    except Exception as e:       # noqa: BLE001
        log.warning("SIGTERM flush: trace finalize failed: %s: %s",
                    type(e).__name__, e)


def _flush_then_reraise() -> None:
    global _phase
    from ..utils.logger import get_logger

    flush_for_shutdown()
    _phase = 2
    get_logger("observe").info(
        "SIGTERM: telemetry flushed; re-raising for the previous "
        "disposition")
    os.kill(os.getpid(), signal.SIGTERM)


def _chain(signum, frame) -> None:
    prev = _prev_handler
    if callable(prev):
        prev(signum, frame)
    elif prev is signal.SIG_IGN:
        return
    else:   # SIG_DFL (or unknowable): die by SIGTERM, exit status honest
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _handler(signum, frame) -> None:
    global _phase
    if _phase == 2:
        _chain(signum, frame)
        return
    if _phase == 1:
        return                   # flush in flight; coalesce repeats
    _phase = 1
    threading.Thread(target=_flush_then_reraise,
                     name=FLUSH_THREAD_NAME, daemon=True).start()


def install_from_flags() -> bool:
    """Install the chaining SIGTERM hook iff ``--sigterm_flush`` (on by
    default) AND some telemetry surface is configured in this process
    (a reporter/pusher, a trace sink, or a hosted fleet aggregator) —
    a process with nothing to flush keeps its signal dispositions
    untouched.  Idempotent; main-thread only (a worker-thread entry
    point degrades gracefully, same contract as ``dump.py``)."""
    global _installed, _prev_handler, _phase
    from ..utils import FLAGS
    from . import fleet, report, trace

    if not FLAGS.get("sigterm_flush"):
        return _installed
    if report._global is None and not trace.enabled() \
            and not fleet.hosting():
        return _installed
    with _lock:
        if _installed:
            return True
        try:
            prev = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, _handler)
        except (ValueError, OSError, AttributeError):
            from ..utils.logger import get_logger, warn_once

            warn_once("sigterm_flush_unavailable",
                      "--sigterm_flush: SIGTERM hook could not be "
                      "installed from this thread/platform; the final "
                      "telemetry interval relies on atexit only",
                      logger=get_logger("observe"))
            return False
        _prev_handler = prev
        _phase = 0
        _installed = True
    return True


def uninstall() -> None:
    """Restore the pre-install SIGTERM disposition (tests; main-thread
    only).  No-op when never installed."""
    global _installed, _prev_handler, _phase
    with _lock:
        if not _installed:
            return
        try:
            signal.signal(signal.SIGTERM,
                          _prev_handler if _prev_handler is not None
                          else signal.SIG_DFL)
        except (ValueError, OSError) as e:
            # non-main-thread teardown: leave the hook in place
            from ..utils.logger import get_logger

            get_logger("observe").debug(
                "sigterm_flush uninstall skipped: %s", e)
        _prev_handler = None
        _phase = 0
        _installed = False
