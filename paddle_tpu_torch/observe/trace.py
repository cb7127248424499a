"""Span-based tracing: flight recorder + Chrome trace JSONL
(counterpart of ``paddle_tpu/observe/trace.py``).

The metrics registry (:mod:`paddle_tpu_torch.observe.metrics`) answers
"how much / how often"; this module answers "where did *this* step /
request spend its time".  A :func:`span` context manager produces
timeline spans with trace-id / span-id / parent-id, recorded into

- a bounded thread-safe **ring buffer** (the flight recorder — the last
  N spans of a live run, dumped on demand through ``/trace`` or the
  SIGUSR2 debug dump), and
- optionally a ``--trace_jsonl PATH`` sink: **Chrome trace-event JSON**
  (``ph:"X"`` complete events, one lane per thread) written by a
  background ``ptpu-trace-writer`` thread — the file loads directly in
  Perfetto / ``chrome://tracing`` and parses with ``json.load``.

Trace context propagates three ways:

- **nesting** — thread-local: a span opened inside another becomes its
  child (same trace id, ``parent_id`` set);
- **across threads** — :func:`current_context` / :func:`context_scope`
  hand the active context to worker threads (the async input pipeline
  does this), so reader/convert/place spans land in the trace of the
  pass that consumes them;
- **across processes** — :func:`parent_header` renders the active
  context as an opaque ``<trace_id>/<span_id>`` token an RPC can carry
  and :func:`record_span` records the peer's echoed span (the data
  master's RPC, ``distributed/master.py``, uses them).

Device-timeline correlation: while a ``torch.profiler`` window opened
by :func:`paddle_tpu_torch.utils.profiler.trace` is open, every span
additionally enters ``torch.profiler.record_function(name)``, so the
span encloses its kernels in the profiler's timeline.  Torch is never
imported from here: the hook goes through ``sys.modules`` and only
fires when the profiler module is already live, and the profiler module
imports torch inside the call.

Overhead contract: with tracing disabled — no ``--trace_jsonl``, no
``/trace`` scrape, no programmatic :func:`enable` — :func:`span`
returns a shared no-op context manager (one function call + a None
check), NOTHING is written to the ring buffer, and no writer thread
exists.  Telemetry never kills the process it observes: an unwritable
sink degrades to ring-only recording with a warn-once.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import queue
import random
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

from ..analysis.lockorder import named_lock

DEFAULT_RING_SIZE = 4096

#: Thread name of the JSONL writer; the tests' thread-leak guards
#: key on it (same contract as the pipeline's ``ptpu-io-*`` workers).
WRITER_THREAD_NAME = "ptpu-trace-writer"

# perf_counter is the span clock (monotonic, ns resolution); this offset
# maps it onto the epoch once so trace timestamps are wall-clock µs and
# multiple processes' traces can be merged on one timeline.
_EPOCH_OFFSET_S = time.time() - time.perf_counter()

_ids = random.Random()          # span/trace ids need no crypto strength
_ids_lock = named_lock("trace.ids")

_tls = threading.local()        # .ctx: the active SpanContext (or None)


class SpanContext(NamedTuple):
    """The propagatable identity of an active span."""
    trace_id: str
    span_id: str


def _new_id() -> str:
    with _ids_lock:
        return "%016x" % _ids.getrandbits(64)


def now_us() -> float:
    """Wall-clock microseconds on the span clock (epoch-aligned)."""
    return (time.perf_counter() + _EPOCH_OFFSET_S) * 1e6


# ------------------------------------------------------------- context
def current_context() -> Optional[SpanContext]:
    """The innermost open span's context on THIS thread (None outside
    any span).  Cheap enough to call unconditionally."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def context_scope(ctx: Optional[SpanContext]) -> Iterator[None]:
    """Run a block under ``ctx`` — how worker threads adopt the trace of
    the pass/step that spawned them (thread-locals don't inherit)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def parent_header() -> str:
    """Active context as the opaque wire token (``trace_id/span_id``;
    empty string outside any span).  Tab/newline-free by construction,
    so it rides a line protocol unescaped."""
    ctx = getattr(_tls, "ctx", None)
    return f"{ctx.trace_id}/{ctx.span_id}" if ctx is not None else ""


def parse_header(header: str) -> Optional[SpanContext]:
    """Inverse of :func:`parent_header`; None on anything malformed (a
    peer speaking a different dialect must not kill telemetry)."""
    if not header or "/" not in header:
        return None
    trace_id, _, span_id = header.partition("/")
    if not trace_id or not span_id:
        return None
    return SpanContext(trace_id, span_id)


# ------------------------------------------------------------ recorder
class _Recorder:
    """Ring buffer + optional JSONL writer behind one record() call."""

    def __init__(self, jsonl_path: Optional[str],
                 ring_size: int = DEFAULT_RING_SIZE, fences: bool = True):
        self.ring: "collections.deque" = collections.deque(
            maxlen=max(1, int(ring_size)))
        self._ring_lock = named_lock("trace.ring")
        self.jsonl_path = jsonl_path or None
        # an explicit sink always wants the honest (fenced) timeline;
        # scrape-originated ring-only recording opts out (see
        # fences_steps)
        self.fences = bool(fences) or self.jsonl_path is not None
        self.dropped = 0
        self._q: Optional["queue.Queue"] = None
        self._writer: Optional[threading.Thread] = None
        self._file = None
        if self.jsonl_path:
            try:
                self._file = open(self.jsonl_path, "w")
                self._file.write("[")
            except OSError as e:
                self._warn_sink(e)
            else:
                self._q = queue.Queue(maxsize=8192)
                self._writer = threading.Thread(
                    target=self._writer_loop, name=WRITER_THREAD_NAME,
                    daemon=True)
                self._writer.start()

    def _warn_sink(self, e: Exception) -> None:
        from ..utils.logger import get_logger, warn_once

        f, self._file = self._file, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        warn_once(
            f"trace_sink_failed:{self.jsonl_path}",
            "trace sink %r failed (%s: %s); spans keep landing in the "
            "flight recorder but the JSONL stream is DROPPED (reported "
            "once)", self.jsonl_path, type(e).__name__, e,
            logger=get_logger("observe"))

    def record(self, event: Dict[str, Any]) -> None:
        with self._ring_lock:
            self.ring.append(event)
        if self._q is not None:
            try:
                self._q.put_nowait(event)
            except queue.Full:      # writer can't keep up: shed, count
                with self._ring_lock:
                    self.dropped += 1
                    first = self.dropped == 1
                if first:   # a silently-truncated timeline lies: say so
                    from ..utils.logger import get_logger, warn_once

                    warn_once(
                        f"trace_spans_dropped:{self.jsonl_path}",
                        "trace writer can't keep up with span volume; "
                        "spans are being DROPPED from the %r stream "
                        "(the flight recorder still has them; dropped "
                        "count on /healthz)", self.jsonl_path,
                        logger=get_logger("observe"))

    def events(self) -> List[Dict[str, Any]]:
        with self._ring_lock:
            return list(self.ring)

    # writer thread: drains the queue into the trace-event JSON array.
    _STOP = object()

    def _writer_loop(self) -> None:
        first = True
        while True:
            item = self._q.get()
            if item is self._STOP:
                break
            if self._file is None:
                continue            # sink already degraded: drain only
            try:
                self._file.write(("\n" if first else ",\n")
                                 + json.dumps(item))
                first = False
            except (OSError, TypeError, ValueError) as e:
                self._warn_sink(e)

    def close(self) -> None:
        if self._writer is not None:
            self._q.put(self._STOP)
            self._writer.join(timeout=5.0)
            self._writer = None
        if self._file is not None:
            try:
                # terminate the array so json.load accepts the file
                # (Perfetto tolerates a missing "]" after a crash; a
                # clean stop writes a strictly valid document)
                self._file.write("\n]\n")
                self._file.close()
            except OSError:
                pass
            self._file = None


_recorder: Optional[_Recorder] = None
_state_lock = named_lock("trace.state")
_atexit_installed = False


def enabled() -> bool:
    """True iff spans are being recorded — the hot-path gate."""
    # benign racy read on the span hot path: every write is
    # _state_lock-guarded; a stale recorder finishes one span into the
    # old ring harmlessly — taking the lock here would price every span
    # ptpu: lint-ok[PT-RACE] atomic reference read, writes lock-guarded
    return _recorder is not None


def fences_steps() -> bool:
    """True iff tracing asked for the trainer's per-step fence: an
    EXPLICIT opt-in — ``--trace_jsonl`` or a programmatic
    :func:`enable`.  Ring-only recording lazily enabled by a ``/trace``
    scrape (:func:`ensure_ring`) stays fence-free, so an accidental
    probe of the endpoint can never convert a production run's async
    dispatch into a per-step device sync; its spans carry dispatch-time
    durations, honest about what they measured."""
    rec = _recorder
    return rec is not None and rec.fences


def dropped_count() -> int:
    """Spans shed from the JSONL stream because the writer couldn't
    keep up (the flight recorder keeps them); surfaced on /healthz."""
    rec = _recorder
    return rec.dropped if rec is not None else 0


def enable(jsonl_path: Optional[str] = None,
           ring_size: int = DEFAULT_RING_SIZE,
           fences: bool = True) -> None:
    """Turn tracing on: flight recorder always, JSONL stream when
    ``jsonl_path`` is given.  Idempotent re-enable replaces the sink.
    ``fences=False`` (the ``/trace`` scrape path) records ring-only
    without asking the trainer for its per-step fence."""
    global _recorder, _atexit_installed
    with _state_lock:
        old, _recorder = _recorder, _Recorder(jsonl_path, ring_size,
                                              fences=fences)
        if not _atexit_installed:
            atexit.register(disable)
            _atexit_installed = True
    if old is not None:
        old.close()


def disable() -> None:
    """Stop recording, join the writer, and finalize the JSONL file
    (writes the closing ``]``).  Idempotent; spans still open keep a
    reference to the old recorder and finish harmlessly into it."""
    global _recorder
    with _state_lock:
        rec, _recorder = _recorder, None
    if rec is not None:
        rec.close()


def start_from_flags() -> bool:
    """Enable tracing iff ``--trace_jsonl`` is set (the HTTP endpoint
    enables ring-only recording lazily, on its first ``/trace``
    request — see :mod:`paddle_tpu_torch.observe.http`).  Idempotent:
    re-calls with an unchanged flag don't restart the sink mid-run."""
    from ..utils import FLAGS

    path = FLAGS.get("trace_jsonl")
    if not path:
        return enabled()
    if _recorder is not None and _recorder.jsonl_path == path:
        return True
    enable(jsonl_path=path, ring_size=FLAGS.get("trace_ring_size"))
    return True


def ensure_ring(ring_size: Optional[int] = None) -> None:
    """Enable ring-only, fence-free recording if tracing is fully off
    — the lazy opt-in behind the HTTP endpoint's first ``/trace``
    request, so a run scraped only for ``/metrics`` never starts
    recording, and even a ``/trace`` scrape never buys the trainer's
    per-step fence (:func:`fences_steps` stays False); a live recorder
    — with or without a sink — is kept."""
    if _recorder is None:
        from ..utils import FLAGS

        enable(ring_size=FLAGS.get("trace_ring_size")
               if ring_size is None else ring_size, fences=False)


# ------------------------------------------------------------- spans
class _NullSpan:
    """Shared do-nothing span: the disabled-mode fast path."""
    __slots__ = ()
    context = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def _profiler_annotation(name: str):
    """A ``torch.profiler.record_function`` for ``name`` iff a profiler
    window opened by ``utils/profiler.trace`` is open right now —
    resolved through sys.modules so this module never imports torch
    (and pays nothing when the profiler is idle)."""
    prof = sys.modules.get("paddle_tpu_torch.utils.profiler")
    if prof is None or not prof.trace_active():
        return None
    try:
        return prof.annotate(name)
    except Exception:   # noqa: BLE001 — telemetry never kills the host
        return None


class _Span:
    __slots__ = ("_rec", "name", "attrs", "context", "parent_id",
                 "_t0", "_prev", "_annot")

    def __init__(self, rec: _Recorder, name: str,
                 remote_parent: Optional[SpanContext],
                 attrs: Dict[str, Any]):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        parent = remote_parent if remote_parent is not None \
            else getattr(_tls, "ctx", None)
        if parent is not None:
            self.context = SpanContext(parent.trace_id, _new_id())
            self.parent_id = parent.span_id
        else:
            self.context = SpanContext(_new_id(), _new_id())
            self.parent_id = None

    def __enter__(self) -> "_Span":
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.context
        annot = _profiler_annotation(self.name)
        if annot is not None:
            # the profiler window can close between the trace_active()
            # check and this enter — a raise here would skip the with
            # body AND leak _tls.ctx (no __exit__ runs)
            try:
                annot.__enter__()
            except Exception:   # noqa: BLE001 — telemetry never kills
                annot = None
        self._annot = annot
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if self._annot is not None:
            try:
                self._annot.__exit__(exc_type, exc, tb)
            except Exception as e:  # noqa: BLE001 — telemetry never
                # kills: the profiler window can close mid-span
                from ..utils.logger import get_logger
                get_logger("observe").debug(
                    "profiler annotation exit failed (window closed "
                    "mid-span?): %s: %s", type(e).__name__, e)
        _tls.ctx = self._prev
        args = {"trace_id": self.context.trace_id,
                "span_id": self.context.span_id}
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        if exc_type is not None:
            args["error"] = exc_type.__name__
        for k, v in self.attrs.items():
            args[k] = v if isinstance(v, (int, float, bool)) else str(v)
        self._rec.record({
            "name": self.name, "ph": "X", "cat": "ptpu",
            "ts": round((self._t0 + _EPOCH_OFFSET_S) * 1e6, 3),
            "dur": round((t1 - self._t0) * 1e6, 3),
            "pid": os.getpid(), "tid": threading.get_native_id(),
            "args": args})
        return False


def span(name: str, remote_parent: Optional[SpanContext] = None,
         **attrs):
    """Open a timeline span: ``with trace.span("feed", step=i): ...``.

    Disabled mode returns a shared no-op (no allocation, no record);
    enabled mode records one ``ph:"X"`` complete event on exit, parented
    under the innermost open span of this thread — or under
    ``remote_parent`` when an RPC peer handed its context over."""
    rec = _recorder
    if rec is None:
        return _NULL_SPAN
    return _Span(rec, name, remote_parent, attrs)


def record_span(name: str, ts_us: float, dur_us: float, trace_id: str,
                parent_id: Optional[str] = None,
                pid: Optional[int] = None, tid: Optional[int] = None,
                **attrs) -> Optional[str]:
    """Record a span observed OUTSIDE this thread's clock — e.g. an
    RPC peer's server-side handling time echoed back to the client.  The
    caller supplies absolute µs timestamps; returns the new span id
    (None when tracing is disabled)."""
    rec = _recorder
    if rec is None:
        return None
    span_id = _new_id()
    args: Dict[str, Any] = {"trace_id": trace_id, "span_id": span_id}
    if parent_id:
        args["parent_id"] = parent_id
    for k, v in attrs.items():
        args[k] = v if isinstance(v, (int, float, bool)) else str(v)
    rec.record({
        "name": name, "ph": "X", "cat": "ptpu",
        "ts": round(float(ts_us), 3), "dur": round(float(dur_us), 3),
        "pid": os.getpid() if pid is None else int(pid),
        "tid": threading.get_native_id() if tid is None else int(tid),
        "args": args})
    return span_id


# ----------------------------------------------------- flight recorder
def events() -> List[Dict[str, Any]]:
    """Current flight-recorder contents (oldest first; [] when off)."""
    rec = _recorder
    return rec.events() if rec is not None else []


def flight_recorder_json() -> str:
    """Flight recorder as a Chrome trace-event JSON array — the
    ``/trace`` endpoint body and the SIGUSR2 dump payload; loadable
    as-is in Perfetto."""
    return json.dumps(events())
