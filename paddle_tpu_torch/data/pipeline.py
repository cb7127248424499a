"""Bounded asynchronous input pipeline: reader → convert → device
(counterpart of ``paddle_tpu/data/pipeline.py``).

The synchronous train loop serializes three kinds of host work in front
of every step: pulling the next minibatch from the reader, the feeder's
``convert`` (numpy padding) and the host-to-device copy.
:class:`AsyncPipeline` moves them onto N worker threads that share the
pass's reader iterator, convert and place batches, and feed a
depth-bounded queue of placed feed dicts; the consumer
(``Trainer.train``'s loop) blocks only when the queue is empty.

Contract (the reference's, pinned by the tests):

- **order determinism** — batches come out in exactly the reader's
  order whatever the worker count, so a fixed-seed run's losses equal
  the synchronous path's;
- **bounded** — at most ``depth`` batches are in flight between the
  reader and the consumer (reader IO, conversion and the ready queue
  all count against the bound);
- **exceptions propagate** — a fault in the reader or in a worker's
  convert re-raises in the consumer at the position it occurred, after
  every earlier batch was delivered;
- **clean shutdown** — ``close()`` (idempotent; also run when a
  consumer abandons iteration) stops and joins every worker and closes
  the source iterator.

Locks are plain ``threading`` ones: the reference's lock-order checker
(``analysis.lockorder``) waits for queue A10, as do its telemetry (queue
depth, prefetch hits and stalls, convert time) and trace spans.  No
port flag asks for any of them.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Iterator, Optional

from ..utils import get_logger

log = get_logger("pipeline")

#: Thread-name prefix of every IO/pipeline worker thread (pipeline
#: workers, buffered/xmap reader threads); the test suite's thread-leak
#: guard keys on it.
IO_THREAD_PREFIX = "ptpu-io-"

_POLL_S = 0.05          # stop-flag poll period for blocking queue ops
_JOIN_TIMEOUT_S = 5.0   # per-thread join budget on close()


class PipelineClosed(RuntimeError):
    """Raised when the consumer keeps iterating a closed pipeline."""


class AsyncPipeline:
    """One pass's async prefetcher over an iterable of raw minibatches.

    :param batches: iterable (typically a reader generator) of raw
        minibatches for this pass.  Consumed by the worker threads,
        serialized under a lock — the iterator itself need not be
        thread-safe.
    :param convert_fn: per-batch host conversion (``feeder.convert``);
        runs on a worker thread.  None = batches are already feed dicts.
    :param place_fn: device placement for a converted feed
        (``Trainer._place_feed``); runs on the same worker thread so the
        copy is issued while the step runs.  None = no placement.
    :param depth: max batches in flight between reader and consumer.
    :param workers: reader/convert worker threads (clamped to
        ``[1, depth]``).

    Iterating the pipeline yields converted+placed feeds in reader
    order; breaking out of the loop (or an exception crossing it) closes
    it.  ``close()`` may also be called explicitly and is idempotent.
    """

    def __init__(self, batches: Iterable[Any],
                 convert_fn: Optional[Callable[[Any], Any]] = None,
                 place_fn: Optional[Callable[[Any], Any]] = None,
                 depth: int = 2, workers: int = 2,
                 name: str = "pipeline"):
        if depth < 1:
            raise ValueError(f"AsyncPipeline: depth must be >= 1, "
                             f"got {depth} (0 means: don't build one)")
        self._src = iter(batches)
        self._convert = convert_fn
        self._place = place_fn
        self.depth = depth
        self.workers = max(1, min(int(workers), depth))
        self.name = name

        self._src_lock = threading.Lock()     # serializes next(_src)
        self._cond = threading.Condition()    # guards the state below
        self._ready: dict = {}              # index -> (feed, exc|None)
        self._seq = 0                       # next index to read from src
        self._next_out = 0                  # next index the consumer wants
        self._end_at: Optional[int] = None  # src exhausted/faulted here
        self._closed = False
        # at most `depth` batches between src and consumer: a worker
        # must hold a credit to pull a batch; the consumer returns it
        self._credits = threading.Semaphore(depth)

        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{IO_THREAD_PREFIX}{name}-w{i}")
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ workers
    def _pull(self):
        """Pull (index, raw_batch) from the source, or None when the
        pipeline should wind down.  Serialized; also records source
        exhaustion/faults so peers stop pulling."""
        with self._src_lock:
            with self._cond:
                if self._closed or self._end_at is not None:
                    return None
                i = self._seq
            try:
                raw = next(self._src)
            except StopIteration:
                with self._cond:
                    if self._end_at is None:
                        self._end_at = i
                    self._cond.notify_all()
                return None
            except BaseException as exc:  # reader fault: deliver at i
                with self._cond:
                    self._ready[i] = (None, exc)
                    self._end_at = i + 1
                    self._cond.notify_all()
                return None
            with self._cond:
                self._seq = i + 1
            return i, raw

    def _worker(self) -> None:
        while True:
            # a credit bounds in-flight batches; poll so close() is
            # never stuck behind a full queue
            if not self._credits.acquire(timeout=_POLL_S):
                with self._cond:
                    if self._closed:
                        return
                continue
            item = self._pull()
            if item is None:
                self._credits.release()
                return
            i, raw = item
            try:
                feed = self._convert(raw) if self._convert else raw
                if self._place is not None:
                    feed = self._place(feed)
                out = (feed, None)
            except BaseException as exc:  # convert fault: deliver at i
                out = (None, exc)
            with self._cond:
                if self._closed:
                    return
                self._ready[i] = out
                self._cond.notify_all()

    # ----------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[Any]:
        try:
            while True:
                try:
                    yield self.get()
                except StopIteration:
                    return
        finally:
            self.close()

    def get(self) -> Any:
        """Next feed in reader order; raises StopIteration at the end,
        re-raises reader/convert faults at their position."""
        with self._cond:
            i = self._next_out
            while i not in self._ready:
                if self._end_at is not None and i >= self._end_at:
                    raise StopIteration
                if self._closed:
                    raise PipelineClosed(
                        f"pipeline {self.name!r} is closed")
                self._cond.wait(_POLL_S)
            feed, exc = self._ready.pop(i)
            self._next_out = i + 1
        self._credits.release()
        if exc is not None:
            raise exc
        return feed

    # ----------------------------------------------------------- teardown
    def close(self) -> None:
        """Stop and join every worker, then close the source iterator
        (propagating GeneratorExit through reader generator chains).
        Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._ready.clear()   # buffered batches die with the pass
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=_JOIN_TIMEOUT_S)
            if t.is_alive():  # pragma: no cover — indicates a stuck src
                log.warning("pipeline %r worker %s did not stop within "
                            "%.0fs", self.name, t.name, _JOIN_TIMEOUT_S)
        close = getattr(self._src, "close", None)
        if close is not None:
            try:
                close()
            except Exception as e:  # noqa: BLE001 — teardown best-effort
                log.debug("pipeline %r source close failed during "
                          "teardown: %s: %s", self.name,
                          type(e).__name__, e)

    def __enter__(self) -> "AsyncPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_reader(reader: Callable[[], Iterable[Any]],
                    convert_fn: Optional[Callable[[Any], Any]] = None,
                    place_fn: Optional[Callable[[Any], Any]] = None,
                    depth: int = 2, workers: int = 2,
                    name: str = "pipeline") -> Callable[[], Iterator[Any]]:
    """Wrap a reader (zero-arg callable returning an iterable) so each
    invocation runs through a fresh :class:`AsyncPipeline` — the reader
    -protocol face of the pipeline."""

    def prefetched() -> Iterator[Any]:
        # generator function: the pipeline (and its worker threads) is
        # only constructed when iteration actually starts, so a dropped
        # never-started invocation leaks nothing
        pipe = AsyncPipeline(reader(), convert_fn=convert_fn,
                             place_fn=place_fn, depth=depth,
                             workers=workers, name=name)
        try:
            yield from pipe
        finally:
            pipe.close()

    return prefetched
