"""Reader creators and combinators (counterpart of
``paddle_tpu/data/reader.py``).

The v2 functional reader stack (``python/paddle/v2/reader/decorator.py``:
map_readers, shuffle, chain, compose, buffered, firstn, xmap_readers;
``creator.py``: np_array, text_file), plus ``cache``, ``batch`` and
``mix_readers``.  A *reader* is a zero-arg callable returning an
iterable of samples, so user reader code carries over unchanged.
``shuffle`` draws from ``random.Random(seed)`` as the reference does, so
one seed gives both packages the same order.

``recordio`` reads the record files of :mod:`.recordio` (pickled
samples, as :func:`.download.convert` writes them); ``cloud_reader``
refuses by name: the master-leased reader waits for queue A9.
"""

from __future__ import annotations

import itertools
import queue
import random
import threading
from typing import Any, Callable, Iterable, List

from ..utils import PaddleTpuError, get_logger
from .pipeline import IO_THREAD_PREFIX

Reader = Callable[[], Iterable[Any]]


def _put_until(q: "queue.Queue", item: Any, stop: threading.Event,
               poll_s: float = 0.05) -> bool:
    """``q.put`` that gives up when ``stop`` is set — a producer thread
    must never stay blocked against a full queue after its consumer
    abandoned the generator.  Returns False when it gave up."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll_s)
            return True
        except queue.Full:
            continue
    return False


def _close_iter(it: Any) -> None:
    """Close a (possibly generator) iterator, best-effort: propagates
    GeneratorExit through reader chains so their teardown runs
    deterministically instead of waiting on GC."""
    close = getattr(it, "close", None)
    if close is not None:
        try:
            close()
        except Exception as e:  # noqa: BLE001 — teardown is best-effort
            get_logger("reader").debug(
                "iterator close failed during teardown: %s: %s",
                type(e).__name__, e)


def np_array(x) -> Reader:
    def reader():
        for row in x:
            yield row

    return reader


def text_file(path: str) -> Reader:
    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def map_readers(func: Callable, *readers: Reader) -> Reader:
    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return reader


def shuffle(reader: Reader, buf_size: int, seed: int = None) -> Reader:
    def shuffled():
        rng = random.Random(seed)
        buf: List[Any] = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers: Reader) -> Reader:
    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers: Reader, check_alignment: bool = True) -> Reader:
    """Zip readers into tuple samples (flattening tuple components)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        if check_alignment:
            for items in zip(*[r() for r in readers]):
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in itertools.zip_longest(*[r() for r in readers]):
                yield sum((make_tuple(i) for i in items if i is not None), ())

    return reader


def buffered(reader: Reader, size: int) -> Reader:
    """Double-buffering via a background thread (the reference's
    double-buffer queue, ``DataProvider.h:360``).

    A consumer that abandons the generator mid-pass (break / ``close()``
    / GC → GeneratorExit) shuts the producer down and joins it: the
    producer must not stay blocked on ``q.put`` against a full queue
    forever (the classic thread leak), and the inner reader is closed so
    its own teardown (lease FAILs, socket closes) runs.
    """

    class _End:
        pass

    def buffered_reader():
        q: "queue.Queue" = queue.Queue(maxsize=size)

        error: List[BaseException] = []
        stop = threading.Event()

        def producer():
            it = None
            try:
                # inside the try: a reader that raises EAGERLY (before
                # returning its iterable) must still reach the consumer
                it = iter(reader())
                for e in it:
                    if not _put_until(q, e, stop):
                        return               # consumer gone
            except BaseException as exc:  # re-raised in the consumer
                error.append(exc)
            finally:
                if it is not None:
                    _close_iter(it)
                _put_until(q, _End, stop)

        t = threading.Thread(target=producer, daemon=True,
                             name=IO_THREAD_PREFIX + "buffered")
        t.start()
        try:
            while True:
                e = q.get()
                if e is _End:
                    if error:
                        raise error[0]
                    break
                yield e
        finally:
            stop.set()
            t.join(timeout=5.0)

    return buffered_reader


def firstn(reader: Reader, n: int) -> Reader:
    def reader_n():
        return itertools.islice(reader(), n)

    return reader_n


def cache(reader: Reader) -> Reader:
    """Materialize once, then replay from memory (pass-in-memory cache,
    ``PyDataProvider2.cpp:70``)."""
    data: List[Any] = []
    filled = [False]

    def cached():
        if not filled[0]:
            fresh: List[Any] = []  # discarded if this pass stops early
            for e in reader():
                fresh.append(e)
                yield e
            data[:] = fresh
            filled[0] = True
        else:
            yield from data

    return cached


def xmap_readers(mapper: Callable, reader: Reader, process_num: int,
                 buffer_size: int, order: bool = False) -> Reader:
    """Parallel map over a reader with worker threads (reference uses
    threads too — CPython-level parallelism for IO/numpy work).

    Fault contract: an exception in ``mapper`` or in the feed thread is
    caught, recorded, and re-raised in the consumer — the dying thread
    still delivers its ``_End`` so the consumer never blocks forever on
    ``out_q.get()``.  A consumer that abandons
    the generator mid-pass shuts down and joins the threads.
    """

    class _End:
        pass

    def xreader():
        in_q: "queue.Queue" = queue.Queue(buffer_size)
        out_q: "queue.Queue" = queue.Queue(buffer_size)
        error: List[BaseException] = []
        stop = threading.Event()

        def feed():
            it = None
            try:
                # inside the try: an eagerly-raising reader must still
                # deliver the _End markers below, or the consumer wedges
                it = iter(reader())
                for i, e in enumerate(it):
                    if not _put_until(in_q, (i, e), stop):
                        return               # consumer gone
            except BaseException as exc:  # re-raised in the consumer
                error.append(exc)
            finally:
                if it is not None:
                    _close_iter(it)
                # every worker gets its end marker even when the source
                # died mid-pass — a missing _End wedges the consumer
                for _ in range(process_num):
                    if not _put_until(in_q, _End, stop):
                        return

        def work():
            try:
                while True:
                    try:
                        item = in_q.get(timeout=0.05)
                    except queue.Empty:
                        if stop.is_set():
                            return
                        continue
                    if item is _End:
                        _put_until(out_q, _End, stop)
                        return
                    i, e = item
                    if not _put_until(out_q, (i, mapper(e)), stop):
                        return
            except BaseException as exc:  # re-raised in the consumer
                error.append(exc)
                _put_until(out_q, _End, stop)

        threads = [threading.Thread(target=feed, daemon=True,
                                    name=IO_THREAD_PREFIX + "xmap-feed")]
        threads += [threading.Thread(target=work, daemon=True,
                                     name=f"{IO_THREAD_PREFIX}xmap-w{i}")
                    for i in range(process_num)]
        for t in threads:
            t.start()
        try:
            finished = 0
            if order:
                pending = {}
                next_i = 0
                while finished < process_num:
                    if error:     # fault: stop draining NOW, not after
                        raise error[0]   # the rest of the stream maps
                    item = out_q.get()
                    if item is _End:
                        finished += 1
                        continue
                    i, e = item
                    pending[i] = e
                    while next_i in pending:
                        yield pending.pop(next_i)
                        next_i += 1
                if error:
                    raise error[0]
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
            else:
                while finished < process_num:
                    if error:
                        raise error[0]
                    item = out_q.get()
                    if item is _End:
                        finished += 1
                        continue
                    yield item[1]
                if error:
                    raise error[0]
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)

    return xreader


def batch(reader: Reader, batch_size: int, drop_last: bool = True) -> Reader:
    """Group samples into lists (``paddle.v2.minibatch.batch``).

    drop_last defaults True, as in the JAX package: every batch has one
    shape.
    """

    def batch_reader():
        b = []
        for e in reader():
            b.append(e)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


# ------------------------------------------------- recordio-backed creators

def recordio(paths, buf_size: int = 100) -> Reader:
    """Reader over chunked record files written by
    :func:`.download.convert` / :class:`.recordio.Writer`
    (``creator.py:60``): ``paths`` a comma-separated string or a list,
    globs expanded in sorted order; each record a pickled sample, the
    reference's convention for these framework-written caches."""
    import pickle

    from . import recordio as rio

    def reader():
        for rec in rio.reader(paths):
            yield pickle.loads(rec)

    return buffered(reader, buf_size)


def cloud_reader(paths, master, buf_size: int = 64,
                 read_ahead: int = 2) -> Reader:
    """Not ported: the master-coordinated reader (``distributed/``)
    waits for queue A9."""
    raise PaddleTpuError(
        "data.reader.cloud_reader is not ported yet: the master-leased "
        "distributed reader waits for queue A9")


def mix_readers(readers, ratios=None, main: int = 0) -> Reader:
    """Ratio-weighted mixing of sample streams — the
    ``MultiDataProvider`` capability (``MultiDataProvider.cpp:79-117``):
    each pass interleaves samples from every reader in proportion to its
    ratio; the pass ends when the *main* reader is exhausted, while the
    other readers restart transparently (the reference resets non-main
    sub-providers mid-pass).

    :param readers: list of readers.
    :param ratios: per-reader positive weights (``data_ratio``);
        defaults to uniform.
    :param main: index of the main reader (``is_main_data``).
    """
    ratios = list(ratios) if ratios is not None else [1.0] * len(readers)
    if len(ratios) != len(readers):
        raise ValueError("mix_readers: one ratio per reader required")
    if any(r <= 0 for r in ratios):
        raise ValueError("mix_readers: ratios must be positive")
    if not 0 <= main < len(readers):
        raise ValueError(
            f"mix_readers: main index {main} out of range for "
            f"{len(readers)} readers")

    def reader():
        iters = [iter(r()) for r in readers]
        # error-accumulator interleave: at every step pull from the
        # stream whose emitted count is furthest below its ratio share;
        # shares are maintained incrementally (O(n_readers) per sample,
        # no per-sample re-summation)
        counts = [0] * len(readers)
        total = sum(ratios)
        shares = [r / total for r in ratios]
        step = 0
        while True:
            step += 1
            i = max(range(len(readers)),
                    key=lambda j: shares[j] * step - counts[j])
            try:
                sample = next(iters[i])
            except StopIteration:
                if i == main:
                    return            # main stream exhausted: pass ends
                iters[i] = iter(readers[i]())   # non-main: restart
                try:
                    sample = next(iters[i])
                except StopIteration:
                    raise ValueError(
                        f"mix_readers: reader {i} is empty")
            counts[i] += 1
            yield i, sample

    return reader
