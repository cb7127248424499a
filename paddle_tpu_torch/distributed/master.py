"""The master service's clients (counterpart of
``paddle_tpu/distributed/master.py``): the C++ data-task service of
``native/master/master.cc`` — leases, failure re-queue, snapshot and
recover, the save-model election, PING liveness — which both packages
drive.  ``native/`` is no file of the JAX package: it is a wire-protocol
server, and the port builds its own copy of the library from that source
with the Makefile's compiler and flags (its ``CXX`` / ``CXXFLAGS``
values, not the environment's) into the gitignored
``build/torch_master/`` at first use (rebuilt when the source is newer).

Two transports, mirroring the reference's two paths:
- in-process via ctypes (like ``go/master/c/client.go`` cgo exports used
  through ``python/paddle/v2/master/client.py``),
- TCP line protocol for multi-process trainers (replaces Go RPC + etcd
  discovery — address is passed explicitly, no external coordinator).

The TCP client, its payload escaping, the reconnect-and-replay loop
(``--master_retry_max``), the trace-context framing and the readers are
the JAX module's, with the port's named locks
(``analysis.lockorder``) and telemetry (``observe``): a master one
package serves is driven by the other's client, and back.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import queue
import random
import re
import shlex
import socket
import subprocess
import tempfile
import threading
import time
import zlib
from typing import List, Optional, Sequence, Tuple

from ..analysis.lockorder import named_lock
from ..observe import counter, gauge, trace
from ..utils import FLAGS, PaddleTpuError, enforce, get_logger

log = get_logger("master")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO, "native")
_CC = os.path.join(_NATIVE, "master", "master.cc")
_SO = os.path.join(_REPO, "build", "torch_master", "libptpu_master.so")

_lib = None
_build_lock = threading.Lock()


def _makefile_flags() -> Tuple[List[str], List[str]]:
    """``(CXX, CXXFLAGS)`` as ``native/Makefile`` sets them.  Unlike
    ``make``, the environment's ``CXX`` / ``CXXFLAGS`` do not override
    them: the library is loaded into this process, so it must be built by
    the compiler whose C++ runtime the process already uses (a machine
    whose ``CXX`` names another GCC gave a library that crashed on its
    first call)."""
    vals = {"CXX": "g++", "CXXFLAGS": ""}
    with open(os.path.join(_NATIVE, "Makefile")) as f:
        for line in f:
            m = re.match(r"^(CXX|CXXFLAGS)\s*\?=\s*(.*)$", line.strip())
            if m:
                vals[m.group(1)] = m.group(2)
    return shlex.split(vals["CXX"]), shlex.split(vals["CXXFLAGS"])


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    try:  # stale .so from an older source tree: rebuild
        return os.path.getmtime(_SO) < os.path.getmtime(_CC)
    except OSError:
        return False


def build_library() -> str:
    """Build ``native/master/master.cc`` into the port's build dir if it
    is missing or older than the source; returns the library's path.  The
    build writes a temporary file and renames it, so processes building
    at once never load a torn library."""
    with _build_lock:
        if _needs_build():
            log.info("building the native master library into %s", _SO)
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            cxx, flags = _makefile_flags()
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_SO),
                                       suffix=".so")
            os.close(fd)
            try:
                subprocess.run(cxx + flags + ["-shared", "-o", tmp, _CC],
                               check=True, capture_output=True)
                os.replace(tmp, _SO)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return _SO


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    lib.ptpu_master_create.restype = ctypes.c_void_p
    lib.ptpu_master_create.argtypes = [ctypes.c_double, ctypes.c_int,
                                       ctypes.c_char_p]
    lib.ptpu_master_destroy.argtypes = [ctypes.c_void_p]
    lib.ptpu_master_set_dataset.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    lib.ptpu_master_get_task.restype = ctypes.c_int
    lib.ptpu_master_get_task.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.ptpu_master_task_finished.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptpu_master_task_failed.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptpu_master_reset_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptpu_master_epoch.restype = ctypes.c_int
    lib.ptpu_master_epoch.argtypes = [ctypes.c_void_p]
    lib.ptpu_master_request_save_model.restype = ctypes.c_int
    lib.ptpu_master_request_save_model.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double]
    lib.ptpu_master_counts.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_int)] * 4
    lib.ptpu_master_snapshot.argtypes = [ctypes.c_void_p]
    lib.ptpu_master_serve.restype = ctypes.c_int
    lib.ptpu_master_serve.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
    _lib = lib
    return lib


class Master:
    """In-process master (``go/master/service.go`` Service equivalent)."""

    def __init__(self, timeout_s: float = 60.0, failure_max: int = 3,
                 snapshot_path: str = ""):
        self._lib = _load_lib()
        self._h = self._lib.ptpu_master_create(
            timeout_s, failure_max,
            snapshot_path.encode() if snapshot_path else None)

    def set_dataset(self, payloads: Sequence[str]) -> None:
        arr = (ctypes.c_char_p * len(payloads))(
            *[p.encode() for p in payloads])
        self._lib.ptpu_master_set_dataset(self._h, arr, len(payloads))

    def get_task(self) -> Tuple[int, Optional[str]]:
        """Returns (rc, payload): rc 0 granted / 1 wait / -1 epoch done."""
        buf = ctypes.create_string_buffer(1 << 16)
        tid = ctypes.c_int(-1)
        rc = self._lib.ptpu_master_get_task(self._h, buf, len(buf),
                                            ctypes.byref(tid))
        if rc == 0:
            return tid.value, buf.value.decode()
        return rc, None

    def task_finished(self, task_id: int) -> None:
        self._lib.ptpu_master_task_finished(self._h, task_id)

    def task_failed(self, task_id: int) -> None:
        self._lib.ptpu_master_task_failed(self._h, task_id)

    def reset_epoch(self, target_epoch: int = -1) -> None:
        """Request the start of ``target_epoch`` (pass-number handshake:
        a trainer that finished pass P asks for P+1); peers' duplicate
        requests for an already-performed reset are no-ops. ``-1`` is
        the legacy argless reset."""
        self._lib.ptpu_master_reset_epoch(self._h, target_epoch)

    def current_epoch(self) -> int:
        """Epoch counter — read on (re)connect to offset local pass
        counters against a long-lived or snapshot-recovered master."""
        return self._lib.ptpu_master_epoch(self._h)

    def request_save_model(self, trainer_id: str,
                           interval_s: float = 60.0) -> bool:
        return bool(self._lib.ptpu_master_request_save_model(
            self._h, trainer_id.encode(), interval_s))

    def counts(self) -> dict:
        vals = [ctypes.c_int() for _ in range(4)]
        self._lib.ptpu_master_counts(self._h, *[ctypes.byref(v)
                                                for v in vals])
        return dict(zip(("todo", "pending", "done", "failed"),
                        (v.value for v in vals)))

    def snapshot(self) -> None:
        self._lib.ptpu_master_snapshot(self._h)

    def serve(self, port: int = 0, bind_any: bool = False) -> int:
        """Start the TCP server (loopback by default; ``bind_any``
        listens on all interfaces for multi-host trainers); returns the
        bound port."""
        p = self._lib.ptpu_master_serve(self._h, port, int(bind_any))
        enforce(p > 0, "master serve failed")
        return p

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ptpu_master_destroy(self._h)
                self._h = None
        # modules/loggers may already be torn down under us
        except Exception:   # __del__ teardown
            pass


def _escape_payload(s: str) -> str:
    """%-escape control bytes that would break the line/tab framing
    (mirrors ``EscapePayload`` in ``native/master/master.cc``)."""
    out = []
    for ch in s:
        if ch in "%\n\r\t\x1f":
            out.append("%%%02X" % ord(ch))
        else:
            out.append(ch)
    return "".join(out)


_HEX = set("0123456789abcdefABCDEF")

# distinct jitter streams for clients created in the same process
_client_nonce = itertools.count()


def _unescape_payload(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        # decode only well-formed %XX; a literal '%' from a pre-escaping
        # master passes through untouched
        if s[i] == "%" and i + 3 <= len(s) and s[i + 1] in _HEX \
                and s[i + 2] in _HEX:
            out.append(chr(int(s[i + 1:i + 3], 16)))
            i += 3
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


class MasterClient:
    """TCP client speaking the master's line protocol (remote trainers).

    Connection loss mid-call is survived, not fatal: ``_call`` re-dials
    with exponential backoff + jitter and replays the request up to
    ``retry_max`` times (default ``--master_retry_max``).  Replay is safe
    for every op in the protocol: a GET whose response was lost leaves a
    granted-but-unheard lease that times out server-side and re-queues
    (at-least-once); SET is first-wins; FIN/FAIL on an unknown lease and
    duplicate RESET/SAVE are no-ops.  ``retry_max=0`` restores the
    legacy fail-fast contract — the first drop raises
    ``PaddleTpuError("master connection closed")``.
    """

    def __init__(self, addr: str, timeout: float = 30.0,
                 retry_max: Optional[int] = None,
                 retry_base_s: float = 0.05, retry_cap_s: float = 2.0):
        host, port = addr.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout
        self._retry_max = (FLAGS.get("master_retry_max")
                           if retry_max is None else retry_max)
        self._retry_base_s = retry_base_s
        self._retry_cap_s = retry_cap_s
        # jitter spread: every client of one master must NOT share a
        # backoff sequence or a master restart gets a reconnect stampede
        # in lockstep — mix a per-process/per-client nonce into the seed
        # (chaos tests stay deterministic via call-count triggers, not
        # jitter values)
        self._rng = random.Random(
            zlib.crc32(addr.encode()) ^ (os.getpid() << 16)
            ^ next(_client_nonce))
        self._buf = b""
        self._closed = False
        # trace-context framing capability: assumed until a master
        # answers a CTX frame with a bare ERR (pre-CTX binary) — then
        # this client stops framing so tracing never breaks the RPCs
        # it is meant to observe
        self._ctx_frames = True
        # the initial dial keeps today's fail-fast semantics: a wrong
        # address should error immediately, not burn a retry budget
        self._sock: Optional[socket.socket] = socket.create_connection(
            self._addr, timeout=timeout)

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf = b""  # a partial response from the dead socket is junk

    def _call(self, line: str, retry_override: Optional[int] = None) -> str:
        if self._closed:
            raise PaddleTpuError("master client is closed")
        retry_max = (self._retry_max if retry_override is None
                     else retry_override)
        attempt = 0
        op = line.split("\t", 1)[0]
        # one span covers the whole call incl. reconnect+replay; when
        # tracing is on the request rides a CTX frame so the master's
        # own handling comes back as a server-side span in this trace
        with trace.span("master_rpc", op=op):
            while True:
                try:
                    if self._sock is None:
                        self._sock = socket.create_connection(
                            self._addr, timeout=self._timeout)
                        self._buf = b""
                    wire = line
                    framed = False
                    if trace.enabled() and self._ctx_frames:
                        hdr = trace.parent_header()
                        if hdr:
                            wire = f"CTX\t{hdr}\t{line}"
                            framed = True
                    t_send = trace.now_us()
                    self._sock.sendall(wire.encode() + b"\n")
                    while b"\n" not in self._buf:
                        chunk = self._sock.recv(4096)
                        if not chunk:
                            raise ConnectionResetError(
                                "master closed the connection")
                        self._buf += chunk
                    resp, self._buf = self._buf.split(b"\n", 1)
                    if attempt:   # request survived via reconnect+replay
                        counter("master_replays",
                                "master RPCs completed on a replay after "
                                "reconnect").inc()
                    resp_s = resp.decode()
                    if framed and resp_s.startswith("ERR"):
                        # a pre-CTX master parsed "CTX" as the op and
                        # errored without touching state: stop framing
                        # and replay this request bare (one extra round
                        # trip, once per client)
                        from ..utils.logger import warn_once
                        self._ctx_frames = False
                        warn_once(
                            f"master_no_ctx:{self._addr}",
                            "master %s:%d predates trace-context "
                            "framing; tracing continues client-side "
                            "only (no server-side spans)", *self._addr,
                            logger=log)
                        continue
                    if resp_s.startswith("CTX\t"):
                        resp_s = self._absorb_ctx_echo(
                            resp_s, t_send, trace.now_us(), op)
                    return resp_s
                except OSError as e:  # incl. ConnectionError, timeout
                    self._drop_sock()
                    if attempt >= retry_max:
                        counter("master_giveups",
                                "master RPCs that exhausted the "
                                "reconnect budget and raised").inc()
                        raise PaddleTpuError(
                            "master connection closed") from e
                    delay = min(self._retry_cap_s,
                                self._retry_base_s * (2 ** attempt))
                    delay *= 0.5 + self._rng.random()  # jitter [0.5,1.5)
                    attempt += 1
                    counter("master_reconnects",
                            "master connection losses answered with a "
                            "re-dial (per retry attempt)").inc()
                    counter("master_backoff_seconds",
                            "total backoff slept before master re-dials"
                            ).inc(delay)
                    log.warning(
                        "master call %s failed (%s: %s); reconnect "
                        "attempt %d/%d in %.2fs", op,
                        type(e).__name__, e, attempt, retry_max, delay)
                    with trace.span("master_backoff", op=op,
                                    attempt=attempt):
                        time.sleep(delay)

    @staticmethod
    def _absorb_ctx_echo(resp: str, t_send_us: float, t_recv_us: float,
                         op: str) -> str:
        """Unwrap a ``CTX\\t<opaque>\\t<pid>\\t<us>\\t<response>`` echo
        and record the master's handling as a server-side span of the
        echoed context (clock skew sidestepped: the span is placed at
        the midpoint of the client-observed round trip, its duration is
        the server-measured one).  Anything malformed passes through
        untouched — trace framing must never corrupt the protocol."""
        try:
            _, hdr, pid_s, us_s, rest = resp.split("\t", 4)
            dur_us = float(us_s)
            server_pid = int(pid_s)
        except ValueError:
            return resp
        ctx = trace.parse_header(hdr)
        if ctx is not None:
            slack = max(0.0, (t_recv_us - t_send_us) - dur_us)
            trace.record_span(
                "master.handle", t_send_us + slack / 2.0, dur_us,
                ctx.trace_id, parent_id=ctx.span_id, pid=server_pid,
                tid=server_pid, op=op)
        return rest

    def ping(self) -> bool:
        """Cheap liveness probe (PING op; no master state touched).

        A probe must answer fast, not block through the full reconnect
        budget: at most one re-dial (to shed a dead cached socket), so
        a down master yields False in ~one connect timeout.
        """
        try:
            return self._call("PING",
                              retry_override=min(self._retry_max, 1)) \
                == "PONG"
        except PaddleTpuError:
            return False

    def set_dataset(self, payloads: Sequence[str]) -> None:
        self._call("SET\t" + "\x1f".join(_escape_payload(p)
                                         for p in payloads))

    def get_task(self) -> Tuple[int, Optional[str]]:
        resp = self._call("GET")
        if resp.startswith("OK\t"):
            _, tid, payload = resp.split("\t", 2)
            return int(tid), _unescape_payload(payload)
        return (1, None) if resp == "WAIT" else (-1, None)

    def task_finished(self, task_id: int) -> None:
        self._call(f"FIN\t{task_id}")

    def task_failed(self, task_id: int) -> None:
        self._call(f"FAIL\t{task_id}")

    def reset_epoch(self, target_epoch: int = -1) -> None:
        self._call("RESET" if target_epoch < 0 else f"RESET\t{target_epoch}")

    def current_epoch(self) -> int:
        resp = self._call("EPOCH")
        try:
            return int(resp)
        except ValueError:
            return 0  # pre-EPOCH master binary: degrade to legacy base

    def request_save_model(self, trainer_id: str,
                           interval_s: float = 60.0) -> bool:
        return self._call(f"SAVE\t{trainer_id}\t{interval_s}") == "1"

    def counts(self) -> dict:
        vals = [int(x) for x in self._call("COUNTS").split("\t")]
        return dict(zip(("todo", "pending", "done", "failed"), vals))

    def close(self) -> None:
        """Idempotent: safe to call any number of times."""
        self._closed = True
        self._drop_sock()

    def __enter__(self) -> "MasterClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def master_reader(client, load_fn, wait_sleep: float = 0.05,
                  close_client: bool = True, read_ahead: int = 0):
    """Reader pulling task payloads from a master and yielding samples —
    the ``cloud_reader`` equivalent (``python/paddle/v2/reader/creator.py:91``).

    ``load_fn(payload) -> iterable of samples``; a task is marked finished
    only after its samples were fully consumed, failed if ``load_fn``
    raises — so a dead trainer's lease times out and the shard is re-done
    elsewhere (fault tolerance, ``go/master/service.go:313``).

    When the generator is torn down *abandoned* — ``close()``d or
    garbage-collected mid-pass (GeneratorExit) — the in-flight lease is
    FAILed (immediate re-queue; peers must not WAIT out a dead lease's
    full timeout) and the client's ``close()`` is called when it has
    one, so a dropped reader never leaks its master socket.  Normal
    exhaustion and escaping load faults leave the client open: the
    returned reader is re-invocable (one call per pass) and
    poison-shard retry loops re-enter it.  Pass ``close_client=False``
    for a shared client whose lifecycle is managed elsewhere (e.g.
    ``cloud_reader``'s multi-pass wrapper — the lease FAIL on
    abandonment still happens).

    ``read_ahead > 0`` overlaps the NEXT chunk's lease + ``load_fn``
    fetch with consumption of the current one: a background thread
    leases tasks and materializes their samples into a queue at most
    ``read_ahead`` chunks deep (see :func:`_readahead_reader`).  The
    lease contract is unchanged — FIN only after the chunk's samples
    were all consumed, FAIL on a load fault or on abandonment, for
    every chunk the prefetcher holds (queued, in flight, or being
    consumed).  The client survives master reconnects mid-prefetch
    exactly as in the synchronous path (``_call`` replays).
    """

    if read_ahead > 0:
        return _readahead_reader(client, load_fn, wait_sleep,
                                 close_client, read_ahead)

    def reader():
        open_tid = None                    # leased, not yet FIN/FAILed
        try:
            while True:
                tid, payload = client.get_task()
                if payload is None:
                    if tid == 1:           # all leased elsewhere: wait
                        time.sleep(wait_sleep)
                        continue
                    break                   # epoch done
                open_tid = tid
                try:
                    for sample in load_fn(payload):
                        yield sample
                except Exception:
                    open_tid = None
                    client.task_failed(tid)
                    raise
                open_tid = None
                client.task_finished(tid)
        except GeneratorExit:
            try:
                if open_tid is not None:   # re-queue the abandoned shard
                    client.task_failed(open_tid)
            except Exception as e:  # noqa: BLE001 — teardown best-effort
                log.debug("abandoned-shard FAIL for task %s lost: %s: %s",
                          open_tid, type(e).__name__, e)
            if close_client:
                close = getattr(client, "close", None)
                if close is not None:
                    close()
            raise

    return reader


def _readahead_reader(client, load_fn, wait_sleep: float,
                      close_client: bool, depth: int):
    """``master_reader`` with chunk read-ahead: a background thread
    leases the next task and materializes its samples while the trainer
    consumes the current chunk, so shard fetch (network/disk IO in
    ``load_fn``) overlaps training instead of stalling each chunk
    boundary.

    Lease lifecycle is identical to the synchronous path, just tracked
    for every chunk the prefetcher holds: FIN after the chunk's last
    sample was consumed; FAIL on a load fault (which then re-raises in
    the consumer, so retry loops re-enter the reader) and on
    abandonment — a torn-down generator FAILs the chunk being consumed
    AND every prefetched-but-unconsumed chunk, so peers re-lease them
    immediately instead of waiting out the server-side timeout.  All
    client calls (two threads share one socket) are serialized under a
    lock; master reconnects inside ``_call`` replay as usual, so the
    prefetcher rides through connection drops.

    Note: a prefetched chunk's lease ages while it waits in the queue —
    keep ``read_ahead × chunk-train-time`` well under the master's
    lease ``timeout_s`` or leases re-queue spuriously (at-least-once
    still holds; samples may train twice).
    """
    from ..data.pipeline import IO_THREAD_PREFIX
    from ..data.reader import _put_until

    _End = object()
    depth_gauge = gauge(
        "cloud_readahead_depth",
        "prefetched chunks waiting in the cloud reader's read-ahead "
        "queue")
    chunk_counter = counter(
        "cloud_readahead_chunks_total",
        "chunks fetched by the cloud reader's read-ahead thread")

    def reader():
        out_q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()
        error: List[BaseException] = []
        call_lock = named_lock("master.readahead.call")  # one socket, two threads
        tids_lock = named_lock("master.readahead.tids")
        open_tids: set = set()         # leased, not yet FIN/FAILed
        # the fetcher adopts the consuming pass's trace context so its
        # lease RPCs + chunk loads land in that trace, not a fresh one
        trace_ctx = trace.current_context()

        def _put(item) -> bool:
            return _put_until(out_q, item, stop)

        def fetcher():
            with trace.context_scope(trace_ctx):
                _fetch_loop()

        def _fetch_loop():
            try:
                while not stop.is_set():
                    with call_lock:
                        tid, payload = client.get_task()
                    if payload is None:
                        if tid == 1:           # all leased elsewhere
                            time.sleep(wait_sleep)
                            continue
                        break                  # epoch done
                    with tids_lock:
                        open_tids.add(tid)
                    try:
                        with trace.span("master_load_chunk", task=tid):
                            samples = list(load_fn(payload))
                    except Exception as exc:   # shard fault: re-queue,
                        with tids_lock:        # then re-raise consumer-
                            open_tids.discard(tid)  # side
                        with call_lock:
                            client.task_failed(tid)
                        error.append(exc)
                        break
                    chunk_counter.inc()
                    if not _put((tid, samples)):
                        return                 # consumer gone
                    depth_gauge.set(out_q.qsize())
            except BaseException as exc:  # noqa: BLE001 — incl. RPC
                error.append(exc)         # giveups: consumer re-raises
            finally:
                _put(_End)

        t = threading.Thread(target=fetcher, daemon=True,
                             name=IO_THREAD_PREFIX + "cloud-readahead")
        t.start()
        abandoned = False
        try:
            while True:
                item = out_q.get()
                if item is _End:
                    if error:
                        raise error[0]
                    return
                tid, samples = item
                depth_gauge.set(out_q.qsize())
                for sample in samples:
                    yield sample
                with call_lock:
                    client.task_finished(tid)  # fully consumed
                with tids_lock:
                    open_tids.discard(tid)
        except GeneratorExit:
            abandoned = True
            raise
        finally:
            stop.set()
            t.join(timeout=5.0)
            with tids_lock:
                leftovers = sorted(open_tids)
                open_tids.clear()
            for tid in leftovers:   # re-queue: consumed-not-FINed chunk
                try:                # + every prefetched-unconsumed one
                    with call_lock:
                        client.task_failed(tid)
                except Exception as e:  # noqa: BLE001 — best-effort
                    log.debug("read-ahead FAIL for task %s lost during "
                              "teardown: %s: %s", tid,
                              type(e).__name__, e)
            if abandoned and close_client:
                close = getattr(client, "close", None)
                if close is not None:
                    close()

    return reader
