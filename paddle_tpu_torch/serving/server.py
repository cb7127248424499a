"""Continuous-batching inference server over the paged-KV decode kernel
(counterpart of ``paddle_tpu/serving/server.py``).

Request lifecycle — admission → prefill → continuous-batch decode loop:

1. **Admission**: :meth:`InferenceServer.submit` enqueues a request;
   the decode thread admits from the queue *between decode steps*
   whenever a batch slot AND enough free KV pages exist.  Each request
   reserves ``prompt + max_new_tokens`` worth of pages up front from the
   shared :class:`~paddle_tpu_torch.serving.pagepool.PagePool`, so pool
   exhaustion is admission backpressure, never a mid-decode failure.
2. **Prefill**: every request admitted in the same round runs in ONE
   packed prefill (one ``prefill_attention_packed`` launch per layer),
   which writes the prompt K/V into the request's pages and yields the
   first generated token — the TTFT moment.
3. **Decode loop**: one ``paged_decode_attention`` step per iteration
   over a fixed-width batch (``--serve_max_batch``; inactive slots point
   at the scratch page).  Finished requests retire at step boundaries
   and their pages recycle at once.

``--serve_continuous=false`` degrades the same loop to sequential
single-request serving (admit one, run to completion, batch width 1);
both modes generate byte-identical tokens.

Not ported yet: hot-swap rollout, SLO reporting and telemetry.  The
decode and HTTP threads are named ``ptpu-serve-torch-*``.
"""

from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import FLAGS, enforce, get_logger, warn_once
from .model import DecoderModel
from .pagepool import PagePool, PagePoolExhausted, SCRATCH_PAGE, TornSnapshot

log = get_logger("serving")

#: Decode-loop thread name.
DECODE_THREAD_NAME = "ptpu-serve-torch-decode"
#: HTTP front-end thread name.
HTTP_THREAD_NAME = "ptpu-serve-torch-http"

_LOOPBACK_HOSTS = ("", "127.0.0.1", "localhost", "::1")
_REQ_IDS = itertools.count()


class Request:
    """One generation request and its lifecycle state.  ``tokens`` holds
    the generated ids (prompt excluded); ``length`` counts tokens whose
    K/V is already written to this request's pages."""

    __slots__ = ("id", "prompt", "max_new_tokens", "tokens", "state",
                 "error", "done", "length", "next_token",
                 "t_submit", "t_first", "t_done")

    def __init__(self, prompt: Sequence[int], max_new_tokens: int):
        self.id = f"req{next(_REQ_IDS)}"
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.tokens: List[int] = []
        self.state = "queued"            # queued|active|done|failed
        self.error: Optional[str] = None
        self.done = threading.Event()
        self.length = 0                  # tokens materialized in pages
        self.next_token = -1             # token to feed the next step
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit


class InferenceServer:
    """The continuous-batching decode loop around a
    :class:`~paddle_tpu_torch.serving.model.DecoderModel` and a
    :class:`~paddle_tpu_torch.serving.pagepool.PagePool`."""

    def __init__(self, model: DecoderModel,
                 max_batch: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 continuous: Optional[bool] = None,
                 snapshot_path: Optional[str] = None):
        self.model = model
        self.max_batch = int(FLAGS.get("serve_max_batch")
                             if max_batch is None else max_batch)
        n_pages = int(FLAGS.get("kv_pool_pages")
                      if n_pages is None else n_pages)
        page_size = int(FLAGS.get("kv_page_size")
                        if page_size is None else page_size)
        self.continuous = bool(FLAGS.get("serve_continuous")
                               if continuous is None else continuous)
        enforce(self.max_batch >= 1,
                f"serve_max_batch must be >= 1, got {self.max_batch}")
        self.snapshot_path = snapshot_path
        self.pool = self._make_pool(n_pages, page_size, snapshot_path)
        self._k_pool, self._v_pool = model.new_pools(n_pages, page_size)
        # one page-table width for every request: enough pages to cover
        # a max_context-long sequence (or the whole pool if smaller)
        self.max_pages = min(self.pool.capacity,
                             self.pool.pages_needed(model.cfg.max_context))
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._active: List[Request] = []
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.served = 0
        self.generated_tokens = 0

    @staticmethod
    def _make_pool(n_pages: int, page_size: int,
                   snapshot_path: Optional[str]) -> PagePool:
        """Fresh pool, or crash recovery from a prior snapshot: a valid
        snapshot restores and then RELEASES every orphaned table (the KV
        content died with the previous process); a torn one is refused
        and replaced by a fresh pool."""
        if snapshot_path:
            try:
                pool = PagePool.restore(snapshot_path)
            except FileNotFoundError:
                pool = None
            except TornSnapshot as e:
                log.warning("pool snapshot refused (%s); starting fresh", e)
                pool = None
            if pool is not None:
                enforce(pool.n_pages == n_pages
                        and pool.page_size == page_size,
                        f"pool snapshot geometry {pool.n_pages}x"
                        f"{pool.page_size} != configured {n_pages}x"
                        f"{page_size}")
                for owner in pool.owners():
                    pool.release(owner)
                pool.verify()
                return pool
        return PagePool(n_pages, page_size)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "InferenceServer":
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name=DECODE_THREAD_NAME, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)
        self.stop_http()
        # unblock every waiter; their requests will never run
        with self._cond:
            pending = list(self._queue) + list(self._active)
            self._queue.clear()
            self._active = []
        for r in pending:
            self.pool.release(r.id)
            r.state = "failed"
            r.error = "server stopped"
            r.done.set()

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- clients
    def submit(self, prompt: Sequence[int],
               max_new_tokens: int = 16) -> Request:
        """Enqueue a generation request; returns immediately.  Rejects
        (raises) only what could NEVER run: an empty prompt, a sequence
        longer than ``max_context``, or a page-table need beyond the
        whole pool — a merely-busy pool is backpressure, not an error."""
        enforce(len(prompt) >= 1, "empty prompt")
        enforce(max_new_tokens >= 1,
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        total = len(prompt) + max_new_tokens
        enforce(total <= self.model.cfg.max_context,
                f"prompt + max_new_tokens = {total} exceeds max_context "
                f"{self.model.cfg.max_context}")
        enforce(self.pool.pages_needed(total) <= self.max_pages,
                f"request needs {self.pool.pages_needed(total)} pages, "
                f"page tables hold {self.max_pages}")
        vocab = self.model.cfg.vocab
        enforce(all(0 <= int(t) < vocab for t in prompt),
                f"prompt token out of range [0, {vocab})")
        r = Request(prompt, max_new_tokens)
        with self._cond:
            enforce(not self._stop, "server is stopped")
            self._queue.append(r)
            self._cond.notify_all()
        return r

    def result(self, r: Request, timeout: Optional[float] = None
               ) -> List[int]:
        """Block until a request finishes; returns its generated token
        ids (prompt excluded)."""
        if not r.done.wait(timeout):
            raise TimeoutError(f"{r.id}: no result within {timeout}s")
        if r.state != "done":
            raise RuntimeError(f"{r.id}: {r.error or r.state}")
        return list(r.tokens)

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 timeout: Optional[float] = None) -> List[int]:
        return self.result(self.submit(prompt, max_new_tokens), timeout)

    def stats(self) -> Dict[str, int]:
        with self._cond:
            q, a = len(self._queue), len(self._active)
        return {"queue_depth": q, "active": a,
                "free_pages": self.pool.free_pages(),
                "used_pages": self.pool.used_pages(),
                "served": self.served,
                "generated_tokens": self.generated_tokens,
                "continuous": int(self.continuous),
                "max_batch": self.max_batch}

    # ---------------------------------------------------------- decode loop
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop and not self._queue \
                        and not self._active:
                    self._cond.wait(0.05)
                if self._stop:
                    return
                admitted = self._admit_locked()
            try:
                changed = bool(admitted)
                if admitted:
                    self._prefill(admitted)
                if self._active:
                    self._decode_step()
                    changed = True
            except Exception as e:  # noqa: BLE001 - one bad batch must
                # not kill the serve loop: fail its requests, recycle
                # their pages, keep serving the queue
                log.exception("decode loop error; failing %d in-flight "
                              "request(s)", len(self._active))
                with self._cond:
                    failed, self._active = self._active, []
                for r in failed:
                    self.pool.release(r.id)
                    r.state = "failed"
                    r.error = f"{type(e).__name__}: {e}"
                    r.done.set()
                changed = True
            if changed and self.snapshot_path:
                self.pool.snapshot(self.snapshot_path)

    def _admit_locked(self) -> List[Request]:
        """Move requests queue → active while a batch slot and enough
        free pages exist.  Sequential mode admits one request only when
        the batch is empty — single-request serving."""
        cap = self.max_batch if self.continuous else 1
        admitted: List[Request] = []
        while self._queue and len(self._active) + len(admitted) < cap:
            r = self._queue[0]
            try:
                self.pool.alloc(r.id, len(r.prompt) + r.max_new_tokens)
            except PagePoolExhausted:
                break            # backpressure: retry after retires
            self._queue.popleft()
            r.state = "active"
            self._active.append(r)
            admitted.append(r)
        return admitted

    def _table_row(self, r: Request) -> List[int]:
        t = self.pool.table_of(r.id)
        return t + [SCRATCH_PAGE] * (self.max_pages - len(t))

    def _prefill(self, admitted: List[Request]) -> None:
        """One packed prefill for every request admitted this round;
        produces each request's first generated token (TTFT)."""
        b = len(admitted)
        t_pad = max(len(r.prompt) for r in admitted)
        # bucket the pad length to a multiple of 16 tokens
        t_pad = -(-t_pad // 16) * 16
        t_pad = min(t_pad, self.model.cfg.max_context)
        tokens = np.zeros((b, t_pad), np.int32)
        lengths = np.zeros((b,), np.int32)
        tables = np.zeros((b, self.max_pages), np.int32)
        for i, r in enumerate(admitted):
            tokens[i, :len(r.prompt)] = r.prompt
            lengths[i] = len(r.prompt)
            tables[i] = self._table_row(r)
        nxt, _, self._k_pool, self._v_pool = self.model.prefill(
            self._k_pool, self._v_pool, tokens, lengths, tables)
        now = time.perf_counter()
        for i, r in enumerate(admitted):
            r.length = len(r.prompt)
            r.t_first = now
            self._emit_token(r, int(nxt[i]))

    def _decode_step(self) -> None:
        """Advance every active request one token in one fixed-width
        decode step; retire finished requests at the step boundary."""
        slots = list(self._active)
        b = self.max_batch if self.continuous else 1
        enforce(len(slots) <= b,
                f"active {len(slots)} exceeds batch width {b}")
        tokens = np.zeros((b,), np.int32)
        lengths = np.ones((b,), np.int32)
        active = np.zeros((b,), bool)
        tables = np.full((b, self.max_pages), SCRATCH_PAGE, np.int32)
        for i, r in enumerate(slots):
            tokens[i] = r.next_token
            lengths[i] = r.length + 1    # feeding one new token
            active[i] = True
            tables[i] = self._table_row(r)
        nxt, _, self._k_pool, self._v_pool = self.model.decode(
            self._k_pool, self._v_pool, tokens, tables, lengths, active)
        for i, r in enumerate(slots):
            r.length += 1
            self._emit_token(r, int(nxt[i]))

    def _emit_token(self, r: Request, token: int) -> None:
        """Record one generated token; finish the request on EOS or the
        token budget, releasing its pages for immediate recycling."""
        r.tokens.append(token)
        r.next_token = token
        self.generated_tokens += 1
        if token == self.model.cfg.eos_id \
                or len(r.tokens) >= r.max_new_tokens:
            self._finish(r)

    def _finish(self, r: Request) -> None:
        r.t_done = time.perf_counter()
        r.state = "done"
        self.pool.release(r.id)
        with self._cond:
            if r in self._active:
                self._active.remove(r)
            self._cond.notify_all()
        self.served += 1
        r.done.set()

    # --------------------------------------------------------- HTTP front
    def start_http(self, port: Optional[int] = None) -> int:
        """Serve ``POST /v1/generate`` + ``GET /healthz`` on
        ``--serve_bind`` (loopback unless explicitly set).  Returns the
        bound port."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        port = int(FLAGS.get("serve_port")) if port is None else int(port)
        host = str(FLAGS.get("serve_bind")).strip()
        if host in _LOOPBACK_HOSTS:
            host = host or "127.0.0.1"
        else:
            warn_once(f"nonloopback_bind:{host}",
                      "--serve_bind=%s serves beyond loopback: no auth, "
                      "no TLS", host, logger=log)
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name=HTTP_THREAD_NAME, daemon=True)
        self._http_thread.start()
        bound = self._httpd.server_address[1]
        log.info("serving endpoint on http://%s:%d (/v1/generate /healthz)",
                 host, bound)
        return bound

    def stop_http(self) -> None:
        httpd, self._httpd = self._httpd, None
        t, self._http_thread = self._http_thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if t is not None:
            t.join(timeout=5.0)


def _make_handler(server: InferenceServer):
    class _Handler(BaseHTTPRequestHandler):
        server_version = "paddle-tpu-torch-serving"

        def _send(self, code: int, payload: Dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self) -> None:  # noqa: N802 - stdlib API
            if self.path.split("?", 1)[0].rstrip("/") == "/healthz":
                self._send(200, dict(server.stats(), status="ok"))
            else:
                self._send(404, {"error": "unknown path",
                                 "paths": ["/v1/generate", "/healthz"]})

        def do_POST(self) -> None:  # noqa: N802 - stdlib API
            if self.path.split("?", 1)[0].rstrip("/") != "/v1/generate":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                req = server.submit(body["prompt"],
                                    int(body.get("max_new_tokens", 16)))
                tokens = server.result(req, timeout=60.0)
                self._send(200, {"id": req.id, "tokens": tokens,
                                 "ttft_ms": round(req.ttft_s * 1e3, 3),
                                 "latency_ms": round(
                                     req.latency_s * 1e3, 3)})
            except BrokenPipeError:      # client hung up mid-response
                pass
            except Exception as e:  # noqa: BLE001 - a bad request must
                self._send(400, {"error": str(e)})  # never kill serving

        def log_message(self, fmt: str, *args) -> None:
            log.debug("http %s", fmt % args)

    return _Handler
