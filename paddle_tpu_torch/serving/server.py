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

Telemetry (``observe/``, the JAX server's names): the spans
``serve_admit``, ``serve_prefill`` and ``serve_decode_step``; the
histograms ``serve_ttft_seconds``, ``serve_request_seconds`` and
``serve_request_failures`` (failed requests as unit events); the
counters ``serve_requests`` and ``serve_tokens_generated``; the gauges
``serve_batch_size``, ``serve_queue_depth`` and (``pagepool.py``)
``serve_page_pool_pages``.  The admission condition is
``named_condition("serve.admission")`` for the lock-order checker, and
the front end is built by ``observe.http.make_threading_server`` on
``resolve_bind_host("serve_bind")``.

Hot swap (``--rollout``, default on; ``serving/rollout.py`` is the
pipeline around it): :meth:`InferenceServer.request_swap` parks a built
replacement model as a :class:`SwapTicket`, and the decode loop applies
it at a step boundary — ``drain`` pauses admission and flips once the
in-flight requests finished on the old model, ``reprefill`` flips at
once and restarts them from the prompt on the new one — so every
response's tokens come from exactly one model.  The flip stands up the
new model's pools and rolls back if that fails; it sets
``rollout_swap_total``, ``rollout_swap_pause_seconds`` and
``rollout_model_version``.  ``model_version``, ``rollout_state`` and
``last_swap_error`` join :meth:`InferenceServer.stats` and ``/healthz``,
and ``POST /v1/swap`` runs the whole pipeline (500 with the rolled-back
report).  ``--rollout=false`` is the kill switch: no swap surface, and
``stats()``, ``/healthz`` and the 404 body keep their pre-rollout bytes.
``--serve_slo_ms`` > 0 adds the windowed ``ttft_p99_ms`` and
``slo_met``.  With rollout on, the model version and rollout state are
published into the fleet identity (``observe.fleet.set_serving_info``),
so every frame this process pushes carries them.  The decode and HTTP
threads are named
``ptpu-serve-torch-*``.
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

from ..analysis.lockorder import named_condition
from ..observe import REGISTRY, counter, fleet, gauge, histogram, trace
from ..observe.http import make_threading_server, resolve_bind_host
from ..utils import FLAGS, enforce, get_logger
from .model import DecoderModel
from .pagepool import PagePool, PagePoolExhausted, SCRATCH_PAGE, TornSnapshot

log = get_logger("serving")

#: Decode-loop thread name.
DECODE_THREAD_NAME = "ptpu-serve-torch-decode"
#: HTTP front-end thread name.
HTTP_THREAD_NAME = "ptpu-serve-torch-http"

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


class SwapTicket:
    """A pending hot swap: the fully built replacement model plus the
    handshake back to the requester.  ``event`` fires once the decode
    loop has applied (or rolled back) the swap; ``report`` then holds
    the outcome — ``result`` (``ok``/``rolled_back``), the flip's
    ``pause_s``, and which in-flight requests were re-prefilled."""

    __slots__ = ("model", "version", "inflight", "exported_at",
                 "event", "report")

    def __init__(self, model: DecoderModel, version: str, inflight: str,
                 exported_at: Optional[float]):
        self.model = model
        self.version = version
        self.inflight = inflight
        self.exported_at = exported_at
        self.event = threading.Event()
        self.report: Dict = {"result": "pending", "version": version,
                             "inflight": inflight}

    def wait(self, timeout: Optional[float] = None) -> Dict:
        if not self.event.wait(timeout):
            raise TimeoutError(f"swap to {self.version[:12]} not applied "
                               f"within {timeout}s")
        return dict(self.report)


class InferenceServer:
    """The continuous-batching decode loop around a
    :class:`~paddle_tpu_torch.serving.model.DecoderModel` and a
    :class:`~paddle_tpu_torch.serving.pagepool.PagePool`, with the hot
    swap of the module docstring."""

    def __init__(self, model: DecoderModel,
                 max_batch: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 continuous: Optional[bool] = None,
                 snapshot_path: Optional[str] = None,
                 rollout: Optional[bool] = None,
                 model_version: str = "unversioned",
                 model_exported_at: Optional[float] = None):
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
        self._cond = named_condition("serve.admission")
        self._queue: collections.deque = collections.deque()
        self._active: List[Request] = []
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.served = 0
        self.generated_tokens = 0
        self.rollout_enabled = bool(FLAGS.get("rollout")
                                    if rollout is None else rollout)
        self.model_version = model_version
        self.model_exported_at = model_exported_at
        self.rollout_state = "serving"     # serving|swapping|rolled_back
        self.last_swap_error: Optional[str] = None
        self._pending_swap: Optional[SwapTicket] = None

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
            self._publish_serving_info()
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
            swap, self._pending_swap = self._pending_swap, None
        for r in pending:
            self.pool.release(r.id)
            r.state = "failed"
            r.error = "server stopped"
            r.done.set()
        if swap is not None:       # a parked swap never applies now
            swap.report.update(result="rolled_back", error="server stopped")
            swap.event.set()

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
            self._publish_queue_locked()
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
            rollout = None
            if self.rollout_enabled:
                rollout = {"model_version": self.model_version,
                           "model_exported_at": self.model_exported_at,
                           "rollout_state": self.rollout_state,
                           "last_swap_error": self.last_swap_error}
        out = {"queue_depth": q, "active": a,
               "free_pages": self.pool.free_pages(),
               "used_pages": self.pool.used_pages(),
               "served": self.served,
               "generated_tokens": self.generated_tokens,
               "continuous": int(self.continuous),
               "max_batch": self.max_batch}
        if rollout is not None:
            # gated on the kill switch: --rollout=false keeps stats()
            # (and with it /healthz) byte-identical to the pre-rollout
            # server
            out.update(rollout)
        slo_ms = float(FLAGS.get("serve_slo_ms") or 0.0)
        if slo_ms > 0:
            # the WINDOWED p99 (last 60 s), not the lifetime reservoir:
            # a recovered server stops advertising a stale bad p99
            h = REGISTRY.find("serve_ttft_seconds")
            p99 = h.window_quantile(0.99, 60.0) \
                if h is not None and hasattr(h, "window_quantile") \
                else None
            out["ttft_p99_ms"] = None if p99 is None \
                else round(p99 * 1e3, 3)
            out["slo_met"] = int(p99 is None or p99 * 1e3 <= slo_ms)
        return out

    # ------------------------------------------------------------ hot swap
    def request_swap(self, model: DecoderModel,
                     version: str = "unversioned",
                     inflight: Optional[str] = None,
                     exported_at: Optional[float] = None) -> SwapTicket:
        """Park a fully built replacement model for the decode loop to
        apply at its next step boundary; returns the
        :class:`SwapTicket` to ``wait()`` on.  The model must already be
        built, verified and probed — this method does no loading
        (``rollout.swap_from_artifact`` is the whole pipeline)."""
        enforce(self.rollout_enabled,
                "rollout disabled (--rollout=false): request_swap refused")
        inflight = str(FLAGS.get("rollout_inflight")
                       if inflight is None else inflight)
        enforce(inflight in ("drain", "reprefill"),
                f"unknown in-flight policy {inflight!r} "
                "(expected 'drain' or 'reprefill')")
        # the same architecture is the contract (continuous training
        # swaps weights, not shapes): pools and page tables carry over
        # only because the config is identical
        enforce(model.cfg == self.model.cfg,
                f"swap model config {model.cfg} != serving config "
                f"{self.model.cfg}")
        ticket = SwapTicket(model, version, inflight, exported_at)
        with self._cond:
            enforce(not self._stop, "server is stopped")
            enforce(self._pending_swap is None,
                    "a swap is already in progress")
            self._pending_swap = ticket
            self.rollout_state = "swapping"
            ticket.report["inflight_at_request"] = len(self._active)
            self._cond.notify_all()
        self._publish_serving_info()
        return ticket

    def record_swap_failure(self, reason: str) -> None:
        """Record a swap that failed before a ticket was parked (the
        artifact's verify, load or probe, on the caller's thread).  The
        old model keeps serving; ``/healthz`` carries the reason."""
        with self._cond:
            self.rollout_state = "rolled_back"
            self.last_swap_error = reason
        self._publish_serving_info()

    def _apply_swap_locked(self, ticket: SwapTicket) -> List[Request]:
        """Apply a parked swap at the decode loop's step boundary
        (``_cond`` held).  Returns the in-flight requests to re-prefill
        on the new model (``reprefill``; empty under ``drain``, which
        only gets here with no actives).  Failing to stand up the new
        pools rolls back: the old model and pools were never
        unhooked."""
        t0 = time.perf_counter()
        old_version = self.model_version
        try:
            k_pool, v_pool = ticket.model.new_pools(self.pool.n_pages,
                                                    self.pool.page_size)
        except Exception as e:  # noqa: BLE001 - roll back, keep serving
            self._pending_swap = None
            self.rollout_state = "rolled_back"
            self.last_swap_error = f"pool standup: {type(e).__name__}: {e}"
            ticket.report.update(result="rolled_back",
                                 error=self.last_swap_error)
            counter("rollout_swap_total",
                    "hot-swap attempts by outcome").inc(
                result="rolled_back")
            log.error("swap to %s rolled back (%s)", ticket.version[:12],
                      self.last_swap_error)
            ticket.event.set()
            return []
        reprefill: List[Request] = []
        if ticket.inflight == "reprefill" and self._active:
            # restart in-flight generation from the prompt on the NEW
            # model: drop every old-model token (exactly-one-model),
            # keep the page tables — the fresh pools get the prompt
            # K/V from the re-prefill
            for r in self._active:
                r.tokens.clear()
                r.length = 0
                r.next_token = -1
                r.t_first = None
            reprefill = list(self._active)
            ticket.report["reprefilled"] = [r.id for r in reprefill]
        self.model = ticket.model
        self._k_pool, self._v_pool = k_pool, v_pool
        self.model_version = ticket.version
        self.model_exported_at = ticket.exported_at
        self.rollout_state = "serving"
        self.last_swap_error = None
        self._pending_swap = None
        pause_s = time.perf_counter() - t0
        ticket.report.update(result="ok", pause_s=pause_s)
        counter("rollout_swap_total",
                "hot-swap attempts by outcome").inc(result="ok")
        histogram("rollout_swap_pause_seconds",
                  "decode-loop pause for the atomic pointer flip "
                  "(pool standup + in-flight bookkeeping; the model "
                  "build/verify/probe ran off-thread)").observe(pause_s)
        g = gauge("rollout_model_version",
                  "1 for the live artifact digest, 0 for retired ones "
                  "(info gauge keyed by digest label)")
        if old_version:
            g.set(0.0, digest=old_version)
        g.set(1.0, digest=ticket.version)
        log.info("hot-swapped model %s -> %s (pause %.1f ms, %d "
                 "re-prefilled)", old_version[:12], ticket.version[:12],
                 pause_s * 1e3, len(reprefill))
        ticket.event.set()
        return reprefill

    def _publish_serving_info(self) -> None:
        """Push model version + rollout state into the fleet identity so
        every frame this process pushes carries them (``/fleet/topology``
        and the ``--watch`` version column)."""
        if not self.rollout_enabled:
            return
        fleet.set_serving_info(version=self.model_version,
                               state=self.rollout_state,
                               exported_at=self.model_exported_at,
                               error=self.last_swap_error)

    # ---------------------------------------------------------- decode loop
    def _loop(self) -> None:
        while True:
            swapped = False
            with self._cond:
                while not self._stop and not self._queue \
                        and not self._active \
                        and self._pending_swap is None:
                    self._cond.wait(0.05)
                if self._stop:
                    return
                reprefill: List[Request] = []
                pending = self._pending_swap
                if pending is not None and (pending.inflight == "reprefill"
                                            or not self._active):
                    # the pointer flip, at the step boundary: drain
                    # flips once the actives emptied, reprefill flips now
                    # and restarts them below
                    reprefill = self._apply_swap_locked(pending)
                    pending = None
                    swapped = True
                # a pending drain swap pauses admission: new requests
                # first-run on the NEW model, and the flip waits for the
                # actives to finish on the old one
                admitted = [] if pending is not None \
                    else self._admit_locked()
            if swapped:
                self._publish_serving_info()
            try:
                batch = reprefill + admitted
                changed = bool(batch)
                if batch:
                    with trace.span("serve_prefill", n=len(batch)):
                        self._prefill(batch)
                if self._active:
                    with trace.span("serve_decode_step",
                                    batch=len(self._active)):
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
                    # unit events: window_rate = failures/s
                    histogram("serve_request_failures",
                              "failed requests as unit events "
                              "(windowed rate = failures/sec)"
                              ).observe(1.0)
                changed = True
            if changed and self.snapshot_path:
                self.pool.snapshot(self.snapshot_path)

    def _admit_locked(self) -> List[Request]:
        """Move requests queue → active while a batch slot and enough
        free pages exist.  Sequential mode admits one request only when
        the batch is empty — single-request serving."""
        cap = self.max_batch if self.continuous else 1
        admitted: List[Request] = []
        with trace.span("serve_admit", queued=len(self._queue)):
            while self._queue and len(self._active) + len(admitted) < cap:
                r = self._queue[0]
                try:
                    self.pool.alloc(r.id,
                                    len(r.prompt) + r.max_new_tokens)
                except PagePoolExhausted:
                    break            # backpressure: retry after retires
                self._queue.popleft()
                r.state = "active"
                self._active.append(r)
                admitted.append(r)
        if admitted:
            self._publish_queue_locked()
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
        # testing knob: a seeded-slow artifact (manifest
        # debug_prefill_delay_ms) inflates TTFT here, inside the stamp,
        # so a canary bake has a latency regression to detect; the swap
        # probe calls model.prefill directly and never pays it
        delay = self.model.debug_prefill_delay_s
        if delay:
            time.sleep(delay)
        nxt, _, self._k_pool, self._v_pool = self.model.prefill(
            self._k_pool, self._v_pool, tokens, lengths, tables)
        now = time.perf_counter()
        for i, r in enumerate(admitted):
            r.length = len(r.prompt)
            r.t_first = now
            histogram("serve_ttft_seconds",
                      "submit-to-first-token latency").observe(
                now - r.t_submit)
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
        gauge("serve_batch_size",
              "requests in the most recent inference launch").set(
            len(slots))
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
        counter("serve_tokens_generated",
                "tokens generated across requests").inc()
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
        histogram("serve_request_seconds",
                  "submit-to-last-token latency").observe(r.latency_s)
        counter("serve_requests", "requests served").inc()
        r.done.set()

    def _publish_queue_locked(self) -> None:
        gauge("serve_queue_depth",
              "requests waiting for admission").set(len(self._queue))

    # --------------------------------------------------------- HTTP front
    def start_http(self, port: Optional[int] = None) -> int:
        """Serve ``POST /v1/generate`` + ``GET /healthz`` on
        ``--serve_bind`` (loopback unless explicitly opted out, the
        trust rule of ``--metrics_bind``).  Returns the bound port."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        port = int(FLAGS.get("serve_port")) if port is None else int(port)
        host = resolve_bind_host("serve_bind")
        self._httpd = make_threading_server(host, port, _make_handler(self))
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
                # /v1/swap exists only with rollout on: the kill switch
                # keeps this body byte-identical to pre-rollout
                paths = ["/v1/generate", "/healthz"]
                if server.rollout_enabled:
                    paths.append("/v1/swap")
                self._send(404, {"error": "unknown path", "paths": paths})

        def _do_swap(self) -> None:
            """POST /v1/swap {"artifact": dir[, "inflight": policy]
            [, "reason": text]}: the whole pipeline (verify → load →
            probe → flip) on this handler thread; 500 carries a
            rolled-back report."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                from . import rollout as _rollout
                report = _rollout.swap_from_artifact(
                    server, body["artifact"],
                    inflight=body.get("inflight"))
                ok = report.get("result") in ("ok", "unchanged")
                if ok and body.get("reason"):
                    # a coordinator-driven rollback swap succeeded; its
                    # reason (a failed canary bake) lands on /healthz
                    server.record_swap_failure(str(body["reason"]))
                    report = dict(report, reason=str(body["reason"]))
                self._send(200 if ok else 500, report)
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001 - a bad request must
                self._send(400, {"error": str(e)})  # never kill serving

        def do_POST(self) -> None:  # noqa: N802 - stdlib API
            path = self.path.split("?", 1)[0].rstrip("/")
            if path == "/v1/swap" and server.rollout_enabled:
                self._do_swap()
                return
            if path != "/v1/generate":
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
