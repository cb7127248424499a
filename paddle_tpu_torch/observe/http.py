"""Live observability endpoint: ``/metrics`` + ``/healthz`` +
``/trace`` (counterpart of ``paddle_tpu/observe/http.py``).

A stdlib ``http.server`` thread (name ``ptpu-metrics-http``) behind
``--metrics_port`` makes a live run scrapeable without the JSONL sinks:

- ``GET /metrics``  — Prometheus exposition text: the typed registry +
  the ``StatSet`` timer table
  (:func:`paddle_tpu_torch.observe.prometheus_dump`);
- ``GET /healthz``  — liveness JSON (``{"status": "ok", ...}`` with pid
  and uptime), for load-balancer / k8s probes;
- ``GET /trace``    — the flight recorder as a Chrome trace-event JSON
  array, loadable directly in Perfetto — "what were the last N spans of
  this live run" without attaching a debugger;
- ``GET /slo`` — the SLO engine's fresh evaluation
  (:mod:`paddle_tpu_torch.observe.slo`), and with an engine ``/healthz``
  carries its ``slo`` digest (a standing breach reads ``degraded``);
  without ``--slo`` ``/slo`` answers 404 and ``/healthz`` has no ``slo``
  field;
- ``GET /roofline`` and ``/health`` — the reference's reports of its
  cost model and training-health observatory, which come with queue
  A10b: they answer 404 with the reference's text — exactly what a JAX
  process that never loaded those modules answers — and ``/healthz``
  carries no ``health`` field.

The handler resolves the engine and the observatories through
``sys.modules`` at request time, as the reference does.

Nothing here imports torch.  Starting the server does NOT enable
tracing: the first ``/trace`` request flips on ring-only recording
(``trace.ensure_ring``) — an opt-in at scrape time, so a run that only
serves ``/metrics`` never pays the step fence.  With neither
``--metrics_port`` nor ``--trace_jsonl`` configured no thread starts
and the hot-path instrumentation stays no-op.

The handler never raises into the serving loop (telemetry never kills
— a scrape that fails returns 500 with the error text), binds loopback
by default (metrics are not an external API; ``--metrics_bind`` is an
explicit, loudly-warned opt-in for same-host/container scraping on a
trusted network — see :func:`resolve_bind_host`, which the inference
server's front end shares), and every request runs on a short-lived
daemon thread (``ThreadingHTTPServer``), so a slow scraper cannot wedge
the trainer.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..analysis.lockorder import named_lock
from . import trace
from .report import prometheus_dump

#: Serve-loop thread name (the tests' thread-leak guards key on it).
SERVER_THREAD_NAME = "ptpu-metrics-http"

#: Addresses that stay within the host (no warning needed).
_LOOPBACK_HOSTS = ("", "127.0.0.1", "localhost", "::1")


class _ThreadingHTTPServerV6(ThreadingHTTPServer):
    address_family = socket.AF_INET6


def make_threading_server(host: str, port: int,
                          handler) -> ThreadingHTTPServer:
    """A ``ThreadingHTTPServer`` bound to ``host:port``, picking the
    address family from the host spelling — ``ThreadingHTTPServer`` is
    AF_INET by default, so an IPv6 host (``::1``, ``::``) would always
    fail to bind and silently disable the endpoint it serves."""
    cls = _ThreadingHTTPServerV6 if ":" in host else ThreadingHTTPServer
    return cls((host, port), handler)


def resolve_bind_host(flag_name: str) -> str:
    """Resolve a bind-address flag (``metrics_bind`` /
    ``serve_bind``): empty keeps the loopback default; anything else
    is an EXPLICIT opt-in (cross-container scraping on a trusted
    network) and logs a loud structured warning — these endpoints are
    diagnostics, not an external API (no auth, no TLS, free trace and
    metric disclosure to anyone who can connect)."""
    from ..utils import FLAGS
    from ..utils.logger import get_logger, warn_once

    host = str(FLAGS.get(flag_name)).strip()
    if host in _LOOPBACK_HOSTS:
        return host or "127.0.0.1"
    warn_once(
        f"nonloopback_bind:{flag_name}:{host}",
        "--%s=%s binds a telemetry endpoint BEYOND loopback: this is "
        "a diagnostics surface, NOT an external API — no auth, no "
        "TLS; metrics, traces and health detail are readable by "
        "anyone who can reach the port.  Keep it inside a trusted "
        "network boundary (pod/network-policy), never on a public "
        "interface", flag_name, host, logger=get_logger("observe"))
    return host


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-observe"

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(200, prometheus_dump(),
                           "text/plain; version=0.0.4")
            elif path == "/healthz":
                payload = {
                    "status": "ok", "pid": os.getpid(),
                    "uptime_s": round(
                        time.monotonic() - self.server.t0, 3),
                    "trace_enabled": trace.enabled(),
                    "trace_spans_dropped": trace.dropped_count(),
                }
                # the sys.modules probe keeps the legacy-probe path
                # byte-identical when the health observatory never ran
                # this process (nothing imported, nothing computed)
                hmod = sys.modules.get("paddle_tpu_torch.observe.health")
                if hmod is not None:
                    payload["health"] = hmod.status_summary()
                    # degraded-but-ALIVE: detail degrades, the HTTP
                    # code stays 200 — never invite a kill
                    payload["status"] = payload["health"]["status"]
                # same discipline for the SLO engine: --slo unset →
                # module never imported → byte-identical body
                smod = sys.modules.get("paddle_tpu_torch.observe.slo")
                eng = smod.active_engine() if smod is not None else None
                if eng is not None:
                    digest = eng.frame_digest()
                    payload["slo"] = digest
                    if digest["status"] == "breach" \
                            and payload["status"] == "ok":
                        payload["status"] = "degraded"
                self._send(200, json.dumps(payload), "application/json")
            elif path == "/slo":
                smod = sys.modules.get("paddle_tpu_torch.observe.slo")
                eng = smod.active_engine() if smod is not None else None
                if eng is None:
                    self._send(404, json.dumps(
                        {"error": "no SLO engine configured (set "
                                  "--slo 'metric:p99<0.5:60s')"}),
                        "application/json")
                else:
                    # FRESH evaluation — scrape-time truth, matching
                    # /metrics semantics (the reporter-interval cadence
                    # still drives the gauges and fleet frames)
                    self._send(200, json.dumps(eng.status_doc()),
                               "application/json")
            elif path == "/trace":
                # lazy opt-in: the FIRST /trace request enables
                # ring-only recording — fence-free (trace.fences_steps
                # stays False), so a probe of this endpoint never
                # converts the trainer's async dispatch into per-step
                # device syncs; a run only ever scraped for /metrics
                # never records at all
                trace.ensure_ring()
                self._send(200, trace.flight_recorder_json(),
                           "application/json")
            elif path == "/roofline":
                cmod = sys.modules.get("paddle_tpu_torch.observe.costmodel")
                report = cmod.latest_report() if cmod is not None \
                    else None
                if report is None:
                    self._send(404, json.dumps(
                        {"error": "no roofline report yet (run a "
                                  "--roofline_dump pass or a bench "
                                  "lane first)"}), "application/json")
                else:
                    self._send(200, json.dumps(report),
                               "application/json")
            elif path == "/health":
                hmod = sys.modules.get("paddle_tpu_torch.observe.health")
                report = hmod.latest_report() if hmod is not None \
                    else None
                if report is None:
                    self._send(404, json.dumps(
                        {"error": "no training-health report yet "
                                  "(enable --health_interval N)"}),
                        "application/json")
                else:
                    self._send(200, json.dumps(report),
                               "application/json")
            else:
                self._send(404, json.dumps(
                    {"error": "unknown path",
                     "paths": ["/metrics", "/healthz", "/trace",
                               "/roofline", "/health", "/slo"]}),
                    "application/json")
        except BrokenPipeError:      # scraper hung up mid-response
            pass
        except Exception as e:       # noqa: BLE001 — never kill serving
            try:
                self._send(500, f"observability handler error: {e}\n",
                           "text/plain")
            except OSError:
                pass

    def log_message(self, fmt: str, *args) -> None:
        from ..utils.logger import get_logger

        get_logger("observe.http").debug("http %s", fmt % args)


class ObservabilityServer:
    """The ``/metrics`` + ``/healthz`` + ``/trace`` + ``/roofline`` +
    ``/health`` server thread."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = make_threading_server(host, port, _Handler)
        self._httpd.daemon_threads = True
        self._httpd.t0 = time.monotonic()
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ObservabilityServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name=SERVER_THREAD_NAME, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            self._httpd.shutdown()
            t.join(timeout=5.0)
        self._httpd.server_close()

    def __enter__(self) -> "ObservabilityServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


_global: Optional[ObservabilityServer] = None
_global_lock = named_lock("observe.http.global")


def start_from_flags() -> Optional[ObservabilityServer]:
    """Start the process-wide endpoint iff ``--metrics_port`` > 0
    (port 0 disables; use :class:`ObservabilityServer` directly for an
    ephemeral-port server in tests).  Idempotent.  A port that cannot
    be bound warns once and leaves the process running — telemetry
    never kills the run it observes."""
    global _global
    from ..utils import FLAGS
    from ..utils.logger import get_logger, warn_once

    port = int(FLAGS.get("metrics_port"))
    if port <= 0:
        return _global
    with _global_lock:
        if _global is None:
            host = resolve_bind_host("metrics_bind")
            try:
                _global = ObservabilityServer(port, host=host).start()
            except OSError as e:
                warn_once(
                    f"metrics_port_bind_failed:{port}",
                    "--metrics_port %d could not be bound (%s); the "
                    "observability endpoint is OFF for this run",
                    port, e, logger=get_logger("observe"))
                return None
            get_logger("observe").info(
                "observability endpoint on http://%s:%d "
                "(/metrics /healthz /trace /roofline /health /slo)",
                host, _global.port)
    return _global


def serving() -> bool:
    """True iff the process-wide observability endpoint is live —
    samplers that only matter when someone can scrape them (the
    trainer's pass-boundary HBM gauges) key on this together with
    ``observe.active()``."""
    return _global is not None


def stop_global() -> None:
    global _global
    with _global_lock:
        srv, _global = _global, None
    if srv is not None:
        srv.stop()
