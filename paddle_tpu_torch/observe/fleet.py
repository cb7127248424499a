"""Fleet observatory: the cross-process telemetry plane (counterpart of
``paddle_tpu/observe/fleet.py``).

Every process observes itself (``/metrics``, ``/healthz``, ``/trace``,
the JSONL sinks, cross-process trace ids); a real run is a cluster —
master, N elastic trainers, serving replicas — each its own pane of
glass.  This module is the plane that merges them:

- **Aggregator** (:class:`FleetAggregator`, ``--fleet_port``): a
  stdlib-only HTTP service any process can host — the
  ``ThreadingHTTPServer`` discipline of :mod:`paddle_tpu_torch.observe.
  http` (daemon handler threads, telemetry-never-kills, loopback bind
  unless explicitly opted out).  Endpoints:

  - ``POST /fleet/push``   — frame intake (see below);
  - ``GET /fleet/metrics`` — every registered process's metric families
    merged into ONE Prometheus exposition, each sample labeled with the
    pushing process's ``role`` / ``pid`` / ``node`` / ``proc`` identity;
  - ``GET /fleet/healthz`` — the cluster rollup: per-process
    ok / degraded / **missing** / down, with staleness detection — a
    process that has not pushed for ``--fleet_stale_factor`` × its own
    advertised interval flips to ``missing``; a restarted process
    (same logical id, new pid) flips it back;
  - ``GET /fleet/trace``   — spans from ALL processes merged by their
    already-propagated trace ids into ONE Chrome trace-event document
    with per-process lanes (``process_name`` metadata events) —
    loadable directly in Perfetto;
  - ``GET /fleet/topology``— who is registered: role, pid, node,
    uptime, frames received, last push, the serving model version.

- **Push client** (:class:`FleetPusher`, ``--fleet_addr host:port``):
  driven by :class:`paddle_tpu_torch.observe.report.MetricsReporter` —
  on the reporter interval each process pushes ONE self-describing
  frame: its metrics snapshot, the flight-recorder spans recorded since
  the last acknowledged push, and a health digest.  Registration is
  implicit in every frame (role / pid / node / logical id), so a
  restarted process re-registers by simply pushing again.

- **Live console**: ``python -m paddle_tpu_torch.observe.fleet --watch
  host:port`` renders per-process step/s, input-bound ratio, HBM peak,
  health status and last-seen age from a running aggregator;
  ``python -m paddle_tpu_torch.observe.fleet --fleet_port N`` hosts a
  standalone aggregator.

The frame's schema is the JAX package's, key for key, so a port process
pushes to a JAX aggregator and the other way round.

Failure semantics: **telemetry never kills** — a dead/unreachable
aggregator marks the push sink degraded (warn-once) and backs off
exponentially with per-client jitter, the trainer never notices; a peer
speaking a different dialect (bare-ERR body, version-skew ``schema``
rejection) degrades the sink exactly like a failing JSONL flush; a later
successful push clears the state.  With ``--fleet_addr`` unset nothing
here runs: no thread, no socket, no write.

Nothing in this module imports torch — the frame payload is the same
self-describing JSON the ``--metrics_jsonl`` sink writes, and the
aggregator renders merged Prometheus text from those snapshots without
ever touching live metric objects.
"""

from __future__ import annotations

import argparse
import collections
import http.client
import json
import os
import random
import signal
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis.lockorder import named_lock
from . import trace
from .metrics import REGISTRY, _label_key, format_labels

#: Frame/protocol schema this build speaks.  An aggregator rejects
#: frames from a NEWER schema with a structured 400 (the pusher
#: degrades, the run continues); older frames are accepted as-is.
FLEET_SCHEMA = 1

#: Aggregator serve-loop thread name (conftest thread-leak guard entry).
AGGREGATOR_THREAD_NAME = "ptpu-fleet-http"

#: Spans a single frame may carry; older unsent spans beyond this are
#: acknowledged as dropped on the frame itself (``spans_dropped``) —
#: a slow interval must not grow frames without bound.
MAX_SPANS_PER_FRAME = 1000

_DOWN = "down"
_MISSING = "missing"
_DEGRADED = "degraded"
_OK = "ok"

# ------------------------------------------------------------ identity
# Role/logical-name a subsystem claims for this process.  Flags give
# the defaults; the elastic trainer (trainer_id), the serving loader
# and bench override programmatically.  The pusher reads this at frame
# build time, so an identity set after the reporter started still
# lands on the next frame.
_identity_lock = named_lock("observe.fleet.identity")
_identity: Dict[str, str] = {}


def set_identity(role: Optional[str] = None,
                 name: Optional[str] = None,
                 node: Optional[str] = None) -> None:
    """Claim this process's fleet identity (role ∈ trainer |
    master-client | serving | bench by convention; free-form).  Unset
    fields keep their flag/derived defaults."""
    with _identity_lock:
        if role:
            _identity["role"] = str(role)
        if name:
            _identity["name"] = str(name)
        if node:
            _identity["node"] = str(node)


def reset_identity() -> None:
    """Drop programmatic identity overrides (tests)."""
    with _identity_lock:
        _identity.clear()
    with _serving_lock:
        _serving_info.clear()


# Serving-plane info a replica publishes alongside its identity: model
# version (artifact digest + export time) and rollout state.  Rides
# every frame as the optional "serving" field (additive — schema 1
# aggregators that predate it simply ignore the key).
_serving_lock = named_lock("observe.fleet.serving")
_serving_info: Dict[str, Any] = {}


def set_serving_info(version: Optional[str] = None,
                     state: Optional[str] = None,
                     exported_at: Optional[float] = None,
                     error: Optional[str] = None) -> None:
    """Publish this process's served-model version + rollout state
    (``serving/server.py`` calls this at start and at every swap /
    rollback); lands on the next pushed frame."""
    with _serving_lock:
        if version is not None:
            _serving_info["model_version"] = str(version)
        _serving_info["rollout_state"] = str(state or "serving")
        _serving_info["exported_at"] = exported_at
        _serving_info["swap_error"] = error


def serving_info() -> Dict[str, Any]:
    """This process's published serving info (``{}`` when it never
    loaded a model — trainers and exporters push no serving field)."""
    with _serving_lock:
        return dict(_serving_info)


def identity() -> Dict[str, str]:
    """The resolved (role, name, node) triple this process pushes as.
    ``name`` is the *logical* id staleness tracking keys on: stable
    across restarts when set (``--fleet_id`` / trainer_id), else
    derived from role+node+pid (a restart then registers as a new
    process and the old entry ages out as ``missing``)."""
    from ..utils import FLAGS

    with _identity_lock:
        ident = dict(_identity)
    role = ident.get("role") or str(FLAGS.get("fleet_role")) or "trainer"
    node = ident.get("node") or socket.gethostname()
    name = ident.get("name") or str(FLAGS.get("fleet_id")) \
        or f"{role}@{node}:{os.getpid()}"
    return {"role": role, "name": name, "node": node}


def local_health_digest() -> Dict[str, Any]:
    """This process's own health summary — the ``/healthz`` body logic,
    reused as the frame's ``health`` field (training-health observatory
    resolved through ``sys.modules`` so a run that never enabled it
    pays nothing)."""
    digest: Dict[str, Any] = {"status": _OK,
                              "trace_enabled": trace.enabled()}
    hmod = sys.modules.get("paddle_tpu_torch.observe.health")
    if hmod is not None:
        digest["health"] = hmod.status_summary()
        digest["status"] = digest["health"]["status"]
    return digest


# --------------------------------------------------------------- state
class FleetFrameError(ValueError):
    """A push body that is not a fleet frame at all."""


class FleetSchemaError(ValueError):
    """A frame from a NEWER protocol than this aggregator speaks."""


class FleetState:
    """The aggregator's model of the cluster — pure bookkeeping, no IO.

    Injectable ``clock`` (monotonic seconds) so staleness math is unit-
    testable with a fake clock, no sleeps.  Thread-safe: handler
    threads ingest concurrently with rollup/metrics scrapes."""

    def __init__(self, stale_factor: Optional[float] = None,
                 ring_size: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ..utils import FLAGS

        self.stale_factor = float(FLAGS.get("fleet_stale_factor")
                                  if stale_factor is None else stale_factor)
        self.ring_size = int(FLAGS.get("fleet_ring_size")
                             if ring_size is None else ring_size)
        self._clock = clock
        self._lock = named_lock("observe.fleet.state")
        self._procs: Dict[str, Dict[str, Any]] = {}
        self._spans: Dict[str, "collections.deque"] = {}

    # ------------------------------------------------------------ intake
    @staticmethod
    def _span_key(e: Dict[str, Any]) -> Tuple:
        args = e.get("args") or {}
        sid = args.get("span_id")
        if sid:
            return (e.get("pid"), sid)
        return (e.get("pid"), e.get("tid"), e.get("ts"), e.get("dur"),
                e.get("name"))

    def ingest(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Fold one pushed frame in; returns the ack body.  Raises
        :class:`FleetFrameError` / :class:`FleetSchemaError` on a body
        that must be refused (the HTTP layer maps them to 400)."""
        if not isinstance(frame, dict) or "schema" not in frame:
            raise FleetFrameError("not a fleet frame (no schema field)")
        try:
            schema = int(frame["schema"])
        except (TypeError, ValueError):
            raise FleetFrameError("non-integer schema field")
        if schema > FLEET_SCHEMA:
            raise FleetSchemaError(
                f"frame schema {schema} is newer than this aggregator "
                f"(speaks <= {FLEET_SCHEMA}); upgrade the aggregator")
        pid = int(frame.get("pid") or 0)
        role = str(frame.get("role") or "proc")
        name = str(frame.get("name") or f"{role}:{pid}")
        now = self._clock()
        spans = frame.get("spans") or []
        with self._lock:
            prev = self._procs.get(name)
            restarted = prev is not None and prev["pid"] != pid
            entry = {
                "role": role, "pid": pid,
                "node": str(frame.get("node") or "?"),
                "name": name,
                "interval_s": float(frame.get("interval_s") or 10.0),
                "seq": int(frame.get("seq") or 0),
                "uptime_s": float(frame.get("uptime_s") or 0.0),
                "going_down": bool(frame.get("going_down")),
                "health": frame.get("health")
                if isinstance(frame.get("health"), dict) else {},
                "metrics": frame.get("metrics")
                if isinstance(frame.get("metrics"), list) else [],
                "timers": frame.get("timers")
                if isinstance(frame.get("timers"), list) else [],
                "last_push": now,
                "first_seen": now if (prev is None or restarted)
                else prev["first_seen"],
                "frames": 1 if (prev is None or restarted)
                else prev["frames"] + 1,
                "restarts": (prev.get("restarts", 0) + 1)
                if restarted else (prev or {}).get("restarts", 0),
                "spans_dropped": int(frame.get("spans_dropped") or 0)
                + (0 if (prev is None or restarted)
                   else prev.get("spans_dropped", 0)),
                "serving": frame.get("serving")
                if isinstance(frame.get("serving"), dict) else {},
                "slo": frame.get("slo")
                if isinstance(frame.get("slo"), dict) else {},
            }
            self._procs[name] = entry
            # a restart KEEPS the predecessor incarnation's spans (the
            # ring bounds them): "what was trainer-0 doing before it
            # died" is exactly what the merged timeline is for, and
            # span pids are real so the lanes stay distinct
            dq = self._spans.get(name)
            if dq is None:
                dq = self._spans[name] = collections.deque(
                    maxlen=max(1, self.ring_size))
            if spans:
                known = {self._span_key(e) for e in dq}
                for e in spans:
                    if not isinstance(e, dict):
                        continue
                    k = self._span_key(e)
                    if k not in known:
                        known.add(k)
                        dq.append(e)
            n_procs = len(self._procs)
        # aggregator's own telemetry — OUTSIDE the state lock (lock
        # hygiene: never nest observe.metric under observe.fleet.state)
        from .metrics import counter, gauge

        counter("fleet_frames_total",
                "fleet frames ingested by the hosted aggregator").inc(
            role=role)
        gauge("fleet_procs",
              "processes currently registered with the hosted "
              "aggregator").set(n_procs)
        return {"ok": True, "schema": FLEET_SCHEMA, "procs": n_procs,
                "name": name}

    # ----------------------------------------------------------- rollup
    def _proc_status(self, e: Dict[str, Any], now: float) -> str:
        if e["going_down"]:
            return _DOWN
        age = now - e["last_push"]
        if age > self.stale_factor * max(e["interval_s"], 1e-3):
            return _MISSING
        status = str(e["health"].get("status", _OK))
        if status not in (_OK, _DEGRADED):
            return _DEGRADED
        # a standing SLO breach marks the process degraded — the
        # breached objective is named in the rollup entry
        if status == _OK and (e.get("slo") or {}).get("status") == "breach":
            return _DEGRADED
        return status

    def rollup(self) -> Dict[str, Any]:
        """The ``/fleet/healthz`` body: per-process status + cluster
        verdict.  ``missing`` dominates ``degraded`` dominates ``ok``;
        a clean ``down`` (final going-down frame received) is reported
        but does not degrade the cluster — a SIGKILLed process never
        says goodbye, which is exactly how the two cases differ."""
        now = self._clock()
        with self._lock:
            items = [(name, dict(e)) for name, e in self._procs.items()]
        procs: Dict[str, Any] = {}
        counts = {_OK: 0, _DEGRADED: 0, _MISSING: 0, _DOWN: 0}
        for name, e in sorted(items):
            st = self._proc_status(e, now)
            counts[st] += 1
            procs[name] = {
                "role": e["role"], "pid": e["pid"], "node": e["node"],
                "status": st,
                "last_push_age_s": round(now - e["last_push"], 3),
                "interval_s": e["interval_s"],
                "stale_after_s": round(
                    self.stale_factor * max(e["interval_s"], 1e-3), 3),
                "seq": e["seq"], "uptime_s": round(e["uptime_s"], 3),
                "restarts": e["restarts"],
            }
            slo = e.get("slo") or {}
            if slo:
                procs[name]["slo"] = str(slo.get("status", "?"))
                if slo.get("breached"):
                    # name WHICH objective degraded this process
                    procs[name]["slo_breached"] = list(slo["breached"])
        if counts[_MISSING]:
            status = _MISSING
        elif counts[_DEGRADED]:
            status = _DEGRADED
        elif procs:
            status = _OK
        else:
            status = "empty"
        return {"status": status, "pid": os.getpid(),
                "schema": FLEET_SCHEMA,
                "stale_factor": self.stale_factor,
                "counts": counts, "procs": procs}

    def topology(self) -> Dict[str, Any]:
        """The ``/fleet/topology`` body: who is registered, since when,
        last push."""
        now = self._clock()
        with self._lock:
            items = [(name, dict(e)) for name, e in self._procs.items()]
            span_counts = {name: len(dq)
                           for name, dq in self._spans.items()}
        procs = {}
        for name, e in sorted(items):
            procs[name] = {
                "role": e["role"], "pid": e["pid"], "node": e["node"],
                "registered_age_s": round(now - e["first_seen"], 3),
                "last_push_age_s": round(now - e["last_push"], 3),
                "uptime_s": round(e["uptime_s"], 3),
                "frames": e["frames"], "seq": e["seq"],
                "restarts": e["restarts"],
                "spans_held": span_counts.get(name, 0),
                "spans_dropped": e["spans_dropped"],
                "going_down": e["going_down"],
                # the process's own LAST-PUSHED health verdict —
                # distinct from the rollup's liveness status (a
                # missing process keeps its last-known health here)
                "health": str(e["health"].get("status", "?")),
            }
            serving = e.get("serving") or {}
            if serving:
                # the rollout plane: artifact digest + export time +
                # swap state, straight off the replica's frames — what
                # the rolling coordinator and --watch version column read
                procs[name]["model_version"] = serving.get(
                    "model_version", "?")
                procs[name]["rollout_state"] = serving.get(
                    "rollout_state", "?")
                procs[name]["model_exported_at"] = serving.get(
                    "exported_at")
                if serving.get("swap_error"):
                    procs[name]["swap_error"] = serving["swap_error"]
                # windowed serving signals: what the canary
                # bake compares across replicas
                if serving.get("ttft_p99_s") is not None:
                    procs[name]["ttft_p99_s"] = serving["ttft_p99_s"]
                if serving.get("error_rate_s") is not None:
                    procs[name]["error_rate_s"] = serving["error_rate_s"]
            slo = e.get("slo") or {}
            if slo:
                procs[name]["slo"] = str(slo.get("status", "?"))
                if slo.get("breached"):
                    procs[name]["slo_breached"] = list(slo["breached"])
        return {"schema": FLEET_SCHEMA, "pid": os.getpid(),
                "procs": procs}

    # ---------------------------------------------------------- metrics
    def merged_prometheus(self) -> str:
        """Every process's snapshot rendered as ONE Prometheus
        exposition, samples labeled ``role``/``pid``/``node``/``proc``.
        Families keep their original names; the TYPE/HELP header is
        emitted once per family (first pusher's description wins; a
        name that arrives as a different type from another process is
        skipped with a comment — a name means one thing fleet-wide,
        same rule as the in-process registry)."""
        with self._lock:
            items = [(name, dict(e)) for name, e in
                     sorted(self._procs.items())]
        fams: Dict[str, Dict[str, Any]] = {}
        skipped: List[str] = []
        for name, e in items:
            extra = {"role": e["role"], "pid": e["pid"],
                     "node": e["node"], "proc": name}
            for m in e["metrics"]:
                if not isinstance(m, dict) or "name" not in m:
                    continue
                fam = fams.setdefault(
                    m["name"], {"type": m.get("type", "gauge"),
                                "help": m.get("help", ""),
                                "lines": [], "qlines": []})
                if fam["type"] != m.get("type", "gauge"):
                    skipped.append(f"{m['name']} from {name}: type "
                                   f"{m.get('type')} != {fam['type']}")
                    continue
                self._render_family(fam, m, extra)
        out: List[str] = []
        for fname in sorted(fams):
            fam = fams[fname]
            if fam["help"]:
                out.append(f"# HELP {fname} {fam['help']}")
            out.append(f"# TYPE {fname} {fam['type']}")
            out.extend(fam["lines"])
            if fam["qlines"]:
                out.append(f"# TYPE {fname}_q gauge")
                out.extend(fam["qlines"])
        for s in skipped:
            out.append(f"# fleet: skipped conflicting family {s}")
        return "\n".join(out) + ("\n" if out else "")

    @staticmethod
    def _render_family(fam: Dict[str, Any], m: Dict[str, Any],
                       extra: Dict[str, Any]) -> None:
        name = m["name"]
        for s in m.get("samples", []):
            if not isinstance(s, dict):
                continue
            labels = {**(s.get("labels") or {}), **extra}
            key = _label_key(labels)
            if fam["type"] == "histogram":
                for le, acc in s.get("buckets", []):
                    lk = _label_key({**labels, "le": le})
                    fam["lines"].append(
                        f"{name}_bucket{format_labels(lk)} {acc}")
                fam["lines"].append(
                    f"{name}_sum{format_labels(key)} {s.get('sum', 0.0)}")
                fam["lines"].append(
                    f"{name}_count{format_labels(key)} "
                    f"{s.get('count', 0)}")
                for tag, v in (s.get("quantiles") or {}).items():
                    lk = _label_key({**labels,
                                     "quantile": f"0.{tag[1:]}"})
                    fam["qlines"].append(
                        f"{name}_q{format_labels(lk)} {v}")
            else:
                fam["lines"].append(
                    f"{name}{format_labels(key)} {s.get('value', 0.0)}")

    # ------------------------------------------------------------ trace
    def merged_trace_events(self) -> List[Dict[str, Any]]:
        """Spans from every process on ONE timeline: per-process
        ``process_name`` metadata lanes first, then all recorded spans
        ordered by wall-clock ``ts`` — trace ids were already
        propagated at record time (CTX frames, context_scope), so a
        cross-process flow lines up without any join logic here."""
        with self._lock:
            procs = [(name, dict(e))
                     for name, e in sorted(self._procs.items())]
            spans = [e for dq in self._spans.values() for e in dq]
        out: List[Dict[str, Any]] = []
        for name, e in procs:
            out.append({
                "name": "process_name", "ph": "M", "cat": "__metadata",
                "pid": e["pid"], "tid": 0, "ts": 0, "dur": 0,
                "args": {"name": f"{e['role']} {name}@{e['node']}"}})
        out.extend(sorted(
            spans, key=lambda ev: (ev.get("ts") or 0,
                                   ev.get("pid") or 0)))
        return out

    def merged_trace_json(self) -> str:
        return json.dumps(self.merged_trace_events())

    # ------------------------------------------------------------ watch
    @staticmethod
    def _snapshot_value(metrics: List[Dict[str, Any]], name: str,
                        agg: str = "sum") -> Optional[float]:
        for m in metrics:
            if m.get("name") != name:
                continue
            vals = [s.get("value") for s in m.get("samples", [])
                    if isinstance(s, dict)
                    and isinstance(s.get("value"), (int, float))]
            if not vals:
                return None
            return float(sum(vals) if agg == "sum" else max(vals))
        return None

    def watch_rows(self) -> List[Dict[str, Any]]:
        """Per-process headline numbers for the live console."""
        now = self._clock()
        with self._lock:
            items = [(name, dict(e)) for name, e in
                     sorted(self._procs.items())]
        rows = []
        for name, e in items:
            metrics = e["metrics"]
            rows.append({
                "proc": name, "role": e["role"], "pid": e["pid"],
                "node": e["node"],
                "status": self._proc_status(e, now),
                "last_seen_s": round(now - e["last_push"], 1),
                "steps_per_s": self._snapshot_value(
                    metrics, "train_samples_per_sec"),
                "input_bound": self._snapshot_value(
                    metrics, "input_bound_ratio", agg="max"),
                "hbm_peak_bytes": self._snapshot_value(
                    metrics, "hbm_peak_bytes", agg="max"),
                "health": str(e["health"].get("status", "?")),
                "version": (e.get("serving") or {}).get("model_version"),
                "rollout": (e.get("serving") or {}).get("rollout_state"),
                "ttft_p99_s": (e.get("serving") or {}).get("ttft_p99_s"),
                "slo": (e.get("slo") or {}).get("status"),
            })
        return rows

    def reset(self) -> None:
        with self._lock:
            self._procs.clear()
            self._spans.clear()


# ---------------------------------------------------------- aggregator
class _FleetHandler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-fleet"

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, payload: Dict[str, Any]) -> None:
        self._send(code, json.dumps(payload), "application/json")

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        state: FleetState = self.server.state
        try:
            if path == "/fleet/metrics":
                self._send(200, state.merged_prometheus(),
                           "text/plain; version=0.0.4")
            elif path == "/fleet/healthz":
                self._send_json(200, state.rollup())
            elif path == "/fleet/trace":
                self._send(200, state.merged_trace_json(),
                           "application/json")
            elif path == "/fleet/topology":
                self._send_json(200, state.topology())
            else:
                self._send_json(404, {
                    "error": "unknown path",
                    "paths": ["/fleet/metrics", "/fleet/healthz",
                              "/fleet/trace", "/fleet/topology",
                              "POST /fleet/push"]})
        except BrokenPipeError:      # scraper hung up mid-response
            pass
        except Exception as e:       # noqa: BLE001 — never kill serving
            try:
                self._send(500, f"fleet handler error: {e}\n",
                           "text/plain")
            except OSError:
                pass

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0].rstrip("/")
        state: FleetState = self.server.state
        try:
            if path != "/fleet/push":
                self._send_json(404, {"error": "unknown path",
                                      "paths": ["POST /fleet/push"]})
                return
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            try:
                frame = json.loads(raw.decode("utf-8", "replace"))
            except ValueError:
                self._send_json(400, {"error": "push body is not JSON",
                                      "schema": FLEET_SCHEMA})
                return
            try:
                ack = state.ingest(frame)
            except FleetSchemaError as e:
                self._send_json(400, {"error": str(e),
                                      "schema": FLEET_SCHEMA})
                return
            except FleetFrameError as e:
                self._send_json(400, {"error": str(e),
                                      "schema": FLEET_SCHEMA})
                return
            self._send_json(200, ack)
        except BrokenPipeError:
            pass
        except Exception as e:       # noqa: BLE001 — never kill serving
            try:
                self._send(500, f"fleet handler error: {e}\n",
                           "text/plain")
            except OSError:
                pass

    def log_message(self, fmt: str, *args) -> None:
        from ..utils.logger import get_logger

        get_logger("observe.fleet").debug("http %s", fmt % args)


class FleetAggregator:
    """The hosted aggregator: :class:`FleetState` behind a
    ``ThreadingHTTPServer`` (thread name ``ptpu-fleet-http``)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 state: Optional[FleetState] = None):
        from .http import make_threading_server

        self.state = state if state is not None else FleetState()
        self._httpd = make_threading_server(host, port, _FleetHandler)
        self._httpd.daemon_threads = True
        self._httpd.state = self.state
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def addr(self) -> str:
        """A CONNECTABLE host:port for this aggregator — the bind host,
        except the wildcard binds (empty / 0.0.0.0 / ::), which are
        reachable locally via loopback."""
        host = self.host
        if host in ("", "0.0.0.0", "::"):
            host = "127.0.0.1"
        return f"{host}:{self.port}"

    def start(self) -> "FleetAggregator":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name=AGGREGATOR_THREAD_NAME, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            self._httpd.shutdown()
            t.join(timeout=5.0)
        self._httpd.server_close()

    def __enter__(self) -> "FleetAggregator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


_global: Optional[FleetAggregator] = None
_global_lock = named_lock("observe.fleet.global")


def start_from_flags() -> Optional[FleetAggregator]:
    """Host the process-wide aggregator iff ``--fleet_port`` > 0.
    Idempotent; an unbindable port warns once and leaves the process
    running — telemetry never kills the run it observes."""
    global _global
    from ..utils import FLAGS
    from ..utils.logger import get_logger, warn_once
    from .http import resolve_bind_host

    port = int(FLAGS.get("fleet_port"))
    if port <= 0:
        return _global
    with _global_lock:
        if _global is None:
            host = resolve_bind_host("fleet_bind")
            try:
                _global = FleetAggregator(port, host=host).start()
            except OSError as e:
                warn_once(
                    f"fleet_port_bind_failed:{port}",
                    "--fleet_port %d could not be bound (%s); the "
                    "fleet aggregator is OFF for this run", port, e,
                    logger=get_logger("observe"))
                return None
            get_logger("observe").info(
                "fleet aggregator on http://%s:%d (/fleet/metrics "
                "/fleet/healthz /fleet/trace /fleet/topology)",
                host, _global.port)
    return _global


def hosting() -> bool:
    """True iff this process hosts the process-wide aggregator — the
    SIGUSR2 debug dump keys its ``.fleet.json`` artifact on this."""
    return _global is not None


def topology() -> Optional[Dict[str, Any]]:
    agg = _global
    return agg.state.topology() if agg is not None else None


def rollup() -> Optional[Dict[str, Any]]:
    agg = _global
    return agg.state.rollup() if agg is not None else None


def stop_global() -> None:
    global _global
    with _global_lock:
        agg, _global = _global, None
    if agg is not None:
        agg.stop()


# -------------------------------------------------------------- pusher
class FleetPusher:
    """The push half: builds and POSTs one frame per reporter interval.

    Owned by :class:`paddle_tpu_torch.observe.report.MetricsReporter` and
    driven from ITS background thread — the pusher starts no thread of
    its own and never touches the train step.  Failure semantics are
    the retry/backoff/degrade contract of the module docstring."""

    def __init__(self, addr: str, interval_s: float = 10.0,
                 registry=None, stat: Any = None,
                 timeout_s: Optional[float] = None,
                 jsonl_degraded: Optional[Callable[[], bool]] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ..utils import FLAGS

        host, _, port_s = addr.rpartition(":")
        try:
            self.host, self.port = host or "127.0.0.1", int(port_s)
        except ValueError:
            raise ValueError(
                f"--fleet_addr {addr!r}: expected host:port")
        self.addr = addr
        self.interval_s = float(interval_s)
        self.registry = REGISTRY if registry is None else registry
        self.stat = stat
        self.timeout_s = float(FLAGS.get("fleet_push_timeout_s")
                               if timeout_s is None else timeout_s)
        self._jsonl_degraded = jsonl_degraded
        self._clock = clock
        self.degraded = False
        self.failures = 0            # consecutive
        self._skip_until = 0.0
        self._seq = 0
        self._t0 = clock()
        self._last_span_ts = 0.0
        self._pending_span_ts = 0.0
        # per-client jitter nonce: a fleet of trainers restarting in
        # lockstep must not retry the aggregator in lockstep (a
        # reconnect stampede)
        self._jitter = random.Random(f"{addr}:{os.getpid()}")
        self._lock = named_lock("observe.fleet.pusher")

    # ------------------------------------------------------------ frame
    @staticmethod
    def _span_end(e: Dict[str, Any]) -> float:
        return (e.get("ts") or 0) + (e.get("dur") or 0)

    def _new_spans(self) -> Tuple[List[Dict[str, Any]], float, int]:
        """Flight-recorder events recorded since the last acknowledged
        push: (events, candidate high-water mark, dropped count).  The
        mark is the END time (ts + dur) — spans are recorded at exit
        with ts = their START, so filtering on start would silently
        drop any long span straddling a push boundary (a 0.5 s
        master_rpc starting before a short span that already shipped);
        boundary-equal resends are harmless, the aggregator dedups by
        span id."""
        evs = [e for e in trace.events()
               if self._span_end(e) > self._last_span_ts]
        dropped = 0
        if len(evs) > MAX_SPANS_PER_FRAME:
            dropped = len(evs) - MAX_SPANS_PER_FRAME
            evs = evs[-MAX_SPANS_PER_FRAME:]
        high = max((self._span_end(e) for e in evs),
                   default=self._last_span_ts)
        return evs, high, dropped

    def build_frame(self, going_down: bool = False) -> Dict[str, Any]:
        ident = identity()
        spans, self._pending_span_ts, dropped = self._new_spans()
        timers: List[Dict[str, Any]] = []
        if self.stat is not None:
            snap = self.stat.snapshot()
            timers = [snap[n] for n in sorted(snap)]
        digest = local_health_digest()
        if self._jsonl_degraded is not None and self._jsonl_degraded():
            digest["status"] = _DEGRADED
            digest["jsonl_sink"] = _DEGRADED
        frame = {
            "schema": FLEET_SCHEMA, "kind": "fleet-frame",
            "role": ident["role"], "name": ident["name"],
            "node": ident["node"], "pid": os.getpid(),
            "seq": self._seq, "ts": round(time.time(), 3),
            "uptime_s": round(self._clock() - self._t0, 3),
            "interval_s": self.interval_s,
            "going_down": bool(going_down),
            "health": digest,
            "metrics": self.registry.snapshot(),
            "timers": timers,
            "spans": spans,
        }
        if dropped:
            frame["spans_dropped"] = dropped
        serving = serving_info()
        if serving:
            # additive, optional: only processes that loaded a serving
            # model carry it, and older aggregators ignore the key
            frame["serving"] = serving
            # windowed serving signals ride the frame so the canary
            # bake can compare replicas fleet-side (sys.modules read:
            # the registry was imported long before any pusher exists)
            hist = self.registry.find("serve_ttft_seconds")
            if hist is not None and hasattr(hist, "window_quantile"):
                p99 = hist.window_quantile(0.99, 60.0)
                if p99 is not None:
                    serving["ttft_p99_s"] = round(p99, 6)
            errs = self.registry.find("serve_request_failures")
            if errs is not None and hasattr(errs, "window_rate"):
                serving["error_rate_s"] = round(
                    errs.window_rate(60.0), 6)
        # SLO verdicts (additive, optional — same discipline); the
        # reporter evaluated right before this push, so last() is fresh
        smod = sys.modules.get("paddle_tpu_torch.observe.slo")
        eng = smod.active_engine() if smod is not None else None
        if eng is not None:
            frame["slo"] = eng.frame_digest()
        return frame

    # ------------------------------------------------------------- push
    def maybe_push(self) -> Optional[bool]:
        """Interval-driven push honoring the backoff window: returns
        None while backing off, else the push outcome."""
        if self._clock() < self._skip_until:
            return None
        return self.push()

    def push(self, going_down: bool = False) -> bool:
        """Build + POST one frame.  Never raises; a failure (network,
        HTTP != 200, bare-ERR body, version skew) degrades the sink
        with warn-once and schedules backoff; success clears the
        degraded state and advances the span high-water mark."""
        from .metrics import counter, histogram

        t0 = time.perf_counter()
        with self._lock:
            try:
                frame = self.build_frame(going_down=going_down)
                ack = self._post(frame)
            except Exception as e:   # noqa: BLE001 — telemetry never
                self._note_failure(e)        # kills the process it
                counter("fleet_pushes_total",     # observes
                        "fleet frames pushed, by result").inc(
                    result="error")
                return False
            self._seq += 1
            self._last_span_ts = self._pending_span_ts
            recovered, self.degraded, self.failures = \
                self.degraded, False, 0
            self._skip_until = 0.0
        counter("fleet_pushes_total",
                "fleet frames pushed, by result").inc(result="ok")
        histogram("fleet_push_seconds",
                  "one fleet frame build + POST round trip (runs on "
                  "the reporter thread, never the step path)").observe(
            time.perf_counter() - t0)
        if recovered:
            from ..utils.logger import get_logger, reset_warn_once

            get_logger("observe").info(
                "fleet push to %s recovered after degradation",
                self.addr)
            reset_warn_once(f"fleet_push_failed:{self.addr}")
        return True

    def _post(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        body = json.dumps(frame)
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            conn.request("POST", "/fleet/push", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
        finally:
            try:
                conn.close()
            except OSError as e:
                from ..utils.logger import get_logger
                get_logger("observe").debug(
                    "fleet push connection close failed: %s", e)
        try:
            ack = json.loads(data.decode("utf-8", "replace"))
        except ValueError:
            # a bare-ERR (or any non-JSON) body: a peer speaking a
            # different dialect — degrade exactly like a failing flush
            raise OSError(
                f"aggregator answered non-JSON ({resp.status}): "
                f"{data[:80]!r}")
        if resp.status != 200 or not isinstance(ack, dict) \
                or ack.get("ok") is not True:
            err = ack.get("error") if isinstance(ack, dict) else ack
            raise OSError(
                f"aggregator refused frame (HTTP {resp.status}): {err}")
        if int(ack.get("schema") or 0) > FLEET_SCHEMA:
            raise OSError(
                f"aggregator speaks schema {ack.get('schema')} > "
                f"{FLEET_SCHEMA} (version skew)")
        return ack

    def _note_failure(self, e: Exception) -> None:
        from ..utils.logger import get_logger, warn_once

        self.degraded = True
        self.failures += 1
        backoff = min(self.interval_s * (2.0 ** (self.failures - 1)),
                      max(60.0, 8.0 * self.interval_s))
        backoff *= 1.0 + 0.25 * self._jitter.random()
        self._skip_until = self._clock() + backoff
        warn_once(
            f"fleet_push_failed:{self.addr}",
            "fleet push to %s failed (%s: %s); the push sink is "
            "DEGRADED — frames are being dropped, retrying with "
            "backoff (reported once)", self.addr, type(e).__name__, e,
            logger=get_logger("observe"))


# ------------------------------------------------------- watch console
def _http_get(addr: str, path: str, timeout_s: float = 5.0) -> bytes:
    host, _, port_s = addr.rpartition(":")
    conn = http.client.HTTPConnection(host or "127.0.0.1", int(port_s),
                                      timeout=timeout_s)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise OSError(f"GET {path}: HTTP {resp.status}")
        return data
    finally:
        conn.close()


def _fmt_bytes(v: Optional[float]) -> str:
    if v is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(v) < 1024.0:
            return f"{v:.1f}{unit}"
        v /= 1024.0
    return f"{v:.1f}PB"


def _parse_prom_labels(label_str: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in label_str.strip("{}").split(","):
        k, eq, v = part.partition("=")
        if eq:
            out[k.strip()] = v.strip().strip('"')
    return out


def summarize_label_families(prom: str, threshold: int = 8,
                             top_k: int = 3) -> List[str]:
    """Label-explosion guard for the watch console: a gauge family
    with ``threshold``-or-more labelled series — the per-(category,
    shard) ``hbm_shard_bytes`` family on a wide mesh is the canonical
    case — renders as ONE summary line (series count, total, top-k
    series by value) instead of one console line per series.  Families
    below the threshold are left to their usual columns."""
    fams: Dict[str, List[Any]] = {}
    for line in prom.splitlines():
        if line.startswith("#") or "{" not in line:
            continue
        fam = line.split("{", 1)[0]
        labels, _, value = line.rpartition("} ")
        try:
            v = float(value)
        except ValueError:
            continue
        fams.setdefault(fam, []).append(
            (_parse_prom_labels(labels.split("{", 1)[-1]), v))
    out: List[str] = []
    for fam in sorted(fams):
        series = fams[fam]
        if len(series) < threshold:
            continue
        fmt = _fmt_bytes if fam.endswith("_bytes") \
            else (lambda v: f"{v:g}")
        top = sorted(series, key=lambda s: -s[1])[:top_k]
        cells = []
        for labels, v in top:
            key = ",".join(f"{k}={labels[k]}" for k in sorted(labels)
                           if k != "proc")
            cells.append(f"{key}={fmt(v)}")
        total = sum(v for _, v in series)
        out.append(f"{fam}  {len(series)} series  total={fmt(total)}"
                   f"  top: " + "  ".join(cells))
    return out


def render_watch(rollup_doc: Dict[str, Any],
                 rows: List[Dict[str, Any]],
                 family_summaries: Optional[List[str]] = None) -> str:
    """The live-console frame: one aligned row per process, plus a
    top-k summary line per label-explosion gauge family (see
    :func:`summarize_label_families`)."""
    hdr = (f"fleet: {rollup_doc['status']}  "
           + "  ".join(f"{k}={v}" for k, v in
                       sorted(rollup_doc.get("counts", {}).items())
                       if v))
    cols = ["proc", "role", "pid", "status", "step/s", "input_bound",
            "hbm_peak", "health", "version", "p99_ttft", "slo",
            "last_seen"]
    table: List[List[str]] = [cols]
    for r in rows:
        version = r.get("version")
        rollout = r.get("rollout")
        # digest-prefix + swap state: "1a2b3c4d5e6f" while serving,
        # "1a2b…(swapping)" mid-rollout — a rolling rollout is visible
        # as the column changing row by row
        if version is None:
            vcell = "-"
        else:
            vcell = str(version)[:12]
            if rollout and rollout != "serving":
                vcell = f"{vcell[:6]}…({rollout})"
        p99 = r.get("ttft_p99_s")
        table.append([
            str(r["proc"]), str(r["role"]), str(r["pid"]),
            str(r["status"]),
            "-" if r["steps_per_s"] is None
            else f"{r['steps_per_s']:.1f}",
            "-" if r["input_bound"] is None
            else f"{r['input_bound']:.3f}",
            _fmt_bytes(r["hbm_peak_bytes"]),
            str(r["health"]), vcell,
            "-" if p99 is None else f"{p99 * 1e3:.0f}ms",
            str(r.get("slo") or "-"),
            f"{r['last_seen_s']:.1f}s",
        ])
    widths = [max(len(row[i]) for row in table)
              for i in range(len(cols))]
    lines = [hdr, ""]
    for row in table:
        lines.append("  ".join(c.ljust(w) for c, w in
                               zip(row, widths)).rstrip())
    if family_summaries:
        lines.append("")
        lines.append("label-wide families (one line per family, "
                     "top series by value):")
        lines.extend(f"  {s}" for s in family_summaries)
    return "\n".join(lines)


def watch_once(addr: str) -> str:
    """One console frame from a remote aggregator (fetch + render)."""
    roll = json.loads(_http_get(addr, "/fleet/healthz"))
    topo = json.loads(_http_get(addr, "/fleet/topology"))
    # re-derive watch rows from the remote documents: the remote holds
    # the snapshots, so headline numbers ride a dedicated scrape of
    # /fleet/metrics only when needed — topology + rollup are enough
    # for the table's identity/status columns
    rows = []
    for name, p in sorted(topo.get("procs", {}).items()):
        r = roll.get("procs", {}).get(name, {})
        rows.append({
            "proc": name, "role": p["role"], "pid": p["pid"],
            "node": p["node"], "status": r.get("status", "?"),
            "last_seen_s": p["last_push_age_s"],
            "steps_per_s": None, "input_bound": None,
            "hbm_peak_bytes": None,
            # liveness (rollup) and the pushed health digest are
            # DIFFERENT columns: a missing process still shows its
            # last-known health
            "health": p.get("health", "?"),
            "version": p.get("model_version"),
            "rollout": p.get("rollout_state"),
            "ttft_p99_s": p.get("ttft_p99_s"),
            "slo": p.get("slo"),
        })
    # headline metrics come from the merged exposition
    summaries: List[str] = []
    try:
        prom = _http_get(addr, "/fleet/metrics").decode()
        _fill_headline_from_prometheus(prom, rows)
        summaries = summarize_label_families(prom)
    except OSError:
        pass
    return render_watch(roll, rows, family_summaries=summaries)


def _fill_headline_from_prometheus(prom: str,
                                   rows: List[Dict[str, Any]]) -> None:
    """Scrape per-proc headline gauges back out of the merged text."""
    want = {"train_samples_per_sec": "steps_per_s",
            "input_bound_ratio": "input_bound",
            "hbm_peak_bytes": "hbm_peak_bytes"}
    by_proc = {r["proc"]: r for r in rows}
    for line in prom.splitlines():
        if line.startswith("#") or "{" not in line:
            continue
        fam = line.split("{", 1)[0]
        field = want.get(fam)
        if field is None:
            continue
        labels, _, value = line.rpartition("} ")
        proc = None
        for part in labels.split("{", 1)[-1].split(","):
            if part.startswith('proc="'):
                proc = part[len('proc="'):].rstrip('"')
        row = by_proc.get(proc)
        if row is None:
            continue
        try:
            row[field] = float(value)
        except ValueError:
            continue


def watch_loop(addr: str, interval_s: float = 2.0,
               once: bool = False, out=None) -> int:
    """The ``--watch`` console: redraw every ``interval_s`` until
    interrupted (or a single frame with ``once``)."""
    out = sys.stdout if out is None else out
    while True:
        try:
            frame = watch_once(addr)
        except (OSError, ValueError) as e:
            frame = f"fleet: aggregator at {addr} unreachable ({e})"
        print(frame, file=out, flush=True)
        if once:
            return 0
        try:
            time.sleep(interval_s)
        except KeyboardInterrupt:
            return 0
        print("", file=out)


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m paddle_tpu_torch.observe.fleet``: host a standalone
    aggregator (``--fleet_port``) or watch a running one
    (``--watch host:port``)."""
    from ..utils import FLAGS

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observe.fleet",
        description="fleet observatory: host or watch an aggregator")
    ap.add_argument("--watch", metavar="HOST:PORT",
                    help="render the live per-process console from a "
                         "running aggregator")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="console refresh period (seconds)")
    ap.add_argument("--once", action="store_true",
                    help="render one console frame and exit")
    ap.add_argument("--fleet_port", type=int, default=None,
                    help="host a standalone aggregator on this port")
    ap.add_argument("--fleet_bind", default=None,
                    help="aggregator bind address (default loopback; "
                         "non-loopback is an explicit opt-in and warns "
                         "— fleet telemetry is not an external API)")
    args = ap.parse_args(argv)
    if args.watch:
        return watch_loop(args.watch, interval_s=args.interval,
                          once=args.once)
    if args.fleet_port is None:
        ap.error("one of --watch HOST:PORT or --fleet_port N required")
    FLAGS.set("fleet_port", args.fleet_port)
    if args.fleet_bind is not None:
        FLAGS.set("fleet_bind", args.fleet_bind)
    agg = start_from_flags()
    if agg is None:
        return 1
    print(f"fleet aggregator on :{agg.port} (/fleet/metrics "
          "/fleet/healthz /fleet/trace /fleet/topology)", flush=True)
    stop: List[int] = []
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
        signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    except ValueError as e:   # non-main thread (embedding): poll-only
        from ..utils.logger import get_logger
        get_logger("observe").debug(
            "fleet main: signal handlers unavailable: %s", e)
    while not stop:
        time.sleep(0.2)
    stop_global()
    return 0


if __name__ == "__main__":
    # `python -m paddle_tpu_torch.observe.fleet` runs a runpy COPY of
    # this module while the package's eager import holds the canonical
    # one — delegate so --fleet_port hosting lands in the state every
    # other surface (dump.py, hosting()) actually reads.
    from paddle_tpu_torch.observe import fleet as _canonical

    sys.exit(_canonical.main())
