"""Serving SLO engine: declarative windowed objectives and a
multi-window burn rate (counterpart of ``paddle_tpu/observe/slo.py``).

An **objective** is one entry of the ``--slo`` flag grammar::

    serve_ttft_seconds:p99<0.5:60s

read "the p99 of ``serve_ttft_seconds`` over the last 60 seconds stays
under 0.5" — ``metric:stat op threshold:window``, where ``stat`` is
``pNN`` (a quantile of the histogram's windowed reservoir,
:meth:`paddle_tpu_torch.observe.metrics.Histogram.window_quantile`) or
``rate`` (events a second, :meth:`~paddle_tpu_torch.observe.metrics.
Histogram.window_rate` — the error-rate form when failures are observed
as events), ``op`` is ``<`` or ``>``, and ``window`` takes an ``s`` or
``m`` suffix.  Objectives join with ``,`` or ``;``.

Each objective is evaluated on the reporter thread
(:mod:`paddle_tpu_torch.observe.report`) and yields ok/breach plus a
**multi-window burn rate**:

- the **fast** burn rate reads the objective's own window: for a
  quantile objective the violating fraction of the windowed samples over
  the allowed fraction (``1 - q``, the error budget), so burn 1.0 spends
  the budget exactly as fast as allowed; for a rate objective the ratio
  to the threshold;
- the **slow** burn rate reads a :data:`SLOW_FACTOR` x confirmation
  window (clamped to the reservoir's ring span).

A **breach** needs BOTH burns >= 1: one slow scrape trips the fast
window but not the slow one (a transient; the status stays ok), and
recovery clears the fast window first, so a recovered server never
advertises a stale breach.

Surfaces: the ``slo_status{objective}`` (1 ok / 0 breach) and
``slo_burn_rate{objective}`` gauges on every evaluation, and the
``/slo`` and ``/healthz`` endpoints (:mod:`paddle_tpu_torch.observe.
http`), which find the engine through ``sys.modules`` as the reference's
do.  :meth:`SloEngine.frame_digest` is the fleet frame's ``slo`` field
(``observe/fleet.FleetPusher.build_frame``): a standing breach marks the
process degraded in the aggregator's rollup.

Telemetry never kills: an objective over a missing metric or an empty
window is ``no_data`` (ok, burn 0), and an evaluator fault warns once
and degrades to ``no_data``.  With ``--slo`` unset no engine exists and
every surface above is byte-identical to the engine-less build.  Nothing
here imports torch.
"""

from __future__ import annotations

import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from ..analysis.lockorder import named_lock
from .metrics import REGISTRY, Histogram, MetricsRegistry

#: Slow confirmation window = this factor × the objective's window
#: (clamped to the metric's ring span at read time).
SLOW_FACTOR = 5.0

_OK = "ok"
_BREACH = "breach"
_NO_DATA = "no_data"

_OBJECTIVE_RE = re.compile(
    r"^(?P<metric>[A-Za-z_][A-Za-z0-9_]*)"
    r":(?P<stat>p\d{1,2}(?:\.\d+)?|rate)"
    r"(?P<op>[<>])(?P<threshold>[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)"
    r":(?P<window>[0-9]*\.?[0-9]+)(?P<unit>[sm])$")


class SloParseError(ValueError):
    """An ``--slo`` objective that does not parse."""


class Objective:
    """One parsed objective.  ``text`` is the canonical spelling — it
    labels the gauges, the fleet frames, and every report."""

    __slots__ = ("text", "metric", "stat", "q", "op", "threshold",
                 "window_s")

    def __init__(self, metric: str, stat: str, op: str,
                 threshold: float, window_s: float):
        self.metric = metric
        self.stat = stat
        self.q = None if stat == "rate" \
            else min(float(stat[1:]) / 100.0, 1.0)
        self.op = op
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        win = f"{window_s:g}s"
        self.text = f"{metric}:{stat}{op}{threshold:g}:{win}"

    def __repr__(self) -> str:
        return f"Objective({self.text!r})"

    def violates(self, value: float) -> bool:
        """True when ``value`` is on the wrong side of the threshold."""
        return value >= self.threshold if self.op == "<" \
            else value <= self.threshold


def parse_objective(text: str) -> Objective:
    """``"serve_ttft_seconds:p99<0.5:60s"`` → :class:`Objective`."""
    m = _OBJECTIVE_RE.match(text.strip())
    if m is None:
        raise SloParseError(
            f"--slo objective {text!r} does not parse; expected "
            "metric:statOPthreshold:window, e.g. "
            "'serve_ttft_seconds:p99<0.5:60s' (stat pNN or rate, OP "
            "< or >, window Ns or Nm)")
    window_s = float(m.group("window"))
    if m.group("unit") == "m":
        window_s *= 60.0
    if window_s <= 0:
        raise SloParseError(f"--slo objective {text!r}: window must "
                            "be > 0")
    stat = m.group("stat")
    if stat != "rate" and not 0.0 < float(stat[1:]) <= 100.0:
        raise SloParseError(f"--slo objective {text!r}: quantile must "
                            "be in (0, 100]")
    return Objective(m.group("metric"), stat, m.group("op"),
                     float(m.group("threshold")), window_s)


def parse_objectives(spec: str) -> List[Objective]:
    """The full ``--slo`` value: objectives joined with ``,`` or ``;``
    (empty → no objectives)."""
    out = []
    for part in re.split(r"[,;]", spec or ""):
        if part.strip():
            out.append(parse_objective(part))
    return out


class SloEngine:
    """Evaluates a fixed objective list against a metrics registry.

    ``clock`` is only used to stamp evaluation time; the window math
    lives in each histogram's own (independently injectable) clock.
    Thread-safe: the reporter thread evaluates while ``/slo`` and
    ``/healthz`` handler threads read the last verdicts."""

    def __init__(self, objectives: Sequence[Union[Objective, str]],
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 slow_factor: float = SLOW_FACTOR):
        self.objectives = [o if isinstance(o, Objective)
                           else parse_objective(o) for o in objectives]
        self.registry = REGISTRY if registry is None else registry
        self.slow_factor = float(slow_factor)
        self._clock = clock
        self._lock = named_lock("observe.slo")
        self._last: List[Dict[str, Any]] = []

    # --------------------------------------------------------- verdicts
    def _burn(self, hist: Histogram, obj: Objective,
              window_s: float) -> Optional[float]:
        """Error-budget burn rate over one window (None = no data)."""
        if obj.stat == "rate":
            rate = hist.window_rate(window_s)
            if obj.op == "<":
                if obj.threshold <= 0:
                    return 0.0 if rate == 0.0 else float("inf")
                return rate / obj.threshold
            # op ">": the objective wants the rate ABOVE the floor;
            # the burn inverts so >= 1 still means "breaching"
            return obj.threshold / rate if rate > 0 else float("inf")
        samples = hist.window_samples(window_s)
        if not samples:
            return None
        bad = sum(1 for v in samples if obj.violates(v)) / len(samples)
        budget = max(1.0 - (obj.q or 1.0), 1e-9)
        return bad / budget

    def _eval_one(self, obj: Objective) -> Dict[str, Any]:
        verdict: Dict[str, Any] = {
            "objective": obj.text, "metric": obj.metric,
            "window_s": obj.window_s, "status": _NO_DATA,
            "value": None, "burn_fast": 0.0, "burn_slow": 0.0,
        }
        m = self.registry.find(obj.metric)
        if not isinstance(m, Histogram):
            return verdict
        slow_s = min(obj.window_s * self.slow_factor, m.window_span_s)
        verdict["slow_window_s"] = slow_s
        if obj.stat == "rate":
            verdict["value"] = m.window_rate(obj.window_s)
            if m.window_count(slow_s) == 0:
                return verdict
        else:
            verdict["value"] = m.window_quantile(obj.q, obj.window_s)
        fast = self._burn(m, obj, obj.window_s)
        slow = self._burn(m, obj, slow_s)
        verdict["burn_fast"] = round(fast, 4) if fast is not None else 0.0
        verdict["burn_slow"] = round(slow, 4) if slow is not None else 0.0
        if fast is None and slow is None:
            return verdict
        # standing breach needs BOTH windows burning (>= 1): the fast
        # window alerts quickly, the slow window confirms it is not a
        # transient; recovery clears fast first, so status goes back
        # to ok while the slow window drains (the standing-clear)
        breach = (fast or 0.0) >= 1.0 and (slow or 0.0) >= 1.0
        verdict["status"] = _BREACH if breach else _OK
        return verdict

    def evaluate(self) -> List[Dict[str, Any]]:
        """One evaluation pass over every objective: computes verdicts,
        publishes the ``slo_status`` / ``slo_burn_rate`` gauges, and
        retains the result for :meth:`frame_digest`.  Never raises
        (telemetry never kills): an objective whose read faults warns
        once and reports ``no_data``."""
        t0 = time.perf_counter()
        results: List[Dict[str, Any]] = []
        for obj in self.objectives:
            try:
                v = self._eval_one(obj)
            except Exception as e:  # noqa: BLE001 — degrade, never kill
                from ..utils.logger import get_logger, warn_once

                warn_once(
                    f"slo_eval_failed:{obj.text}",
                    "SLO objective %r evaluation failed (%s: %s); "
                    "reporting no_data (reported once)", obj.text,
                    type(e).__name__, e, logger=get_logger("observe"))
                v = {"objective": obj.text, "metric": obj.metric,
                     "window_s": obj.window_s, "status": _NO_DATA,
                     "value": None, "burn_fast": 0.0, "burn_slow": 0.0}
            results.append(v)
            self.registry.gauge(
                "slo_status",
                "1 while the objective holds (or has no data), 0 on "
                "a standing breach (fast AND slow burn >= 1)").set(
                0.0 if v["status"] == _BREACH else 1.0,
                objective=obj.text)
            self.registry.gauge(
                "slo_burn_rate",
                "fast-window error-budget burn rate per objective "
                "(1.0 = spending the budget exactly as fast as the "
                "objective allows)").set(
                v["burn_fast"], objective=obj.text)
        with self._lock:
            self._last = results
        self.registry.histogram(
            "slo_eval_seconds",
            "wall time of one SLO evaluation pass over every "
            "objective (runs on the reporter interval, never "
            "the request path)").observe(time.perf_counter() - t0)
        return results

    # ---------------------------------------------------------- readers
    def last(self) -> List[Dict[str, Any]]:
        """Verdicts from the most recent :meth:`evaluate` (empty before
        the first pass)."""
        with self._lock:
            return [dict(v) for v in self._last]

    def status_doc(self) -> Dict[str, Any]:
        """The ``/slo`` body: a FRESH evaluation (scrape-time truth,
        matching ``/metrics`` semantics)."""
        results = self.evaluate()
        breached = [v["objective"] for v in results
                    if v["status"] == _BREACH]
        return {"status": _BREACH if breached else _OK,
                "breached": breached, "objectives": results}

    def frame_digest(self) -> Dict[str, Any]:
        """The compact form a fleet frame carries (last verdicts, no
        re-evaluation — built on the reporter thread right after
        :meth:`evaluate` ran)."""
        results = self.last()
        breached = [v["objective"] for v in results
                    if v["status"] == _BREACH]
        return {
            "status": _BREACH if breached else _OK,
            "breached": breached,
            "objectives": {
                v["objective"]: {"status": v["status"],
                                 "burn_fast": v["burn_fast"],
                                 "burn_slow": v["burn_slow"],
                                 "value": v["value"]}
                for v in results},
        }


# ---------------------------------------------------------------- global
_engine: Optional[SloEngine] = None
_engine_lock = named_lock("observe.slo.global")


def configure_from_flags() -> Optional[SloEngine]:
    """Build the process-wide engine from ``--slo`` (idempotent; None
    with the flag unset — no engine, no gauges, every surface
    byte-identical to the engine-less build).  A malformed objective
    warns once and leaves the engine OFF: telemetry never kills the
    run it observes."""
    global _engine
    from ..utils import FLAGS

    spec = str(FLAGS.get("slo") or "")
    if not spec.strip():
        return _engine
    with _engine_lock:
        if _engine is None:
            try:
                objectives = parse_objectives(spec)
            except SloParseError as e:
                from ..utils.logger import get_logger, warn_once

                warn_once(
                    f"slo_flag_invalid:{spec}",
                    "--slo %r is not usable (%s); the SLO engine is "
                    "OFF for this run", spec, e,
                    logger=get_logger("observe"))
                return None
            if objectives:
                _engine = SloEngine(objectives)
    return _engine


def set_engine(engine: Optional[SloEngine]) -> None:
    """Install a programmatic engine (tests, notebooks)."""
    global _engine
    with _engine_lock:
        _engine = engine


def active_engine() -> Optional[SloEngine]:
    """The process-wide engine, or None when ``--slo`` never
    configured one — every surface probes this through ``sys.modules``
    so an engine-less process pays nothing."""
    return _engine


def reset() -> None:
    """Drop the process-wide engine (tests)."""
    set_engine(None)
