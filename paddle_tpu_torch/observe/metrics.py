"""Typed process-wide metrics registry: Counter / Gauge / Histogram
(counterpart of ``paddle_tpu/observe/metrics.py``; standard library
only).

The reference engine's observability spine is the ``StatSet`` timer table
(``paddle/utils/Stat.h:63-242``) — wall timers only.  This module adds
the other half: monotonic event counts (dispatch tiers, quarantines),
point-in-time gauges (input-bound ratio, fused-pair census), and
fixed-bucket latency histograms (step/save time), all exportable through
one path (:mod:`paddle_tpu_torch.observe.report`) together with the
timer table.  Metric names, help strings and label keys are the JAX
package's, so one dashboard reads either package.

Design constraints, in order:

- **zero dependencies** — stdlib only, importable without torch;
- **near-zero overhead when no sink is attached** — an increment is one
  dict lookup + a lock + a float add (~1 µs); anything that would wait
  for the device lives with the callers, gated on
  :func:`paddle_tpu_torch.observe.report.active`;
- **thread-safe** — every metric guards its label table with its own
  lock (reader threads, the flush thread, and trainer threads race).

Labels are free-form keyword arguments; each distinct label set is an
independent sample series, Prometheus-style::

    counter("rnn_dispatch_total").inc(kind="lstm", path="fused")
"""

from __future__ import annotations

import collections
import contextlib
import math
import random
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, \
    Sequence, Tuple

from ..analysis.lockorder import named_lock

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def format_labels(key: LabelKey) -> str:
    """``((k, v), ...)`` → ``{k="v",...}`` (empty string for no labels)."""
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = named_lock("observe.metric")

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "type": self.kind, "help": self.help,
                "samples": self.samples()}

    def samples(self) -> List[Dict[str, Any]]:  # pragma: no cover
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count; ``inc`` of a negative amount is a
    programming error and raises."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        amount = float(amount)   # numpy scalars would poison json.dumps
        if amount < 0:
            raise ValueError(
                f"counter {self.name!r}: negative increment {amount}")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        """Sum over every label series."""
        with self._lock:
            return sum(self._values.values())

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = sorted(self._values.items())
        return [{"labels": dict(k), "value": v} for k, v in items]


class Gauge(_Metric):
    """Point-in-time value; settable, incrementable, decrementable."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        amount = float(amount)   # numpy scalars would poison json.dumps
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = sorted(self._values.items())
        return [{"labels": dict(k), "value": v} for k, v in items]


# latency buckets in seconds: 0.5 ms … 60 s, the span from a fused-kernel
# train step to a multi-GB checkpoint save
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


#: Default bound on raw samples a histogram series retains for the
#: exact-quantile reservoir — the retention cap that keeps a
#: million-observation training run at constant memory per series.
DEFAULT_SAMPLE_CAP = 2048

#: Windowed-reservoir geometry.  Each histogram series additionally
#: keeps a time-bucketed ring of raw samples: ``WINDOW_BUCKETS``
#: buckets of ``WINDOW_BUCKET_S`` seconds each (the ring spans
#: bucket_s × buckets seconds — 360 s at the defaults, wide enough for
#: a 60 s fast window AND its slow confirmation window of the
#: reference's SLO engine), at most ``WINDOW_SAMPLE_CAP`` raw
#: samples per bucket (Algorithm R within the bucket).  Memory per
#: series is therefore bounded by buckets × cap floats no matter how
#: long the process observes.
WINDOW_BUCKET_S = 5.0
WINDOW_BUCKETS = 72
WINDOW_SAMPLE_CAP = 128


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus ``le`` convention: a bucket
    counts observations ``<= upper_bound``; ``+Inf`` is implicit).

    Beyond the buckets, each label series keeps a BOUNDED uniform
    reservoir of raw observations (Vitter's Algorithm R, cap
    ``sample_cap``, default :data:`DEFAULT_SAMPLE_CAP`, 0 disables):
    :meth:`sample_quantile` reads quantiles from it at sample
    resolution — exact while the series is under the cap, an unbiased
    uniform-subsample estimate past it — where :meth:`quantile` is
    limited to bucket-interpolation resolution.  Retention never grows
    past the cap no matter how long the run observes.

    Each series ALSO keeps a **windowed reservoir**: a time-bucketed
    ring of :data:`WINDOW_BUCKETS` buckets of ``window_bucket_s``
    seconds, each bounded at ``window_cap`` raw samples (Algorithm R
    within the bucket).  :meth:`window_quantile` /
    :meth:`window_rate` / :meth:`window_count` answer "over the last N
    seconds" — the primitive SLO verdicts, burn-rate alerts, and
    canary comparisons need, which the LIFETIME reservoir cannot
    (a recovered server's lifetime p99 advertises the bad minute
    forever).  The observe-path cost is one clock read plus a ring
    append under the same lock; the merge/sort work happens only when
    a window is actually read, so a process that never reads a window
    pays nothing beyond that.  ``clock`` is injectable (monotonic
    seconds) so expiry is unit-testable with a fake clock."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None,
                 sample_cap: Optional[int] = None,
                 window_bucket_s: Optional[float] = None,
                 window_buckets: Optional[int] = None,
                 window_cap: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None):
        super().__init__(name, help)
        bs = tuple(sorted(buckets if buckets is not None
                          else DEFAULT_BUCKETS))
        if not bs:
            raise ValueError(f"histogram {self.name!r}: needs >= 1 bucket")
        self.buckets = bs
        self.sample_cap = DEFAULT_SAMPLE_CAP if sample_cap is None \
            else max(0, int(sample_cap))
        self.window_bucket_s = float(WINDOW_BUCKET_S if window_bucket_s
                                     is None else window_bucket_s)
        if self.window_bucket_s <= 0:
            raise ValueError(f"histogram {self.name!r}: window_bucket_s "
                             "must be > 0")
        self.window_buckets = max(1, int(WINDOW_BUCKETS if window_buckets
                                         is None else window_buckets))
        self.window_cap = max(0, int(WINDOW_SAMPLE_CAP if window_cap
                                     is None else window_cap))
        self._now = time.monotonic if clock is None else clock
        # reservoir replacement draws need no crypto strength; a
        # name-derived seed keeps runs reproducible.  The window ring
        # draws from its own stream: how many draws it makes depends on
        # how many bucket boundaries the observations cross (the
        # clock), which must not move the lifetime reservoir's samples
        self._rng = random.Random(name)
        self._window_rng = random.Random(name + "@window")
        # per label set: [per-bucket counts + overflow, sum, count,
        #                 bounded sample reservoir, window ring] where
        # the ring is a bounded deque of [bucket_id, count, sum,
        # bounded samples] time buckets
        self._series: Dict[LabelKey, List[Any]] = {}

    @property
    def window_span_s(self) -> float:
        """Widest answerable window: ring buckets × bucket width.
        Wider queries clamp to it."""
        return self.window_bucket_s * self.window_buckets

    def observe(self, value: float, **labels) -> None:
        value = float(value)     # numpy scalars would poison json.dumps
        key = _label_key(labels)
        now = self._now() if self.window_cap else 0.0
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [
                    [0] * (len(self.buckets) + 1), 0.0, 0, [],
                    collections.deque(maxlen=self.window_buckets)]
            counts = s[0]
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            s[1] += value
            s[2] += 1
            if self.sample_cap:
                res = s[3]
                if len(res) < self.sample_cap:
                    res.append(value)
                else:
                    # Algorithm R: keep each of the n observations so
                    # far with equal probability cap/n
                    j = self._rng.randrange(s[2])
                    if j < self.sample_cap:
                        res[j] = value
            if self.window_cap:
                bid = int(now // self.window_bucket_s)
                ring = s[4]
                b = ring[-1] if ring else None
                if b is None or b[0] != bid:
                    b = [bid, 0, 0.0, []]
                    ring.append(b)   # maxlen evicts the oldest bucket
                b[1] += 1
                b[2] += value
                ws = b[3]
                if len(ws) < self.window_cap:
                    ws.append(value)
                else:
                    j = self._window_rng.randrange(b[1])
                    if j < self.window_cap:
                        ws[j] = value

    @contextlib.contextmanager
    def time(self, **labels) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0, **labels)

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s[2] if s else 0

    #: Derived quantiles exported with every histogram (p50/p95/p99) —
    #: step-latency SLOs become checkable straight off ``/metrics`` /
    #: the JSONL sink, no Prometheus server required.
    EXPORT_QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Estimated ``q``-quantile (0 < q <= 1) from the fixed buckets,
        Prometheus ``histogram_quantile`` style: linear interpolation
        inside the bucket the rank falls in.  Observations past the last
        finite bound clamp to it (the +Inf bucket has no width to
        interpolate over).  None with no observations."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or s[2] == 0:
                return None
            counts, n = list(s[0]), s[2]
        rank = q * n
        acc, lo = 0.0, 0.0
        for i, ub in enumerate(self.buckets):
            prev = acc
            acc += counts[i]
            if acc >= rank:
                if counts[i] == 0:        # rank == prev on an empty bucket
                    return lo
                frac = min(max((rank - prev) / counts[i], 0.0), 1.0)
                return lo + (ub - lo) * frac
            lo = ub
        return self.buckets[-1]

    def quantiles(self, **labels) -> Dict[str, float]:
        """``{"p50": ..., "p95": ..., "p99": ...}`` (empty when no
        observations) — the derived series :meth:`samples` and the
        Prometheus dump export."""
        out: Dict[str, float] = {}
        for q in self.EXPORT_QUANTILES:
            v = self.quantile(q, **labels)
            if v is not None:
                out[f"p{int(q * 100)}"] = v
        return out

    def sample_quantile(self, q: float, **labels) -> Optional[float]:
        """``q``-quantile from the bounded raw-sample reservoir: exact
        while the series has observed <= ``sample_cap`` values, an
        unbiased uniform-subsample estimate beyond (linear
        interpolation between order statistics).  None with no retained
        samples (empty series or ``sample_cap=0``) — callers fall back
        to the bucket-resolution :meth:`quantile`."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            res = list(s[3]) if s else []
        if not res:
            return None
        res.sort()
        pos = min(max(q, 0.0), 1.0) * (len(res) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(res) - 1)
        return res[lo] + (res[hi] - res[lo]) * (pos - lo)

    def retained_samples(self, **labels) -> int:
        """Raw observations currently held in the reservoir for this
        series — bounded by ``sample_cap`` by construction."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            return len(s[3]) if s else 0

    # --------------------------------------------------------- windows
    def _window_cut(self, window_s: float) -> Tuple[float, float]:
        """(clamped window, cutoff time): a bucket whose interval ends
        at or before the cutoff holds no sample younger than
        ``window_s`` and is expired for this read."""
        window_s = min(max(float(window_s), self.window_bucket_s),
                       self.window_span_s)
        return window_s, self._now() - window_s

    def _window_ring(self, window_s: float, **labels
                     ) -> Tuple[float, List[List[Any]]]:
        """Lock-consistent copy of the ring buckets still inside the
        window (newest data only; bucket granularity)."""
        window_s, cutoff = self._window_cut(window_s)
        with self._lock:
            s = self._series.get(_label_key(labels))
            ring = [[b[0], b[1], b[2], list(b[3])] for b in s[4]] \
                if s else []
        live = [b for b in ring
                if (b[0] + 1) * self.window_bucket_s > cutoff]
        return window_s, live

    def window_count(self, window_s: float, **labels) -> int:
        """Observations recorded in the last ``window_s`` seconds
        (bucket granularity — a window narrower than one ring bucket
        widens to it, one wider than the ring span clamps to it)."""
        _, live = self._window_ring(window_s, **labels)
        return sum(b[1] for b in live)

    def window_rate(self, window_s: float, **labels) -> float:
        """Observations per second over the last ``window_s`` seconds
        (the error-rate reader when failures are observed as events)."""
        window_s, live = self._window_ring(window_s, **labels)
        return sum(b[1] for b in live) / window_s

    def window_sum(self, window_s: float, **labels) -> float:
        """Sum of observed values over the last ``window_s`` seconds."""
        _, live = self._window_ring(window_s, **labels)
        return sum(b[2] for b in live)

    def window_samples(self, window_s: float, **labels) -> List[float]:
        """The raw samples retained for the last ``window_s`` seconds
        (unsorted; at most ``window_cap`` per ring bucket).  The SLO
        engine's burn-rate reader: the violating fraction of these IS
        the fraction of the error budget being burned."""
        _, live = self._window_ring(window_s, **labels)
        return [v for b in live for v in b[3]]

    def window_quantile(self, q: float, window_s: float,
                        **labels) -> Optional[float]:
        """``q``-quantile over the last ``window_s`` seconds, from the
        windowed reservoir: exact while the in-window buckets are under
        their per-bucket cap, an unbiased uniform-subsample estimate
        beyond (linear interpolation between order statistics, the
        :meth:`sample_quantile` convention).  None with no in-window
        samples — a recovered series goes back to None/ok instead of
        advertising a stale bad quantile forever."""
        res = self.window_samples(window_s, **labels)
        if not res:
            return None
        res.sort()
        pos = min(max(q, 0.0), 1.0) * (len(res) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(res) - 1)
        return res[lo] + (res[hi] - res[lo]) * (pos - lo)

    def window_retained(self, **labels) -> int:
        """Raw samples currently held across the whole ring for this
        series — bounded by buckets × window_cap by construction (the
        cross-window monotone memory bound)."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            return sum(len(b[3]) for b in s[4]) if s else 0

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s[1] if s else 0.0

    def cumulative_buckets(self, **labels) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` ending with ``(inf, count)``."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            counts = list(s[0]) if s else [0] * (len(self.buckets) + 1)
        out, acc = [], 0
        for ub, c in zip(self.buckets + (math.inf,), counts):
            acc += c
            out.append((ub, acc))
        return out

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = [(k, list(s[0]), s[1], s[2])
                     for k, s in sorted(self._series.items())]
        out = []
        for key, counts, total, n in items:
            acc, buckets = 0, []
            for ub, c in zip(self.buckets + (math.inf,), counts):
                acc += c
                buckets.append(["+Inf" if ub == math.inf else ub, acc])
            out.append({"labels": dict(key), "count": n,
                        "sum": total, "buckets": buckets,
                        "quantiles": self.quantiles(**dict(key))})
        return out


class MetricsRegistry:
    """Get-or-create home for every metric in the process.

    Re-requesting a name returns the existing instance; re-requesting it
    as a different type raises — a name means one thing process-wide.
    """

    def __init__(self) -> None:
        self._lock = named_lock("observe.registry")
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested as {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  sample_cap: Optional[int] = None,
                  **window_kw) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets,
                         sample_cap=sample_cap, **window_kw)

    def find(self, name: str) -> Optional[_Metric]:
        """The registered metric of that name, or None — readers that
        must not CREATE a series (the SLO evaluator, the fleet frame's
        windowed-TTFT stamp) probe with this instead of the
        get-or-create accessors."""
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def snapshot(self) -> List[Dict[str, Any]]:
        """Self-describing dump of every metric (the JSONL line body)."""
        return [m.describe() for m in self.metrics()]

    def flat(self, kinds: Sequence[str] = ("counter", "gauge")
             ) -> Dict[str, float]:
        """``{'name{k="v"}': value}`` for scalar metric kinds — the
        compact form bench lines and delta assertions consume."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            if m.kind not in kinds:
                continue
            for s in m.samples():
                out[m.name + format_labels(_label_key(s["labels"]))] = \
                    s["value"]
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition-format dump of the registry."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            qlines: List[str] = []
            for s in m.samples():
                key = _label_key(s["labels"])
                if m.kind == "histogram":
                    for le, acc in zip([b[0] for b in s["buckets"]],
                                       [b[1] for b in s["buckets"]]):
                        lk = _label_key({**s["labels"], "le": le})
                        lines.append(
                            f"{m.name}_bucket{format_labels(lk)} {acc}")
                    lines.append(f"{m.name}_sum{format_labels(key)} "
                                 f"{s['sum']}")
                    lines.append(f"{m.name}_count{format_labels(key)} "
                                 f"{s['count']}")
                    # derived p50/p95/p99 as a sibling gauge family
                    # (summary-style quantile label): SLOs readable off
                    # one scrape, no PromQL histogram_quantile needed
                    for tag, v in s.get("quantiles", {}).items():
                        lk = _label_key({**s["labels"],
                                         "quantile": f"0.{tag[1:]}"})
                        qlines.append(
                            f"{m.name}_q{format_labels(lk)} {v}")
                else:
                    lines.append(
                        f"{m.name}{format_labels(key)} {s['value']}")
            if qlines:
                lines.append(f"# TYPE {m.name}_q gauge")
                lines.extend(qlines)
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every metric (tests; a live process never resets)."""
        with self._lock:
            self._metrics.clear()


#: The process-wide registry every subsystem instruments against.
REGISTRY = MetricsRegistry()


# The module-level get-or-create shims forward their caller's name
# verbatim — THEY are not registration sites, their callers are
# (PT-METRIC judges the literal-ness of the name where it originates).
def counter(name: str, help: str = "") -> Counter:
    # ptpu: lint-ok[PT-METRIC] forwarding shim; callers are the sites
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    # ptpu: lint-ok[PT-METRIC] forwarding shim; callers are the sites
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Optional[Sequence[float]] = None,
              sample_cap: Optional[int] = None, **window_kw) -> Histogram:
    # ptpu: lint-ok[PT-METRIC] forwarding shim; callers are the sites
    return REGISTRY.histogram(name, help, buckets=buckets,
                              sample_cap=sample_cap, **window_kw)
