"""The port's windowed reservoirs and SLO engine
(``paddle_tpu_torch/observe/metrics.py``, ``observe/slo.py``) on the
CPU: the cases of ``tests/test_slo.py``, its two fleet cases included,
run against the port, and the same objectives over the same
samples through both packages' engines, which must give the same
verdicts, values and burn rates (exactly: both are the same float64
arithmetic over the same samples).
"""

import contextlib
import json
import threading
import urllib.error
import urllib.request

import pytest

from paddle_tpu_torch import observe
from paddle_tpu_torch.observe import MetricsRegistry, REGISTRY
from paddle_tpu_torch.observe import slo as slo_mod
from paddle_tpu_torch.observe.metrics import (WINDOW_BUCKETS,
                                              WINDOW_SAMPLE_CAP)
from paddle_tpu_torch.observe.slo import (Objective, SloEngine,
                                          SloParseError, parse_objective,
                                          parse_objectives)
from paddle_tpu_torch.utils import FLAGS


@pytest.fixture(autouse=True)
def _port_state():
    """The port's registry, engine and fleet identity are its own
    (tests/conftest.py resets only the JAX package's)."""
    observe.fleet.reset_identity()
    yield
    observe.stop_global()
    observe.fleet.reset_identity()
    REGISTRY.reset()
    slo_mod.reset()


@contextlib.contextmanager
def _flag(name, value):
    saved = FLAGS.get(name)
    FLAGS.set(name, value)
    try:
        yield
    finally:
        FLAGS.set(name, saved)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _hist(clock, name="ttft_seconds", **kw):
    return MetricsRegistry().histogram(name, "test", clock=clock, **kw)


# -------------------------------------------------- windowed reservoirs
def test_window_bucket_expiry():
    clk = FakeClock()
    h = _hist(clk)
    for _ in range(10):
        h.observe(0.25)
        clk.advance(0.1)
    assert h.window_count(60.0) == 10
    assert h.window_quantile(0.5, 60.0) == pytest.approx(0.25)
    # advance past the window: every bucket expires from the READ
    # (the ring still holds them — constant memory, lazy expiry)
    clk.advance(120.0)
    assert h.window_count(60.0) == 0
    assert h.window_quantile(0.5, 60.0) is None
    assert h.window_samples(60.0) == []
    # but the LIFETIME reservoir still remembers — the two views are
    # exactly the stale-p99 fix the windowed reader exists for
    assert h.sample_quantile(0.5) == pytest.approx(0.25)


def test_window_partial_expiry_slides():
    clk = FakeClock()
    h = _hist(clk)
    h.observe(1.0)             # t=0, bucket [0, 5)
    clk.advance(30.0)
    h.observe(2.0)             # t=30, bucket [30, 35)
    clk.advance(29.0)          # now=59: both buckets inside 60s
    assert h.window_count(60.0) == 2
    clk.advance(7.0)           # now=66: bucket [0,5) end=5 <= 6 cutoff
    assert h.window_count(60.0) == 1
    assert h.window_quantile(0.99, 60.0) == pytest.approx(2.0)


def test_window_exact_quantiles_under_cap():
    clk = FakeClock()
    h = _hist(clk)
    vals = [float(i) for i in range(1, 101)]     # 100 < per-bucket cap
    for v in vals:
        h.observe(v)
    # exact order statistics with linear interpolation
    assert h.window_quantile(0.0, 60.0) == pytest.approx(1.0)
    assert h.window_quantile(1.0, 60.0) == pytest.approx(100.0)
    assert h.window_quantile(0.5, 60.0) == pytest.approx(50.5)
    assert h.window_quantile(0.99, 60.0) == pytest.approx(99.01)


def test_window_rate_and_sum():
    clk = FakeClock()
    h = _hist(clk)
    for _ in range(30):
        h.observe(2.0)
        clk.advance(1.0)       # 30 events over 30 s
    assert h.window_count(30.0) == pytest.approx(30, abs=5)
    assert h.window_rate(30.0) == pytest.approx(1.0, rel=0.2)
    assert h.window_sum(60.0) == pytest.approx(60.0)


def test_window_memory_bound_monotone_across_windows():
    """The cross-window memory bound: an unbounded observation stream
    retains at most ``buckets x cap`` window samples, and the bound
    does not grow as time advances across many ring rotations."""
    clk = FakeClock()
    h = _hist(clk)
    bound = WINDOW_BUCKETS * WINDOW_SAMPLE_CAP
    last = 0
    for burst in range(50):
        for _ in range(1000):
            h.observe(1.0)
        retained = h.window_retained()
        assert retained <= bound
        # monotone within the span, never beyond the bound
        assert retained >= min(last, bound - WINDOW_SAMPLE_CAP)
        last = retained
        clk.advance(5.0)       # next bucket each burst
    assert h.window_retained() <= bound
    # lifetime reservoir holds its own (separate) bound
    assert h.retained_samples() <= 2048


def test_window_concurrency_8_threads():
    clk = FakeClock()
    h = _hist(clk)
    n, k = 8, 2000
    start = threading.Barrier(n)

    def worker(i):
        start.wait()
        for j in range(k):
            h.observe(float(i))

    ts = [threading.Thread(target=worker, args=(i,),
                           name=f"ptpu-test-slo-{i}") for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # count/sum are exact under concurrency; samples stay capped
    assert h.window_count(60.0) == n * k
    assert h.window_retained() <= WINDOW_BUCKETS * WINDOW_SAMPLE_CAP
    q = h.window_quantile(0.5, 60.0)
    assert q is not None and 0.0 <= q <= n - 1


def test_window_labeled_series_are_independent():
    clk = FakeClock()
    h = _hist(clk)
    h.observe(1.0, shard="a")
    h.observe(9.0, shard="b")
    assert h.window_quantile(0.5, 60.0, shard="a") == pytest.approx(1.0)
    assert h.window_quantile(0.5, 60.0, shard="b") == pytest.approx(9.0)
    assert h.window_count(60.0, shard="a") == 1


def test_window_disabled_with_zero_cap():
    clk = FakeClock()
    h = _hist(clk, window_cap=0)
    h.observe(1.0)
    assert h.window_count(60.0) == 0
    assert h.window_quantile(0.5, 60.0) is None
    assert h.window_retained() == 0
    assert h.sample_quantile(0.5) == pytest.approx(1.0)


# --------------------------------------------------- objective grammar
def test_parse_objective_quantile():
    o = parse_objective("serve_ttft_seconds:p99<0.5:60s")
    assert (o.metric, o.stat, o.op) == ("serve_ttft_seconds", "p99", "<")
    assert o.q == pytest.approx(0.99)
    assert o.threshold == 0.5 and o.window_s == 60.0
    assert o.text == "serve_ttft_seconds:p99<0.5:60s"


def test_parse_objective_rate_and_minutes():
    o = parse_objective("serve_request_failures:rate<0.1:5m")
    assert o.stat == "rate" and o.q is None
    assert o.window_s == 300.0
    assert o.text.endswith(":300s")           # canonical spelling
    o2 = parse_objective("train_samples_per_sec_hist:p50>100:2m")
    assert o2.op == ">" and o2.window_s == 120.0


def test_parse_objectives_joined_and_empty():
    objs = parse_objectives(
        "a_metric:p99<0.5:60s, b_metric:rate<1:30s; c_metric:p50>2:1m")
    assert [o.metric for o in objs] == ["a_metric", "b_metric",
                                       "c_metric"]
    assert parse_objectives("") == []
    assert parse_objectives("  ") == []


@pytest.mark.parametrize("bad", [
    "nope", "m:p99<0.5", "m:p99<0.5:60x", "m:p101<0.5:60s",
    "m:p0<0.5:60s", "m:q99<0.5:60s", "m:p99=0.5:60s",
    "m:p99<0.5:0s", "m:rate<:60s",
])
def test_parse_objective_rejects(bad):
    with pytest.raises(SloParseError):
        parse_objective(bad)


def test_objective_violates_both_ops():
    lt = Objective("m", "p99", "<", 0.5, 60.0)
    assert lt.violates(0.5) and lt.violates(0.9)
    assert not lt.violates(0.49)
    gt = Objective("m", "p50", ">", 10.0, 60.0)
    assert gt.violates(10.0) and gt.violates(1.0)
    assert not gt.violates(11.0)


# -------------------------------------------------- burn-rate engine
def _engine(clk, spec="ttft_seconds:p99<0.5:60s", **kw):
    reg = MetricsRegistry()
    h = reg.histogram("ttft_seconds", "test", clock=clk)
    eng = SloEngine([spec], registry=reg, clock=clk, **kw)
    return reg, h, eng


def test_engine_no_data_and_missing_metric():
    clk = FakeClock()
    _, _, eng = _engine(clk)
    (v,) = eng.evaluate()
    assert v["status"] == "no_data" and v["value"] is None
    eng2 = SloEngine(["never_observed:p99<1:60s"],
                     registry=MetricsRegistry(), clock=clk)
    (v2,) = eng2.evaluate()
    assert v2["status"] == "no_data"


def test_burn_breach_requires_fast_and_slow():
    """A transient spike trips the fast window but not the slow
    confirmation window — status stays ok (the PR-11 lesson)."""
    clk = FakeClock()
    reg, h, eng = _engine(clk)
    # 5 minutes of good traffic fills the slow (300s) window
    for _ in range(300):
        h.observe(0.1)
        clk.advance(1.0)
    (v,) = eng.evaluate()
    assert v["status"] == "ok" and v["burn_fast"] == 0.0
    # one bad scrape: a couple of slow samples — ~3% of the fast
    # window (burn 3.3 on a 1% budget) but ~0.7% of the slow one
    for _ in range(2):
        h.observe(1.0)
        clk.advance(1.0)
    (v,) = eng.evaluate()
    assert v["burn_fast"] >= 1.0          # fast window IS burning
    assert v["burn_slow"] < 1.0           # slow window says transient
    assert v["status"] == "ok"            # no standing breach


def test_burn_breach_recover_standing_clear():
    """breach → recover → standing-clear: a standing regression
    breaches (both windows ≥ 1); once the regression is fixed the
    fast window clears first and status returns to ok while the slow
    window is still draining."""
    clk = FakeClock()
    reg, h, eng = _engine(clk)
    for _ in range(60):
        h.observe(0.1)
        clk.advance(1.0)
    # standing regression: 5 minutes of bad p99
    for _ in range(300):
        h.observe(1.0)
        clk.advance(1.0)
    (v,) = eng.evaluate()
    assert v["status"] == "breach"
    assert v["burn_fast"] >= 1.0 and v["burn_slow"] >= 1.0
    # recovery: 90 s of good traffic — fast (60s) window is clean,
    # slow (300s) window still holds the regression
    for _ in range(90):
        h.observe(0.1)
        clk.advance(1.0)
    (v,) = eng.evaluate()
    assert v["burn_fast"] < 1.0
    assert v["burn_slow"] >= 1.0          # still draining
    assert v["status"] == "ok"            # the standing-clear


def test_rate_objective_breach_and_zero_threshold():
    clk = FakeClock()
    reg = MetricsRegistry()
    h = reg.histogram("errs", "test", clock=clk)
    eng = SloEngine(["errs:rate<0.1:60s"], registry=reg, clock=clk)
    for _ in range(120):                  # 2 errors/s for 2 minutes
        h.observe(1.0)
        h.observe(1.0)
        clk.advance(1.0)
    (v,) = eng.evaluate()
    assert v["status"] == "breach"
    assert v["value"] == pytest.approx(2.0, rel=0.2)
    assert v["burn_fast"] == pytest.approx(20.0, rel=0.2)


def test_evaluate_publishes_gauges_and_eval_histogram():
    clk = FakeClock()
    reg, h, eng = _engine(clk)
    for _ in range(30):
        h.observe(0.1)
        clk.advance(1.0)
    eng.evaluate()
    obj = "ttft_seconds:p99<0.5:60s"
    assert reg.gauge("slo_status", "").value(objective=obj) == 1.0
    assert reg.gauge("slo_burn_rate", "").value(objective=obj) == 0.0
    assert reg.histogram("slo_eval_seconds", "").count() == 1
    # a breach flips the status gauge to 0
    for _ in range(600):
        h.observe(2.0)
        clk.advance(1.0)
    eng.evaluate()
    assert reg.gauge("slo_status", "").value(objective=obj) == 0.0
    assert reg.gauge("slo_burn_rate", "").value(objective=obj) >= 1.0


def test_evaluator_fault_degrades_to_no_data():
    """Telemetry never kills: an objective whose read faults reports
    no_data instead of raising into the reporter thread."""
    clk = FakeClock()
    reg, h, eng = _engine(clk)
    h.observe(0.1)

    def boom(*a, **kw):
        raise RuntimeError("window exploded")

    h.window_samples = boom               # sabotage the reader
    (v,) = eng.evaluate()                 # must not raise
    assert v["status"] == "no_data"


def test_status_doc_and_frame_digest():
    clk = FakeClock()
    reg, h, eng = _engine(clk)
    for _ in range(600):
        h.observe(2.0)
        clk.advance(1.0)
    doc = eng.status_doc()
    assert doc["status"] == "breach"
    assert doc["breached"] == ["ttft_seconds:p99<0.5:60s"]
    digest = eng.frame_digest()
    assert digest["status"] == "breach"
    entry = digest["objectives"]["ttft_seconds:p99<0.5:60s"]
    assert entry["status"] == "breach" and entry["burn_fast"] >= 1.0


# ------------------------------------------------------------- surfaces
def test_configure_from_flags_and_kill_switch():
    try:
        with _flag("slo", ""):
            assert slo_mod.configure_from_flags() is None
            assert slo_mod.active_engine() is None
        with _flag("slo", "serve_ttft_seconds:p99<0.5:60s"):
            eng = slo_mod.configure_from_flags()
            assert eng is not None
            assert slo_mod.active_engine() is eng
            assert slo_mod.configure_from_flags() is eng   # idempotent
    finally:
        slo_mod.reset()


def test_configure_from_flags_malformed_warns_engine_off():
    try:
        with _flag("slo", "totally bogus"):
            assert slo_mod.configure_from_flags() is None
            assert slo_mod.active_engine() is None
    finally:
        slo_mod.reset()


def test_http_slo_endpoint_and_healthz_block():
    from paddle_tpu_torch.observe.http import ObservabilityServer

    with ObservabilityServer(0) as srv:
        # engine-less process: /slo is 404, /healthz has no slo key
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/slo", timeout=30)
        assert ei.value.code == 404
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz",
                timeout=30) as resp:
            hz = json.loads(resp.read())
        assert "slo" not in hz
        # 404 path list names /slo
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/nope", timeout=30)
        assert "/slo" in json.loads(ei.value.read())["paths"]

        clk = FakeClock()
        h = REGISTRY.histogram("serve_ttft_seconds", "ttft", clock=clk)
        eng = SloEngine(["serve_ttft_seconds:p99<0.5:60s"], clock=clk)
        try:
            slo_mod.set_engine(eng)
            for _ in range(600):
                h.observe(2.0)
                clk.advance(1.0)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/slo",
                    timeout=30) as resp:
                doc = json.loads(resp.read())
            assert doc["status"] == "breach"
            # degraded-but-ALIVE: status degrades, the code stays 200
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/healthz",
                    timeout=30) as resp:
                hz = json.loads(resp.read())
            assert hz["status"] == "degraded"
            assert hz["slo"]["status"] == "breach"
        finally:
            slo_mod.reset()


def test_reporter_evaluates_engine_on_interval(tmp_path):
    from paddle_tpu_torch.observe.report import MetricsReporter

    clk = FakeClock()
    h = REGISTRY.histogram("serve_ttft_seconds", "ttft", clock=clk)
    for _ in range(600):
        h.observe(2.0)
        clk.advance(1.0)
    eng = SloEngine(["serve_ttft_seconds:p99<0.5:60s"], clock=clk)
    try:
        slo_mod.set_engine(eng)
        r = MetricsReporter(str(tmp_path / "m.jsonl"),
                            interval_s=0.05).start()
        try:
            deadline = 50
            while not eng.last() and deadline:
                import time as _t
                _t.sleep(0.05)
                deadline -= 1
            assert eng.last(), "reporter never evaluated the engine"
            assert eng.last()[0]["status"] == "breach"
        finally:
            r.stop()
    finally:
        slo_mod.reset()


def test_start_from_flags_starts_reporter_for_slo_alone():
    from paddle_tpu_torch.observe import report

    with _flag("slo", "serve_ttft_seconds:p99<0.5:60s"):
        try:
            r = report.start_from_flags()
            assert r is not None
            assert slo_mod.active_engine() is not None
        finally:
            report.stop_global()
            slo_mod.reset()


def test_fleet_frame_rollup_and_watch_carry_slo():
    from paddle_tpu_torch.observe import fleet
    from paddle_tpu_torch.observe.fleet import FleetAggregator

    def frame(name, slo=None, serving=None):
        f = {"schema": 1, "kind": "fleet-frame", "role": "serving",
             "name": name, "node": "host-a", "pid": 7, "seq": 0,
             "ts": 0.0, "uptime_s": 1.0, "interval_s": 600.0,
             "going_down": False, "health": {"status": "ok"},
             "metrics": [], "timers": [], "spans": []}
        if slo is not None:
            f["slo"] = slo
        if serving is not None:
            f["serving"] = serving
        return f

    with FleetAggregator(0) as agg:
        breach = {"status": "breach",
                  "breached": ["serve_ttft_seconds:p99<0.5:60s"],
                  "objectives": {}}
        agg.state.ingest(frame(
            "serve-bad", slo=breach,
            serving={"model_version": "a" * 64,
                     "rollout_state": "serving",
                     "ttft_p99_s": 0.75, "error_rate_s": 0.0}))
        agg.state.ingest(frame(
            "serve-good", slo={"status": "ok", "breached": [],
                               "objectives": {}}))
        roll = agg.state.rollup()
        # an SLO breach marks the process degraded, objective named
        assert roll["procs"]["serve-bad"]["status"] == "degraded"
        assert roll["procs"]["serve-bad"]["slo"] == "breach"
        assert roll["procs"]["serve-bad"]["slo_breached"] == \
            ["serve_ttft_seconds:p99<0.5:60s"]
        assert roll["procs"]["serve-good"]["status"] == "ok"
        topo = agg.state.topology()
        assert topo["procs"]["serve-bad"]["ttft_p99_s"] == 0.75
        assert topo["procs"]["serve-bad"]["slo"] == "breach"
        rows = agg.state.watch_rows()
        (bad,) = [r for r in rows if r["proc"] == "serve-bad"]
        assert bad["ttft_p99_s"] == 0.75 and bad["slo"] == "breach"
        rendered = fleet.render_watch(roll, rows)
        assert "p99_ttft" in rendered and "slo" in rendered
        assert "750ms" in rendered and "breach" in rendered
        # a frame with NO slo field renders "-" (older pushers)
        (good,) = [r for r in rows if r["proc"] == "serve-good"]
        assert good["ttft_p99_s"] is None


def test_pusher_frame_carries_slo_and_windowed_ttft():
    from paddle_tpu_torch.observe import fleet
    from paddle_tpu_torch.observe.fleet import FleetPusher

    clk = FakeClock()
    h = REGISTRY.histogram("serve_ttft_seconds", "ttft", clock=clk)
    eng = SloEngine(["serve_ttft_seconds:p99<0.5:60s"], clock=clk)
    try:
        slo_mod.set_engine(eng)
        for _ in range(60):
            h.observe(0.2)
            clk.advance(1.0)
        eng.evaluate()
        fleet.set_serving_info(version="c" * 64, state="serving")
        p = FleetPusher("127.0.0.1:1", interval_s=600.0)
        frame = p.build_frame()
        assert frame["slo"]["status"] == "ok"
        assert frame["serving"]["ttft_p99_s"] == pytest.approx(
            0.2, rel=0.01)
    finally:
        fleet.reset_identity()
        slo_mod.reset()


# ----------------------------------------------- against the JAX package
def _scenario(clk, h, kind):
    """One sample stream per case of the burn-rate tests above."""
    if kind == "transient":
        for _ in range(300):
            h.observe(0.1)
            clk.advance(1.0)
        for _ in range(2):
            h.observe(1.0)
            clk.advance(1.0)
    elif kind == "standing_then_clear":
        for v, n in ((0.1, 60), (1.0, 300), (0.1, 90)):
            for _ in range(n):
                h.observe(v)
                clk.advance(1.0)
    elif kind == "breach":
        for _ in range(600):
            h.observe(2.0)
            clk.advance(1.0)
    else:                                  # "rate": 2 events a second
        for _ in range(120):
            h.observe(1.0)
            h.observe(1.0)
            clk.advance(1.0)


@pytest.mark.parametrize("kind,specs", [
    ("transient", ["m:p99<0.5:60s", "m:p90<0.5:1m"]),
    ("standing_then_clear", ["m:p99<0.5:60s", "m:p50>0.05:30s"]),
    ("breach", ["m:p99<0.5:60s", "m:p99.9<3:2m"]),
    ("rate", ["m:rate<0.1:60s", "m:rate>5:30s", "m:rate<0:60s"]),
])
def test_verdicts_and_burn_rates_equal_the_jax_packages(kind, specs):
    from paddle_tpu.observe import MetricsRegistry as JRegistry
    from paddle_tpu.observe.slo import SloEngine as JEngine

    out = []
    for reg_cls, eng_cls in ((JRegistry, JEngine),
                             (MetricsRegistry, SloEngine)):
        clk = FakeClock()
        reg = reg_cls()
        h = reg.histogram("m", "test", clock=clk)
        eng = eng_cls(specs, registry=reg, clock=clk)
        _scenario(clk, h, kind)
        out.append((eng.evaluate(), eng.status_doc()["status"],
                    eng.frame_digest(),
                    [reg.gauge("slo_burn_rate", "").value(
                        objective=o.text) for o in eng.objectives]))
    assert out[0] == out[1]
    assert [o.text for o in parse_objectives(";".join(specs))] == \
        [v["objective"] for v in out[1][0]]
