"""The port's telemetry core (``paddle_tpu_torch/observe``,
``utils/stat.py``, ``utils/profiler.py``) against the JAX package's.

- The cases of ``tests/test_observe.py``: registry semantics, the export
  schema, ``warn_once``, the ``StatSet`` table, the RNN dispatch counter
  against the JAX tier predicate (``pallas_lstm.fused_tier``) at small
  shapes, the trainer's step split and loop gauges on the port's
  ``Trainer`` on the CPU, the ResNet-50 fused-pair census, the bounded
  reservoirs.
- The telemetry cases of ``tests/test_pipeline.py``.
- Across the packages: a registry (and a reporter with a timer table)
  holding the same instruments renders the same Prometheus text byte for
  byte; a JSONL line carries the same keys; a tiny ``Trainer.train``
  pass in each package records the same (metric name, kind, label keys)
  — but the JAX trainer's ``jit_recompiles``, which an eager step has no
  counterpart of — and the same span names and parentage.
- The port's own pieces: the step's fence (``block_until_ready``), the
  timers' ``--enable_timers``, the memory gauges on the CPU, the SIGTERM
  flush, ``enable_fp_exceptions``, the refusals of A10b part 3, the SLO
  engine found on ``/slo`` and ``/healthz`` (``tests/test_torch_slo.py``
  holds the engine itself; ``tests/test_torch_port_rules.py`` holds
  that importing ``paddle_tpu_torch.observe`` loads no torch).

Each test resets the port's registry, trace, reporter, endpoint and
handlers in a fixture of this file (``tests/conftest.py`` resets the JAX
package's).
"""

import json
import logging
import math
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import observe
from paddle_tpu_torch.observe import (
    Histogram,
    MetricsRegistry,
    MetricsReporter,
    REGISTRY,
    trace,
)
from paddle_tpu_torch.utils import FLAGS, PaddleTpuError
from paddle_tpu_torch.utils.logger import reset_warn_once, warn_once
from paddle_tpu_torch.utils.stat import StatSet, global_stat

@pytest.fixture(autouse=True)
def _port_state():
    """The port's process-wide telemetry put back after every test."""
    old_term = signal.getsignal(signal.SIGTERM)
    yield
    observe.stop_global()
    global_stat.reset()
    REGISTRY.reset()
    reset_warn_once()
    signal.signal(signal.SIGTERM, old_term)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- registry
def test_counter_monotonic_and_labeled():
    reg = MetricsRegistry()
    c = reg.counter("req_total", "requests")
    c.inc()
    c.inc(2.5)
    c.inc(3, kind="a")
    assert c.value() == 3.5
    assert c.value(kind="a") == 3
    assert c.total() == 6.5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert c.total() == 6.5   # the rejected inc left no trace


def test_registry_get_or_create_and_type_collision():
    reg = MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


def test_gauge_set_inc_dec():
    g = MetricsRegistry().gauge("q_depth")
    g.set(5)
    g.inc(2)
    g.dec()
    assert g.value() == 6
    g.set(0.25, shard="0")
    assert g.value(shard="0") == 0.25


def test_histogram_bucket_boundaries():
    h = MetricsRegistry().histogram("lat", buckets=(0.1, 0.5, 1.0))
    for v in (0.05, 0.1, 0.100001, 0.5, 0.9, 7.0):
        h.observe(v)
    assert h.cumulative_buckets() == [
        (0.1, 2), (0.5, 4), (1.0, 5), (math.inf, 6)]
    assert h.count() == 6
    assert h.sum() == pytest.approx(0.05 + 0.1 + 0.100001 + 0.5 + 0.9 + 7.0)


def test_histogram_time_context():
    h = MetricsRegistry().histogram("t", buckets=(10.0,))
    with h.time():
        pass
    assert h.count() == 1 and 0 <= h.sum() < 10


def test_histogram_quantile_interpolation():
    h = MetricsRegistry().histogram("lat", buckets=(1.0, 2.0))
    for _ in range(50):
        h.observe(0.5)
    for _ in range(50):
        h.observe(1.5)
    assert h.quantile(0.5) == pytest.approx(1.0)
    assert h.quantile(0.75) == pytest.approx(1.5)
    assert h.quantile(1.0) == pytest.approx(2.0)
    assert h.quantiles() == {"p50": pytest.approx(1.0),
                             "p95": pytest.approx(1.9),
                             "p99": pytest.approx(1.98)}


def test_histogram_quantile_overflow_clamps_to_last_finite_bound():
    h = MetricsRegistry().histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.2, 0.9, 5.0, 7.0, 9.0):
        h.observe(v)
    assert h.quantile(0.5) == pytest.approx(1.0)
    assert h.quantile(0.99) == 1.0
    assert math.isfinite(h.quantiles()["p99"])


def test_histogram_quantile_empty_and_labeled_series():
    h = MetricsRegistry().histogram("lat", buckets=(1.0,))
    assert h.quantile(0.5) is None and h.quantiles() == {}
    h.observe(0.25, op="read")
    assert h.quantile(0.5, op="read") == pytest.approx(0.5)
    assert h.quantile(0.5) is None


def test_quantiles_exported_on_samples_and_prometheus_dump():
    reg = MetricsRegistry()
    h = reg.histogram("step_seconds", buckets=(0.1, 1.0))
    for _ in range(100):
        h.observe(0.05)
    s = h.samples()[0]
    assert set(s["quantiles"]) == {"p50", "p95", "p99"}
    assert s["quantiles"]["p50"] == pytest.approx(0.05)
    txt = reg.prometheus_text()
    assert "# TYPE step_seconds_q gauge" in txt
    assert 'step_seconds_q{quantile="0.50"}' in txt
    assert 'step_seconds_q{quantile="0.95"}' in txt
    assert 'step_seconds_q{quantile="0.99"}' in txt


def test_concurrent_increments_from_threads():
    reg = MetricsRegistry()
    c = reg.counter("n")
    h = reg.histogram("hh", buckets=(0.5, 1.0))

    def work():
        for _ in range(1000):
            c.inc()
            h.observe(0.25)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value() == 8000
    assert h.count() == 8000
    assert h.cumulative_buckets()[0] == (0.5, 8000)


# --------------------------------------------------------------- export
def test_jsonl_schema_round_trip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("c", "help c").inc(3, kind="x")
    reg.gauge("g").set(0.5)
    reg.histogram("h", buckets=(1.0, 2.0)).observe(1.5)
    stat = StatSet("test")
    with stat.timer("unit"):
        pass
    path = str(tmp_path / "m.jsonl")
    rep = MetricsReporter(path, registry=reg, stat=stat)
    rep.flush()
    rep.flush()
    lines = [json.loads(ln) for ln in open(path)]
    assert [ln["seq"] for ln in lines] == [0, 1]
    assert all("ts" in ln for ln in lines)
    by_name = {m["name"]: m for m in lines[0]["metrics"]}
    assert by_name["c"]["type"] == "counter"
    assert by_name["c"]["help"] == "help c"
    assert by_name["c"]["samples"] == [{"labels": {"kind": "x"}, "value": 3}]
    assert by_name["g"]["samples"][0]["value"] == 0.5
    hs = by_name["h"]["samples"][0]
    assert hs["count"] == 1 and hs["sum"] == 1.5
    assert hs["buckets"] == [[1.0, 0], [2.0, 1], ["+Inf", 1]]
    timers = {t["name"]: t for t in lines[0]["timers"]}
    assert timers["unit"]["count"] == 1
    assert timers["unit"]["min"] <= timers["unit"]["max"]
    assert timers["unit"]["avg"] == pytest.approx(
        timers["unit"]["total"] / timers["unit"]["count"])


def test_prometheus_text_dump():
    reg = MetricsRegistry()
    reg.counter("c_total", "a counter").inc(2, op="x")
    reg.histogram("lat_seconds", buckets=(0.1,)).observe(0.05)
    stat = StatSet()
    with stat.timer("fwd"):
        pass
    txt = MetricsReporter(registry=reg, stat=stat).prometheus_text()
    assert "# HELP c_total a counter" in txt
    assert "# TYPE c_total counter" in txt
    assert 'c_total{op="x"} 2' in txt
    assert 'lat_seconds_bucket{le="0.1"} 1' in txt
    assert 'lat_seconds_bucket{le="+Inf"} 1' in txt
    assert "lat_seconds_count 1" in txt
    assert "# TYPE paddle_tpu_timer_seconds summary" in txt
    assert 'paddle_tpu_timer_seconds_count{name="fwd"} 1' in txt


def test_reporter_attach_active_and_stop(tmp_path):
    path = str(tmp_path / "sink.jsonl")
    assert observe.active() is False
    observe.attach(path, interval_s=999)
    try:
        assert observe.active() is True
        observe.counter("attached_c").inc()
    finally:
        observe.stop_global()
    assert observe.active() is False
    lines = [json.loads(ln) for ln in open(path)]  # stop() final-flushes
    assert any(m["name"] == "attached_c"
               for ln in lines for m in ln["metrics"])


def test_flat_compact_form():
    reg = MetricsRegistry()
    reg.counter("a").inc(2, k="v")
    reg.gauge("b").set(1.5)
    reg.histogram("h").observe(1)   # histograms excluded from flat()
    assert reg.flat() == {'a{k="v"}': 2, "b": 1.5}


def test_warn_once_logs_once_per_key():
    reset_warn_once()
    hits = []

    class Grab(logging.Handler):
        def emit(self, record):
            hits.append(record.getMessage())

    h = Grab()
    logging.getLogger("paddle_tpu_torch").addHandler(h)
    try:
        assert warn_once("k1", "message %d", 1) is True
        assert warn_once("k1", "message %d", 2) is False
        assert warn_once("k2", "other") is True
    finally:
        logging.getLogger("paddle_tpu_torch").removeHandler(h)
    assert hits == ["message 1", "other"]
    reset_warn_once()
    assert warn_once("k1", "message %d", 3) is True


def test_stat_min_column_printed():
    stat = StatSet("s")
    with stat.timer("op"):
        pass
    out = []
    stat.print_all_status(log=out.append)
    assert "min(ms)" in out[1]
    assert len(out) == 3 and len(out[2].split()) == 6


def test_enable_timers_flag_and_cpu_block_on():
    """``--enable_timers=false`` makes every timer a no-op; ``block_on``
    of CPU tensors (a dict of them too) needs no wait and still times."""
    stat = StatSet("s")
    with stat.timer("cpu", block_on={"loss": torch.ones(2)}):
        pass
    assert stat.item("cpu").count == 1
    FLAGS.set("enable_timers", False)
    try:
        with stat.timer("off"):
            pass
    finally:
        FLAGS.set("enable_timers", True)
    assert "off" not in stat.snapshot()


# ----------------------------------------------- dispatch-tier counters
def _lstm_once(b, h, t=3, **kw):
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops.recurrent_ops import lstm_sequence

    rng = np.random.RandomState(0)
    seq = SequenceBatch(
        torch.from_numpy(rng.randn(b, t, 4 * h).astype(np.float32)),
        torch.from_numpy(np.full((b,), t, np.int32)))
    w_hh = torch.from_numpy(rng.randn(h, 4 * h).astype(np.float32) * 0.01)
    return lstm_sequence(seq, None, w_hh, **kw)


@pytest.mark.parametrize("b,h", [(8, 128), (8, 100)])
def test_rnn_dispatch_counter_matches_tier_predicate(b, h):
    """The registry's ``rnn_dispatch_total`` path label agrees with the
    JAX package's tier predicate (``pallas_lstm.fused_tier``): (8, 128)
    fused, (8, 100) off lane tiling → scan."""
    from paddle_tpu.ops import pallas_lstm

    expect = pallas_lstm.fused_tier(b, h) or "scan"
    c = REGISTRY.counter("rnn_dispatch_total")
    before = sum(s["value"] for s in c.samples()
                 if s["labels"].get("kind") == "lstm")
    _lstm_once(b, h)
    after = [s for s in c.samples() if s["labels"].get("kind") == "lstm"]
    assert sum(s["value"] for s in after) == before + 1
    hit = [s for s in after if s["labels"]["path"] == expect]
    assert hit, f"no sample for expected path {expect!r}: {after}"
    if expect == "scan":
        assert "128" in hit[0]["labels"]["reason"]   # lane-tiling reason


def test_rnn_dispatch_counter_nondefault_activation_reason():
    _lstm_once(8, 128, gate_act="sigmoid", cell_act="relu",
               out_act="tanh")
    c = REGISTRY.counter("rnn_dispatch_total")
    assert c.value(kind="lstm", path="scan",
                   reason="non-default activations") == 1


def test_dispatch_counters_tick_with_the_module_counters():
    """The module-level ``Counter``s and the registry's counters move
    together, once per call (the JAX package ticks once per traced
    program: a deliberate difference)."""
    from paddle_tpu_torch.ops import recurrent_ops

    before = sum(recurrent_ops.rnn_dispatch_total.values())
    for _ in range(3):
        _lstm_once(8, 128)
    assert sum(recurrent_ops.rnn_dispatch_total.values()) - before == 3
    assert REGISTRY.counter("rnn_dispatch_total").value(
        kind="lstm", path="fused", reason="") == 3
    assert REGISTRY.counter("precision_dispatch_total").total() >= 3


# ------------------------------------------------- trainer instrumentation
def _tiny_trainer(seed=0):
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.config.dsl import config_scope
    from paddle_tpu_torch.config.model_config import OptimizationConfig
    from paddle_tpu_torch.data.feeder import DataFeeder, dense_vector, \
        integer_value
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.trainer.trainer import Trainer

    with config_scope():
        x = dsl.data("x", dense_vector(8))
        lab = dsl.data("label", integer_value(2))
        p = dsl.fc(x, size=2, act=dsl.SoftmaxActivation())
        cost = dsl.classification_cost(p, lab)
        cfg = dsl.topology(cost)
    tr = Trainer(NeuralNetwork(cfg), opt_config=OptimizationConfig(
        learning_method="momentum", momentum=0.9, learning_rate=0.05),
        seed=seed, device="cpu")
    feeder = DataFeeder([("x", dense_vector(8)),
                         ("label", integer_value(2))])
    return tr, feeder


def _batch(rng, n=4):
    return [(rng.randn(8).astype(np.float32), int(rng.randint(0, 2)))
            for _ in range(n)]


def test_trainer_step_metrics_with_sink(tmp_path):
    """With a sink attached the step is fenced: the host-feed +
    device-blocked split exists and fits in the step histogram, and the
    counters tick.  An eager step registers no ``jit_recompiles``."""
    tr, feeder = _tiny_trainer()
    rng = np.random.RandomState(0)
    tr.train_one_batch(feeder.convert(_batch(rng)))
    assert REGISTRY.find("jit_recompiles") is None
    REGISTRY.reset()
    observe.attach(str(tmp_path / "m.jsonl"), interval_s=999)
    try:
        for _ in range(3):
            tr.train_one_batch(feeder.convert(_batch(rng)))
    finally:
        observe.stop_global()
    assert REGISTRY.counter("train_steps").value() == 3
    assert REGISTRY.counter("train_samples").value() == 12
    step = REGISTRY.histogram("train_step_seconds")
    feed = REGISTRY.histogram("train_host_feed_seconds")
    dev = REGISTRY.histogram("train_device_blocked_seconds")
    assert step.count() == feed.count() == dev.count() == 3
    assert feed.sum() + dev.sum() <= step.sum() + 1e-6
    assert REGISTRY.gauge("train_samples_per_sec").value() > 0
    assert global_stat.item("train_batch").count == 4


def test_trainer_unfenced_without_sink():
    tr, feeder = _tiny_trainer()
    rng = np.random.RandomState(0)
    assert observe.active() is False
    tr.train_one_batch(feeder.convert(_batch(rng)))
    assert REGISTRY.counter("train_steps").value() == 1
    assert REGISTRY.histogram("train_device_blocked_seconds").count() == 0
    assert REGISTRY.histogram("train_step_seconds").count() == 1


def test_fence_waits_on_the_loss_only_when_listened_to(monkeypatch):
    """The step's fence is ``block_until_ready(loss)``, called once a
    step while a sink or an opened trace listens and never otherwise."""
    from paddle_tpu_torch.trainer import trainer as ttrainer

    calls = []
    monkeypatch.setattr(ttrainer, "block_until_ready",
                        lambda v: calls.append(v))
    tr, feeder = _tiny_trainer()
    rng = np.random.RandomState(0)
    loss = tr.train_one_batch(feeder.convert(_batch(rng)))
    assert calls == []
    trace.ensure_ring()                      # a /trace scrape: no fence
    tr.train_one_batch(feeder.convert(_batch(rng)))
    assert calls == []
    trace.enable()
    loss = tr.train_one_batch(feeder.convert(_batch(rng)))
    assert len(calls) == 1 and calls[0] is loss


def test_train_loop_input_bound_ratio():
    tr, feeder = _tiny_trainer()
    rng = np.random.RandomState(0)

    def reader():
        for _ in range(3):
            yield _batch(rng)

    saved = {k: FLAGS.get(k) for k in ("save_dir", "prefetch_depth")}
    FLAGS.set("save_dir", "")
    FLAGS.set("prefetch_depth", 0)
    try:
        tr.train(reader, num_passes=1, feeder=feeder)
    finally:
        for k, v in saved.items():
            FLAGS.set(k, v)
    ratio = REGISTRY.gauge("input_bound_ratio").value()
    assert 0.0 <= ratio <= 1.0
    assert REGISTRY.histogram("data_reader_wait_seconds").count() == 3
    assert REGISTRY.histogram("data_feed_convert_seconds").count() == 3


def test_network_fused_pair_census_resnet():
    """The build-time census gauge equals the peephole tables: ResNet-50
    resolves 16 3x3 + 16 1x1 forward pairs and no backward pair."""
    from paddle_tpu_torch.layers.network import NeuralNetwork
    from paddle_tpu_torch.models.image import resnet

    net = NeuralNetwork(resnet(50, 1000, 224))
    g = REGISTRY.gauge("network_conv_bn_fused_pairs")
    assert g.value(direction="fwd", kernel="3x3") == 16
    assert g.value(direction="fwd", kernel="1x1") == 16
    assert len(net._bn_conv_fuse) == 32
    assert g.value(direction="bwd", kernel="3x3") \
        == len(net._conv_bn_fuse) == 0
    assert REGISTRY.counter("network_builds_total").total() == 1


# --------------------------------------------- bounded sample reservoir
def test_histogram_reservoir_bounded_over_a_million_observations():
    h = Histogram("step_seconds", buckets=(0.5, 1.0), sample_cap=1024)
    rng = np.random.RandomState(7)
    for v in rng.uniform(0.0, 100.0, size=1_000_000):
        h.observe(float(v))
    assert h.count() == 1_000_000
    assert h.retained_samples() <= 1024
    assert h.sample_quantile(0.5) == pytest.approx(50.0, rel=0.08)
    assert h.sample_quantile(0.99) == pytest.approx(99.0, rel=0.08)
    assert h.quantile(0.99) == 1.0


def test_histogram_reservoir_does_not_depend_on_the_clock():
    """The lifetime reservoir's draws come from their own stream: how
    many window buckets the observations span (the clock) does not move
    its samples, so the sampled quantiles are the same however slowly a
    loaded machine observes."""
    def samples(step):
        t = [0.0]

        def clock():
            t[0] += step
            return t[0]
        h = Histogram("step_seconds", sample_cap=64, clock=clock)
        for v in np.random.RandomState(7).uniform(0.0, 100.0, size=20_000):
            h.observe(float(v))
        return [h.sample_quantile(q) for q in (0.1, 0.5, 0.99)]
    assert samples(0.0) == samples(1e-3) == samples(7.0)


def test_histogram_reservoir_exact_under_cap():
    h = Histogram("lat", sample_cap=64)
    for v in [1.0, 2.0, 3.0, 4.0, 5.0]:
        h.observe(v)
    assert h.retained_samples() == 5
    assert h.sample_quantile(0.0) == 1.0
    assert h.sample_quantile(0.5) == 3.0
    assert h.sample_quantile(1.0) == 5.0
    assert h.sample_quantile(0.25) == 2.0


def test_histogram_reservoir_per_label_series_and_disable():
    h = Histogram("lat", sample_cap=8)
    h.observe(1.0, op="read")
    h.observe(9.0, op="write")
    assert h.sample_quantile(0.5, op="read") == 1.0
    assert h.sample_quantile(0.5, op="write") == 9.0
    assert h.sample_quantile(0.5) is None
    off = Histogram("lat_off", sample_cap=0)
    for v in range(100):
        off.observe(float(v))
    assert off.retained_samples() == 0
    assert off.sample_quantile(0.5) is None
    assert off.quantile(0.5) is not None


def test_registry_histogram_passes_sample_cap():
    reg = MetricsRegistry()
    h = reg.histogram("x_seconds", sample_cap=16)
    for v in range(64):
        h.observe(float(v))
    assert h.retained_samples() == 16
    assert reg.histogram("x_seconds") is h


# ------------------------------------------------- pipeline telemetry
def test_pipeline_metrics_emitted():
    from paddle_tpu_torch.data.pipeline import AsyncPipeline

    def convert(b):
        time.sleep(0.001)
        return b

    pipe = AsyncPipeline(iter(range(8)), convert_fn=convert, depth=2,
                         workers=2)
    list(pipe)
    hits = observe.counter("pipeline_prefetch_hits_total").total()
    stalls = observe.counter("pipeline_prefetch_stalls_total").total()
    assert hits + stalls == 8
    assert observe.histogram(
        "pipeline_worker_convert_seconds").count() == 8
    assert observe.gauge("pipeline_queue_depth").value() == 0


def test_trainer_pipeline_sets_queue_wait_telemetry():
    """With the pipeline on, data_reader_wait_seconds counts queue-get
    waits and input_bound_ratio is still produced per pass."""
    rng = np.random.RandomState(0)
    data = [[(rng.randn(8).astype(np.float32), int(rng.randint(0, 2)))
             for _ in range(8)] for _ in range(6)]
    tr, feeder = _tiny_trainer()
    saved = {k: FLAGS.get(k) for k in ("save_dir", "prefetch_depth")}
    FLAGS.set("prefetch_depth", 2)
    FLAGS.set("save_dir", "")
    try:
        tr.train(lambda: iter(data), num_passes=1, feeder=feeder,
                 event_handler=lambda e: None)
    finally:
        for k, v in saved.items():
            FLAGS.set(k, v)
    assert observe.histogram("data_reader_wait_seconds").count() == 6
    ratio = observe.gauge("input_bound_ratio").value()
    assert 0.0 <= ratio <= 1.0
    assert observe.histogram(
        "pipeline_worker_convert_seconds").count() == 6


# ------------------------------------------------ across the packages
def _same_instruments(obs_mod, stat_cls):
    reg = obs_mod.MetricsRegistry()
    reg.counter("req_total", "requests served").inc(3, kind="a")
    reg.counter("req_total", "requests served").inc(0.5)
    reg.gauge("queue_depth", "waiting").set(7, shard="0")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0, 0.07):
        h.observe(v, op="read")
    stat = stat_cls("s")
    stat.item("fwd").add(0.25)
    stat.item("fwd").add(0.5)
    return reg, stat


def test_prometheus_text_is_the_jax_packages_byte_for_byte():
    import paddle_tpu.observe as jobs
    from paddle_tpu.utils.stat import StatSet as JStat

    jreg, jstat = _same_instruments(jobs, JStat)
    treg, tstat = _same_instruments(observe, StatSet)
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert MetricsReporter(registry=treg, stat=tstat).prometheus_text() \
        == jobs.MetricsReporter(registry=jreg, stat=jstat).prometheus_text()


def _keys(tree):
    """The key structure of a JSON value (dict keys, recursively; lists
    by their elements' union)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        out = {}
        for v in tree:
            k = _keys(v)
            if isinstance(k, dict):
                out.update(k)
        return out or "list"
    return "leaf"


def test_jsonl_line_carries_the_jax_packages_keys(tmp_path):
    import paddle_tpu.observe as jobs
    from paddle_tpu.utils.stat import StatSet as JStat

    lines = []
    for mod, stat_cls, tag in ((jobs, JStat, "j"), (observe, StatSet, "t")):
        reg, stat = _same_instruments(mod, stat_cls)
        path = str(tmp_path / f"{tag}.jsonl")
        mod.MetricsReporter(path, registry=reg, stat=stat).flush()
        with open(path) as f:
            lines.append(json.loads(f.readline()))
    assert _keys(lines[1]) == _keys(lines[0])
    assert [m["name"] for m in lines[1]["metrics"]] \
        == [m["name"] for m in lines[0]["metrics"]]


def _signature(obs_mod):
    return {(m.name, m.kind, tuple(sorted({k for s in m.samples()
                                           for k in s["labels"]})))
            for m in obs_mod.REGISTRY.metrics()}


def _span_tree(events):
    """(name, parent's name) of every span."""
    names = {e["args"]["span_id"]: e["name"] for e in events}
    return sorted({(e["name"], names.get(e["args"].get("parent_id")))
                   for e in events})


def test_a_tiny_train_pass_records_what_the_jax_trainer_records(tmp_path):
    """A 2-batch ``Trainer.train`` pass (the async pipeline on) of the
    same tiny net in each package, with a metrics sink and a trace on:
    the same (name, kind, label keys) of every metric but the JAX
    trainer's ``jit_recompiles`` (no counterpart in an eager step), and
    the same span names and parentage."""
    import paddle_tpu.observe as jobs
    from paddle_tpu.observe import trace as jtrace
    from paddle_tpu.utils import FLAGS as JFLAGS
    from test_observe import _tiny_trainer as j_tiny

    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(2)]
    flags = ("save_dir", "prefetch_depth")
    old = [{k: f.get(k) for k in flags} for f in (JFLAGS, FLAGS)]
    sigs, trees = [], []
    try:
        for mod, tr_mod, flag_reg, make in (
                (jobs, jtrace, JFLAGS, j_tiny),
                (observe, trace, FLAGS, _tiny_trainer)):
            flag_reg.set("save_dir", "")
            flag_reg.set("prefetch_depth", 2)
            mod.REGISTRY.reset()
            tr, feeder = make()
            path = str(tmp_path / f"{mod.__name__}.trace.json")
            mod.attach(str(tmp_path / f"{mod.__name__}.jsonl"),
                       interval_s=999)
            tr_mod.enable(jsonl_path=path)
            try:
                tr.train(lambda: iter(batches), num_passes=1,
                         feeder=feeder)
            finally:
                mod.stop_global()
            sigs.append(_signature(mod))
            with open(path) as f:
                trees.append(_span_tree(json.load(f)))
            mod.REGISTRY.reset()
    finally:
        for f, o in zip((JFLAGS, FLAGS), old):
            for k, v in o.items():
                f.set(k, v)
    jsig = {s for s in sigs[0] if s[0] != "jit_recompiles"}
    assert ("jit_recompiles", "counter", ()) in sigs[0]
    assert sigs[1] == jsig
    assert trees[1] == trees[0]
    assert ("fence", "train_step") in trees[1]
    assert ("pipeline_convert", "train_pass") in trees[1]


# ------------------------------------------------------ the port's own
def test_memory_account_on_the_cpu_and_the_gauges():
    """On the CPU the in-use figure is the sum of the categories (source
    ``tensors``); the gauges keep the JAX names."""
    from paddle_tpu_torch.observe import memory as omem

    tr, feeder = _tiny_trainer()
    feed = feeder.convert(_batch(np.random.RandomState(0)))
    omem.reset_peak()
    snap = omem.sample(tr, feed=feed)
    want = {"params": omem.tree_bytes(tr.params),
            "opt_state": omem.tree_bytes(tr.opt_state),
            "buffers": 0, "data": omem.tree_bytes(feed), "other": 0}
    assert snap["source"] == "tensors"
    assert snap["categories"] == want
    assert snap["in_use_bytes"] == snap["peak_bytes"] == sum(want.values())
    assert want["params"] == 4 * (8 * 2 + 2)
    assert REGISTRY.gauge("hbm_in_use_bytes").value() == sum(want.values())
    assert REGISTRY.gauge("hbm_category_bytes").value(
        category="params") == want["params"]
    assert snap["shards"]["params"] == {"cpu": want["params"]}
    assert omem.device_stats("cpu") is None


def test_pass_boundary_samples_memory_only_when_listened_to(tmp_path):
    tr, feeder = _tiny_trainer()
    rng = np.random.RandomState(0)
    batches = [_batch(rng)]
    saved = FLAGS.get("save_dir")
    FLAGS.set("save_dir", "")
    try:
        tr.train(lambda: iter(batches), num_passes=1, feeder=feeder)
        assert REGISTRY.find("hbm_in_use_bytes") is None
        observe.attach(str(tmp_path / "m.jsonl"), interval_s=999)
        tr.train(lambda: iter(batches), num_passes=1, feeder=feeder)
    finally:
        FLAGS.set("save_dir", saved)
    assert REGISTRY.gauge("hbm_in_use_bytes").value() > 0


def test_sigterm_hook_installs_only_with_a_surface_and_flushes(tmp_path):
    """The SIGTERM hook is installed only once a surface is configured;
    its flush writes the reporter's final line and closes the trace's
    JSON array."""
    from paddle_tpu_torch.observe import shutdown

    assert shutdown.install_from_flags() is False
    assert signal.getsignal(signal.SIGTERM) is not shutdown._handler
    sink, tpath = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    observe.attach(sink, interval_s=999)
    trace.enable(jsonl_path=tpath)
    assert shutdown.install_from_flags() is True
    assert signal.getsignal(signal.SIGTERM) is shutdown._handler
    with trace.span("last"):
        pass
    observe.counter("before_term_total").inc()
    shutdown.flush_for_shutdown()
    with open(tpath) as f:
        assert [e["name"] for e in json.load(f)] == ["last"]
    with open(sink) as f:
        last = json.loads(f.read().splitlines()[-1])
    assert any(m["name"] == "before_term_total" for m in last["metrics"])
    shutdown.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not shutdown._handler


def test_enable_fp_exceptions_traps_at_the_op():
    from paddle_tpu_torch.utils import profiler

    profiler.enable_fp_exceptions()
    try:
        torch.ones(3) * 2.0                  # finite: passes
        with pytest.raises(FloatingPointError, match="NaN or Inf"):
            torch.log(torch.tensor([-1.0, 1.0]))
        with pytest.raises(FloatingPointError):
            torch.tensor([1.0]) / torch.tensor([0.0])
    finally:
        profiler.enable_fp_exceptions(False)
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


def test_unported_observe_modules_refuse_by_name():
    """Part 3 of queue A10b (the cost model and the bench gate) refuses
    by name; ``fleet`` and ``health`` are ported: importable, and a
    reporter asked for a push client has one."""
    for name in ("benchgate", "costmodel"):
        with pytest.raises(PaddleTpuError, match=f"{name}.*A10b part 3"):
            getattr(observe, name)
    from paddle_tpu_torch.observe import fleet, health
    assert observe.fleet is fleet and health.HealthSession
    r = MetricsReporter(fleet_addr="127.0.0.1:1")
    assert r.fleet is not None and r.fleet.addr == "127.0.0.1:1"
    with pytest.raises(AttributeError):
        observe.no_such_thing


def test_slo_engine_found_on_slo_and_healthz():
    """The SLO engine (no longer refused): ``--slo`` through
    :func:`observe.start_from_flags` brings it in, and the endpoint's
    ``sys.modules`` probe finds it on ``/slo`` and ``/healthz``, as in a
    JAX process with ``--slo`` set."""
    import json
    import urllib.request
    from paddle_tpu_torch.observe import slo
    from paddle_tpu_torch.observe.http import ObservabilityServer
    saved = FLAGS.get("slo")
    FLAGS.set("slo", "serve_ttft_seconds:p99<0.5:60s")
    try:
        assert observe.start_from_flags() is not None   # --slo alone
        eng = slo.active_engine()
        assert eng is not None
        for _ in range(50):
            observe.histogram("serve_ttft_seconds", "ttft").observe(2.0)
        with ObservabilityServer(port=0) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(base + "/slo", timeout=30) as r:
                doc = json.loads(r.read())
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=30) as r:
                health = json.loads(r.read())
        assert doc["breached"] == ["serve_ttft_seconds:p99<0.5:60s"]
        assert health["slo"]["status"] == "breach"
        assert health["status"] == "degraded"
    finally:
        FLAGS.set("slo", saved)
        slo.reset()
