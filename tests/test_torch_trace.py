"""The port's tracing and live endpoint (``paddle_tpu_torch/observe/
trace.py``, ``http.py``, ``dump.py``, ``utils/profiler.py``) on the cases
of ``tests/test_trace.py``: span identity and nesting, the flight recorder's bound, the Chrome
trace-event schema, cross-thread parenting through the async pipeline,
the master RPC's context echo across a child master process (and the
fallback for a master without it, and the protocol without tracing),
the ``/metrics`` + ``/healthz`` + ``/trace`` endpoints, the degraded
reporter, profiler re-entrancy, the debug dump, the trainer's step and
pass spans and the checkpoint spans — all on the CPU.

Differences from the JAX cases, kept on purpose:
- the disabled-span contract is asserted structurally (the shared no-op
  object, nothing recorded, no thread started), not by a timing bound
  under a loaded worker; its time is read on the card (phase 4z-obs);
- the SIGUSR2 case checks the installed handler and calls the function
  its thread runs, instead of raising the signal and polling for a file;
- the profiler cases open real ``torch.profiler`` windows (cheap on the
  CPU), and ``parameter_stats`` is held to one host copy and to the JAX
  package's text.

Each test resets the port's registry, trace, reporter, endpoint and
handlers in a fixture of this file.
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch import observe
from paddle_tpu_torch.observe import REGISTRY, trace
from paddle_tpu_torch.observe.http import ObservabilityServer
from paddle_tpu_torch.utils import FLAGS
from paddle_tpu_torch.utils.logger import reset_warn_once
from paddle_tpu_torch.utils.stat import global_stat

from test_torch_observe import _batch, _tiny_trainer


@pytest.fixture(autouse=True)
def _port_state():
    """The port's process-wide telemetry put back after every test."""
    from paddle_tpu_torch.observe import dump
    old_usr2 = signal.getsignal(signal.SIGUSR2)
    yield
    observe.stop_global()
    global_stat.reset()
    REGISTRY.reset()
    reset_warn_once()
    signal.signal(signal.SIGUSR2, old_usr2)
    dump._installed = False


def _by_name(events, name):
    return [e for e in events if e["name"] == name]


def _args(e):
    return e["args"]


# ---------------------------------------------------------- span identity
def test_span_nesting_shares_trace_and_sets_parent():
    trace.enable(ring_size=64)
    with trace.span("outer") as outer:
        with trace.span("inner") as inner:
            assert inner.context.trace_id == outer.context.trace_id
            assert inner.parent_id == outer.context.span_id
            assert inner.context.span_id != outer.context.span_id
        # context restored after the child closes
        assert trace.current_context() == outer.context
    assert trace.current_context() is None
    evs = trace.events()
    assert [e["name"] for e in evs] == ["inner", "outer"]  # close order
    assert _args(evs[0])["parent_id"] == _args(evs[1])["span_id"]
    assert "parent_id" not in _args(evs[1])


def test_sibling_roots_get_distinct_traces():
    trace.enable(ring_size=64)
    with trace.span("a"):
        pass
    with trace.span("b"):
        pass
    a, b = trace.events()
    assert _args(a)["trace_id"] != _args(b)["trace_id"]


def test_span_attrs_and_error_tag():
    trace.enable(ring_size=64)
    with pytest.raises(RuntimeError):
        with trace.span("boom", shard=3, kind="lease"):
            raise RuntimeError("x")
    (e,) = trace.events()
    assert _args(e)["shard"] == 3
    assert _args(e)["kind"] == "lease"
    assert _args(e)["error"] == "RuntimeError"
    # an escaping exception must not leak the span's context
    assert trace.current_context() is None


def test_parent_header_roundtrip():
    trace.enable(ring_size=8)
    assert trace.parent_header() == ""
    with trace.span("rpc") as sp:
        hdr = trace.parent_header()
        ctx = trace.parse_header(hdr)
        assert ctx == sp.context
    assert trace.parse_header("") is None
    assert trace.parse_header("garbage") is None
    assert trace.parse_header("/half") is None


def test_record_span_remote():
    trace.enable(ring_size=8)
    sid = trace.record_span("server.work", 1000.0, 250.0, "t" * 16,
                            parent_id="p" * 16, pid=4242, op="GET")
    (e,) = trace.events()
    assert e["pid"] == 4242 and e["ts"] == 1000.0 and e["dur"] == 250.0
    assert _args(e) == {"trace_id": "t" * 16, "span_id": sid,
                       "parent_id": "p" * 16, "op": "GET"}


# ------------------------------------------------------- flight recorder
def test_ring_buffer_bounds_and_evicts_oldest():
    trace.enable(ring_size=8)
    for i in range(20):
        with trace.span(f"s{i}"):
            pass
    evs = trace.events()
    assert len(evs) == 8
    assert [e["name"] for e in evs] == [f"s{i}" for i in range(12, 20)]
    dumped = json.loads(trace.flight_recorder_json())
    assert [e["name"] for e in dumped] == [e["name"] for e in evs]


def test_disabled_mode_records_nothing_and_starts_no_threads():
    assert not trace.enabled()
    before = set(threading.enumerate())
    with trace.span("ignored", k=1) as sp:
        assert sp is trace.span("also-ignored")  # shared no-op object
    assert trace.events() == []
    assert trace.flight_recorder_json() == "[]"
    assert set(threading.enumerate()) == before


def test_disabled_span_overhead_under_contract():
    """The disabled-mode contract, structurally: every span call returns
    the one shared ``_NullSpan`` (no object made, no clock read, nothing
    recorded, no context change), over many calls and with attributes,
    and no thread starts.  Its time is read on the card (4z-obs (c))."""
    assert not trace.enabled()
    before = set(threading.enumerate())
    spans = set()
    for i in range(1000):
        with trace.span("noop", step=i) as sp:
            spans.add(id(sp))
            assert trace.current_context() is None
    assert spans == {id(trace._NULL_SPAN)}
    assert type(trace._NULL_SPAN).__slots__ == ()
    assert trace.events() == [] and trace.dropped_count() == 0
    assert set(threading.enumerate()) == before


# ------------------------------------------------------------ JSONL sink
def test_chrome_trace_event_schema_roundtrip(tmp_path):
    path = str(tmp_path / "trace.json")
    trace.enable(jsonl_path=path, ring_size=64)
    with trace.span("pass", pass_id=0):
        with trace.span("step"):
            time.sleep(0.001)
    trace.disable()                      # joins writer, closes the array
    with open(path) as f:
        events = json.load(f)            # must parse as a JSON document
    assert isinstance(events, list) and len(events) == 2
    for e in events:
        for key in ("ph", "ts", "dur", "pid", "tid", "name"):
            assert key in e, f"event missing {key}: {e}"
        assert e["ph"] == "X"
        assert e["pid"] == os.getpid()
        assert e["dur"] >= 0
    step = _by_name(events, "step")[0]
    assert step["dur"] >= 1000.0         # slept 1 ms inside
    # same-thread events share a Perfetto lane
    assert len({e["tid"] for e in events}) == 1


def test_empty_trace_file_is_valid_json(tmp_path):
    path = str(tmp_path / "empty.json")
    trace.enable(jsonl_path=path)
    trace.disable()
    with open(path) as f:
        assert json.load(f) == []


def test_unwritable_sink_degrades_to_ring_only(tmp_path):
    path = str(tmp_path / "no-such-dir" / "trace.json")
    trace.enable(jsonl_path=path, ring_size=16)   # open fails, no raise
    with trace.span("still-recorded"):
        pass
    assert [e["name"] for e in trace.events()] == ["still-recorded"]


# --------------------------------------------- cross-thread: AsyncPipeline
def test_pipeline_worker_spans_parent_under_creating_span():
    from paddle_tpu_torch.data.pipeline import AsyncPipeline

    trace.enable(ring_size=256)
    with trace.span("train_pass") as outer:
        pipe = AsyncPipeline(iter(range(6)),
                             convert_fn=lambda x: x * 2,
                             depth=2, workers=2)
        got = list(pipe)
    assert got == [0, 2, 4, 6, 8, 10]
    evs = trace.events()
    converts = _by_name(evs, "pipeline_convert")
    reads = _by_name(evs, "pipeline_read")
    assert len(converts) == 6 and len(reads) >= 6
    outer_tid = _by_name(evs, "train_pass")[0]["tid"]
    for e in converts + reads:
        # same trace as the consuming pass, recorded from worker threads
        assert _args(e)["trace_id"] == outer.context.trace_id
        assert _args(e)["parent_id"] == outer.context.span_id
        assert e["tid"] != outer_tid
    assert sorted(_args(e)["index"] for e in converts) == list(range(6))


def test_pipeline_without_tracing_stays_silent():
    from paddle_tpu_torch.data.pipeline import AsyncPipeline

    assert not trace.enabled()
    pipe = AsyncPipeline(iter(range(4)), depth=2, workers=2)
    assert list(pipe) == [0, 1, 2, 3]
    assert trace.events() == []


# ------------------------------------------------------- HTTP endpoints
def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.headers.get("Content-Type", ""), \
            r.read().decode()


def test_endpoints_metrics_healthz_trace():
    observe.counter("endpoint_test_total", "test counter").inc(3)
    trace.enable(ring_size=16)
    with trace.span("visible-in-trace"):
        pass
    with ObservabilityServer(port=0) as srv:
        code, ctype, body = _get(srv.port, "/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert "endpoint_test_total 3" in body
        code, ctype, body = _get(srv.port, "/healthz")
        assert code == 200 and ctype == "application/json"
        health = json.loads(body)
        assert health["status"] == "ok"
        assert health["pid"] == os.getpid()
        assert health["uptime_s"] >= 0
        code, ctype, body = _get(srv.port, "/trace")
        assert code == 200 and ctype == "application/json"
        events = json.loads(body)
        assert [e["name"] for e in events] == ["visible-in-trace"]
        for key in ("ph", "ts", "dur", "pid", "tid", "name"):
            assert key in events[0]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.port, "/nope")
        assert ei.value.code == 404
        # the reports of queue A10b, and /slo with no --slo engine,
        # answer as a JAX process that never loaded their modules
        for path in ("/roofline", "/health", "/slo"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(srv.port, path)
            assert ei.value.code == 404


def test_trace_endpoint_lazily_enables_ring():
    """/metrics scrapes must NOT turn tracing (and the trainer's step
    fence) on; the first /trace request is the scrape-time opt-in —
    ring-only and fence-free."""
    with ObservabilityServer(port=0) as srv:
        _get(srv.port, "/metrics")
        assert not trace.enabled()
        code, _, body = _get(srv.port, "/trace")
        assert code == 200 and json.loads(body) == []
        assert trace.enabled()               # opted in by the scrape
        assert not trace.fences_steps()      # ...but fence-free
        with trace.span("after-opt-in"):
            pass
        _, _, body = _get(srv.port, "/trace")
        assert [e["name"] for e in json.loads(body)] == ["after-opt-in"]


def test_explicit_enable_fences_but_scrape_ring_does_not():
    """fences_steps(): True for --trace_jsonl / programmatic enable(),
    False for ensure_ring() (the /trace scrape path) — and the trainer
    obeys: a scrape-enabled ring records step spans WITHOUT the fence."""
    trace.ensure_ring(ring_size=64)
    assert trace.enabled() and not trace.fences_steps()
    tr, feeder = _tiny_trainer()
    rng = np.random.RandomState(0)
    tr.train_one_batch(feeder.convert(_batch(rng)))
    assert _by_name(trace.events(), "train_step")       # spans recorded
    assert not _by_name(trace.events(), "fence")        # but no fence
    assert REGISTRY.histogram("train_device_blocked_seconds").count() == 0
    trace.enable(ring_size=64)           # explicit opt-in replaces it
    assert trace.fences_steps()


def test_healthz_reports_dropped_span_count():
    trace.enable(ring_size=16)
    with ObservabilityServer(port=0) as srv:
        _, _, body = _get(srv.port, "/healthz")
        health = json.loads(body)
        assert health["trace_spans_dropped"] == 0
        assert health["trace_enabled"] is True
        assert "health" not in health and "slo" not in health


def test_metrics_port_flag_gating():
    """--metrics_port=0 (the default) ⇒ no server thread, no implicit
    tracing."""
    from paddle_tpu_torch.observe import http as ohttp

    assert FLAGS.get("metrics_port") == 0
    assert ohttp.start_from_flags() is None
    assert not any(t.name == ohttp.SERVER_THREAD_NAME
                   for t in threading.enumerate())
    assert not trace.enabled()


def test_start_from_flags_with_port_serves_and_enables_ring():
    from paddle_tpu_torch.observe import http as ohttp

    saved = FLAGS.get("metrics_port")
    FLAGS.set("metrics_port", 0)
    try:
        srv = ObservabilityServer(port=0).start()
        try:
            code, _, _ = _get(srv.port, "/healthz")
            assert code == 200
        finally:
            srv.stop()
        # the umbrella with everything unset: nothing starts
        assert observe.start_from_flags() is None
        assert not trace.enabled()
        assert not any(
            t.name in (ohttp.SERVER_THREAD_NAME, trace.WRITER_THREAD_NAME)
            for t in threading.enumerate())
    finally:
        FLAGS.set("metrics_port", saved)


# -------------------------------------------------- the degraded sink
def test_failing_metrics_sink_deactivates_fencing(tmp_path):
    """A permanently failing --metrics_jsonl sink stops claiming someone
    is listening: after the flush failure the reporter is degraded and
    observe.active() returns False (the trainer stops fencing)."""
    bad = str(tmp_path / "no-such-dir" / "m.jsonl")
    r = observe.attach(bad, interval_s=999)
    try:
        assert observe.active() is True      # sink configured…
        with pytest.raises(OSError):
            r.flush()                         # …but every write fails
        assert r.degraded is True
        assert observe.active() is False      # fencing gate released
        os.makedirs(os.path.dirname(bad))
        assert r.flush() is not None
        assert r.degraded is False
        assert observe.active() is True
    finally:
        observe.stop_global()


def test_degraded_startup_probe(tmp_path):
    from paddle_tpu_torch.observe import report

    saved = FLAGS.get("metrics_jsonl")
    FLAGS.set("metrics_jsonl", str(tmp_path / "nope" / "m.jsonl"))
    try:
        report.start_from_flags()
        assert observe.active() is False
    finally:
        FLAGS.set("metrics_jsonl", saved)
        observe.stop_global()


# --------------------------------------------------------- the profiler
def test_profiler_trace_reentrant_and_annotates(tmp_path):
    """A nested profiler.trace is a warn-once no-op instead of a second
    window, windows are tick-counted, and while the window is open an
    enabled span also enters a record_function range — and still
    records normally."""
    from paddle_tpu_torch.utils import profiler

    trace.enable(ring_size=16)
    assert profiler.trace_active() is False
    with profiler.trace(str(tmp_path / "prof")) as path:
        assert profiler.trace_active() is True
        with profiler.trace(str(tmp_path / "prof-inner")) as inner:
            assert inner is None and profiler.trace_active() is True
            with trace.span("annotated"):
                torch.ones(3).sum()
    assert profiler.trace_active() is False
    assert REGISTRY.counter("profiler_trace_windows_total").value() == 1
    assert [e["name"] for e in trace.events()] == ["annotated"]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert [e for e in events if e.get("name") == "annotated"
            and e.get("cat") == "user_annotation"]
    assert not os.path.exists(str(tmp_path / "prof-inner"))


def test_profiler_trace_real_window(tmp_path):
    """Two windows one after the other each write their own trace, and a
    span outside any window enters no range."""
    from paddle_tpu_torch.utils import profiler

    trace.enable(ring_size=16)
    paths = []
    for _ in range(2):
        with profiler.trace(str(tmp_path / "prof")) as path:
            with trace.span("annotated"):
                pass
        paths.append(path)
    assert paths[0] != paths[1] and all(os.path.exists(p) for p in paths)
    assert trace._profiler_annotation("outside") is None
    assert [e["name"] for e in trace.events()] == ["annotated"] * 2


def test_parameter_stats_single_batched_device_get(monkeypatch):
    """One host copy for all (fp32) parameters, and the JAX package's
    text for the same values."""
    import jax.numpy as jnp

    from paddle_tpu.utils.profiler import parameter_stats as j_stats
    from paddle_tpu_torch.utils import profiler

    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        calls.append(tuple(self.shape))
        return real(self, *a, **kw)

    rng = np.random.RandomState(0)
    values = {"w": rng.randn(3, 4).astype(np.float32),
              "b": np.zeros((4,), np.float32)}
    params = {k: torch.from_numpy(v) for k, v in values.items()}
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    out = profiler.parameter_stats(params)
    monkeypatch.undo()
    assert len(calls) == 1            # ONE batched copy over the dict
    assert "w: shape=(3, 4)" in out and "b: shape=(4,)" in out
    assert out == j_stats({k: jnp.asarray(v) for k, v in values.items()})


# --------------------------------------------------- the SIGUSR2 dump
def test_debug_dump_writes_metrics_and_trace(tmp_path):
    from paddle_tpu_torch.observe import dump

    observe.counter("dump_test_total", "x").inc(7)
    trace.enable(ring_size=16)
    with trace.span("dumped"):
        pass
    prom, tr = dump.debug_dump(str(tmp_path))
    with open(prom) as f:
        assert "dump_test_total 7" in f.read()
    with open(tr) as f:
        events = json.load(f)
    assert [e["name"] for e in events] == ["dumped"]


@pytest.mark.skipif(not hasattr(signal, "SIGUSR2"),
                    reason="platform without SIGUSR2")
def test_sigusr2_handler_installed_by_flag(tmp_path):
    """--debug_dump_signal installs the SIGUSR2 handler (idempotently);
    the dump its thread runs lands under --debug_dump_dir — called here
    directly rather than through a signal and a poll."""
    from paddle_tpu_torch.observe import dump

    saved_sig = FLAGS.get("debug_dump_signal")
    saved_dir = FLAGS.get("debug_dump_dir")
    FLAGS.set("debug_dump_signal", True)
    FLAGS.set("debug_dump_dir", str(tmp_path))
    try:
        assert dump.install_from_flags() is True
        assert dump.install_from_flags() is True
        assert signal.getsignal(signal.SIGUSR2) is dump._handler
        observe.counter("usr2_test_total", "x").inc()
        dump._do_dump()
        dumps = [f for f in os.listdir(str(tmp_path))
                 if f.endswith(".metrics.prom")]
        assert len(dumps) == 1
        with open(os.path.join(str(tmp_path), dumps[0])) as f:
            assert "usr2_test_total 1" in f.read()
    finally:
        FLAGS.set("debug_dump_signal", saved_sig)
        FLAGS.set("debug_dump_dir", saved_dir)


# ------------------------------------------------ trainer integration
def test_trainer_step_phase_spans():
    """One traced step yields the train_step span with feed /
    step_dispatch / fence children — all in one trace, fence present
    because an open trace fences the step."""
    tr, feeder = _tiny_trainer()
    rng = np.random.RandomState(0)
    tr.train_one_batch(feeder.convert(_batch(rng)))
    trace.enable(ring_size=64)
    tr.train_one_batch(feeder.convert(_batch(rng)))
    evs = trace.events()
    (step,) = _by_name(evs, "train_step")
    for phase in ("feed", "step_dispatch", "fence"):
        (e,) = _by_name(evs, phase)
        assert _args(e)["trace_id"] == _args(step)["trace_id"]
        assert _args(e)["parent_id"] == _args(step)["span_id"]
    assert REGISTRY.histogram("train_device_blocked_seconds").count() == 1


def test_trainer_untraced_steps_record_no_spans_and_stay_unfenced():
    tr, feeder = _tiny_trainer()
    rng = np.random.RandomState(0)
    assert not trace.enabled() and not observe.active()
    tr.train_one_batch(feeder.convert(_batch(rng)))
    assert trace.events() == []
    assert REGISTRY.histogram("train_device_blocked_seconds").count() == 0


def test_train_loop_pass_span_parents_pipeline_and_steps(tmp_path):
    """`Trainer.train` with the async pipeline on: the pass span is the
    root; step spans and worker convert spans hang off it in ONE trace,
    and the JSONL file round-trips through json.load."""
    path = str(tmp_path / "train-trace.json")
    tr, feeder = _tiny_trainer()
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(3)]

    def reader():
        yield from batches

    saved = {k: FLAGS.get(k) for k in ("save_dir", "prefetch_depth")}
    FLAGS.set("save_dir", "")
    FLAGS.set("prefetch_depth", 2)
    trace.enable(jsonl_path=path, ring_size=512)
    try:
        tr.train(reader, num_passes=1, feeder=feeder)
    finally:
        for k, v in saved.items():
            FLAGS.set(k, v)
        trace.disable()
    with open(path) as f:
        events = json.load(f)
    (pass_e,) = _by_name(events, "train_pass")
    steps = _by_name(events, "train_step")
    converts = _by_name(events, "pipeline_convert")
    assert len(steps) == 3 and len(converts) == 3
    trace_id = _args(pass_e)["trace_id"]
    for e in steps + converts:
        assert _args(e)["trace_id"] == trace_id
    assert {_args(e)["parent_id"] for e in converts} \
        == {_args(pass_e)["span_id"]}
    assert _args(pass_e)["pass_id"] == 0
    for key in ("ph", "ts", "dur", "pid", "tid", "name"):
        assert all(key in e for e in events)


# -------------------------------------------------- checkpoint spans
def test_checkpoint_save_and_verify_spans(tmp_path):
    from paddle_tpu_torch.trainer.checkpoint import save_checkpoint, \
        verify_checkpoint

    trace.enable(ring_size=64)
    d = save_checkpoint(str(tmp_path), 0, {"w": np.ones((2, 2))})
    assert verify_checkpoint(d)
    evs = trace.events()
    (save_e,) = _by_name(evs, "ckpt_save")
    assert _args(save_e)["pass_id"] == 0
    assert _by_name(evs, "ckpt_verify")
    assert REGISTRY.counter("ckpt_saves").value() == 1
    assert REGISTRY.histogram("ckpt_save_seconds").count() == 1
    assert REGISTRY.histogram("ckpt_verify_seconds").count() == 1


def test_checkpoint_retention_span(tmp_path):
    """The retention sweep lands in the trace (and its counter)."""
    from paddle_tpu_torch.trainer.checkpoint import save_checkpoint, \
        sweep_retention

    for p in range(3):
        save_checkpoint(str(tmp_path), p, {"w": np.ones((2, 2)) * p})
    trace.enable(ring_size=64)
    removed = sweep_retention(str(tmp_path), keep=1)
    assert len(removed) == 2
    (ret_e,) = _by_name(trace.events(), "ckpt_retention")
    assert _args(ret_e)["keep"] == 1
    assert REGISTRY.counter("ckpt_retention_removed").value() == 2


# --------------------------------------------- cross-process: master RPC
def test_master_rpc_context_echo_child_process(tmp_path):
    """The acceptance pin for 'same trace id across the client/server
    boundary': a GET against the C++ master in a SIGKILL-able child
    process (testing/fault.py) yields a client `master_rpc` span AND a
    `master.handle` span carrying the CHILD's pid, both in the trace of
    the surrounding pass span."""
    from paddle_tpu_torch.distributed.master import MasterClient
    from paddle_tpu_torch.testing import fault

    trace.enable(ring_size=256)
    srv = fault.MasterServerProcess(str(tmp_path / "snap"), timeout_s=5)
    with srv:
        with trace.span("train_pass") as outer:
            c = MasterClient(srv.addr, retry_max=2)
            c.set_dataset(["shard-a", "shard-b"])
            tid, payload = c.get_task()
            assert payload in ("shard-a", "shard-b")
            c.task_finished(tid)
            c.close()
        evs = trace.events()
        rpcs = _by_name(evs, "master_rpc")
        handles = _by_name(evs, "master.handle")
        assert {_args(e)["op"] for e in rpcs} == {"SET", "GET", "FIN"}
        assert len(handles) == len(rpcs) == 3
        rpc_by_id = {_args(e)["span_id"]: e for e in rpcs}
        for h in handles:
            a = _args(h)
            assert a["trace_id"] == outer.context.trace_id
            parent = rpc_by_id[a["parent_id"]]       # nests under its RPC
            assert a["op"] == _args(parent)["op"]
            assert h["pid"] == srv.proc.pid           # the CHILD's pid
            assert h["pid"] != os.getpid()
            # server handling fits inside the client-observed round trip
            assert h["ts"] >= parent["ts"]
            assert h["ts"] + h["dur"] <= parent["ts"] + parent["dur"] + 1


def test_tracing_client_falls_back_on_pre_ctx_master():
    """A master binary that predates CTX framing answers the frame with
    a bare ERR; the client must detect it, stop framing, and replay the
    request bare — tracing never breaks the RPCs it observes
    (version-skew deploys)."""
    import socket as sk

    from paddle_tpu_torch.distributed.master import MasterClient

    srv = sk.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def old_master():   # speaks the pre-CTX dialect: CTX is unknown
        conn, _ = srv.accept()
        buf = b""
        while True:
            chunk = conn.recv(4096)
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                cmd = line.split(b"\t", 1)[0]
                if cmd == b"GET":
                    conn.sendall(b"OK\t0\tonly\n")
                elif cmd == b"FIN":
                    conn.sendall(b"OK\n")
                else:
                    conn.sendall(b"ERR\tunknown command\n")
        conn.close()

    t = threading.Thread(target=old_master, daemon=True)
    t.start()
    trace.enable(ring_size=64)
    c = MasterClient(f"127.0.0.1:{port}", retry_max=0)
    with trace.span("pass"):
        tid, payload = c.get_task()   # framed → ERR → bare replay
        assert (tid, payload) == (0, "only")
        assert c._ctx_frames is False
        c.task_finished(tid)          # later calls go bare directly
    c.close()
    srv.close()
    t.join(timeout=5)
    evs = trace.events()
    assert {_args(e)["op"] for e in _by_name(evs, "master_rpc")} \
        == {"GET", "FIN"}
    assert not _by_name(evs, "master.handle")   # no echo, no fake span


def test_master_protocol_unchanged_without_tracing(tmp_path):
    """Tracing off ⇒ no CTX frames on the wire and byte-identical
    protocol behavior (the GET/FIN cycle completes, counts move)."""
    from paddle_tpu_torch.distributed.master import Master, MasterClient

    assert not trace.enabled()
    m = Master(timeout_s=5, failure_max=3)
    m.set_dataset(["only"])
    port = m.serve(0)
    with MasterClient(f"127.0.0.1:{port}") as c:
        tid, payload = c.get_task()
        assert payload == "only"
        c.task_finished(tid)
        assert c.counts()["done"] == 1
    assert trace.events() == []
