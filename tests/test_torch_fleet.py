"""The port's fleet plane (``paddle_tpu_torch/observe/fleet.py``, the push
client folded into the reporter, the SIGTERM goodbye frame) against the
JAX package's ``tests/test_fleet.py``.

- Each of ``tests/test_fleet.py``'s 36 cases runs on the port: the case's
  own code, with its module names — the package, ``observe``, ``fleet``,
  ``report``, ``shutdown``, ``trace``, the fleet classes and ``FLAGS`` —
  bound to the port's, and its imports of ``paddle_tpu.*`` (the fault
  harness's pusher and master children, ``observe.dump``,
  ``observe.http``) resolved to ``paddle_tpu_torch.*``; the framework
  logger it listens on is the port's.  The chaos cases spawn the port's
  children (``testing/fault.py``) on the CPU.
- Across the packages: a frame built by the port's ``FleetPusher`` is
  ingested by the JAX package's ``FleetState`` and a JAX frame by the
  port's, with equal rollups, topologies and merged Prometheus text; a
  port pusher pushes to a JAX aggregator over HTTP and the other way
  round; the frames carry the same keys.
"""

import builtins
import inspect
import json
import logging
import os
import types

import pytest

import test_fleet as jt
from paddle_tpu.observe import fleet as jfleet
from paddle_tpu.observe import health as jhealth
from paddle_tpu_torch import observe
from paddle_tpu_torch.observe import fleet, health, report, shutdown, trace
from paddle_tpu_torch.utils import FLAGS
from paddle_tpu_torch.utils.logger import reset_warn_once

FLEET_FLAGS = ("fleet_addr", "fleet_port", "fleet_bind", "fleet_id",
               "fleet_role", "metrics_interval_s", "metrics_bind",
               "metrics_jsonl", "trace_jsonl")


@pytest.fixture(autouse=True)
def _port_state():
    """The port's fleet identity and health report cleared before every
    test, its process-wide telemetry and fleet flags put back after it
    (``tests/conftest.py`` resets the JAX package's)."""
    import signal
    saved = {k: FLAGS.get(k) for k in FLEET_FLAGS}
    old_term = signal.getsignal(signal.SIGTERM)
    # an identity or serving info another file's trainer or server left
    fleet.reset_identity()
    health.reset()
    yield
    observe.stop_global()
    shutdown.uninstall()
    trace.disable()
    fleet.reset_identity()
    health.reset()
    for k, v in saved.items():
        FLAGS.set(k, v)
    observe.REGISTRY.reset()
    reset_warn_once()
    signal.signal(signal.SIGTERM, old_term)


# ------------------------------------------- the JAX cases, on the port
def _port_name(name: str) -> str:
    if name == "paddle_tpu" or name.startswith("paddle_tpu."):
        return "paddle_tpu_torch" + name[len("paddle_tpu"):]
    return name


class _PortLogging(types.ModuleType):
    """``logging`` with the JAX framework logger's name read as the
    port's (``paddle_tpu`` -> ``paddle_tpu_torch``)."""

    def __getattr__(self, name):
        return getattr(logging, name)

    @staticmethod
    def getLogger(name=None):  # noqa: N802 — logging's API
        return logging.getLogger(_port_name(name) if name else name)


_LOGGING = _PortLogging("logging")


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if name == "logging" and level == 0:
        return _LOGGING
    return builtins.__import__(_port_name(name), globals, locals, fromlist,
                               level)


_PORT_GLOBALS = dict(vars(jt))
_PORT_GLOBALS.update(
    observe=observe, fleet=fleet, report=report, shutdown=shutdown,
    trace=trace, FLAGS=FLAGS, FLEET_SCHEMA=fleet.FLEET_SCHEMA,
    FleetAggregator=fleet.FleetAggregator,
    FleetFrameError=fleet.FleetFrameError, FleetPusher=fleet.FleetPusher,
    FleetSchemaError=fleet.FleetSchemaError, FleetState=fleet.FleetState,
    __builtins__={**vars(builtins), "__import__": _port_import})

CASES = sorted(n for n, f in vars(jt).items()
               if n.startswith("test_") and inspect.isfunction(f))


def _case_param(name):
    marks = [m for m in getattr(getattr(jt, name), "pytestmark", [])]
    return pytest.param(name, marks=marks, id=name[len("test_"):])


def test_the_jax_file_has_its_36_cases():
    assert len(CASES) == 36


@pytest.mark.parametrize("name", [_case_param(n) for n in CASES])
def test_jax_fleet_case_on_the_port(name, tmp_path, monkeypatch):
    src = getattr(jt, name)
    fn = types.FunctionType(src.__code__, _PORT_GLOBALS, name,
                            src.__defaults__, src.__closure__)
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: fixtures[p] for p in inspect.signature(src).parameters})


# --------------------------------------------------- across the packages
def test_frames_cross_the_packages_with_equal_rollups(monkeypatch):
    """A port frame (a health digest and serving info on it) ingested by
    the JAX ``FleetState``, and the JAX frame built the same way
    ingested by the port's: the same keys, and the two states' rollups,
    topologies and merged Prometheus text are equal."""
    for mod in (fleet, jfleet):
        mod.set_identity(role="serving", name="replica-0", node="host-a")
        mod.set_serving_info(version="abc123def456", state="serving",
                             exported_at=1.5)
    for hmod in (health, jhealth):
        m = hmod.HealthMonitor(["l"])
        hmod.publish_report({"ts": 1.0, "steps": 1, "base_step": 0,
                             "interval": 1, "loss": 1.0, "layers": {}},
                            m)
    observe.gauge("fleet_x", "h").set(2.0)
    from paddle_tpu import observe as jobs
    jobs.gauge("fleet_x", "h").set(2.0)
    frames = []
    for mod in (fleet, jfleet):
        p = mod.FleetPusher("127.0.0.1:1", interval_s=1.0)
        f = p.build_frame()
        f["pid"], f["ts"], f["uptime_s"] = 7, 0.0, 1.0
        f["metrics"] = [m for m in f["metrics"] if m["name"] == "fleet_x"]
        f["health"]["health"]["last_drain_ts"] = 0.0
        frames.append(f)
    tframe, jframe = frames
    assert sorted(tframe) == sorted(jframe)
    assert tframe == jframe
    clock = jt.FakeClock()
    states = [fleet.FleetState(clock=clock), jfleet.FleetState(clock=clock)]
    for st in states:
        for f in frames:
            st.ingest(dict(f, name=f"{f['name']}-{frames.index(f)}"))
    (troll, jroll), (ttop, jtop) = ([getattr(st, k)() for st in states]
                                    for k in ("rollup", "topology"))
    troll.pop("pid"), jroll.pop("pid"), ttop.pop("pid"), jtop.pop("pid")
    assert troll == jroll and ttop == jtop
    assert ttop["procs"]["replica-0-0"]["model_version"] == "abc123def456"
    assert states[0].merged_prometheus() == states[1].merged_prometheus()
    for mod in (fleet, jfleet):
        mod.reset_identity()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_a_pusher_pushes_to_the_other_packages_aggregator(direction):
    """Over HTTP: a port pusher registers with a JAX aggregator and a
    JAX pusher with a port aggregator; the rollup reads ok and the
    pusher is not degraded."""
    agg_mod, push_mod = (jfleet, fleet) if direction == "port_to_jax" \
        else (fleet, jfleet)
    push_mod.set_identity(role="trainer", name="t-cross")
    try:
        with agg_mod.FleetAggregator(0) as agg:
            p = push_mod.FleetPusher(agg.addr, interval_s=1.0)
            assert p.push() is True and not p.degraded
            roll = agg.state.rollup()
            assert roll["status"] == "ok"
            assert roll["procs"]["t-cross"]["pid"] == os.getpid()
            assert p.push(going_down=True) is True
            assert agg.state.rollup()["procs"]["t-cross"]["status"] == \
                "down"
    finally:
        push_mod.reset_identity()


def test_fleet_runs_as_a_module_and_watches(tmp_path):
    """``python -m paddle_tpu_torch.observe.fleet --watch HOST:PORT
    --once`` renders one console frame from a running aggregator."""
    import subprocess
    import sys
    with fleet.FleetAggregator(0) as agg:
        fleet.set_identity(role="trainer", name="watched-0")
        fleet.FleetPusher(agg.addr, interval_s=1.0).push()
        out = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.observe.fleet",
             "--watch", agg.addr, "--once"], capture_output=True,
            text=True, timeout=60,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                __file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("fleet: ok") and "watched-0" in out.stdout
    assert json.dumps(fleet.identity())
