"""The port's training-health observatory (``paddle_tpu_torch/observe/
health.py`` and its trainer wiring) against the JAX package's
``tests/test_health.py``, case for case — less its two roofline cases,
which wait for the cost model — and against the JAX package itself:

- ``layer_param_map`` gives the JAX keys on the same ``ModelConfig`` (a
  recurrent group's step layers too);
- from the same parameters and feeds, the port's drained reports equal
  the JAX ``HealthSession``'s: counts and ``first_nonfinite`` exactly,
  the gradient and parameter norms within rtol 1e-5 and the update
  norms and ratios within rtol 1e-4 (an update is a difference of two
  nearly equal fp32 parameters, so its norm carries their rounding),
  fp32 with a non-finite step and bf16 with a loss-scale skip;
- one stream fed to both packages' ``HealthMonitor`` fires the same
  alerts;
- the same report published in both packages gives the same ``/health``
  body and the same ``health`` digest and status on ``/healthz``;
- with ``--health_interval 0`` no session exists and the step is the
  step without the feature; with it on the parameters stay bit for bit
  what they are with it off.
"""

import json
import math
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import observe as jobs
from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config.model_config import OptimizationConfig as JOpt
from paddle_tpu.data import feeder as jfeeder
from paddle_tpu.layers import NeuralNetwork as JNet
from paddle_tpu.observe import health as jhealth
from paddle_tpu.observe.http import ObservabilityServer as JServer
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils import FLAGS as JFLAGS
from paddle_tpu_torch import observe
from paddle_tpu_torch.config.model_config import ModelConfig as TModel
from paddle_tpu_torch.config.model_config import OptimizationConfig as TOpt
from paddle_tpu_torch.layers.network import NeuralNetwork as TNet
from paddle_tpu_torch.observe import health, trace
from paddle_tpu_torch.observe.http import ObservabilityServer
from paddle_tpu_torch.trainer.trainer import Trainer
from paddle_tpu_torch.utils import FLAGS
from paddle_tpu_torch.utils.jax_interop import network_params_from_jax
from paddle_tpu_torch.utils.logger import reset_warn_once

HEALTH_FLAGS = ("health_interval", "health_window", "health_spike_mad",
                "health_plateau_rtol", "health_dead_ratio",
                "health_explode_ratio", "health_patience",
                "precision", "loss_scale_init", "prefetch_depth",
                "save_dir")
NORM_RTOL, UPDATE_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = [(f, {k: f.get(k) for k in HEALTH_FLAGS})
             for f in (JFLAGS, FLAGS)]
    yield
    for f, values in saved:
        for k, v in values.items():
            f.set(k, v)
    health.reset()
    observe.stop_global()
    trace.disable()
    observe.REGISTRY.reset()
    reset_warn_once()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set_both(**kw):
    for k, v in kw.items():
        JFLAGS.set(k, v)
        FLAGS.set(k, v)


def _fc_config(d, f):
    with d.config_scope():
        img = d.data_layer("x", f.dense_vector(16))
        lbl = d.data_layer("label", f.integer_value(4))
        h = d.fc_layer(img, size=32, act=d.ReluActivation(),
                       name="hidden")
        pred = d.fc_layer(h, size=4, act=d.SoftmaxActivation(),
                          name="pred")
        return d.topology(d.classification_cost(pred, lbl))


def _fc_trainer(precision="", seed=0, lr=1e-2):
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.data import feeder
    net = TNet(_fc_config(dsl, feeder))
    oc = TOpt(learning_method="adam", learning_rate=lr, precision=precision)
    return Trainer(net, opt_config=oc, seed=seed, device="cpu")


def _pair(precision=""):
    """A JAX trainer and a port trainer from the same parameters."""
    jcfg = _fc_config(jdsl, jfeeder)
    jtr = JTrainer(JNet(jcfg), opt_config=JOpt(
        learning_method="adam", learning_rate=1e-2, precision=precision),
        seed=0)
    tnet = TNet(TModel.from_json(jcfg.to_json()))
    ttr = Trainer(tnet, TOpt(learning_method="adam", learning_rate=1e-2,
                             precision=precision), seed=0, device="cpu")
    ttr.params = network_params_from_jax(
        {n: np.array(v) for n, v in jtr.params.items()}, tnet, "cpu")
    return jtr, ttr


def _feed(rng, b=8):
    return {"x": torch.from_numpy(rng.randn(b, 16).astype(np.float32)),
            "label": torch.from_numpy(rng.randint(0, 4, (b,))
                                      .astype(np.int32))}


def _inf_feed(label):
    return {"x": torch.full((8, 16), float("inf")), "label": label}


def _jax(feed):
    return {k: jnp.asarray(v.numpy()) for k, v in feed.items()}


def _bytes(tree):
    return {k: v.detach().numpy().tobytes() for k, v in tree.items()}


def _opt_bytes(tr):
    count, slots = tr.opt_state
    return int(count), {n: [x.numpy().tobytes() for x in s]
                        for n, s in slots.items()}


# ------------------------------------------------------------ layer map
def test_layer_param_map_matches_roofline_region_names():
    t = _fc_trainer()
    pairs = health.layer_param_map(t.network)
    names = [k for k, _ in pairs]
    assert names == ["hidden", "pred"]
    # every trainable parameter is claimed by exactly one layer
    claimed = [p for _, ps in pairs for p in ps]
    assert sorted(claimed) == sorted(t.network.param_specs)
    assert len(claimed) == len(set(claimed))


@pytest.mark.parametrize("builder", ["fc", "recurrent_group"])
def test_layer_param_map_keys_equal_the_jax_keys(builder):
    """The same ``ModelConfig`` in both packages: the same layer keys
    (a recurrent group's step layers as ``<layer>.<group>``) owning the
    same parameters, in the same order."""
    import test_torch_dsl as tdsl
    if builder == "fc":
        jcfg = _fc_config(jdsl, jfeeder)
    else:
        with jdsl.config_scope():
            jcfg = jdsl.topology(tdsl.b_recurrent_group(**tdsl.JAX))
    want = jhealth.layer_param_map(JNet(jcfg))
    got = health.layer_param_map(TNet(TModel.from_json(jcfg.to_json())))
    assert got == want
    if builder == "recurrent_group":
        assert "h.grp" in [k for k, _ in got]


def test_layer_param_map_unclaimed_params_fall_back():
    t = _fc_trainer()

    class NoParams:
        def param_specs(self):
            return []

    class FakeNet:
        layers = {"l1": NoParams()}
        groups = {}
        param_specs = t.network.param_specs

    pairs = health.layer_param_map(FakeNet())
    assert pairs == [(health.UNATTRIBUTED,
                      sorted(t.network.param_specs))]


# ------------------------------------------------- trainer wiring (fp32)
def test_health_off_by_default_no_session_no_extra_outputs():
    """Interval 0: no session, and the step is the step without the
    feature — the losses and parameters of a trainer built with the
    flag at 0 equal, bit for bit, those of one whose session is
    removed by hand."""
    FLAGS.set("health_interval", 0)
    t = _fc_trainer()
    assert t._health is None
    FLAGS.set("health_interval", 2)
    bare = _fc_trainer()
    bare._health = None
    rng = np.random.RandomState(0)
    for _ in range(3):
        f = _feed(rng)
        assert float(t.train_one_batch(dict(f))).hex() == \
            float(bare.train_one_batch(dict(f))).hex()
    assert _bytes(t.params) == _bytes(bare.params)
    assert health.latest_report() is None


def test_health_aux_does_not_perturb_training():
    rng = np.random.RandomState(1)
    feeds = [_feed(rng) for _ in range(4)]
    t_off = _fc_trainer()
    FLAGS.set("health_interval", 2)
    t_on = _fc_trainer()
    assert t_on._health is not None
    for f in feeds:
        t_off.train_one_batch(dict(f))
        t_on.train_one_batch(dict(f))
    assert _bytes(t_off.params) == _bytes(t_on.params)
    assert _opt_bytes(t_off) == _opt_bytes(t_on)


def test_health_gauges_keyed_to_layer_names():
    FLAGS.set("health_interval", 2)
    t = _fc_trainer()
    rng = np.random.RandomState(2)
    for _ in range(4):
        t.train_one_batch(_feed(rng))
    for layer in ("hidden", "pred"):
        g = observe.gauge("health_grad_norm").value(layer=layer)
        p = observe.gauge("health_param_norm").value(layer=layer)
        r = observe.gauge("health_update_ratio").value(layer=layer)
        assert g > 0 and p > 0 and 0 < r < 1
    assert observe.counter("health_drains_total").value() == 2.0
    report = health.latest_report()
    assert report is not None
    assert sorted(report["layers"]) == ["hidden", "pred"]
    assert report["steps"] == 2
    row = report["layers"]["hidden"]
    assert row["update_ratio"] == pytest.approx(
        row["update_norm"] / row["param_norm"], rel=1e-6)


def test_health_interval_drain_cadence_and_pass_boundary():
    FLAGS.set("health_interval", 3)
    FLAGS.set("prefetch_depth", 0)
    FLAGS.set("save_dir", "")
    t = _fc_trainer()
    rng = np.random.RandomState(3)
    batches = [_feed(rng) for _ in range(4)]
    t.train(lambda: iter(batches), num_passes=1)
    # 4 steps at interval 3 = one interval drain + one boundary drain
    assert observe.counter("health_drains_total").value() == 2.0
    assert t._health.pending() is False
    report = health.latest_report()
    assert report["base_step"] == 3 and report["steps"] == 1


def test_health_metrics_on_prometheus_endpoint():
    FLAGS.set("health_interval", 1)
    t = _fc_trainer()
    t.train_one_batch(_feed(np.random.RandomState(4)))
    with ObservabilityServer(port=0) as srv:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics") as resp:
            text = resp.read().decode()
    assert 'health_grad_norm{layer="hidden"}' in text
    assert 'health_grad_norm{layer="pred"}' in text
    assert 'health_update_ratio{layer="pred"}' in text


# --------------------------------------- non-finite: benign vs pathological
def test_bf16_overflow_skip_is_benign_no_alert():
    FLAGS.set("health_interval", 4)
    FLAGS.set("loss_scale_init", 1024.0)
    rng = np.random.RandomState(5)
    t = _fc_trainer(precision="bf16")
    good = _feed(rng)
    t.train_one_batch(dict(good))
    p0 = _bytes(t.params)
    t.train_one_batch(_inf_feed(good["label"]))   # seeded overflow
    assert _bytes(t.params) == p0                 # skipped, bit-identical
    t.train_one_batch(dict(good))
    t.train_one_batch(dict(good))                 # 4th step: drain
    t._sync_precision_metrics()
    assert observe.counter(
        "loss_scale_skipped_steps_total").value() == 1.0
    nf = observe.counter("health_nonfinite_steps_total")
    assert nf.value(layer="hidden", benign="true") >= 1.0
    assert nf.value(layer="hidden", benign="false") == 0.0
    assert nf.value(layer="pred", benign="false") == 0.0
    assert observe.counter("health_alerts_total").total() == 0.0
    assert health.status_summary()["status"] == "ok"


def test_fp32_nonfinite_localizes_and_alerts():
    FLAGS.set("health_interval", 2)
    rng = np.random.RandomState(6)
    t = _fc_trainer()
    good = _feed(rng)
    t.train_one_batch(dict(good))
    t.train_one_batch(_inf_feed(good["label"]))   # applied: pathological
    alerts = observe.counter("health_alerts_total")
    assert alerts.value(kind="nonfinite", layer="hidden") == 1.0
    report = health.latest_report()
    assert report["layers"]["hidden"]["nonfinite_steps"] == 1
    assert report["layers"]["hidden"]["first_nonfinite"] == 1
    assert report["alerts"] and \
        report["alerts"][0]["kind"] == "nonfinite"
    assert health.status_summary()["status"] == "degraded"


def test_first_nonfinite_step_index_survives_accumulation():
    FLAGS.set("health_interval", 3)
    rng = np.random.RandomState(7)
    t = _fc_trainer()
    good = _feed(rng)
    t.train_one_batch(dict(good))                 # step 0: clean
    t.train_one_batch(_inf_feed(good["label"]))   # step 1: inf
    t.train_one_batch(_inf_feed(good["label"]))   # step 2: still inf
    report = health.latest_report()
    assert report["layers"]["hidden"]["first_nonfinite"] == 1
    assert report["layers"]["hidden"]["nonfinite_steps"] == 2


def test_one_gradient_made_nonfinite_is_found_in_its_layer(monkeypatch):
    """A NaN planted in one parameter's gradient (the output layer's
    bias, as the step hands its gradients to the update) at the third
    step is found in that layer, at that step, and alerts once."""
    from paddle_tpu_torch.trainer import trainer as tmod
    FLAGS.set("health_interval", 4)
    t = _fc_trainer()
    prune, calls = tmod.apply_prune_grads, []

    def planted(grads, masks):
        grads = prune(grads, masks)
        calls.append(1)
        if len(calls) == 3:
            grads = dict(grads)
            grads["_pred.wbias"] = grads["_pred.wbias"].clone()
            grads["_pred.wbias"][0] = float("nan")
        return grads

    monkeypatch.setattr(tmod, "apply_prune_grads", planted)
    rng = np.random.RandomState(8)
    for _ in range(4):
        t.train_one_batch(_feed(rng))
    rows = health.latest_report()["layers"]
    assert rows["pred"]["first_nonfinite"] == 2
    assert rows["pred"]["nonfinite_steps"] >= 1
    assert rows["hidden"]["first_nonfinite"] != 2
    assert observe.counter("health_alerts_total").value(
        kind="nonfinite", layer="pred") == 1.0
    assert observe.counter("health_alerts_total").value(
        kind="nonfinite", layer="hidden") == 0.0


# ------------------------------------------------ against the JAX package
def _close_reports(got, want):
    assert got["steps"] == want["steps"]
    assert got["base_step"] == want["base_step"]
    assert sorted(got["layers"]) == sorted(want["layers"])
    for layer, w in want["layers"].items():
        g = got["layers"][layer]
        for k in ("nonfinite_steps", "benign_nonfinite_steps",
                  "first_nonfinite"):
            assert g[k] == w[k], (layer, k)
        for k, rtol in (("grad_norm", NORM_RTOL), ("param_norm", NORM_RTOL),
                        ("update_norm", UPDATE_RTOL),
                        ("update_ratio", UPDATE_RTOL)):
            if w[k] is None:
                assert g[k] is None, (layer, k)
            else:
                assert g[k] == pytest.approx(w[k], rel=rtol), (layer, k)
    assert [a["kind"] for a in got["alerts"]] == \
        [a["kind"] for a in want["alerts"]]
    assert [(a["kind"], a["layer"]) for a in got["alerts"]] == \
        [(a["kind"], a["layer"]) for a in want["alerts"]]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_drained_reports_equal_the_jax_session(precision):
    """Six steps at interval 2 from the same parameters and feeds, the
    fifth a feed of inf (fp32: applied, pathological; bf16: a loss-scale
    skip, benign): each drain's report in both packages."""
    _set_both(health_interval=2, loss_scale_init=1024.0)
    jtr, ttr = _pair("" if precision == "fp32" else "bf16")
    rng = np.random.RandomState(9)
    feeds = [_feed(rng) for _ in range(6)]
    feeds[4] = _inf_feed(feeds[4]["label"])
    drains = 0
    for i, f in enumerate(feeds):
        jtr.train_one_batch(_jax(f))
        ttr.train_one_batch(dict(f))
        if i % 2 == 1:
            drains += 1
            _close_reports(health.latest_report(), jhealth.latest_report())
    assert drains == 3
    last = health.latest_report()["layers"]["hidden"]
    key = "nonfinite_steps" if precision == "fp32" else \
        "benign_nonfinite_steps"
    assert last[key] == 1 and last["first_nonfinite"] == 0
    assert health.status_summary()["status"] == \
        jhealth.status_summary()["status"]


# ------------------------------------------------------- detector units
def _report(layers, base=0, steps=1):
    return {"ts": 0.0, "steps": steps, "base_step": base,
            "interval": 1, "loss": None, "layers": layers}


def _row(grad=1.0, param=10.0, update=0.01, nf=0, benign=0, first=-1):
    return {"grad_norm": grad, "param_norm": param,
            "update_norm": update,
            "update_ratio": update / param if param else None,
            "nonfinite_steps": nf, "benign_nonfinite_steps": benign,
            "first_nonfinite": first}


def test_monitor_loss_spike_fires_once():
    m = health.HealthMonitor(["l"], window=8, spike_mad=6.0)
    for i in range(8):
        m.observe(_report({"l": _row()}), 1.0 + 0.01 * (i % 3))
    fired = m.observe(_report({"l": _row()}), 50.0)
    assert [a["kind"] for a in fired] == ["loss_spike"]
    assert m.observe(_report({"l": _row()}), 60.0) == []
    assert observe.counter("health_alerts_total").value(
        kind="loss_spike", layer="_model") == 2.0


def test_monitor_loss_plateau_detection():
    m = health.HealthMonitor(["l"], window=6, plateau_rtol=1e-3)
    fired = []
    for _ in range(8):
        fired += m.observe(_report({"l": _row()}), 2.0)
    assert [a["kind"] for a in fired] == ["loss_plateau"]


def test_monitor_dead_layer_needs_patience():
    m = health.HealthMonitor(["l"], patience=2, dead_ratio=1e-10)
    dead = {"l": _row(grad=0.0, update=0.0)}
    assert m.observe(_report(dead), 1.0) == []
    fired = m.observe(_report(dead), 1.0)
    assert [a["kind"] for a in fired] == ["dead_layer"]
    m2 = health.HealthMonitor(["l"], patience=2, dead_ratio=1e-10)
    m2.observe(_report(dead), 1.0)
    m2.observe(_report({"l": _row()}), 1.0)
    assert m2.observe(_report(dead), 1.0) == []


def test_monitor_exploding_layer():
    m = health.HealthMonitor(["l"], patience=2, explode_ratio=0.5)
    hot = {"l": _row(update=9.0, param=10.0)}
    m.observe(_report(hot), 1.0)
    fired = m.observe(_report(hot), 1.0)
    assert [a["kind"] for a in fired] == ["exploding_layer"]


def test_monitor_streaks_reset_on_unreadable_drain():
    m = health.HealthMonitor(["l"], patience=2, dead_ratio=1e-10)
    dead = {"l": _row(grad=0.0, update=0.0)}
    unreadable = {"l": dict(_row(), grad_norm=None, update_ratio=None)}
    assert m.observe(_report(dead), 1.0) == []
    assert m.observe(_report(unreadable), 1.0) == []
    assert m.observe(_report(dead), 1.0) == []
    fired = m.observe(_report(dead), 1.0)
    assert [a["kind"] for a in fired] == ["dead_layer"]


def test_status_recovers_after_transient_condition():
    m = health.HealthMonitor(["l"], patience=1, explode_ratio=0.5)
    hot = {"l": _row(update=9.0, param=10.0)}
    m.observe(_report(hot), 1.0)
    health.publish_report(_report(hot), m)
    assert health.status_summary()["status"] == "degraded"
    assert m.active_conditions() == [("exploding_layer", "l")]
    m.observe(_report({"l": _row()}), 1.0)
    assert m.active_conditions() == []
    s = health.status_summary()
    assert s["status"] == "ok"
    assert s["alerts_total"] == 1


def test_monitor_benign_nonfinite_never_alerts():
    m = health.HealthMonitor(["l"])
    benign = {"l": _row(grad=None, update=0.0, nf=0, benign=3, first=0)}
    assert m.observe(_report(benign), 1.0) == []
    assert observe.counter("health_alerts_total").total() == 0.0


def _stream():
    """Drains that trip every detector: a spike, non-finite layers,
    dead and exploding streaks, an unreadable drain, a plateau."""
    out = []
    for i in range(10):
        out.append(({"a": _row(), "b": _row(update=0.1)}, 1.0 + 0.01 * i))
    out.append(({"a": _row(nf=2, first=1), "b": _row(nf=1, first=3)},
                40.0))
    for _ in range(3):
        out.append(({"a": _row(grad=0.0, update=0.0),
                     "b": _row(update=8.0)}, 1.0))
    out.append(({"a": dict(_row(), grad_norm=None, update_ratio=None),
                 "b": _row(update=8.0)}, float("nan")))
    out += [({"a": _row(), "b": _row()}, 2.0)] * 8
    return out


def test_monitor_fires_the_jax_alerts_on_one_stream():
    kw = dict(window=6, spike_mad=6.0, plateau_rtol=1e-3, patience=2)
    ms = [mod.HealthMonitor(["a", "b"], **kw) for mod in (health, jhealth)]
    for i, (layers, loss) in enumerate(_stream()):
        got, want = (m.observe(_report(layers, base=i), loss) for m in ms)
        assert [(a["kind"], a["layer"], a["detail"]) for a in got] == \
            [(a["kind"], a["layer"], a["detail"]) for a in want], i
        assert ms[0].active_conditions() == ms[1].active_conditions(), i
    kinds = {a["kind"] for a in ms[0].recent_alerts()}
    assert kinds == {"loss_spike", "nonfinite", "dead_layer",
                     "exploding_layer", "loss_plateau"}
    assert observe.counter("health_alerts_total").samples() == \
        jobs.counter("health_alerts_total").samples()


# ------------------------------------------------------- live endpoints
def test_health_endpoint_serves_latest_report():
    FLAGS.set("health_interval", 1)
    t = _fc_trainer()
    t.train_one_batch(_feed(np.random.RandomState(8)))
    with ObservabilityServer(port=0) as srv:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/health") as resp:
            body = json.loads(resp.read().decode())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz") as resp:
            hz = json.loads(resp.read().decode())
    assert sorted(body["layers"]) == ["hidden", "pred"]
    assert body["layers"]["hidden"]["grad_norm"] > 0
    assert hz["status"] == "ok" and hz["health"]["alerts_total"] == 0


def test_health_endpoint_404_before_first_drain():
    health.reset()
    with ObservabilityServer(port=0) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health")
        assert ei.value.code == 404


def test_healthz_degrades_on_alert_but_stays_200():
    FLAGS.set("health_interval", 2)
    rng = np.random.RandomState(9)
    t = _fc_trainer()
    good = _feed(rng)
    t.train_one_batch(dict(good))
    t.train_one_batch(_inf_feed(good["label"]))
    with ObservabilityServer(port=0) as srv:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz") as resp:
            assert resp.status == 200
            hz = json.loads(resp.read().decode())
    assert hz["status"] == "degraded"
    assert hz["health"]["alerts_total"] >= 1
    assert hz["health"]["last_alerts"][0]["kind"] == "nonfinite"


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_health_bodies_equal_the_jax_bodies():
    """One report and one monitor state published in both packages: the
    ``/health`` bodies are equal, and so are ``/healthz``'s status code,
    status and health digest; before any report both answer 404 with
    the same body."""
    kw = dict(patience=1, explode_ratio=0.5)
    rep = _report({"l": _row(update=9.0, param=10.0)}, base=4, steps=2)
    rep["ts"] = 12.5
    with ObservabilityServer(port=0) as srv, JServer(port=0) as jsrv:
        assert _get(srv.port, "/health") == _get(jsrv.port, "/health")
        for mod in (health, jhealth):
            m = mod.HealthMonitor(["l"], **kw)
            r = dict(rep)
            r["alerts"] = m.observe(r, 1.0)
            for a in r["alerts"]:
                a["ts"] = 0.0
            mod.publish_report(r, m)
        got, want = _get(srv.port, "/health"), _get(jsrv.port, "/health")
        assert got == want and got[0] == 200
        (code, hz), (jcode, jhz) = (_get(p, "/healthz")
                                    for p in (srv.port, jsrv.port))
    assert code == jcode == 200
    assert hz["status"] == jhz["status"] == "degraded"
    for d in (hz, jhz):
        for a in d["health"]["last_alerts"]:
            a["ts"] = 0.0
    assert hz["health"] == jhz["health"]


def test_train_step_span_carries_drain_summary():
    FLAGS.set("health_interval", 1)
    trace.ensure_ring(ring_size=64)
    t = _fc_trainer()
    t.train_one_batch(_feed(np.random.RandomState(11)))
    steps = [e for e in trace.events() if e["name"] == "train_step"]
    assert steps
    args = steps[-1]["args"]
    assert args["health_drained_steps"] == 1
    assert args["health_grad_norm_max_layer"] in ("hidden", "pred")


def test_bf16_health_aux_rides_the_mixed_step():
    FLAGS.set("health_interval", 1)
    rng = np.random.RandomState(12)
    t = _fc_trainer(precision="bf16")
    for _ in range(2):
        t.train_one_batch(_feed(rng))
    assert observe.gauge("health_grad_norm").value(layer="pred") > 0
    for p in t.params.values():
        assert p.dtype == torch.float32


def test_drain_handles_nonfinite_norm_values():
    FLAGS.set("health_interval", 1)
    rng = np.random.RandomState(14)
    t = _fc_trainer()
    good = _feed(rng)
    t.train_one_batch(_inf_feed(good["label"]))
    report = health.latest_report()
    row = report["layers"]["hidden"]
    assert row["grad_norm"] is None
    assert json.dumps(report)
    assert row["param_norm"] is None or math.isfinite(row["param_norm"])
    assert observe.gauge("health_layer_nonfinite").value(
        layer="hidden") == 1.0
    t.train_one_batch(dict(good))
    assert observe.gauge("health_layer_nonfinite").value(
        layer="hidden") == 0.0


def test_relu_gradient_at_nan_is_zero_as_in_jax():
    """The port's ``relu`` is differentiated as ``jax.nn.relu``: 0 where
    the input is NaN or <= 0, the upstream gradient (NaN too) where it
    is > 0 — so a layer recovers on the finite step after a non-finite
    one, as in the reference."""
    import jax
    from paddle_tpu.ops import activations as jact
    from paddle_tpu_torch.ops import activations as tact
    x = np.asarray([np.nan, -1.0, 0.0, 2.0, np.inf, -np.inf], np.float32)
    g = np.asarray([1.0, 1.0, 1.0, np.nan, 3.0, 1.0], np.float32)
    _, vjp = jax.vjp(jact.relu, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tact.relu(tx)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), want)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jact.relu(jnp.asarray(x))))


def test_health_report_shows_ongoing_incident_beyond_first_drain():
    FLAGS.set("health_interval", 1)
    FLAGS.set("health_patience", 1)
    FLAGS.set("health_explode_ratio", 1e-9)
    rng = np.random.RandomState(15)
    t = _fc_trainer()
    t.train_one_batch(_feed(rng))
    t.train_one_batch(_feed(rng))
    report = health.latest_report()
    assert report["alerts"] == []
    kinds = {a["kind"] for a in report["active"]}
    assert "exploding_layer" in kinds
    assert report["recent_alerts"]


def test_the_sparse_exchange_is_off_while_health_is_on():
    """The reference's veto: with ``--health_interval`` on no table takes
    the sparse gradient exchange."""
    from paddle_tpu_torch.models.ctr import ctr_classifier
    FLAGS.set("health_interval", 1)
    tr = Trainer(TNet(ctr_classifier(64, 8)), device="cpu")
    assert tr._sparse_exchange_plan() == {}
    FLAGS.set("health_interval", 0)
    tr = Trainer(TNet(ctr_classifier(64, 8)), device="cpu")
    assert tr._sparse_exchange_plan() != {}
