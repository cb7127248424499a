"""The port's train→serve pipeline (``paddle_tpu_torch.serving.rollout``,
the server's hot swap) on the CPU: the cases of ``tests/test_rollout.py``
at its ``DecoderConfig(64, 32, 2, 1, 64, 64)``, the fleet-supervised
coordinator's walk over CPU servers and the fleet plumbing included.

Against the JAX package: a JAX checkpoint exported by the JAX watcher
verifies, swaps into the port's server and generates the JAX server's
tokens, and a port export swaps into the JAX server likewise (tokens
equal: both servers decode the same int8-dequantized fp32 weights, and
the prompts' argmax margins, as in ``tests/test_torch_serving.py``, hold
the tokens equal); the port's ``artifact_digest`` of a JAX-written
artifact is the JAX one, and both packages name the export
``model-<digest12>``.
"""

import contextlib
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu_torch import observe
from paddle_tpu_torch.observe import REGISTRY
from paddle_tpu_torch.serving.loader import (TornArtifact, artifact_digest,
                                             read_manifest, verify_artifact)
from paddle_tpu_torch.trainer import checkpoint as ck
from paddle_tpu_torch.utils import FLAGS, PaddleTpuError


@contextlib.contextmanager
def _flag(name, value):
    saved = FLAGS.get(name)
    FLAGS.set(name, value)
    try:
        yield
    finally:
        FLAGS.set(name, saved)


@pytest.fixture(autouse=True)
def _port_registry():
    """The port's registry is its own (tests/conftest.py resets only the
    JAX package's): every case starts and ends empty, with no fleet
    identity or serving info another file's server left."""
    REGISTRY.reset()
    observe.fleet.reset_identity()
    yield
    observe.stop_global()
    observe.fleet.reset_identity()
    REGISTRY.reset()


@pytest.fixture(scope="module")
def cfg():
    from paddle_tpu_torch.serving.model import DecoderConfig

    return DecoderConfig(vocab=64, dim=32, heads=2, layers=1, ffn=64,
                         max_context=64, eos_id=1)


def _params(cfg, seed):
    from paddle_tpu_torch.serving.model import init_decoder_params

    return init_decoder_params(cfg, seed=seed)


def _model(cfg, seed):
    from paddle_tpu_torch.serving.model import DecoderModel

    return DecoderModel(_params(cfg, seed), cfg, device="cpu")


def _export(cfg, dirname, seed, quantize="int8"):
    from paddle_tpu_torch.serving.model import export_decoder

    export_decoder(_params(cfg, seed), cfg, str(dirname), quantize=quantize)
    return str(dirname)


def _server(cfg, seed=0, **kw):
    from paddle_tpu_torch.serving.server import InferenceServer

    kw.setdefault("n_pages", 33)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch", 4)
    return InferenceServer(_model(cfg, seed), **kw)


# -------------------------------------------------- artifact digests
def test_manifest_carries_file_digests_and_stamp(cfg, tmp_path):
    d = _export(cfg, tmp_path / "a", seed=0)
    man = read_manifest(d)
    assert "weights.npz" in man["files"]
    ent = man["files"]["weights.npz"]
    assert len(ent["sha256"]) == 64
    assert ent["bytes"] == os.path.getsize(os.path.join(d, "weights.npz"))
    assert man["exported_at_unix"] > 0
    assert verify_artifact(d) is True


def test_artifact_digest_is_content_stable(cfg, tmp_path):
    a = _export(cfg, tmp_path / "a", seed=0)
    b = _export(cfg, tmp_path / "b", seed=0)   # same content, later time
    c = _export(cfg, tmp_path / "c", seed=1)
    da, db, dc = (artifact_digest(read_manifest(x)) for x in (a, b, c))
    assert da == db                 # timestamps don't leak into identity
    assert da != dc
    assert len(da) == 64


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_torn_artifact_refused(cfg, tmp_path, mode):
    from paddle_tpu_torch.serving.model import DecoderModel
    from paddle_tpu_torch.testing.fault import corrupt_artifact

    d = _export(cfg, tmp_path / "a", seed=0)
    corrupt_artifact(d, mode=mode)
    with pytest.raises(TornArtifact):
        verify_artifact(d)
    with pytest.raises(TornArtifact):
        DecoderModel.from_artifact(d, device="cpu")    # verify=True


def test_resigned_manifest_refused(cfg, tmp_path):
    from paddle_tpu_torch.testing.fault import resign_artifact_manifest

    d = _export(cfg, tmp_path / "a", seed=0)
    resign_artifact_manifest(d)
    with pytest.raises(TornArtifact, match="sha256"):
        verify_artifact(d)


def test_checkpoint_digest(cfg, tmp_path):
    d0 = ck.save_checkpoint(str(tmp_path), 0, _params(cfg, 0))
    d1 = ck.save_checkpoint(str(tmp_path), 1, _params(cfg, 1))
    g0, g1 = ck.checkpoint_digest(d0), ck.checkpoint_digest(d1)
    assert g0 and g1 and g0 != g1
    assert ck.checkpoint_digest(d0) == g0
    assert ck.checkpoint_digest(str(tmp_path)) is None


# ------------------------------------------- retention/export race
def test_export_lease_pins_checkpoint_against_retention(cfg, tmp_path):
    """Retention sweeps WHILE an exporter holds a lease on the oldest
    checkpoint: the sweep skips it, and reaps it once released."""
    dirs = [ck.save_checkpoint(str(tmp_path), i, _params(cfg, 0), keep=0)
            for i in range(3)]
    oldest = dirs[0]
    pinned = observe.counter("ckpt_retention_pinned", "")
    base = pinned.value()
    with ck.export_lease(oldest):
        assert ck.export_pinned(oldest)
        removed = ck.sweep_retention(str(tmp_path), keep=1)
        assert os.path.isdir(oldest)
        assert oldest not in removed
        assert pinned.value() == base + 1
    assert not ck.export_pinned(oldest)
    ck.sweep_retention(str(tmp_path), keep=1)
    assert not os.path.isdir(oldest)
    assert os.path.isdir(dirs[-1])


def test_stale_export_lease_expires(cfg, tmp_path):
    d0 = ck.save_checkpoint(str(tmp_path), 0, _params(cfg, 0), keep=0)
    ck.save_checkpoint(str(tmp_path), 1, _params(cfg, 0), keep=0)
    marker = os.path.join(d0, ".exporting-99999")
    open(marker, "w").close()
    assert ck.export_pinned(d0)
    old = time.time() - float(FLAGS.get("ckpt_export_lease_s")) - 5.0
    os.utime(marker, (old, old))
    assert not ck.export_pinned(d0)
    ck.sweep_retention(str(tmp_path), keep=1)
    assert not os.path.isdir(d0)


# ------------------------------------------------------------ export
def test_export_checkpoint_atomic_and_exactly_once(cfg, tmp_path):
    from paddle_tpu_torch.serving import rollout as ro

    save_dir = str(tmp_path / "ckpts")
    export_dir = str(tmp_path / "export")
    d0 = ck.save_checkpoint(save_dir, 0, _params(cfg, 0))
    art = ro.export_checkpoint(d0, export_dir, cfg)
    assert os.path.basename(art).startswith(ro.ARTIFACT_PREFIX)
    man = read_manifest(art)
    assert man["source_ckpt_digest"] == ck.checkpoint_digest(d0)
    assert man["source_ckpt"] == os.path.basename(d0)
    assert verify_artifact(art) is True
    digest = artifact_digest(man)
    assert os.path.basename(art) == f"model-{digest[:12]}"
    assert ro.export_checkpoint(d0, export_dir, cfg) == art
    assert os.listdir(export_dir) == [os.path.basename(art)]
    assert observe.counter("rollout_exports_total",
                           "").value(result="ok") == 2
    assert observe.histogram("rollout_export_seconds",
                             "").retained_samples() == 2


def test_latest_valid_artifact_skips_torn(cfg, tmp_path):
    from paddle_tpu_torch.serving import rollout as ro
    from paddle_tpu_torch.testing.fault import corrupt_artifact

    save_dir = str(tmp_path / "ckpts")
    export_dir = str(tmp_path / "export")
    arts = []
    for i in range(2):
        d = ck.save_checkpoint(save_dir, i, _params(cfg, i))
        arts.append(ro.export_checkpoint(d, export_dir, cfg))
        time.sleep(0.01)        # distinct exported_at stamps
    assert ro.latest_valid_artifact(export_dir) == arts[-1]
    corrupt_artifact(arts[-1], mode="bitflip")
    assert ro.latest_valid_artifact(export_dir) == arts[0]
    corrupt_artifact(arts[0], mode="truncate")
    assert ro.latest_valid_artifact(export_dir) is None


def test_sweep_export_dir_keeps_newest(cfg, tmp_path):
    from paddle_tpu_torch.serving import rollout as ro

    save_dir = str(tmp_path / "ckpts")
    export_dir = str(tmp_path / "export")
    arts = []
    for i in range(3):
        d = ck.save_checkpoint(save_dir, i, _params(cfg, i))
        arts.append(ro.export_checkpoint(d, export_dir, cfg))
        time.sleep(0.01)
    fresh = os.path.join(export_dir, ".tmp-export-fresh")
    stale = os.path.join(export_dir, ".tmp-export-stale")
    os.makedirs(fresh)
    os.makedirs(stale)
    old = time.time() - ck._TMP_STALE_S - 10
    os.utime(stale, (old, old))
    removed = ro.sweep_export_dir(export_dir, keep=2)
    assert arts[0] in removed and stale in removed
    assert os.path.isdir(arts[1]) and os.path.isdir(arts[2])
    assert os.path.isdir(fresh)


# ----------------------------------------------------------- watcher
def test_watcher_exactly_once_and_skips_bad(cfg, tmp_path):
    from paddle_tpu_torch.serving import rollout as ro
    from paddle_tpu_torch.testing.fault import corrupt_checkpoint

    save_dir = str(tmp_path / "ckpts")
    export_dir = str(tmp_path / "export")
    for i in range(2):
        ck.save_checkpoint(save_dir, i, _params(cfg, i))
    bad = ck.save_checkpoint(save_dir, 2, _params(cfg, 2))
    corrupt_checkpoint(bad, mode="bitflip")
    os.makedirs(os.path.join(save_dir, ".tmp-ckpt-x"))
    os.makedirs(os.path.join(save_dir, ".corrupt-20200101-000000-pass"))

    w = ro.CheckpointWatcher(save_dir, cfg, export_dir=export_dir,
                             poll_s=0.05)
    arts = w.poll_once()
    assert len(arts) == 2               # the two good ones, oldest first
    assert w.poll_once() == []          # exactly once
    w2 = ro.CheckpointWatcher(save_dir, cfg, export_dir=export_dir,
                              poll_s=0.05)
    assert w2.poll_once() == []         # restart: reseeded from artifacts
    srcs = ro.exported_source_digests(export_dir)
    assert ck.checkpoint_digest(bad) not in srcs
    assert len(srcs) == 2


def test_watcher_thread_lifecycle(cfg, tmp_path):
    from paddle_tpu_torch.serving import rollout as ro

    save_dir = str(tmp_path / "ckpts")
    ck.save_checkpoint(save_dir, 0, _params(cfg, 0))
    w = ro.CheckpointWatcher(save_dir, cfg,
                             export_dir=str(tmp_path / "export"),
                             poll_s=0.05)
    with w:
        assert any(t.name == ro.WATCHER_THREAD_NAME
                   for t in threading.enumerate())
        deadline = time.monotonic() + 30.0
        while not w._seen and time.monotonic() < deadline:
            time.sleep(0.02)
        assert w._seen
    assert not any(t.name == ro.WATCHER_THREAD_NAME
                   for t in threading.enumerate())


def test_watcher_refused_when_rollout_disabled(cfg, tmp_path):
    from paddle_tpu_torch.serving import rollout as ro

    with _flag("rollout", False):
        with pytest.raises(PaddleTpuError, match="rollout disabled"):
            ro.CheckpointWatcher(str(tmp_path), cfg)


# ---------------------------------------------------------- hot swap
def test_swap_ok_updates_version_healthz_and_metrics(cfg, tmp_path):
    from paddle_tpu_torch.serving import rollout as ro

    art = _export(cfg, tmp_path / "a", seed=1)
    digest = artifact_digest(read_manifest(art))
    with _server(cfg, seed=0) as srv:
        report = ro.swap_from_artifact(srv, art)
        assert report["result"] == "ok"
        assert report["version"] == digest
        assert report["pause_s"] <= report["swap_s"]
        assert srv.model_version == digest
        assert srv.rollout_state == "serving"
        assert srv.model_exported_at == read_manifest(
            art)["exported_at_unix"]
        toks = srv.generate([2, 3, 4], 4, timeout=120.0)
        assert 1 <= len(toks) <= 4
        st = srv.stats()
        assert st["model_version"] == digest
        assert st["rollout_state"] == "serving"
        assert st["last_swap_error"] is None
        assert ro.swap_from_artifact(srv, art)["result"] == "unchanged"
    assert observe.counter("rollout_swap_total",
                           "").value(result="ok") == 1
    assert observe.histogram("rollout_swap_seconds",
                             "").retained_samples() >= 1
    assert observe.histogram("rollout_swap_pause_seconds",
                             "").retained_samples() >= 1
    g = observe.gauge("rollout_model_version", "")
    assert g.value(digest=digest) == 1.0
    assert g.value(digest="unversioned") == 0.0


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "resign"])
def test_swap_rollback_on_verify_failure(cfg, tmp_path, mode):
    from paddle_tpu_torch.serving import rollout as ro
    from paddle_tpu_torch.testing.fault import (corrupt_artifact,
                                                resign_artifact_manifest)

    art = _export(cfg, tmp_path / "a", seed=1)
    if mode == "resign":
        resign_artifact_manifest(art)
    else:
        corrupt_artifact(art, mode=mode)
    with _server(cfg, seed=0) as srv:
        report = ro.swap_from_artifact(srv, art)
        assert report["result"] == "rolled_back"
        assert report["error"].startswith("verify:")
        assert srv.model_version == "unversioned"
        assert srv.rollout_state == "rolled_back"
        assert "verify:" in srv.stats()["last_swap_error"]
        toks = srv.generate([2, 3, 4], 4, timeout=120.0)
        assert 1 <= len(toks) <= 4
    assert observe.counter("rollout_swap_total",
                           "").value(result="verify_failed") == 1


def test_swap_rollback_on_load_failure(cfg, tmp_path):
    from paddle_tpu_torch.serving import rollout as ro

    art = _export(cfg, tmp_path / "a", seed=1)
    mpath = os.path.join(art, "manifest.json")
    man = json.load(open(mpath))
    man["kind"] = "not-a-decoder"      # manifest itself is not digested
    json.dump(man, open(mpath, "w"))
    with _server(cfg, seed=0) as srv:
        report = ro.swap_from_artifact(srv, art)
        assert report["result"] == "rolled_back"
        assert report["error"].startswith("load:")
        assert srv.model_version == "unversioned"
    assert observe.counter("rollout_swap_total",
                           "").value(result="load_failed") == 1


def test_swap_rollback_on_probe_failure(cfg, tmp_path):
    """Weights verify and load but give non-finite logits: the probe
    (``torch.isfinite`` on the calling thread) is the last gate."""
    from paddle_tpu_torch.serving import export as ex
    from paddle_tpu_torch.serving import rollout as ro

    art = _export(cfg, tmp_path / "a", seed=1, quantize=None)
    wpath = os.path.join(art, ex.WEIGHTS_FILE)
    with np.load(wpath) as z:
        weights = {k: np.full_like(np.asarray(z[k]), np.nan)
                   for k in z.files}
    np.savez(wpath, **weights)
    man = read_manifest(art)
    ex.stamp_manifest(man, art, [ex.WEIGHTS_FILE])
    json.dump(man, open(os.path.join(art, "manifest.json"), "w"))
    assert verify_artifact(art) is True
    with _server(cfg, seed=0) as srv:
        report = ro.swap_from_artifact(srv, art)
        assert report["result"] == "rolled_back"
        assert report["error"].startswith("probe:")
        assert srv.model_version == "unversioned"
        assert srv.generate([2, 3], 3, timeout=120.0)
    assert observe.counter("rollout_swap_total",
                           "").value(result="probe_failed") == 1


def test_swap_config_mismatch_refused(cfg, tmp_path):
    from paddle_tpu_torch.serving.model import DecoderConfig

    other = DecoderConfig(vocab=64, dim=16, heads=2, layers=1, ffn=32,
                          max_context=64, eos_id=1)
    with _server(cfg, seed=0) as srv:
        with pytest.raises(PaddleTpuError, match="config"):
            srv.request_swap(_model(other, 0), version="x")


def _ref_tokens(cfg, seed, prompt, max_new):
    with _server(cfg, seed=seed) as srv:
        return srv.generate(list(prompt), max_new, timeout=120.0)


@pytest.mark.parametrize("policy", ["drain", "reprefill"])
def test_swap_boundary_exactly_one_model(cfg, policy):
    """A request submitted before the flip that completes after it gets
    tokens from exactly one model: the OLD one under ``drain``, the NEW
    one under ``reprefill``."""
    prompt = [2, 3, 4, 5]
    max_new = 16
    ref_old = _ref_tokens(cfg, 0, prompt, max_new)
    ref_new = _ref_tokens(cfg, 1, prompt, max_new)
    assert ref_old != ref_new
    with _server(cfg, seed=0) as srv:
        r = srv.submit(prompt, max_new)
        deadline = time.monotonic() + 60.0
        while len(r.tokens) < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert len(r.tokens) >= 2, "request never started decoding"
        ticket = srv.request_swap(_model(cfg, 1), version="v-new",
                                  inflight=policy)
        report = ticket.wait(120.0)
        assert report["result"] == "ok"
        toks = srv.result(r, timeout=120.0)
        if policy == "drain":
            assert toks == ref_old
            assert "reprefilled" not in report
        else:
            assert toks == ref_new
            assert report["reprefilled"] == [r.id]
        assert srv.model_version == "v-new"
        assert srv.generate(prompt, max_new, timeout=120.0) == ref_new


def test_kill_switch_server_byte_identical(cfg):
    """--rollout=false: stats() and /healthz carry the pre-rollout keys,
    /v1/swap does not exist, the 404 body lists the pre-rollout paths,
    and request_swap refuses."""
    with _flag("rollout", False):
        with _server(cfg, seed=0) as srv:
            assert not srv.rollout_enabled
            st = srv.stats()
            assert set(st) == {"queue_depth", "active", "free_pages",
                               "used_pages", "served",
                               "generated_tokens", "continuous",
                               "max_batch"}
            with pytest.raises(PaddleTpuError, match="rollout disabled"):
                srv.request_swap(_model(cfg, 1))
            port = srv.start_http(0)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz",
                    timeout=30) as resp:
                health = json.loads(resp.read())
            assert set(health) == set(st) | {"status"}
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/swap",
                    data=b"{}"), timeout=30)
            assert ei.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/nope", timeout=30)
            assert json.loads(ei.value.read())["paths"] == \
                ["/v1/generate", "/healthz"]


def test_http_swap_endpoint(cfg, tmp_path):
    art = _export(cfg, tmp_path / "a", seed=1)
    digest = artifact_digest(read_manifest(art))

    def post(body):
        return urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/swap",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}), timeout=120)

    with _server(cfg, seed=0) as srv:
        port = srv.start_http(0)
        with post({"artifact": art}) as resp:
            out = json.loads(resp.read())
        assert out["result"] == "ok" and out["version"] == digest
        with post({"artifact": art}) as resp:       # idempotent re-POST
            assert json.loads(resp.read())["result"] == "unchanged"
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"artifact": str(tmp_path / "missing")})
        assert ei.value.code == 500
        assert json.loads(ei.value.read())["result"] == "rolled_back"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["rollout_state"] == "rolled_back"
        assert health["model_version"] == digest   # old version serving
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=30)
        assert json.loads(ei.value.read())["paths"] == \
            ["/v1/generate", "/healthz", "/v1/swap"]


def test_rollout_metrics_served_on_metrics_endpoint(cfg, tmp_path):
    from paddle_tpu_torch.observe.http import ObservabilityServer
    from paddle_tpu_torch.serving import rollout as ro

    art = _export(cfg, tmp_path / "a", seed=1)
    digest = artifact_digest(read_manifest(art))
    with _server(cfg, seed=0) as srv:
        assert ro.swap_from_artifact(srv, art)["result"] == "ok"
        with ObservabilityServer(0) as obs:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{obs.port}/metrics") as r:
                text = r.read().decode()
    assert 'rollout_swap_total{result="ok"} 1' in text
    assert "# TYPE rollout_swap_seconds histogram" in text
    assert "rollout_swap_seconds_count" in text
    assert f'rollout_model_version{{digest="{digest}"}} 1.0' in text


# ------------------------------------------------------- canary bake
def _export_as_rollback_target(cfg, export_dir, seed, **extra):
    """Export under the canonical ``model-<digest12>`` name so a later
    canary rollback (``previous_artifact_dir``) can find it."""
    from paddle_tpu_torch.serving import rollout as ro
    from paddle_tpu_torch.serving.model import export_decoder

    tmp = os.path.join(str(export_dir), f".stage-{seed}")
    export_decoder(_params(cfg, seed), cfg, tmp, **extra)
    digest = artifact_digest(read_manifest(tmp))
    final = os.path.join(str(export_dir),
                         f"{ro.ARTIFACT_PREFIX}{digest[:12]}")
    os.rename(tmp, final)
    return final, digest


class _Traffic:
    """Background request stream against an in-process server; counts
    successes and records any client-visible failure."""

    def __init__(self, srv):
        self.srv = srv
        self.served = 0
        self.errors = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        i = 0
        while not self._stop.is_set():
            try:
                toks = self.srv.generate([2 + (i % 60)] * 3, 2,
                                         timeout=120.0)
                assert toks
                self.served += 1
            except Exception as e:   # noqa: BLE001 — the assertion ledger
                self.errors.append(repr(e))
            i += 1

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=120.0)


def _warm_window(min_samples=100, timeout_s=60.0):
    h = REGISTRY.find("serve_ttft_seconds")
    deadline = time.monotonic() + timeout_s
    while h is None or h.window_count(60.0) < min_samples:
        assert time.monotonic() < deadline, "baseline never warmed"
        time.sleep(0.05)
        h = REGISTRY.find("serve_ttft_seconds")


def test_canary_bake_rolls_back_slow_artifact_zero_failures(cfg, tmp_path):
    """An artifact with an injected latency regression (manifest
    ``debug_prefill_delay_ms``) is detected by the bake and rolled back
    with zero failed requests; a clean artifact then bakes and
    promotes."""
    from paddle_tpu_torch.serving import rollout as ro

    exp = tmp_path / "export"
    os.makedirs(exp)
    good, dig_good = _export_as_rollback_target(cfg, exp, seed=1)
    slow, _ = _export_as_rollback_target(
        cfg, exp, seed=2, extra_meta={"debug_prefill_delay_ms": 250})
    better, dig_better = _export_as_rollback_target(cfg, exp, seed=3)

    with _server(cfg, seed=0, continuous=True) as srv:
        port = srv.start_http(0)
        with _Traffic(srv) as traffic:
            assert ro.swap_from_artifact(srv, good)["result"] == "ok"
            _warm_window()
            rep = ro.swap_from_artifact(srv, slow, canary=True,
                                        bake_s=1.2, canary_factor=2.0)
            assert rep["result"] == "rolled_back"
            can = rep["canary"]
            assert can["result"] == "rolled_back"
            assert can["rollback"] == "ok"
            assert "p99 TTFT" in can["reason"]
            assert can["p99_s"] > 2.0 * can["baseline_p99_s"]
            assert srv.model_version == dig_good
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz",
                    timeout=30) as resp:
                health = json.loads(resp.read())
            assert health["rollout_state"] == "rolled_back"
            assert health["last_swap_error"].startswith("canary bake:")
            assert health["model_version"] == dig_good
            rep2 = ro.swap_from_artifact(srv, better, canary=True,
                                         bake_s=1.2, canary_factor=2.0)
            assert rep2["result"] == "ok"
            assert rep2["canary"]["result"] == "promoted"
            assert srv.model_version == dig_better
        assert traffic.errors == []
        assert traffic.served > 0
        errs = REGISTRY.find("serve_request_failures")
        assert errs is None or errs.window_count(60.0) == 0
    assert observe.counter("rollout_canary_total",
                           "").value(result="rolled_back") == 1
    assert observe.counter("rollout_canary_total",
                           "").value(result="promoted") == 1


def test_canary_kill_switch_swap_report_identical(cfg, tmp_path):
    from paddle_tpu_torch.serving import rollout as ro

    art = _export(cfg, tmp_path / "a", seed=1)
    with _server(cfg, seed=0) as srv:
        rep = ro.swap_from_artifact(srv, art)       # flags at defaults
        assert rep["result"] == "ok" and "canary" not in rep
        art2 = _export(cfg, tmp_path / "b", seed=2)
        rep = ro.swap_from_artifact(srv, art2, canary=True, bake_s=0.0)
        assert rep["result"] == "ok" and "canary" not in rep
        with _flag("serve_slo_ms", 250.0):
            st = srv.stats()
            assert "ttft_p99_ms" in st and "slo_met" in st


# ------------------------------------------- against the JAX package
PROMPTS = [[2, 3, 4, 5], [9, 8, 7], [11, 12, 13, 14, 15, 16], [40]]


def _jax_tokens(artifact):
    from paddle_tpu.serving.model import DecoderModel as JModel
    from paddle_tpu.serving.server import InferenceServer as JServer

    with JServer(JModel.from_artifact(artifact), max_batch=4, n_pages=33,
                 page_size=8) as srv:
        return [srv.generate(p, 8, timeout=120.0) for p in PROMPTS]


def test_jax_artifact_swaps_into_the_port_and_back(cfg, tmp_path):
    """A JAX checkpoint exported by the JAX watcher verifies, swaps into
    the port's server and gives the JAX server's tokens; a port export
    swaps into the JAX server likewise.  The digests agree."""
    from paddle_tpu.serving import rollout as jro
    from paddle_tpu.serving.loader import artifact_digest as j_digest
    from paddle_tpu.serving.model import DecoderConfig as JConfig
    from paddle_tpu.serving.model import DecoderModel as JModel
    from paddle_tpu.serving.model import init_decoder_params as j_init
    from paddle_tpu.serving.server import InferenceServer as JServer
    from paddle_tpu.trainer import checkpoint as jck
    from paddle_tpu_torch.serving import rollout as ro

    jcfg = JConfig(**cfg._asdict())
    jsave = str(tmp_path / "jax_ckpts")
    jck.save_checkpoint(jsave, 0, j_init(jcfg, seed=1))
    (jart,) = jro.CheckpointWatcher(
        jsave, jcfg, export_dir=str(tmp_path / "jax_export")).poll_once()
    man = read_manifest(jart)
    assert artifact_digest(man) == j_digest(man)
    assert os.path.basename(jart) == f"model-{artifact_digest(man)[:12]}"
    want = _jax_tokens(jart)
    with _server(cfg, seed=0) as srv:
        assert ro.swap_from_artifact(srv, jart)["result"] == "ok"
        assert srv.model_version == artifact_digest(man)
        assert [srv.generate(p, 8, timeout=120.0) for p in PROMPTS] == want

    # the reverse: the port's watcher exports, the JAX server swaps it in
    tsave = str(tmp_path / "port_ckpts")
    ck.save_checkpoint(tsave, 0, _params(cfg, 2))
    (tart,) = ro.CheckpointWatcher(
        tsave, cfg, export_dir=str(tmp_path / "port_export")).poll_once()
    with _server(cfg, seed=0) as srv:
        assert ro.swap_from_artifact(srv, tart)["result"] == "ok"
        got = [srv.generate(p, 8, timeout=120.0) for p in PROMPTS]
    with JServer(JModel(j_init(jcfg, seed=0), jcfg), max_batch=4,
                 n_pages=33, page_size=8) as jsrv:
        rep = jro.swap_from_artifact(jsrv, tart)
        assert rep["result"] == "ok"
        assert rep["version"] == artifact_digest(read_manifest(tart))
        assert [jsrv.generate(p, 8, timeout=120.0) for p in PROMPTS] == got


def test_bf16_dequant_decoder_matches_jax(cfg, tmp_path):
    """A decoder artifact dequantized to bf16.  The product: the JAX
    package promotes a bf16 weight against fp32 activations to an fp32
    product; the port keeps the weight bf16 and upcasts it at the op —
    the same numbers (atol 1e-6: both are f32 sums of the same terms).
    The whole prefill: the port also upcasts the bf16 embedding tables
    where it reads them, while the JAX package carries their bf16 sum
    into its first RMS norm, so the logits differ by one bf16 rounding
    of the input embedding (2^-8 relative) carried through the net:
    atol 2e-2 (6.3e-3 measured), the tokens equal."""
    import jax.numpy as jnp
    from paddle_tpu.serving.model import DecoderModel as JModel
    from paddle_tpu_torch.serving.model import (DecoderModel, _mm,
                                                export_decoder)

    d = str(tmp_path / "bf16")
    export_decoder(_params(cfg, 1), cfg, d, dequant_dtype="bfloat16")
    assert read_manifest(d)["weights"]["dequant_dtype"] == "bfloat16"
    tm = DecoderModel.from_artifact(d, device="cpu")
    jm = JModel.from_artifact(d)
    w = tm.params["l0.wq"]
    assert str(w.dtype) == "torch.bfloat16"
    assert str(jm.params["l0.wq"].dtype) == "bfloat16"
    x = np.random.default_rng(0).standard_normal((5, cfg.dim)) \
        .astype(np.float32)
    import torch
    got = _mm(torch.from_numpy(x), w).numpy()
    want = np.asarray(jnp.asarray(x) @ jm.params["l0.wq"])
    assert want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    toks = np.array([[2, 3, 4, 5, 6, 0, 0, 0], [7, 8, 9, 10, 11, 12, 13, 14]],
                    np.int32)
    lengths = np.array([5, 8], np.int32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    kp, vp = jm.new_pools(9, 8)
    jn, jl, _, _ = jm.prefill(kp, vp, toks, lengths, tables)
    kp, vp = tm.new_pools(9, 8)
    tn, tl, _, _ = tm.prefill(kp, vp, toks, lengths, tables)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               atol=2e-2, rtol=0)
    np.testing.assert_array_equal(tn, np.asarray(jn))


# ------------------------------------------------------- coordinator
def _ingest(agg, name, status="ok", pid=100, serving=None):
    frame = {"schema": 1, "kind": "fleet-frame", "role": "serving",
             "name": name, "node": "host-a", "pid": pid, "seq": 0,
             "ts": time.time(), "uptime_s": 1.0, "interval_s": 600.0,
             "going_down": False, "health": {"status": status},
             "metrics": [], "timers": [], "spans": []}
    if serving is not None:
        frame["serving"] = serving
    agg.state.ingest(frame)


def test_coordinator_skips_degraded_and_missing(cfg, tmp_path):
    from paddle_tpu_torch.observe.fleet import FleetAggregator
    from paddle_tpu_torch.serving import rollout as ro

    art = _export(cfg, tmp_path / "a", seed=1)
    digest = artifact_digest(read_manifest(art))
    with FleetAggregator(0) as agg, \
            _server(cfg, seed=0) as good, _server(cfg, seed=0) as sick:
        gport, sport = good.start_http(0), sick.start_http(0)
        _ingest(agg, "serve-good", status="ok", pid=101)
        _ingest(agg, "serve-sick", status="degraded", pid=102)
        # "serve-gone" never pushed a frame at all
        coord = ro.RollingCoordinator(agg.addr, [
            ("serve-sick", f"127.0.0.1:{sport}"),
            ("serve-gone", "127.0.0.1:1"),
            ("serve-good", f"127.0.0.1:{gport}"),
        ])
        report = coord.rollout(art)
        assert report["result"] == "ok"
        assert report["skipped"] == ["serve-sick", "serve-gone"]
        actions = [s["action"] for s in report["steps"]]
        assert actions == ["skipped", "skipped", "swapped"]
        # the skipped replica kept its old version; the healthy one
        # landed the new one — availability preserved either way
        assert sick.model_version == "unversioned"
        assert good.model_version == digest
    assert observe.counter("rollout_coordinator_steps_total",
                           "").value(result="skipped") == 2
    assert observe.counter("rollout_coordinator_steps_total",
                           "").value(result="ok") == 1


def test_coordinator_halts_on_failed_swap(cfg, tmp_path):
    from paddle_tpu_torch.observe.fleet import FleetAggregator
    from paddle_tpu_torch.serving import rollout as ro
    from paddle_tpu_torch.testing.fault import corrupt_artifact

    art = _export(cfg, tmp_path / "a", seed=1)
    corrupt_artifact(art, mode="bitflip")
    with FleetAggregator(0) as agg, \
            _server(cfg, seed=0) as first, _server(cfg, seed=0) as rest:
        fport, rport = first.start_http(0), rest.start_http(0)
        _ingest(agg, "serve-0", status="ok", pid=101)
        _ingest(agg, "serve-1", status="ok", pid=102)
        coord = ro.RollingCoordinator(agg.addr, [
            ("serve-0", f"127.0.0.1:{fport}"),
            ("serve-1", f"127.0.0.1:{rport}"),
        ])
        report = coord.rollout(art)
        assert report["result"] == "halted"
        assert len(report["steps"]) == 1       # the walk stopped there
        assert report["steps"][0]["action"] == "halt"
        assert report["steps"][0]["swap"]["result"] == "rolled_back"
        # the not-yet-walked replica was never touched: old version
        # keeps serving everywhere — the zero-downtime property
        assert rest.model_version == "unversioned"
        assert rest.rollout_state == "serving"
        assert first.generate([2, 3], 3, timeout=120.0)
    assert observe.counter("rollout_coordinator_steps_total",
                           "").value(result="halted") == 1


# ---------------------------------------------------- fleet plumbing
def test_fleet_frames_topology_watch_carry_version():
    from paddle_tpu_torch.observe import fleet
    from paddle_tpu_torch.observe.fleet import FleetAggregator, FleetPusher

    with FleetAggregator(0) as agg, _flag("fleet_id", "serve-0"):
        fleet.set_serving_info(version="a" * 64, state="serving",
                               exported_at=123.0)
        try:
            p = FleetPusher(agg.addr, interval_s=600.0)
            frame = p.build_frame()
            assert frame["serving"]["model_version"] == "a" * 64
            assert frame["serving"]["rollout_state"] == "serving"
            assert p.push() is True
        finally:
            fleet.reset_identity()     # also clears the serving info
        assert fleet.serving_info() == {}
        topo = agg.state.topology()
        entry = topo["procs"]["serve-0"]
        assert entry["model_version"] == "a" * 64
        assert entry["rollout_state"] == "serving"
        assert entry["model_exported_at"] == 123.0
        assert "swap_error" not in entry       # only surfaced when set
        rows = agg.state.watch_rows()
        (row,) = [r for r in rows if r["proc"] == "serve-0"]
        assert row["version"] == "a" * 64
        rendered = fleet.render_watch(agg.state.rollup(), rows)
        assert "version" in rendered
        assert ("a" * 64)[:12] in rendered


def test_fleet_watch_marks_non_serving_rollout_state():
    from paddle_tpu_torch.observe import fleet
    from paddle_tpu_torch.observe.fleet import FleetAggregator

    with FleetAggregator(0) as agg:
        _ingest(agg, "serve-0", pid=101,
                serving={"model_version": "b" * 64,
                         "rollout_state": "rolled_back",
                         "swap_error": "verify: boom"})
        entry = agg.state.topology()["procs"]["serve-0"]
        assert entry["rollout_state"] == "rolled_back"
        assert entry["swap_error"] == "verify: boom"
        rendered = fleet.render_watch(agg.state.rollup(),
                                      agg.state.watch_rows())
        assert "rolled_back" in rendered


def test_server_publishes_serving_info_on_swap(cfg, tmp_path):
    """The server pushes version + rollout state into the fleet
    identity at start and after every swap/rollback."""
    from paddle_tpu_torch.observe import fleet
    from paddle_tpu_torch.serving import rollout as ro

    art = _export(cfg, tmp_path / "a", seed=1)
    digest = artifact_digest(read_manifest(art))
    try:
        with _server(cfg, seed=0) as srv:
            assert fleet.serving_info()["model_version"] == "unversioned"
            ro.swap_from_artifact(srv, art)
            info = fleet.serving_info()
            assert info["model_version"] == digest
            assert info["rollout_state"] == "serving"
            ro.swap_from_artifact(srv, str(tmp_path / "missing"))
            info = fleet.serving_info()
            assert info["rollout_state"] == "rolled_back"
            assert "verify:" in info["swap_error"]
    finally:
        fleet.reset_identity()


def test_coordinator_canary_promotes_then_walks(cfg, tmp_path):
    """Fleet-side canary: the first replica swaps alone, bakes against
    the pooled baseline signals riding the fleet frames, and only a
    clean bake lets the remaining replicas walk."""
    from paddle_tpu_torch.observe.fleet import FleetAggregator
    from paddle_tpu_torch.serving import rollout as ro

    art = _export(cfg, tmp_path / "a", seed=1)
    digest = artifact_digest(read_manifest(art))
    with FleetAggregator(0) as agg, \
            _server(cfg, seed=0) as canary, _server(cfg, seed=0) as base:
        cport, bport = canary.start_http(0), base.start_http(0)
        _ingest(agg, "serve-canary", pid=101, serving={
            "model_version": "unversioned", "rollout_state": "serving",
            "ttft_p99_s": 0.0012, "error_rate_s": 0.0})
        _ingest(agg, "serve-base", pid=102, serving={
            "model_version": "unversioned", "rollout_state": "serving",
            "ttft_p99_s": 0.0010, "error_rate_s": 0.0})
        coord = ro.RollingCoordinator(agg.addr, [
            ("serve-canary", f"127.0.0.1:{cport}"),
            ("serve-base", f"127.0.0.1:{bport}"),
        ], canary=True, bake_s=0.3, canary_factor=2.0, poll_s=0.05)
        report = coord.rollout(art)
        assert report["result"] == "ok"
        assert report["canary"]["result"] == "promoted"
        assert report["canary"]["replica"] == "serve-canary"
        assert [s["action"] for s in report["steps"]] == \
            ["swapped", "swapped"]
        assert canary.model_version == digest
        assert base.model_version == digest
    assert observe.counter("rollout_canary_total",
                           "").value(result="promoted") == 1


def test_coordinator_canary_rolls_back_and_halts(cfg, tmp_path):
    """Fleet-side breach: the canary's windowed p99 (off its frames)
    blows past the pooled baseline, the coordinator rolls it back to
    the predecessor artifact (bake verdict on the replica's /healthz)
    and HALTS — the baseline replicas never swap."""
    from paddle_tpu_torch.observe.fleet import FleetAggregator
    from paddle_tpu_torch.serving import rollout as ro

    exp = tmp_path / "export"
    os.makedirs(exp)
    prev_art, dig_prev = _export_as_rollback_target(cfg, exp, seed=1)
    new_art, _ = _export_as_rollback_target(cfg, exp, seed=2)

    with FleetAggregator(0) as agg, \
            _server(cfg, seed=0) as canary, _server(cfg, seed=0) as base:
        cport, bport = canary.start_http(0), base.start_http(0)
        # the canary advertises its pre-swap version (the rollback
        # target) and a 50 ms windowed p99; the pool holds 1 ms
        _ingest(agg, "serve-canary", pid=101, serving={
            "model_version": dig_prev, "rollout_state": "serving",
            "ttft_p99_s": 0.050, "error_rate_s": 0.0})
        _ingest(agg, "serve-base", pid=102, serving={
            "model_version": dig_prev, "rollout_state": "serving",
            "ttft_p99_s": 0.001, "error_rate_s": 0.0})
        coord = ro.RollingCoordinator(agg.addr, [
            ("serve-canary", f"127.0.0.1:{cport}"),
            ("serve-base", f"127.0.0.1:{bport}"),
        ], canary=True, bake_s=30.0, canary_factor=2.0, poll_s=0.05)
        report = coord.rollout(new_art)
        assert report["result"] == "halted"
        can = report["canary"]
        assert can["result"] == "rolled_back"
        assert can["rollback"] == "ok"
        assert "p99 TTFT" in can["reason"]
        assert len(report["steps"]) == 1        # baselines never walked
        # the canary is back on the predecessor, verdict on /healthz
        assert canary.model_version == dig_prev
        with urllib.request.urlopen(
                f"http://127.0.0.1:{cport}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["rollout_state"] == "rolled_back"
        assert health["last_swap_error"].startswith("canary bake:")
        # the not-yet-walked replica was never touched
        assert base.model_version == "unversioned"
        assert base.rollout_state == "serving"
    assert observe.counter("rollout_canary_total",
                           "").value(result="rolled_back") == 1
