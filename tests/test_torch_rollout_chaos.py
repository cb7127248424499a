"""The port's train→serve pipeline under SIGKILL: the cases of
``tests/test_rollout_chaos.py``, its journey through the fleet
aggregator and its canary coordinator included.

Child processes (``paddle_tpu_torch/testing/fault.py``) run the port's
pipeline stages — the ``save_checkpoint`` loop, the ``CheckpointWatcher``
export loop, an ``InferenceServer`` with an in-child hot-swap thread, on
the CPU — and SIGKILL lands at every stage under live load:

- **trainer killed mid-save / exporter killed mid-export** — no torn
  artifact is ever published under the ``model-`` prefix; restarted
  stages resume and exactly-once export holds with no side-channel
  state;
- **server killed around a swap** — the restart boots from the newest
  digest-valid artifact;
- **torn / re-signed artifacts injected under live load** — the serving
  child never swaps to them and every response is stamped with a
  verified version.
"""

import json
import os
import time

import pytest

from paddle_tpu_torch.observe import fleet, trace
from paddle_tpu_torch.observe.fleet import FleetAggregator
from paddle_tpu_torch.serving import rollout as ro
from paddle_tpu_torch.serving.loader import (artifact_digest, read_manifest,
                                             verify_artifact)
from paddle_tpu_torch.testing import fault
from paddle_tpu_torch.trainer import checkpoint as ck

pytestmark = [pytest.mark.chaos, pytest.mark.slow]


@pytest.fixture(scope="module")
def cfg():
    from paddle_tpu_torch.serving.model import DecoderConfig

    # must match the config baked into the fault.py child scripts —
    # the serving child refuses a hot-swap across configs
    return DecoderConfig(vocab=64, dim=32, heads=2, layers=1, ffn=64,
                         max_context=64, eos_id=1)


def _params(cfg, seed):
    from paddle_tpu_torch.serving.model import init_decoder_params

    return init_decoder_params(cfg, seed=seed)


def _publish(cfg, tmp_path, export_dir, seed, tag, corrupt=None):
    """Export seed→artifact through a STAGING dir, optionally corrupt
    it there, then land it in ``export_dir`` in one rename — the
    serving child never observes a half-written (or not-yet-corrupted)
    artifact, so the injection itself is race-free."""
    d = ck.save_checkpoint(str(tmp_path / f"stage-ckpt-{tag}"), 0,
                           _params(cfg, seed))
    stage = str(tmp_path / f"stage-export-{tag}")
    art = ro.export_checkpoint(d, stage, cfg)
    digest = artifact_digest(read_manifest(art))
    if corrupt == "truncate" or corrupt == "bitflip":
        fault.corrupt_artifact(art, mode=corrupt)
    elif corrupt == "resign":
        fault.resign_artifact_manifest(art)
    os.makedirs(export_dir, exist_ok=True)
    os.rename(art, os.path.join(export_dir, os.path.basename(art)))
    return digest


def _wait_for(pred, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


# ------------------------------------------- SIGKILL: trainer, exporter
def test_sigkill_trainer_and_exporter_no_torn_artifact(cfg, tmp_path):
    """Kill the producer stages mid-flight and restart them: whatever
    half-written state the kills leave behind (``.tmp-ckpt-*``,
    ``.tmp-export-*``), every artifact PUBLISHED under ``model-``
    digest-verifies, and the restarted exporter re-derives its
    exactly-once set from the artifacts themselves."""
    save_dir = str(tmp_path / "ckpts")
    export_dir = str(tmp_path / "export")

    tr = fault.TrainerLoopProcess(save_dir, interval_s=0.05, keep=3)
    ex = fault.ExporterProcess(save_dir, export_dir, poll_s=0.1)
    try:
        tr.start()
        tr.wait_saved(3)
        ex.start()
        first = ex.wait_exported(2)
        # SIGKILL both — the trainer mid-loop (often mid-save), the
        # exporter right after an export line (often mid-poll/export)
        tr.kill()
        ex.kill()

        # torn-model immunity: every PUBLISHED artifact verifies; the
        # kills may leave tmp dirs behind but never a bad model-*
        published = [d for d in os.listdir(export_dir)
                     if d.startswith(ro.ARTIFACT_PREFIX)]
        assert published, "exporter published nothing before the kill"
        for d in published:
            assert verify_artifact(os.path.join(export_dir, d)) is True

        # restart both stages: seed_base shifts the trainer onto
        # checkpoint digests it never saved, so the pipeline must
        # produce NEW artifacts — proof the kills didn't wedge it
        tr = fault.TrainerLoopProcess(save_dir, interval_s=0.05,
                                      keep=3, seed_base=100)
        ex = fault.ExporterProcess(save_dir, export_dir, poll_s=0.1)
        tr.start()
        tr.wait_saved(2)
        ex.start()
        resumed = ex.wait_exported(1)
        assert resumed and set(resumed).isdisjoint(first)
        tr.kill()
        ex.kill()

        # exactly-once, reconstructed from the artifacts alone: no two
        # published artifacts share a source checkpoint digest
        srcs = [read_manifest(os.path.join(export_dir, d))
                .get("source_ckpt_digest")
                for d in os.listdir(export_dir)
                if d.startswith(ro.ARTIFACT_PREFIX)]
        assert len(srcs) == len(set(srcs))
        for d in os.listdir(export_dir):
            if d.startswith(ro.ARTIFACT_PREFIX):
                assert verify_artifact(os.path.join(export_dir, d))
    finally:
        tr.kill()
        ex.kill()


# --------------------------------- SIGKILL: server, mid-swap, restart
def test_sigkill_server_restart_resumes_from_newest_artifact(
        cfg, tmp_path):
    """A serving replica under live load hot-swaps a new artifact,
    gets SIGKILLed with another swap in flight, and the restarted
    replica boots from the newest digest-valid artifact — responses
    before and after carry exactly one verified version each."""
    export_dir = str(tmp_path / "export")
    v0 = _publish(cfg, tmp_path, export_dir, seed=0, tag="v0")

    sv = fault.RolloutServeProcess(export_dir, poll_s=0.1, device="cpu")
    try:
        sv.start()
        assert sv.boot_version == v0
        sv.wait_served(3)

        # a new artifact lands while requests stream: the in-child
        # watcher must hot-swap it without failing a single request
        time.sleep(0.05)     # distinct exported_at stamp
        v1 = _publish(cfg, tmp_path, export_dir, seed=1, tag="v1")
        swaps = sv.wait_swapped(1)
        assert swaps == [v1]
        sv.wait_served(sv.served + 3)

        # responses never mix versions: each is stamped with exactly
        # one version, from the verified set, and the stream switches
        # old→new exactly once (no flapping back to the old model)
        versions = [v for _, v in sv.served_versions]
        assert set(versions) <= {v0, v1}
        if v1 in versions:
            assert v0 not in versions[versions.index(v1):]

        # land yet another artifact and SIGKILL immediately — with
        # poll_s=0.1 the kill often lands mid-swap; either way no
        # cleanup code runs
        time.sleep(0.05)
        v2 = _publish(cfg, tmp_path, export_dir, seed=2, tag="v2")
        sv.kill()

        # restart: the replica must resume from the NEWEST digest-valid
        # artifact, not the one it was serving when it died
        sv.start()
        assert sv.boot_version == v2
        sv.wait_served(2)
        assert {v for _, v in sv.served_versions} == {v2}
    finally:
        sv.kill()


# ------------------------------- torn artifacts under live request load
def test_torn_artifacts_never_served_under_load(cfg, tmp_path):
    """Corrupted artifacts — truncated weights, bit-flipped weights,
    re-signed manifest — land in the export dir while the replica
    serves live traffic: it must keep serving the old model, never
    swap to a torn one, and still pick up the next GOOD artifact."""
    export_dir = str(tmp_path / "export")
    v0 = _publish(cfg, tmp_path, export_dir, seed=0, tag="v0")

    sv = fault.RolloutServeProcess(export_dir, poll_s=0.1, device="cpu")
    try:
        sv.start()
        assert sv.boot_version == v0
        sv.wait_served(2)

        torn = []
        for i, mode in enumerate(("truncate", "bitflip", "resign")):
            time.sleep(0.05)    # each newer than the last — the
            # watcher tries newest-first, so every torn one is probed
            torn.append(_publish(cfg, tmp_path, export_dir,
                                 seed=10 + i, tag=f"bad-{mode}",
                                 corrupt=mode))
        # traffic keeps flowing on the old model; no swap happens
        sv.wait_served(sv.served + 5)
        assert sv.swaps == []
        assert {v for _, v in sv.served_versions} == {v0}

        # a good artifact after the torn ones: picked up immediately
        time.sleep(0.05)
        good = _publish(cfg, tmp_path, export_dir, seed=20, tag="good")
        assert sv.wait_swapped(1) == [good]
        sv.wait_served(sv.served + 2)
        versions = {v for _, v in sv.served_versions}
        assert versions <= {v0, good}
        assert versions.isdisjoint(torn)
    finally:
        sv.kill()


# ------------------------------------------------- the journey pin
def test_journey_merged_trace_and_fleet_rollout_metrics(cfg, tmp_path):
    """THE acceptance pin: trainer, exporter and serving replica as
    three real processes pushing to one aggregator; a checkpoint
    travels train→export→swap→first-request and the merged
    ``/fleet/trace`` shows the whole journey — ``ckpt_save`` (trainer
    pid), ``rollout_export`` (exporter pid), ``rollout_swap`` and
    ``serve_request`` (server pid) — under ONE trace id across ≥ 3
    pids; ``/fleet/metrics`` carries the ``rollout_*`` family and
    ``/fleet/topology`` the swapped ``model_version``."""
    save_dir = str(tmp_path / "ckpts")
    export_dir = str(tmp_path / "export")

    trace.ensure_ring()
    with FleetAggregator(0) as agg:
        with trace.span("rollout_journey") as root:
            ctx = trace.parent_header()
            assert ctx
        tid = root.context.trace_id

        sv = fault.RolloutServeProcess(
            export_dir, poll_s=0.2, device="cpu", fleet_addr=agg.addr,
            fleet_id="serve-0", parent_ctx=ctx)
        tr = fault.TrainerLoopProcess(
            save_dir, interval_s=0.2, keep=3, fleet_addr=agg.addr,
            fleet_id="trainer-0", parent_ctx=ctx)
        ex = fault.ExporterProcess(
            save_dir, export_dir, poll_s=0.2, fleet_addr=agg.addr,
            fleet_id="exporter-0", parent_ctx=ctx)
        try:
            sv.start()          # boots on seed weights: empty dir
            assert sv.boot_version == "seed"
            tr.start()
            tr.wait_saved(1)
            ex.start()
            ex.wait_exported(1)
            sv.wait_swapped(1)
            sv.wait_served(sv.served + 2)   # first requests post-swap

            def journey_legs():
                evs = [e for e in agg.state.merged_trace_events()
                       if e["ph"] == "X"
                       and e["args"].get("trace_id") == tid]
                return {(e["name"], e["pid"]) for e in evs}

            want = {("ckpt_save", tr.pid),
                    ("rollout_export", ex.pid),
                    ("rollout_swap", sv.pid),
                    ("serve_request", sv.pid)}
            _wait_for(lambda: want <= journey_legs(), timeout_s=30.0,
                      what="all four journey legs in the merged trace")
            pids = {p for _, p in journey_legs()}
            assert len(pids) >= 3          # train → export → serve

            # the timeline is strict Chrome-trace JSON over HTTP
            raw = fleet._http_get(agg.addr, "/fleet/trace")
            evs = json.loads(raw)
            names = {(e["name"], e["pid"]) for e in evs
                     if e["ph"] == "X"
                     and e["args"].get("trace_id") == tid}
            assert want <= names

            # the rollout_* metric family rides the frames into the
            # merged fleet scrape
            def scraped():
                raw = fleet._http_get(agg.addr, "/fleet/metrics")
                return raw.decode() if isinstance(raw, bytes) else raw

            _wait_for(lambda: "rollout_swap_total" in scraped(),
                      what="rollout metrics on /fleet/metrics")
            text = scraped()
            assert 'result="ok"' in text
            assert "rollout_swap_seconds" in text
            assert "rollout_model_version" in text
            assert "rollout_exports_total" in text

            # topology carries the serving replica's swapped version —
            # the pipeline keeps rolling, so by scrape time the replica
            # may already be PAST swapped[0]; what is pinned is that a
            # real digest (not the boot placeholder) is published
            def topo_version():
                procs = agg.state.topology()["procs"]
                return procs.get("serve-0", {}).get("model_version", "")

            _wait_for(lambda: len(topo_version()) == 64,
                      what="swapped model_version in /fleet/topology")
            _wait_for(lambda: agg.state.rollup()["status"] == "ok",
                      what="whole pipeline fleet-healthy")
            assert set(agg.state.rollup()["procs"]) >= {
                "trainer-0", "exporter-0", "serve-0"}
        finally:
            tr.kill()
            ex.kill()
            sv.kill()


# ------------------------------- SIGKILL: the canary, mid-bake
def test_sigkill_canary_mid_bake_halts_and_baselines_never_swap(
        cfg, tmp_path):
    """The canary replica takes SIGKILL in the middle of its bake: its
    fleet frames stop, staleness flips it to ``missing``, and the
    coordinator HALTS with ``rollout_canary_total{result="missing"}``
    — no rollback target is POSTed at a corpse, and the baseline
    replicas never receive a swap (they keep serving the old version
    throughout)."""
    import threading
    import urllib.request

    from paddle_tpu_torch import observe

    baseline_dir = str(tmp_path / "baseline_export")
    v0 = _publish(cfg, tmp_path, baseline_dir, seed=0, tag="v0")
    # the candidate lives in a dir the children's own watchers never
    # scan — only the coordinator lands it, so the kill is the only
    # reason it fails to spread
    candidate_dir = str(tmp_path / "candidate_export")
    v1 = _publish(cfg, tmp_path, candidate_dir, seed=1, tag="v1")
    new_art = os.path.join(candidate_dir,
                           f"{ro.ARTIFACT_PREFIX}{v1[:12]}")

    def _healthz(port):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            return json.loads(r.read())

    with FleetAggregator(0) as agg:
        can = fault.RolloutServeProcess(
            baseline_dir, poll_s=3600, serve_load=False, device="cpu",
            fleet_addr=agg.addr, fleet_id="serve-canary")
        base = fault.RolloutServeProcess(
            baseline_dir, poll_s=3600, serve_load=False, device="cpu",
            fleet_addr=agg.addr, fleet_id="serve-base")
        try:
            can.start()
            base.start()
            assert can.boot_version == v0 and base.boot_version == v0
            _wait_for(lambda: all(
                agg.state.rollup()["procs"].get(n, {}).get("status")
                == "ok" for n in ("serve-canary", "serve-base")),
                what="both replicas ok in the fleet rollup")

            coord = ro.RollingCoordinator(agg.addr, [
                ("serve-canary", can.addr),
                ("serve-base", base.addr),
            ], canary=True, bake_s=60.0, canary_factor=100.0,
                poll_s=0.1)
            result = {}

            def _run():
                result["report"] = coord.rollout(new_art)

            t = threading.Thread(target=_run, name="test-coordinator")
            t.start()
            # the bake is underway once the canary serves v1; SIGKILL
            # lands there — frames stop, staleness flips it missing
            _wait_for(lambda: _healthz(can.port)["model_version"] == v1,
                      what="canary swapped to the candidate")
            can.kill()
            t.join(timeout=120.0)
            assert not t.is_alive(), "coordinator never returned"

            report = result["report"]
            assert report["result"] == "halted"
            assert report["canary"]["result"] == "missing"
            assert "rollback" not in report["canary"]
            assert len(report["steps"]) == 1   # baselines never walked
            # the baseline replica kept the old version the whole time
            hz = _healthz(base.port)
            assert hz["model_version"] == v0
            assert hz["rollout_state"] == "serving"
            assert observe.counter("rollout_canary_total",
                                   "").value(result="missing") == 1
        finally:
            can.kill()
            base.kill()
