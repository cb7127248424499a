"""The port's train→serve pipeline under SIGKILL (the cases of
``tests/test_rollout_chaos.py`` that need no fleet; its journey and
canary-coordinator cases read the fleet aggregator, queue A10b).

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

import os
import time

import pytest

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
