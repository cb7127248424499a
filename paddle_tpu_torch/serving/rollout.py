"""Zero-downtime train→serve pipeline (counterpart of
``paddle_tpu/serving/rollout.py``).

Three cooperating pieces connect the trainer's checkpoint dir to a live
:class:`~paddle_tpu_torch.serving.server.InferenceServer` without a
restart:

1. :class:`CheckpointWatcher` — polls the checkpoint dir and picks up
   each **digest-verified retained** checkpoint exactly once, keyed by
   the checkpoint's manifest digest (``checkpoint_digest``), never a
   ``.corrupt-*`` quarantine or an in-progress ``.tmp-ckpt-*`` dir.
   Exactly-once survives watcher restarts with no side-channel state:
   every exported artifact records its ``source_ckpt_digest`` in its
   own manifest, and the watcher seeds its seen-set from the export dir
   (:func:`exported_source_digests`).
2. :func:`export_checkpoint` — exports a checkpoint to a (quantized)
   decoder artifact **under an export lease**
   (``trainer.checkpoint.export_lease``) so the retention sweep cannot
   reap the source mid-read, written to ``.tmp-export-*`` and renamed
   atomically to ``model-<digest12>``, so a SIGKILLed exporter never
   leaves a half-artifact that loads.
3. :func:`swap_from_artifact` — the full hot swap: verify the
   artifact's digests, build the :class:`~paddle_tpu_torch.serving.
   model.DecoderModel` on the server's device, run a first-inference
   probe — all on the CALLING thread, never the decode thread — then
   park a :class:`~paddle_tpu_torch.serving.server.SwapTicket` for the
   decode loop's pointer flip.  Any failure before the flip rolls back
   (the old model was never unhooked) with the reason on ``/healthz``
   and in ``rollout_swap_total{result}``.  On the card the build and the
   probe are CUDA work on the caller's thread beside the decode thread's.
   With ``--rollout_canary`` a bake window follows the flip and rolls
   back to the predecessor artifact on a latency or error breach.

``RollingCoordinator`` (the fleet-supervised walk over replicas) reads
``/fleet/healthz`` through ``observe.fleet`` and comes with queue A10b;
it refuses by name.  Threads are ``ptpu-rollout-*``; spans are
``rollout_export`` / ``rollout_swap``; metrics are the ``rollout_*``
family.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..analysis.lockorder import named_condition
from ..observe import REGISTRY as _registry
from ..observe import counter as _counter
from ..observe import histogram as _histogram, trace as _trace
from ..trainer import checkpoint as _ckpt
from ..utils import FLAGS, PaddleTpuError, enforce, get_logger
from .loader import TornArtifact, artifact_digest, read_manifest, \
    verify_artifact
from .model import DecoderConfig, DecoderModel, export_decoder
from .server import InferenceServer

log = get_logger("serving")

#: Checkpoint-watcher thread name (leak guard + ptpu-lint contract).
WATCHER_THREAD_NAME = "ptpu-rollout-watcher"

#: Exported artifacts are ``model-<digest12>`` dirs; anything else in
#: the export dir is a temp, a quarantine, or not ours.
ARTIFACT_PREFIX = "model-"


# ------------------------------------------------------------- export
def default_export_dir(save_dir: str) -> str:
    configured = str(FLAGS.get("rollout_export_dir") or "")
    return configured or os.path.join(save_dir, "export")


def export_checkpoint(ckpt_dir: str, export_dir: str, cfg: DecoderConfig,
                      quantize: Optional[str] = None,
                      dequant_dtype: str = "float32") -> str:
    """Export one checkpoint to a serving artifact; returns the final
    ``model-<digest12>`` dir.

    Runs under an export lease so ``sweep_retention`` cannot reap the
    source mid-read (the retention/export race), writes into a
    ``.tmp-export-*`` dir and atomically renames — a SIGKILL at any
    instant leaves either no artifact or a whole one, never a torn dir
    under the ``model-`` prefix.  An identical re-export (same content
    digest) is a no-op returning the existing dir."""
    if quantize is None:
        quantize = str(FLAGS.get("rollout_quantize"))
    q = None if quantize in ("none", "") else quantize
    os.makedirs(export_dir, exist_ok=True)
    src_digest = _ckpt.checkpoint_digest(ckpt_dir)
    t0 = time.perf_counter()
    with _trace.span("rollout_export", ckpt=os.path.basename(ckpt_dir),
                     src_digest=(src_digest or "?")[:12]):
        try:
            with _ckpt.export_lease(ckpt_dir):
                params = _ckpt.load_params(ckpt_dir)
                tmp = tempfile.mkdtemp(dir=export_dir,
                                       prefix=".tmp-export-")
                try:
                    export_decoder(
                        params, cfg, tmp, quantize=q,
                        dequant_dtype=dequant_dtype,
                        extra_meta={
                            "source_ckpt_digest": src_digest,
                            "source_ckpt": os.path.basename(ckpt_dir)})
                    digest = artifact_digest(read_manifest(tmp))
                    final = os.path.join(
                        export_dir, f"{ARTIFACT_PREFIX}{digest[:12]}")
                    if os.path.isdir(final):
                        # identical content already exported (e.g. a
                        # restarted exporter re-walking the ckpt dir)
                        shutil.rmtree(tmp)
                    else:
                        os.replace(tmp, final)
                except Exception:
                    shutil.rmtree(tmp, ignore_errors=True)
                    raise
        except Exception:
            _counter("rollout_exports_total",
                     "checkpoint-to-artifact exports by outcome"
                     ).inc(result="error")
            raise
    _counter("rollout_exports_total",
             "checkpoint-to-artifact exports by outcome").inc(result="ok")
    _histogram("rollout_export_seconds",
               "wall time of one checkpoint-to-artifact export "
               "(load + quantize + digest + rename)").observe(
        time.perf_counter() - t0)
    log.info("exported %s -> %s", ckpt_dir, final)
    return final


def _artifact_dirs(export_dir: str) -> List[str]:
    if not os.path.isdir(export_dir):
        return []
    return sorted(d for d in os.listdir(export_dir)
                  if d.startswith(ARTIFACT_PREFIX))


def _manifest_or_none(path: str) -> Optional[Dict[str, Any]]:
    try:
        return read_manifest(path)
    except (OSError, ValueError):
        return None


def latest_valid_artifact(export_dir: str) -> Optional[str]:
    """Newest digest-valid artifact in the export dir (by its
    ``exported_at_unix`` stamp, mtime fallback), scanning past torn
    ones — a restarted serving process resumes from here.  Never
    considers ``.tmp-export-*`` (in-progress/orphaned) dirs."""
    candidates: List[Tuple[float, str]] = []
    for name in _artifact_dirs(export_dir):
        path = os.path.join(export_dir, name)
        man = _manifest_or_none(path)
        if man is None:
            continue
        ts = man.get("exported_at_unix")
        if not isinstance(ts, (int, float)):
            try:
                ts = os.path.getmtime(path)
            except OSError:
                continue
        candidates.append((float(ts), path))
    for _, path in sorted(candidates, reverse=True):
        try:
            verify_artifact(path)
            return path
        except TornArtifact as e:
            log.warning("artifact %s failed verification (%s); "
                        "falling back", path, e)
    return None


def exported_source_digests(export_dir: str) -> set:
    """The ``source_ckpt_digest`` of every artifact already in the
    export dir — the watcher's exactly-once seen-set, reconstructed
    from the artifacts themselves so it survives restarts."""
    out = set()
    for name in _artifact_dirs(export_dir):
        man = _manifest_or_none(os.path.join(export_dir, name))
        if man and man.get("source_ckpt_digest"):
            out.add(man["source_ckpt_digest"])
    return out


def sweep_export_dir(export_dir: str, keep: Optional[int] = None
                     ) -> List[str]:
    """Retention for the export dir: keep the newest ``keep`` artifacts
    (default ``--ckpt_keep``), reap the rest plus orphaned
    ``.tmp-export-*`` dirs from SIGKILLed exporters (same stale-mtime
    rule as checkpoint temp dirs)."""
    keep = int(FLAGS.get("ckpt_keep")) if keep is None else keep
    if keep <= 0 or not os.path.isdir(export_dir):
        return []
    stamped = []
    for name in _artifact_dirs(export_dir):
        path = os.path.join(export_dir, name)
        man = _manifest_or_none(path) or {}
        ts = man.get("exported_at_unix")
        try:
            ts = float(ts) if isinstance(ts, (int, float)) \
                else os.path.getmtime(path)
        except OSError:
            continue
        stamped.append((ts, path))
    doomed = [p for _, p in sorted(stamped)[:-keep]]
    now = time.time()
    for name in (os.listdir(export_dir) if os.path.isdir(export_dir)
                 else []):
        if not name.startswith(".tmp-export-"):
            continue
        path = os.path.join(export_dir, name)
        try:
            if now - os.path.getmtime(path) > _ckpt._TMP_STALE_S:
                doomed.append(path)
        except OSError:
            pass
    removed = []
    for path in doomed:
        try:
            shutil.rmtree(path)
        except OSError as e:
            log.warning("export sweep could not remove %s (%s)", path, e)
            continue
        removed.append(path)
    if removed:
        log.info("export sweep (keep=%d): removed %s", keep,
                 [os.path.basename(p) for p in removed])
    return removed


# --------------------------------------------------------- canary bake
def _window_signals() -> Tuple[Optional[float], float]:
    """This process's windowed serving signals: (p99 TTFT seconds or
    None, failures/sec) over the last 60 s — the canary bake's
    before/after comparison inputs."""
    p99 = None
    h = _registry.find("serve_ttft_seconds")
    if h is not None and hasattr(h, "window_quantile"):
        p99 = h.window_quantile(0.99, 60.0)
    err = 0.0
    f = _registry.find("serve_request_failures")
    if f is not None and hasattr(f, "window_rate"):
        err = f.window_rate(60.0)
    return p99, err


def _canary_verdict(p99: Optional[float], err: float,
                    base_p99: Optional[float], base_err: float,
                    factor: float) -> Optional[str]:
    """None when the canary passes its bake, else the breach reason.

    p99 is compared only when BOTH sides measured one (no traffic on
    either side is no evidence).  A baseline error rate of zero makes
    ANY canary errors a breach — an error-free pool sets the bar."""
    if p99 is not None and base_p99 is not None and base_p99 > 0 \
            and p99 > factor * base_p99:
        return (f"canary p99 TTFT {p99 * 1e3:.1f}ms > {factor:g}x "
                f"baseline {base_p99 * 1e3:.1f}ms")
    err_bar = factor * base_err if base_err > 0 else 0.0
    if err > err_bar:
        if base_err > 0:
            return (f"canary error rate {err:.4f}/s > {factor:g}x "
                    f"baseline {base_err:.4f}/s")
        return (f"canary error rate {err:.4f}/s on an error-free "
                "baseline")
    return None


def _count_canary(result: str) -> None:
    _counter("rollout_canary_total",
             "canary bakes by outcome (promoted | rolled_back | "
             "missing)").inc(result=result)


def previous_artifact_dir(artifact: str, prev_version: str
                          ) -> Optional[str]:
    """The sibling ``model-<digest12>`` dir a canary rolls back to, or
    None when the predecessor artifact is gone (swept) or the server
    never served an artifact (``unversioned``)."""
    if not prev_version or "/" in prev_version:
        return None
    prev = os.path.join(os.path.dirname(artifact),
                        f"{ARTIFACT_PREFIX}{prev_version[:12]}")
    return prev if os.path.isdir(prev) else None


# ------------------------------------------------------------ hot swap
def _probe_model(model: DecoderModel) -> None:
    """First-inference probe: one tiny prefill on scratch pools, on the
    calling thread.  A model that cannot produce finite logits for a
    one-token prompt must never reach the decode loop — this is the last
    gate before the pointer flip is requested."""
    k_pool, v_pool = model.new_pools(2, 8)
    _, logits, _, _ = model.prefill(k_pool, v_pool, [[0]], [1], [[1]])
    if not bool(torch.isfinite(logits).all()):
        raise FloatingPointError("probe inference produced non-finite "
                                 "logits")


def swap_from_artifact(server: InferenceServer, dirname: str,
                       inflight: Optional[str] = None,
                       timeout_s: float = 120.0,
                       canary: Optional[bool] = None,
                       bake_s: Optional[float] = None,
                       canary_factor: Optional[float] = None
                       ) -> Dict[str, Any]:
    """The full hot-swap pipeline against a live server.

    Verify → load → probe run on the CALLING thread (never the decode
    thread; on the card their CUDA work shares the device with it); only
    then is a :class:`SwapTicket` parked for the decode
    loop's pointer flip.  Every failure path rolls back — the old model
    keeps serving, ``/healthz`` carries the reason, and
    ``rollout_swap_total{result}`` records which gate failed.  Returns
    the swap report (``result`` ∈ ``ok`` | ``unchanged`` |
    ``rolled_back``).

    With ``--rollout_canary`` and ``--rollout_bake_s > 0`` (or the
    matching keyword overrides) a successful flip is followed by the
    single-server **bake-then-commit window**: the windowed p99 TTFT /
    error rate captured just before the flip become the baseline, the
    new model serves for ``bake_s`` seconds, and a post-bake comparison
    beyond ``canary_factor`` rolls BACK to the predecessor artifact
    (reason on ``/healthz``, ``rollout_canary_total{result}``) — the
    same policy :class:`RollingCoordinator` applies fleet-wide.  The
    bake blocks the CALLING thread, never the decode loop."""
    canary = bool(FLAGS.get("rollout_canary")) if canary is None \
        else bool(canary)
    bake_s = float(FLAGS.get("rollout_bake_s")) if bake_s is None \
        else float(bake_s)
    factor = float(FLAGS.get("rollout_canary_factor")) \
        if canary_factor is None else float(canary_factor)
    t0 = time.perf_counter()
    report: Dict[str, Any] = {"artifact": dirname}
    prev_version = server.model_version
    baseline = _window_signals() if canary and bake_s > 0 else None

    def _fail(gate: str, e: Exception) -> Dict[str, Any]:
        reason = f"{gate}: {type(e).__name__}: {e}"
        server.record_swap_failure(reason)
        _counter("rollout_swap_total",
                 "hot-swap attempts by outcome").inc(
            result=f"{gate}_failed")
        log.error("swap from %s rolled back (%s)", dirname, reason)
        report.update(result="rolled_back", error=reason)
        return report

    with _trace.span("rollout_swap", artifact=os.path.basename(dirname)):
        try:
            manifest = read_manifest(dirname)
            verify_artifact(dirname, manifest)
        except Exception as e:  # noqa: BLE001 - every verify fault rolls back
            return _fail("verify", e)
        version = artifact_digest(manifest)
        report["version"] = version
        if version == server.model_version:
            report["result"] = "unchanged"
            return report
        try:
            # digests re-checked a moment ago; don't pay them twice.
            # The new model lives on the serving model's device
            model = DecoderModel.from_artifact(
                dirname, verify=False, device=server.model.device)
        except Exception as e:  # noqa: BLE001
            return _fail("load", e)
        try:
            _probe_model(model)
        except Exception as e:  # noqa: BLE001
            return _fail("probe", e)
        report["build_s"] = time.perf_counter() - t0
        ticket = server.request_swap(
            model, version=version, inflight=inflight,
            exported_at=manifest.get("exported_at_unix"))
        report.update(ticket.wait(timeout_s))
    report["swap_s"] = time.perf_counter() - t0
    _histogram("rollout_swap_seconds",
               "end-to-end hot-swap latency: artifact verify + "
               "model build + probe (off-thread) + pointer flip"
               ).observe(report["swap_s"])
    if canary and bake_s > 0 and report.get("result") == "ok":
        report.update(_bake_single(
            server, dirname, prev_version, baseline, bake_s, factor,
            inflight, timeout_s))
    return report


def _bake_single(server: InferenceServer, dirname: str,
                 prev_version: str,
                 baseline: Tuple[Optional[float], float],
                 bake_s: float, factor: float,
                 inflight: Optional[str],
                 timeout_s: float) -> Dict[str, Any]:
    """Single-server bake-then-commit: serve ``bake_s`` seconds on the
    fresh model, then compare the windowed signals against the
    pre-flip baseline.  Pass → promoted; breach → swap back to the
    predecessor artifact and record the reason on ``/healthz``."""
    base_p99, base_err = baseline
    time.sleep(bake_s)
    p99, err = _window_signals()
    reason = _canary_verdict(p99, err, base_p99, base_err, factor)
    out: Dict[str, Any] = {
        "canary": {"bake_s": bake_s,
                   "baseline_p99_s": base_p99, "p99_s": p99,
                   "baseline_error_rate_s": base_err,
                   "error_rate_s": err}}
    if reason is None:
        out["canary"]["result"] = "promoted"
        _count_canary("promoted")
        log.info("canary bake promoted %s (p99 %.1fms vs baseline "
                 "%.1fms)", os.path.basename(dirname),
                 (p99 or 0.0) * 1e3, (base_p99 or 0.0) * 1e3)
        return out
    out["canary"].update(result="rolled_back", reason=reason)
    out.update(result="rolled_back", error=reason)
    prev_dir = previous_artifact_dir(dirname, prev_version)
    if prev_dir is not None:
        rb = swap_from_artifact(server, prev_dir, inflight=inflight,
                                timeout_s=timeout_s, canary=False)
        out["canary"]["rollback"] = rb.get("result")
    else:
        out["canary"]["rollback"] = "no_predecessor"
        log.error("canary bake breached but predecessor artifact for "
                  "%r is gone; serving stays on the canary", prev_version)
    # AFTER the rollback swap (which clears the swap-error state): the
    # bake verdict is what /healthz must carry
    server.record_swap_failure(f"canary bake: {reason}")
    _count_canary("rolled_back")
    log.error("canary bake rolled back %s (%s)",
              os.path.basename(dirname), reason)
    return out


# ------------------------------------------------------------- watcher
class CheckpointWatcher:
    """Polls a checkpoint dir; exports each digest-verified retained
    checkpoint exactly once and (optionally) hot-swaps the newest
    export into a live server.

    Runs on the ``ptpu-rollout-watcher`` thread.  ``poll_once`` is the
    whole step and is callable synchronously from tests — the thread
    only adds the timer."""

    def __init__(self, save_dir: str, cfg: DecoderConfig,
                 export_dir: Optional[str] = None,
                 server: Optional[InferenceServer] = None,
                 poll_s: Optional[float] = None,
                 quantize: Optional[str] = None,
                 inflight: Optional[str] = None,
                 keep: Optional[int] = None):
        enforce(bool(FLAGS.get("rollout")),
                "rollout disabled (--rollout=false): no watcher")
        self.save_dir = save_dir
        self.cfg = cfg
        self.export_dir = export_dir or default_export_dir(save_dir)
        self.server = server
        self.poll_s = float(FLAGS.get("rollout_poll_s")
                            if poll_s is None else poll_s)
        self.quantize = quantize
        self.inflight = inflight
        self.keep = keep
        # exactly-once across restarts: the artifacts themselves are
        # the ledger
        self._seen = exported_source_digests(self.export_dir)
        self._cond = named_condition("rollout.watcher")
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ step
    def poll_once(self) -> List[str]:
        """One watcher step: export every not-yet-seen digest-valid
        checkpoint (oldest first, so versions roll forward in order),
        swap the newest export into the server, sweep export
        retention.  Returns the artifact dirs exported this step."""
        exported: List[str] = []
        if not os.path.isdir(self.save_dir):
            return exported
        for name in _ckpt._pass_dirs(self.save_dir):
            # _pass_dirs yields only pass-* names: .corrupt-* and
            # .tmp-ckpt-* can never be picked up by construction
            path = os.path.join(self.save_dir, name)
            digest = _ckpt.checkpoint_digest(path)
            if digest is None or digest in self._seen:
                continue
            # quarantine=False: the trainer owns its checkpoint dir;
            # the watcher only refuses to export what fails its digest
            if _ckpt._verify_result(path) != "ok":
                log.warning("watcher: %s fails verification, skipping",
                            path)
                continue
            try:
                artifact = export_checkpoint(
                    path, self.export_dir, self.cfg,
                    quantize=self.quantize)
            except FileNotFoundError:
                # the retention sweep won the race before our lease
                # landed; the checkpoint is gone, nothing to export
                log.warning("watcher: %s vanished mid-export", path)
                continue
            self._seen.add(digest)
            exported.append(artifact)
        if exported and self.server is not None:
            # several checkpoints may have landed in one poll window:
            # serving only ever wants the newest
            swap_from_artifact(self.server, exported[-1],
                               inflight=self.inflight)
        if exported:
            sweep_export_dir(self.export_dir, keep=self.keep)
        return exported

    # ------------------------------------------------------- lifecycle
    def _loop(self) -> None:
        while True:
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - one bad poll must not
                log.exception("watcher poll failed; retrying")  # die
            with self._cond:
                if self._stop:
                    return
                self._cond.wait(self.poll_s)
                if self._stop:
                    return

    def start(self) -> "CheckpointWatcher":
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name=WATCHER_THREAD_NAME, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)

    def __enter__(self) -> "CheckpointWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# --------------------------------------------------------- coordinator
class RollingCoordinator:
    """The fleet-supervised rolling rollout across serving replicas
    (``paddle_tpu/serving/rollout.py:609-860``) reads each replica's
    ``/fleet/healthz`` row through ``observe.fleet``, which comes with
    queue A10b; until then it refuses by name."""

    def __init__(self, *args, **kwargs):
        raise PaddleTpuError(
            "RollingCoordinator is not ported yet (queue A10b: it reads "
            "/fleet/healthz through observe.fleet); swap one server with "
            "swap_from_artifact or POST /v1/swap")
