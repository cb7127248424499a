"""Composable fault injectors for chaos tests (counterpart of
``paddle_tpu/testing/fault.py``).

Injectors are deterministic — they fire on call counts or explicit
triggers, never on wall-clock or RNG draws — so chaos tests stay
reproducible:

- :func:`poison_load_fn` — raise inside ``load_fn`` on chosen shards a
  bounded number of times (:class:`ShardFault`).
- :func:`corrupt_checkpoint` — truncate or bit-flip a checkpoint file.
- :func:`failing_saves` — make ``trainer.save`` raise a disk-full
  ``OSError`` for the next N calls.
- :func:`corrupt_artifact` / :func:`resign_artifact_manifest` — damage a
  serving artifact after its digests were recorded (torn weights, or a
  manifest re-signed with a wrong digest), so the rollout pipeline's
  verify gate is the thing under test.
- :class:`ServeServerProcess` — a continuous-batching inference server
  child (the port's :class:`~paddle_tpu_torch.serving.server.
  InferenceServer`, page-pool snapshots on) serving an endless request
  stream, built to be SIGKILLed mid-decode.
- :class:`TrainerLoopProcess` / :class:`ExporterProcess` /
  :class:`RolloutServeProcess` — the three stages of the train→serve
  pipeline as SIGKILL-able children: a trainer saving checkpoints in a
  loop, an exporter running the port's
  :class:`~paddle_tpu_torch.serving.rollout.CheckpointWatcher`, and a
  serving replica that hot-swaps every new artifact while serving.

- :func:`drop_master_connection` — sever a ``MasterClient``'s TCP socket
  before (request lost) or after (response lost → granted-but-unheard
  lease) every Nth call.
- :class:`MasterServerProcess` — the TCP master in a child process that
  can be SIGKILLed and restarted from its snapshot on the same port.

The children run the port's modules on ``device`` (``None``: the card;
the CPU tests pass ``"cpu"``).  Not ported yet, and refused by name:
:class:`FleetPusherProcess` and any ``fleet_addr=`` (the fleet
observatory, queue A10b).

Everything is loopback/local-fs only; no network is touched.
"""

from __future__ import annotations

import contextlib
import errno
import os
import socket
import subprocess
import sys
import time
from typing import Callable, Iterable, Optional

from ..utils import PaddleTpuError, get_logger

log = get_logger("fault")


def _refuse(what: str, queue: str, why: str):
    raise PaddleTpuError(f"{what} is not ported yet (queue {queue}: "
                         f"{why})")


def _no_fleet(fleet_addr: str) -> None:
    if fleet_addr:
        _refuse("fleet_addr=", "A10b", "the fleet push client, "
                "observe/fleet.py")


# --------------------------------------------------------- TCP faults
def _kill_socket(sock: Optional[socket.socket]) -> None:
    """Hard-sever a socket: subsequent send/recv on it raise OSError."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


@contextlib.contextmanager
def drop_master_connection(client, every: int = 3, limit: Optional[int] = None,
                           when: str = "request"):
    """Sever ``client``'s TCP connection around every ``every``-th call.

    ``when="request"`` kills the socket *before* the request is sent (the
    request is lost; replay is trivially safe).  ``when="response"``
    first pushes the request bytes to the master, then kills the socket
    (the master processes it but the response is lost — for GET this
    manufactures a granted-but-unheard lease that must time out and
    re-queue server-side).  ``limit`` bounds the number of injected
    drops.  Yields a stats dict: ``{"calls": n, "dropped": n}``.
    """
    orig = client._call
    stats = {"calls": 0, "dropped": 0}

    def faulty_call(line: str, **kw) -> str:
        stats["calls"] += 1
        if stats["calls"] % every == 0 and \
                (limit is None or stats["dropped"] < limit):
            stats["dropped"] += 1
            if when == "response" and client._sock is not None:
                try:
                    client._sock.sendall(line.encode() + b"\n")
                except OSError:
                    pass
            _kill_socket(client._sock)
            log.info("injected connection drop #%d (%s) before %r",
                     stats["dropped"], when, line.split("\t", 1)[0])
        return orig(line, **kw)

    client._call = faulty_call
    try:
        yield stats
    finally:
        client._call = orig


# --------------------------------------------------- master processes
# The child runs the C++ service via ctypes directly — no package
# import, so spawn is fast and a SIGKILL cannot corrupt anything but the
# master's own snapshot (which is what we are testing).
_SERVER_SCRIPT = r"""
import ctypes, sys, time
so, snap, port, timeout_s, failure_max = sys.argv[1:6]
lib = ctypes.CDLL(so)
lib.ptpu_master_create.restype = ctypes.c_void_p
lib.ptpu_master_create.argtypes = [
    ctypes.c_double, ctypes.c_int, ctypes.c_char_p]
lib.ptpu_master_serve.restype = ctypes.c_int
lib.ptpu_master_serve.argtypes = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
h = lib.ptpu_master_create(float(timeout_s), int(failure_max),
                           snap.encode() if snap else None)
p = lib.ptpu_master_serve(h, int(port), 0)
print(p, flush=True)
while True:
    time.sleep(3600)
"""


class MasterServerProcess:
    """A TCP master service in a SIGKILL-able child process.

    ``start()`` binds (remembering the port so a restart reuses it, which
    keeps the client's address stable across kills), ``kill()`` sends
    SIGKILL — no shutdown hooks run, exactly like a preempted VM — and a
    later ``start()`` recovers from the snapshot path.
    """

    def __init__(self, snapshot_path: str, timeout_s: float = 5.0,
                 failure_max: int = 3, port: int = 0):
        from ..distributed.master import _SO, _load_lib
        _load_lib()  # ensure the .so is built before the child needs it
        self._so = _SO
        self.snapshot_path = snapshot_path
        self.timeout_s = timeout_s
        self.failure_max = failure_max
        self.port = port
        self.proc: Optional[subprocess.Popen] = None

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self, wait_ready_s: float = 10.0) -> "MasterServerProcess":
        assert self.proc is None or self.proc.poll() is not None, \
            "master process already running"
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _SERVER_SCRIPT, self._so,
             self.snapshot_path, str(self.port), str(self.timeout_s),
             str(self.failure_max)],
            stdout=subprocess.PIPE, text=True)
        port = int(self.proc.stdout.readline())
        assert port > 0, "master serve failed in child"
        self.port = port
        self._wait_ready(wait_ready_s)
        return self

    def _wait_ready(self, budget_s: float) -> None:
        deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline:
            try:
                with socket.create_connection(("127.0.0.1", self.port),
                                              timeout=1.0) as s:
                    s.sendall(b"PING\n")
                    if s.recv(64).startswith(b"PONG"):
                        return
            except OSError:
                time.sleep(0.02)
        raise TimeoutError("master child never answered PING")

    def kill(self) -> None:
        """SIGKILL — the preemption model: no cleanup code runs."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.proc = None

    def __enter__(self) -> "MasterServerProcess":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.kill()


# --------------------------------------------------- refused by name
class FleetPusherProcess:
    """A fleet-pushing child process — queue A10b."""

    def __init__(self, *args, **kwargs):
        _refuse("FleetPusherProcess", "A10b", "the fleet push client, "
                "observe/fleet.py")


# --------------------------------------------- serving server process
# The child runs the port's InferenceServer over a page pool with atomic
# snapshots, serving an endless request stream — so a SIGKILL lands
# between (or inside) pool mutations with high probability.  The decoder
# is tiny: the chaos under test is allocator persistence, not the math.
_SERVE_SCRIPT = r"""
import os, sys
snap, max_batch, n_pages, page_size, device = sys.argv[1:6]
from paddle_tpu_torch.serving.model import (DecoderConfig, DecoderModel,
                                            init_decoder_params)
from paddle_tpu_torch.serving.server import InferenceServer

cfg = DecoderConfig(vocab=64, dim=32, heads=2, layers=1, ffn=64,
                    max_context=64, eos_id=1)
model = DecoderModel(init_decoder_params(cfg, seed=0), cfg,
                     device=device or None)
srv = InferenceServer(model, max_batch=int(max_batch),
                      n_pages=int(n_pages), page_size=int(page_size),
                      continuous=True, snapshot_path=snap).start()
print("READY", os.getpid(), flush=True)
i = 0
while True:      # endless churn: every finish releases pages and
    r = srv.submit([2 + (i % 60)] * (2 + i % 10),   # rewrites the
                   max_new_tokens=6)                # snapshot
    srv.result(r, timeout=60.0)
    print("SERVED", i, flush=True)
    i += 1
"""


def _child_env() -> dict:
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


class _LineChild:
    """Popen wrapper with a deadline-checked line reader: the child
    prints a READY line on startup, then one progress line per unit of
    work, which subclasses dispatch in :meth:`_dispatch`."""

    proc: Optional[subprocess.Popen] = None

    def _spawn(self, script: str, args: Iterable[str]) -> None:
        assert self.proc is None or self.proc.poll() is not None, \
            "child process already running"
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script, *[str(a) for a in args]],
            stdout=subprocess.PIPE, text=True, env=_child_env())
        line = self.proc.stdout.readline()   # blocks until READY
        assert line.startswith("READY"), \
            f"{type(self).__name__} child failed to start: {line!r}"
        self._on_ready(line.split())

    def _on_ready(self, fields: list) -> None:
        pass

    def _dispatch(self, fields: list) -> None:
        pass

    def _pump_until(self, done: Callable[[], bool],
                    timeout_s: float, what: str) -> None:
        assert self.proc is not None
        deadline = time.monotonic() + timeout_s
        while not done():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{type(self).__name__}: {what} not reached "
                    f"in {timeout_s}s")
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"{type(self).__name__} child died before {what}")
            self._dispatch(line.split())

    @property
    def pid(self) -> int:
        assert self.proc is not None
        return self.proc.pid

    def kill(self) -> None:
        """SIGKILL — preemption: no cleanup code runs; whatever write
        was mid-flight stays mid-written."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.proc = None

    def __enter__(self):
        return self.start()          # type: ignore[attr-defined]

    def __exit__(self, *exc) -> None:
        self.kill()


class ServeServerProcess(_LineChild):
    """A continuous-batching inference server in a SIGKILL-able child.

    ``start()`` blocks on the child's READY line (server thread up, pool
    snapshotting to ``snapshot_path``); :meth:`wait_served` blocks until
    N requests completed, so the snapshot went through real churn before
    the fault lands; ``kill()`` SIGKILLs.  The restarted server is built
    by the test in-process from the same snapshot path with the same
    geometry (``max_batch``, ``n_pages``, ``page_size``) and must verify
    clean."""

    def __init__(self, snapshot_path: str, max_batch: int = 4,
                 n_pages: int = 32, page_size: int = 8,
                 device: Optional[str] = None):
        self.snapshot_path = snapshot_path
        self.max_batch = max_batch
        self.n_pages = n_pages
        self.page_size = page_size
        self.device = device
        self.served = 0

    def start(self) -> "ServeServerProcess":
        self.served = 0
        self._spawn(_SERVE_SCRIPT, [self.snapshot_path, self.max_batch,
                                    self.n_pages, self.page_size,
                                    self.device or ""])
        return self

    def _dispatch(self, fields: list) -> None:
        if fields and fields[0] == "SERVED":
            self.served = int(fields[1]) + 1

    def wait_served(self, n: int = 5, timeout_s: float = 120.0) -> int:
        """Block until the child reports ``n`` completed requests;
        returns the last completed request index."""
        self._pump_until(lambda: self.served >= n, timeout_s,
                         f"{n} served requests")
        return self.served - 1


# -------------------------------------------- rollout chaos processes
# The three stages of the train→serve pipeline as child processes (the
# port's save_checkpoint, CheckpointWatcher and InferenceServer hot
# swap), each killable at any instant.
_TRAINER_SCRIPT = r"""
import os, sys, time
save_dir, n_passes, interval_s, keep, seed_base = sys.argv[1:6]
from paddle_tpu_torch.serving.model import DecoderConfig, init_decoder_params
from paddle_tpu_torch.trainer.checkpoint import save_checkpoint
cfg = DecoderConfig(vocab=64, dim=32, heads=2, layers=1, ffn=64,
                    max_context=64, eos_id=1)
print("READY", os.getpid(), flush=True)
i = 0
while int(n_passes) < 0 or i < int(n_passes):
    # a fresh seed per pass: every checkpoint has a distinct digest, so
    # the watcher's exactly-once set is exercised (seed_base shifts a
    # RESTARTED trainer onto digests it never saved before)
    params = init_decoder_params(cfg, seed=int(seed_base) + i)
    save_checkpoint(save_dir, i, params, keep=int(keep))
    print("SAVED", i, flush=True)
    i += 1
    time.sleep(float(interval_s))
while True:
    time.sleep(3600)
"""


class TrainerLoopProcess(_LineChild):
    """A trainer child saving (tiny-decoder) checkpoints in a loop — one
    ``SAVED n`` line per pass, each pass a distinct digest.  ``kill()``
    lands SIGKILL mid-loop (often mid-save: a ``.tmp-ckpt-*`` dir in
    flight), which the checkpoint format must shrug off."""

    def __init__(self, save_dir: str, n_passes: int = -1,
                 interval_s: float = 0.05, keep: int = 3,
                 seed_base: int = 0, fleet_addr: str = ""):
        _no_fleet(fleet_addr)
        self.save_dir = save_dir
        self.n_passes = n_passes
        self.interval_s = interval_s
        self.keep = keep
        self.seed_base = seed_base
        self.saved = 0          # SAVED lines seen so far

    def start(self) -> "TrainerLoopProcess":
        self.saved = 0
        self._spawn(_TRAINER_SCRIPT,
                    [self.save_dir, self.n_passes, self.interval_s,
                     self.keep, self.seed_base])
        return self

    def _dispatch(self, fields: list) -> None:
        if fields and fields[0] == "SAVED":
            self.saved = int(fields[1]) + 1

    def wait_saved(self, n: int, timeout_s: float = 120.0) -> int:
        """Block until the child has completed ``n`` checkpoint saves;
        returns the number completed."""
        self._pump_until(lambda: self.saved >= n, timeout_s,
                         f"{n} checkpoint saves")
        return self.saved


_EXPORTER_SCRIPT = r"""
import os, sys, time
save_dir, export_dir, poll_s, quantize = sys.argv[1:5]
from paddle_tpu_torch.serving.model import DecoderConfig
from paddle_tpu_torch.serving.rollout import CheckpointWatcher
cfg = DecoderConfig(vocab=64, dim=32, heads=2, layers=1, ffn=64,
                    max_context=64, eos_id=1)
w = CheckpointWatcher(save_dir, cfg, export_dir=export_dir,
                      poll_s=float(poll_s), quantize=quantize or None)
print("READY", os.getpid(), flush=True)
while True:
    for a in w.poll_once():
        print("EXPORTED", a, flush=True)
    time.sleep(float(poll_s))
"""


class ExporterProcess(_LineChild):
    """An exporter child running the port's
    :class:`~paddle_tpu_torch.serving.rollout.CheckpointWatcher` poll
    loop (export only, no server) — one ``EXPORTED <dir>`` line per
    artifact.  ``kill()`` lands SIGKILL mid-export (a ``.tmp-export-*``
    dir in flight); a restarted exporter must re-derive its exactly-once
    set from the artifacts and never re-export or half-publish."""

    def __init__(self, save_dir: str, export_dir: str,
                 poll_s: float = 0.1, quantize: str = "int8",
                 fleet_addr: str = ""):
        _no_fleet(fleet_addr)
        self.save_dir = save_dir
        self.export_dir = export_dir
        self.poll_s = poll_s
        self.quantize = quantize
        self.exported: list = []     # artifact dirs, in export order

    def start(self) -> "ExporterProcess":
        self.exported = []
        self._spawn(_EXPORTER_SCRIPT,
                    [self.save_dir, self.export_dir, self.poll_s,
                     self.quantize])
        return self

    def _dispatch(self, fields: list) -> None:
        if fields and fields[0] == "EXPORTED":
            self.exported.append(fields[1])

    def wait_exported(self, n: int, timeout_s: float = 120.0) -> list:
        """Block until ``n`` artifacts have been exported (counted from
        this start()); returns the artifact dirs so far."""
        self._pump_until(lambda: len(self.exported) >= n, timeout_s,
                         f"{n} artifact exports")
        return list(self.exported)


_ROLLOUT_SERVE_SCRIPT = r"""
import os, sys, threading, time
export_dir, poll_s, inflight, serve_load, device = sys.argv[1:6]
from paddle_tpu_torch.serving.loader import artifact_digest, read_manifest
from paddle_tpu_torch.serving.model import (DecoderConfig, DecoderModel,
                                            init_decoder_params)
from paddle_tpu_torch.serving.rollout import (latest_valid_artifact,
                                              swap_from_artifact)
from paddle_tpu_torch.serving.server import InferenceServer
cfg = DecoderConfig(vocab=64, dim=32, heads=2, layers=1, ffn=64,
                    max_context=64, eos_id=1)
dev = device or None
# boot from the newest digest-valid artifact when one exists: a restart
# resumes the pipeline
art = latest_valid_artifact(export_dir)
if art:
    model = DecoderModel.from_artifact(art, device=dev)
    version = artifact_digest(read_manifest(art))
else:
    model = DecoderModel(init_decoder_params(cfg, seed=0), cfg, device=dev)
    version = "seed"
srv = InferenceServer(model, max_batch=4, n_pages=64, page_size=8,
                      continuous=True, model_version=version).start()
port = srv.start_http(0)

def _watch():
    while True:
        time.sleep(float(poll_s))
        a = latest_valid_artifact(export_dir)
        if not a:
            continue
        rep = swap_from_artifact(srv, a, inflight=inflight or None)
        if rep.get("result") == "ok":
            print("SWAPPED", rep.get("version"), flush=True)

threading.Thread(target=_watch, name="ptpu-rollout-swapper",
                 daemon=True).start()
print("READY", os.getpid(), port, version, flush=True)
i = 0
while serve_load == "1":
    r = srv.submit([2 + (i % 60)] * (2 + i % 10), max_new_tokens=6)
    toks = srv.result(r, timeout=60.0)
    assert toks, "empty generation"
    print("SERVED", i, srv.model_version, flush=True)
    i += 1
while True:
    time.sleep(3600)
"""


class RolloutServeProcess(_LineChild):
    """A serving replica child that hot-swaps every new artifact while
    serving an endless request stream.

    Boots from the newest digest-valid artifact in ``export_dir`` (or
    seed weights when empty) and exposes the HTTP front on an ephemeral
    port (``.port``, ``POST /v1/swap``); a watcher thread inside the
    child swaps in whatever :func:`latest_valid_artifact` finds, so
    ``kill()`` can land SIGKILL mid-swap.  Progress lines: ``SWAPPED
    <version>`` per completed hot swap and ``SERVED <i> <version>`` per
    completed request — every response is stamped with the version that
    served it, which is how a test proves responses never mix models."""

    def __init__(self, export_dir: str, poll_s: float = 0.1,
                 inflight: str = "drain", serve_load: bool = True,
                 device: Optional[str] = None, fleet_addr: str = ""):
        _no_fleet(fleet_addr)
        self.export_dir = export_dir
        self.poll_s = poll_s
        self.inflight = inflight
        self.serve_load = serve_load
        self.device = device
        self.port = 0
        self.boot_version = ""
        self.served = 0
        self.swaps: list = []            # versions, in swap order
        self.served_versions: list = []  # (request index, version)

    def start(self) -> "RolloutServeProcess":
        self.served = 0
        self.swaps = []
        self.served_versions = []
        self._spawn(_ROLLOUT_SERVE_SCRIPT,
                    [self.export_dir, self.poll_s, self.inflight,
                     "1" if self.serve_load else "0", self.device or ""])
        return self

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def _on_ready(self, fields: list) -> None:
        self.port = int(fields[2])
        self.boot_version = fields[3]

    def _dispatch(self, fields: list) -> None:
        if not fields:
            return
        if fields[0] == "SWAPPED":
            self.swaps.append(fields[1])
        elif fields[0] == "SERVED":
            self.served = int(fields[1]) + 1
            self.served_versions.append((int(fields[1]), fields[2]))

    def wait_served(self, n: int, timeout_s: float = 120.0) -> int:
        """Block until ``n`` requests completed; returns the count."""
        self._pump_until(lambda: self.served >= n, timeout_s,
                         f"{n} served requests")
        return self.served

    def wait_swapped(self, n: int = 1, timeout_s: float = 120.0) -> list:
        """Block until ``n`` hot swaps completed (counted from this
        start()); returns the swapped-in versions so far."""
        self._pump_until(lambda: len(self.swaps) >= n, timeout_s,
                         f"{n} hot-swaps")
        return list(self.swaps)


# ------------------------------------------------------- data faults
class ShardFault(RuntimeError):
    """Raised by a poisoned ``load_fn`` (distinct type so tests can
    assert the fault propagated through the right path)."""


def poison_load_fn(load_fn: Callable, bad_payloads: Iterable[str],
                   times: int = 1) -> Callable:
    """Wrap ``load_fn`` to raise :class:`ShardFault` the first ``times``
    times each payload in ``bad_payloads`` is loaded; later attempts
    pass through (a transiently bad shard).  ``times < 0`` poisons the
    shard permanently."""
    bad = set(bad_payloads)
    hits: dict = {}

    def wrapped(payload):
        if payload in bad:
            n = hits.get(payload, 0)
            if times < 0 or n < times:
                hits[payload] = n + 1
                raise ShardFault(
                    f"injected shard fault on {payload!r} (hit {n + 1})")
        return load_fn(payload)

    wrapped.hits = hits
    return wrapped


# ------------------------------------------------- checkpoint faults
def corrupt_checkpoint(ckpt_dir: str, fname: str = "params.npz",
                       mode: str = "truncate") -> str:
    """Damage one file of a checkpoint dir in place.

    ``mode="truncate"`` chops the file to half its size (a torn write /
    partial flush); ``mode="bitflip"`` XOR-flips one byte in the middle
    (silent media corruption — the case only digests can catch).
    Returns the damaged path.
    """
    path = os.path.join(ckpt_dir, fname)
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    elif mode == "bitflip":
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    log.info("injected %s corruption into %s", mode, path)
    return path


# --------------------------------------------------- artifact faults
def corrupt_artifact(artifact_dir: str, fname: str = "weights.npz",
                     mode: str = "truncate") -> str:
    """Damage one file of a serving artifact AFTER its digests were
    recorded in the manifest — the torn-artifact case the rollout
    verify gate (``loader.verify_artifact``) exists for.  Same damage
    modes as :func:`corrupt_checkpoint`; returns the damaged path."""
    return corrupt_checkpoint(artifact_dir, fname=fname, mode=mode)


def resign_artifact_manifest(artifact_dir: str,
                             fname: str = "weights.npz") -> str:
    """Re-sign an artifact manifest with a WRONG digest for ``fname``
    (sizes stay correct, so only the sha256 comparison can catch it) —
    the malicious/buggy-writer case: the weights are intact but the
    manifest lies about them.  Returns the manifest path."""
    import json as _json

    path = os.path.join(artifact_dir, "manifest.json")
    with open(path) as f:
        manifest = _json.load(f)
    files = manifest.get("files") or {}
    if fname not in files:
        raise ValueError(f"manifest has no digest entry for {fname!r}")
    files[fname]["sha256"] = "0" * 64
    with open(path, "w") as f:
        _json.dump(manifest, f, indent=1)
    log.info("re-signed %s with wrong digest for %s", path, fname)
    return path


@contextlib.contextmanager
def failing_saves(trainer, times: int = 1,
                  exc: Optional[OSError] = None):
    """Make ``trainer.save`` raise a disk-full ``OSError`` for the next
    ``times`` calls (``times < 0``: every call), then pass through.
    Yields a stats dict ``{"failed": n, "succeeded": n}``."""
    orig = trainer.save
    stats = {"failed": 0, "succeeded": 0}

    def faulty_save(save_dir, pass_id):
        if times < 0 or stats["failed"] < times:
            stats["failed"] += 1
            raise exc or OSError(errno.ENOSPC,
                                 "injected: no space left on device")
        out = orig(save_dir, pass_id)
        stats["succeeded"] += 1
        return out

    trainer.save = faulty_save
    try:
        yield stats
    finally:
        trainer.save = orig
