"""Chaos cases of the port's distributed runtime: the quick cases of
the JAX package's ``tests/test_chaos.py`` that drive the master, its
clients, the master-leased readers and ``ElasticTrainer`` (its
checkpoint-integrity cases are ``tests/test_torch_checkpoint.py``'s; its
process-kill cases are slow there, and ``tests/test_torch_distributed.py``
carries the live-serve one).

Every recovery path is driven by a fault from
``paddle_tpu_torch.testing.fault`` and asserted end to end: training
completes, every sample trains at least once, resume lands on the newest
checkpoint that verifies.  Faults are deterministic (call-count
triggers, fixed seeds); only loopback TCP and the local filesystem are
touched.  Every case runs under the port's runtime lock-order checker.
"""

import os
import threading
import time

import pytest

from paddle_tpu_torch.distributed import ElasticTrainer, Master, \
    MasterClient, master_reader
from paddle_tpu_torch.testing import fault
from paddle_tpu_torch.trainer.checkpoint import (
    latest_checkpoint,
    latest_valid_checkpoint,
    load_manifest,
    sweep_retention,
    verify_checkpoint,
)
from paddle_tpu_torch.utils import FLAGS, PaddleTpuError

from test_torch_distributed import (_CountingTrainer, _shard_samples,
                                    _tiny_trainer)

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _lock_order_guard():
    """The port's runtime lock-order checker over every case: no
    ordering cycle among its named locks may be witnessed."""
    from paddle_tpu_torch.analysis import lockorder
    lockorder.reset()
    lockorder.enable(raise_on_violation=False)
    try:
        yield
        lockorder.check_acyclic()
    finally:
        lockorder.disable()
        lockorder.reset()


@pytest.fixture(autouse=True)
def _port_registry():
    yield
    from paddle_tpu_torch.observe import REGISTRY
    REGISTRY.reset()


def _fast_client(port, retry_max=8):
    return MasterClient(f"127.0.0.1:{port}", retry_max=retry_max,
                        retry_base_s=0.01, retry_cap_s=0.2)


def _load4(payload):
    return [(payload, i) for i in range(4)]


# ------------------------------------------------- reconnecting client
def test_reconnect_survives_request_drops_mid_epoch():
    """TCP drops before the request is sent: the client re-dials,
    replays, and the epoch completes with every sample trained once."""
    m = Master(timeout_s=30, failure_max=3)
    port = m.serve(0)
    c = _fast_client(port)
    c.set_dataset([f"s{i}" for i in range(4)])
    tr = _CountingTrainer()
    et = ElasticTrainer(tr, c, _load4, save_dir="/tmp/none",
                        checkpoint_every_s=1e9)
    with fault.drop_master_connection(c, every=3) as stats:
        et.train(feeder=None, batch_size=4, num_epochs=2)
    assert stats["dropped"] > 0
    assert sum(tr.batches) == 2 * 16          # request-loss: exactly once
    cnt = c.counts()
    assert cnt["pending"] == 0 and cnt["failed"] == 0
    c.close()


def test_reconnect_survives_response_drops_at_least_once():
    """TCP drops after the request reaches the master: a GET's lease is
    granted but never heard, so it must time out server-side and
    re-queue — at-least-once delivery, epoch still completes."""
    m = Master(timeout_s=0.3, failure_max=10)  # fast lease-timeout rescue
    port = m.serve(0)
    c = _fast_client(port)
    c.set_dataset([f"s{i}" for i in range(4)])
    tr = _CountingTrainer()
    et = ElasticTrainer(tr, c, _load4, save_dir="/tmp/none",
                        checkpoint_every_s=1e9)
    with fault.drop_master_connection(c, every=4, limit=3,
                                      when="response") as stats:
        et.train(feeder=None, batch_size=4, num_epochs=1)
    assert stats["dropped"] == 3
    assert sum(tr.batches) >= 16              # at-least-once, never less
    cnt = c.counts()
    assert cnt["pending"] == 0 and cnt["failed"] == 0
    c.close()


def test_retry_max_zero_reproduces_fail_fast():
    """--master_retry_max=0 restores today's behavior exactly: the first
    dropped connection raises PaddleTpuError('master connection
    closed')."""
    m = Master(timeout_s=5, failure_max=3)
    port = m.serve(0)
    c = MasterClient(f"127.0.0.1:{port}", retry_max=0)
    assert c.ping() is True
    fault._kill_socket(c._sock)
    with pytest.raises(PaddleTpuError, match="^master connection closed$"):
        c.counts()
    c.close()


def test_retry_default_comes_from_flag():
    m = Master(timeout_s=5, failure_max=3)
    port = m.serve(0)
    old = FLAGS.get("master_retry_max")
    FLAGS.set("master_retry_max", 0)
    try:
        c = MasterClient(f"127.0.0.1:{port}")
        assert c._retry_max == 0
        fault._kill_socket(c._sock)
        with pytest.raises(PaddleTpuError):
            c.counts()
        c.close()
    finally:
        FLAGS.set("master_retry_max", old)


def test_ping_answers_fast_when_master_is_down():
    """ping() is a probe, not an RPC: it gets at most one re-dial, so a
    dead master yields False promptly instead of blocking through the
    full reconnect budget."""
    m = Master(timeout_s=5, failure_max=3)
    port = m.serve(0)
    c = MasterClient(f"127.0.0.1:{port}", retry_max=10,
                     retry_base_s=0.01, retry_cap_s=0.05)
    assert c.ping() is True
    del m                                      # server torn down
    t0 = time.monotonic()
    assert c.ping() is False                   # no 10-attempt stall
    assert time.monotonic() - t0 < 2.0
    c.close()


def test_sweep_reaps_stale_tmp_dirs(tmp_path):
    """A save SIGKILLed mid-write leaves a .tmp-ckpt-* orphan (no
    in-process cleanup ran); the retention sweep reaps it once stale,
    but never touches a fresh one (a live concurrent save)."""
    from paddle_tpu_torch.trainer import checkpoint as ck

    save_dir = str(tmp_path / "ckpt")
    os.makedirs(save_dir)
    stale = os.path.join(save_dir, ".tmp-ckpt-dead")
    fresh = os.path.join(save_dir, ".tmp-ckpt-live")
    os.makedirs(stale)
    os.makedirs(fresh)
    old = time.time() - ck._TMP_STALE_S - 60
    os.utime(stale, (old, old))
    removed = sweep_retention(save_dir, keep=1)
    assert removed == [stale]
    assert os.path.isdir(fresh) and not os.path.isdir(stale)


def test_client_context_manager_and_idempotent_close():
    m = Master(timeout_s=5, failure_max=3)
    port = m.serve(0)
    with MasterClient(f"127.0.0.1:{port}") as c:
        assert c.ping() is True
    c.close()                                  # second close: no-op
    c.close()
    with pytest.raises(PaddleTpuError, match="closed"):
        c.counts()


def test_master_reader_closes_client_on_abandonment():
    # short lease timeout: the first generator abandons a lease mid-read
    # and the drain below must not wait long for its re-queue
    m = Master(timeout_s=0.3, failure_max=3)
    port = m.serve(0)
    c = MasterClient(f"127.0.0.1:{port}")
    c.set_dataset([f"s{i}" for i in range(3)])
    gen = master_reader(c, _load4)()
    next(gen)
    gen.close()                                # abandoned mid-pass
    assert c._closed is True                   # no leaked master socket
    # the abandoned lease was FAILed (immediate re-queue), not left to
    # burn its full server-side timeout
    cnt = m.counts()
    assert cnt["pending"] == 0 and cnt["todo"] == 3
    # normal exhaustion leaves the client OPEN: the reader is
    # re-invocable (one call per pass, Trainer.train-style)
    c2 = MasterClient(f"127.0.0.1:{port}")
    reader = master_reader(c2, _load4)
    list(reader())
    assert c2._closed is False
    c2.reset_epoch(c2.current_epoch() + 1)     # next pass still works
    assert len(list(reader())) == 12
    # opt-out for shared clients: abandonment must NOT close
    gen3 = master_reader(c2, _load4, close_client=False)()
    c2.reset_epoch(c2.current_epoch() + 1)
    next(gen3)
    gen3.close()
    assert c2._closed is False
    c2.close()


# ------------------------------------------- cloud read-ahead prefetcher
def test_cloud_prefetch_survives_master_reconnect_mid_pass():
    """Connection drops while the read-ahead thread is leasing/fetching
    ahead of training: the client re-dials and replays under its own
    lock, the pass completes with every sample exactly once, and no
    lease is left pending."""
    from paddle_tpu_torch.observe import REGISTRY

    c0 = REGISTRY.flat(kinds=("counter",))
    m = Master(timeout_s=30, failure_max=3)
    port = m.serve(0)
    c = _fast_client(port, retry_max=10)
    c.set_dataset([f"s{i}" for i in range(6)])
    reader = master_reader(c, _load4, read_ahead=2)
    with fault.drop_master_connection(c, every=3) as stats:
        got = list(reader())
    assert stats["dropped"] > 0
    assert sorted(got) == sorted([(f"s{i}", j) for i in range(6)
                                  for j in range(4)])
    cnt = c.counts()
    assert cnt["pending"] == 0 and cnt["failed"] == 0 and cnt["done"] == 6
    c1 = REGISTRY.flat(kinds=("counter",))
    assert c1.get("master_reconnects", 0) > c0.get("master_reconnects", 0)
    assert c1.get("cloud_readahead_chunks_total", 0) \
        - c0.get("cloud_readahead_chunks_total", 0) == 6
    c.close()


def test_cloud_prefetch_fails_all_held_leases_on_abandonment():
    """A torn-down prefetching reader FAILs the chunk being consumed AND
    every prefetched-but-unconsumed chunk, so peers re-lease them
    immediately instead of waiting out the server-side timeout (the
    abandonment lease contract, extended to the read-ahead queue)."""
    m = Master(timeout_s=30, failure_max=3)   # long timeout: only FAIL
    port = m.serve(0)                         # can re-queue promptly
    c = _fast_client(port)
    c.set_dataset([f"s{i}" for i in range(6)])
    gen = master_reader(c, _load4, read_ahead=2)()
    next(gen)
    time.sleep(0.3)                           # let it lease ahead
    gen.close()                               # abandoned mid-pass
    cnt = m.counts()
    assert cnt["pending"] == 0, cnt           # nothing burns a timeout
    assert cnt["todo"] == 6 and cnt["done"] == 0, cnt
    assert c._closed is True                  # no leaked master socket


def test_cloud_prefetch_shard_fault_requeues_and_raises():
    """A load fault in the read-ahead thread FAILs the lease and
    re-raises consumer-side — retry loops re-enter the reader exactly
    like the synchronous path."""
    m = Master(timeout_s=1e6, failure_max=5)
    port = m.serve(0)
    c = _fast_client(port)
    c.set_dataset(["good", "bad"])
    poisoned = fault.poison_load_fn(_load4, ["bad"], times=1)
    reader = master_reader(c, poisoned, read_ahead=2)
    seen = []
    for _ in range(2):                        # poison-retry loop
        try:
            seen.extend(reader())
        except fault.ShardFault:
            continue
        break
    assert poisoned.hits == {"bad": 1}
    # every sample of both shards consumed at least once
    assert {p for p, _ in seen} == {"good", "bad"}
    assert len(seen) >= 8
    cnt = c.counts()
    assert cnt["pending"] == 0 and cnt["failed"] == 0
    c.close()


def test_gauntlet_with_prefetch_enabled(tmp_path):
    """The async input pipeline layered over the master-leased reader,
    with connection drops firing mid-prefetch: training completes, every
    sample trains at least once, and the pipeline tears down clean."""
    from paddle_tpu_torch.data.pipeline import AsyncPipeline
    from paddle_tpu_torch.data.reader import batch as batch_reader

    m = Master(timeout_s=30, failure_max=5)
    port = m.serve(0)
    c = _fast_client(port, retry_max=10)
    c.set_dataset([f"s{i}" for i in range(5)])
    tr, feeder = _tiny_trainer()
    inner = master_reader(c, _shard_samples, read_ahead=2,
                          close_client=False)
    with fault.drop_master_connection(c, every=4, limit=4) as stats:
        pipe = AsyncPipeline(batch_reader(inner, 8)(),
                             convert_fn=feeder.convert,
                             place_fn=tr._place_feed,
                             depth=2, workers=2)
        n = 0
        for feed in pipe:
            tr.train_one_batch(feed, placed=True)
            n += 1
    assert stats["dropped"] > 0
    assert n == 5                             # 5 shards × 8 samples / 8
    cnt = c.counts()
    assert cnt["pending"] == 0 and cnt["failed"] == 0
    c.close()


# --------------------------------------------- master process kill/restart
# ----------------------------------------------------- poisoned shards
def test_poisoned_shard_does_not_kill_training():
    """One shard raises inside load_fn twice; the lease FAILs, the
    master re-queues it, and the epoch completes with every sample
    trained at least once."""
    m = Master(timeout_s=1e6, failure_max=5)
    m.set_dataset([f"s{i}" for i in range(4)])
    poisoned = fault.poison_load_fn(_load4, ["s2"], times=2)
    tr = _CountingTrainer()
    et = ElasticTrainer(tr, m, poisoned, save_dir="/tmp/none",
                        checkpoint_every_s=1e9)
    et.train(feeder=None, batch_size=4, num_epochs=1)
    assert poisoned.hits == {"s2": 2}
    assert sum(tr.batches) >= 16
    cnt = m.counts()
    assert cnt["pending"] == 0 and cnt["failed"] == 0 and cnt["todo"] == 4


def test_permanently_poisoned_shard_hits_failure_cap():
    """A shard that never loads ends in `failed` after failure_max
    attempts; the rest of the epoch still completes."""
    m = Master(timeout_s=1e6, failure_max=2)
    m.set_dataset(["good", "bad"])
    poisoned = fault.poison_load_fn(_load4, ["bad"], times=-1)
    tr = _CountingTrainer()
    et = ElasticTrainer(tr, m, poisoned, save_dir="/tmp/none",
                        checkpoint_every_s=1e9)
    et.train(feeder=None, batch_size=4, num_epochs=1)
    assert sum(tr.batches) == 4                # the good shard trained
    # the epoch-end reset already re-queued the failed shard for the
    # next pass (failures reset); nothing is stuck pending
    cnt = m.counts()
    assert cnt["todo"] == 2 and cnt["pending"] == 0


# ------------------------------------------------------ disk-full saves
def test_disk_full_save_skips_window_and_recovers(tmp_path):
    """A failing periodic save logs + skips its window; once the disk
    'recovers', the next save succeeds and training completed anyway."""
    m = Master(timeout_s=1e6, failure_max=3)
    m.set_dataset([f"s{i}" for i in range(3)])
    tr, feeder = _tiny_trainer()
    save_dir = str(tmp_path / "ckpt")
    et = ElasticTrainer(tr, m, _shard_samples, save_dir,
                        checkpoint_every_s=0.0)  # attempt every batch
    with fault.failing_saves(tr, times=2) as stats:
        et.train(feeder, batch_size=8, num_epochs=1)
    assert stats["failed"] == 2 and stats["succeeded"] >= 1
    assert m.counts()["pending"] == 0
    # the surviving checkpoint is valid and loadable
    ckpt = latest_valid_checkpoint(save_dir)
    assert ckpt is not None and verify_checkpoint(ckpt)


def test_disk_full_escalates_only_at_epoch_end_after_n_failures(tmp_path):
    """With the disk permanently full, periodic saves are skipped
    (training continues) and only the epoch-end force save raises, after
    ckpt_fail_max consecutive failures."""
    m = Master(timeout_s=1e6, failure_max=3)
    m.set_dataset([f"s{i}" for i in range(3)])
    tr = _CountingTrainer()
    et = ElasticTrainer(tr, m, _load4, save_dir=str(tmp_path / "ck"),
                        checkpoint_every_s=0.0, ckpt_fail_max=3)
    with fault.failing_saves(tr, times=-1) as stats:
        with pytest.raises(OSError):
            et.train(feeder=None, batch_size=4, num_epochs=1)
    # every sample still trained before the epoch-end escalation
    assert sum(tr.batches) == 12
    assert stats["failed"] >= 3


def test_failed_save_releases_election_to_healthy_peer():
    """The trainer whose save failed gives the election window back
    (interval < 0 releases), so a healthy peer can checkpoint it instead
    of the fleet silently losing the window."""
    m = Master(timeout_s=5, failure_max=3)
    assert m.request_save_model("sick", 30.0) is True
    assert m.request_save_model("healthy", 30.0) is False  # sick owns it
    m.request_save_model("sick", -1.0)         # sick's save failed
    assert m.request_save_model("healthy", 30.0) is True
    # a non-owner's stray release must not steal the window
    m.request_save_model("other", -1.0)
    assert m.request_save_model("sick", 30.0) is False


def test_one_failed_force_save_does_not_escalate(tmp_path):
    """A single epoch-end save failure (no prior failures) is logged and
    skipped — escalation needs ckpt_fail_max consecutive failures."""
    m = Master(timeout_s=1e6, failure_max=3)
    m.set_dataset(["s0"])
    tr = _CountingTrainer()
    et = ElasticTrainer(tr, m, _load4, save_dir=str(tmp_path / "ck"),
                        checkpoint_every_s=1e9, ckpt_fail_max=3)
    with fault.failing_saves(tr, times=1):
        et.train(feeder=None, batch_size=4, num_epochs=1)  # no raise
    assert sum(tr.batches) == 4


# ------------------------------------------ the whole gauntlet at once
def test_gauntlet_all_faults_one_run(tmp_path):
    """Everything together on loopback TCP: connection drops, one
    transiently poisoned shard, two disk-full saves — the run completes
    all epochs, trains every sample at least once, and leaves a valid
    checkpoint that a fresh trainer resumes from (past an
    injected-corrupt newer one).  The telemetry layer must have
    WITNESSED the gauntlet: every injected fault family leaves its
    counter nonzero (a silent recovery is indistinguishable from a
    fault that never fired)."""
    from paddle_tpu_torch.observe import REGISTRY

    c0 = REGISTRY.flat(kinds=("counter",))
    m = Master(timeout_s=0.5, failure_max=5)
    port = m.serve(0)
    c = _fast_client(port, retry_max=10)
    c.set_dataset([f"s{i}" for i in range(5)])
    save_dir = str(tmp_path / "ckpt")
    tr, feeder = _tiny_trainer()
    poisoned = fault.poison_load_fn(_shard_samples, ["s3"], times=1)
    et = ElasticTrainer(tr, c, poisoned, save_dir,
                        checkpoint_every_s=0.0)
    with fault.drop_master_connection(c, every=5, limit=4) as drops, \
            fault.failing_saves(tr, times=2) as saves:
        et.train(feeder, batch_size=8, num_epochs=2)
    assert drops["dropped"] > 0 and saves["failed"] == 2
    assert poisoned.hits == {"s3": 1}
    assert tr.samples_seen >= 2 * 5 * 8        # at-least-once, 2 epochs
    cnt = c.counts()
    assert cnt["pending"] == 0 and cnt["failed"] == 0
    c.close()

    # newest checkpoint corrupted post-hoc: resume must fall back
    newest = latest_checkpoint(save_dir)
    fault.corrupt_checkpoint(newest, mode="bitflip")
    tr2, _ = _tiny_trainer(seed=7)
    et2 = ElasticTrainer(tr2, m, _shard_samples, save_dir)
    assert et2.resume() is True
    assert tr2.samples_seen > 0
    assert os.path.basename(latest_valid_checkpoint(save_dir)) \
        != os.path.basename(newest)

    c1 = REGISTRY.flat(kinds=("counter",))
    delta = lambda k: c1.get(k, 0) - c0.get(k, 0)  # noqa: E731
    assert delta("master_reconnects") > 0          # TCP drops re-dialed
    assert delta("ckpt_quarantined") >= 1          # bitflip quarantined
    assert delta("elastic_skipped_saves") == 2     # two disk-full windows
    assert delta("ckpt_saves") >= 1                # and real saves landed
    assert delta("train_steps") > 0
