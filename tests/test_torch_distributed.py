"""The port's distributed runtime (``paddle_tpu_torch/distributed``:
the master's ctypes and TCP clients, ``master_reader``, ``ElasticTrainer``)
through the cases of the JAX package's ``tests/test_distributed.py``
(less its DP/TP equivalence cases, ``tests/test_torch_dp.py``'s), and
the wire protocol across the packages: the port's ``Master`` served to
the JAX ``MasterClient`` and the JAX ``Master`` to the port's client.

The service is ``native/master/master.cc``, which both packages drive;
the port builds its own copy of the library (``build/torch_master``).
The elastic kill-and-resume case trains the port's tiny classifier on
the CPU.  ``test_master_live_serve_snapshot_recovery`` is slow, as the
JAX test is.
"""

import os
import time

import numpy as np
import pytest

from paddle_tpu.distributed import Master as JMaster
from paddle_tpu.distributed import MasterClient as JClient
from paddle_tpu_torch.distributed import ElasticTrainer, Master, \
    MasterClient, master_reader


# ------------------------------------------------------------- master
def test_master_lease_and_finish():
    m = Master(timeout_s=5, failure_max=3)
    m.set_dataset([f"s{i}" for i in range(4)])
    tid, payload = m.get_task()
    assert payload == "s0"
    m.task_finished(tid)
    c = m.counts()
    assert c == {"todo": 3, "pending": 0, "done": 1, "failed": 0}


def test_master_set_dataset_first_wins():
    # every trainer calls set_dataset; only the first takes effect
    # (go/master/service.go:287 initDone guard) — a late joiner must not
    # wipe the shared queue and orphan live leases
    m = Master(timeout_s=5, failure_max=3)
    m.set_dataset(["a", "b"])
    m.get_task()
    m.set_dataset(["x", "y", "z"])
    c = m.counts()
    assert c == {"todo": 1, "pending": 1, "done": 0, "failed": 0}


def test_master_early_reset_armed_until_drain():
    # trainer A finishes the pass while B still holds a lease; A's reset
    # must fire once the queue drains — not be dropped, which would give
    # A a zero-sample next pass
    m = Master(timeout_s=5, failure_max=3)
    m.set_dataset(["a", "b"])
    tid_a, _ = m.get_task()
    tid_b, _ = m.get_task()
    m.task_finished(tid_a)
    m.reset_epoch(1)                 # armed: B still pending
    rc, payload = m.get_task()
    assert rc == 1 and payload is None   # WAIT, not DONE
    m.task_finished(tid_b)
    _, payload = m.get_task()        # drain → armed reset fires
    assert payload in ("a", "b")
    c = m.counts()
    assert c["todo"] == 1 and c["pending"] == 1 and c["done"] == 0


def test_master_epoch_boundary_double_reset_no_extra_pass():
    # both trainers see DONE and call reset_epoch back-to-back (the path
    # every real client takes); the second reset must be a pure no-op —
    # arming a stale reset would suppress the next DONE and grant a
    # phantom extra pass
    m = Master(timeout_s=5, failure_max=3)
    m.set_dataset(["a", "b"])
    for _ in range(2):
        tid, _ = m.get_task()
        m.task_finished(tid)
    rc, _ = m.get_task()
    assert rc == -1                  # pass 1 DONE
    m.reset_epoch(1)                 # trainer A refills epoch 2
    m.reset_epoch(1)                 # trainer B: no-op, must not arm
    tid_a, _ = m.get_task()
    tid_b, _ = m.get_task()          # epoch 2 fully leased
    m.reset_epoch(1)                 # trainer C, late: still a no-op
    m.task_finished(tid_a)
    m.task_finished(tid_b)
    rc, payload = m.get_task()
    assert rc == -1 and payload is None   # epoch 2 DONE — no pass 3


def test_master_reset_noop_while_pass_has_work():
    # a desynced/buggy client's reset mid-pass (todo still has work)
    # must be a pure no-op — arming it would auto-fire at drain and
    # blend two epochs into one pass with no DONE boundary
    m = Master(timeout_s=5, failure_max=3)
    m.set_dataset(["a", "b"])
    tid, _ = m.get_task()
    m.task_finished(tid)
    m.reset_epoch(5)                 # mid-pass: "b" still in todo
    tid, _ = m.get_task()
    m.task_finished(tid)
    rc, _ = m.get_task()
    assert rc == -1                  # DONE is observed — no blend


def test_master_epoch_counter_restart_sync(tmp_path):
    # a restarted trainer reads the master's epoch and offsets its local
    # pass counter, so its resets keep advancing after snapshot-recovery
    snap = str(tmp_path / "snap")
    m = Master(timeout_s=5, failure_max=3, snapshot_path=snap)
    m.set_dataset(["a"])
    tid, _ = m.get_task()
    m.task_finished(tid)
    m.reset_epoch(1)
    assert m.current_epoch() == 1
    m.snapshot()
    del m
    m2 = Master(timeout_s=5, failure_max=3, snapshot_path=snap)
    assert m2.current_epoch() == 1   # persisted
    tid, _ = m2.get_task()
    m2.task_finished(tid)
    m2.reset_epoch(m2.current_epoch() + 1)   # what a synced client sends
    _, payload = m2.get_task()
    assert payload == "a"            # advanced — not a permanent no-op


def test_master_empty_set_dataset_does_not_brick():
    # a stray empty SET (misconfigured early trainer) must not consume
    # the first-call-wins slot; the next real dataset still registers
    m = Master(timeout_s=5, failure_max=3)
    m.set_dataset([])
    m.set_dataset(["a"])
    _, payload = m.get_task()
    assert payload == "a"


def test_master_lease_timeout_requeues():
    m = Master(timeout_s=0.2, failure_max=3)
    m.set_dataset(["a", "b"])
    tid, _ = m.get_task()
    time.sleep(0.3)
    c = m.counts()   # lease expired → back to todo with failures+1
    assert c["todo"] == 2 and c["pending"] == 0


def test_master_failure_cap():
    m = Master(timeout_s=5, failure_max=2)
    m.set_dataset(["poison"])
    for _ in range(2):
        tid, _ = m.get_task()
        m.task_failed(tid)
    c = m.counts()
    assert c["failed"] == 1 and c["todo"] == 0
    rc, payload = m.get_task()
    assert payload is None and rc == -1   # epoch over (all failed)


def test_master_snapshot_recover(tmp_path):
    snap = str(tmp_path / "snap")
    m = Master(timeout_s=5, failure_max=3, snapshot_path=snap)
    m.set_dataset(["a", "b", "c"])
    tid, _ = m.get_task()
    m.task_finished(tid)
    m.snapshot()
    del m
    m2 = Master(timeout_s=5, failure_max=3, snapshot_path=snap)
    c = m2.counts()
    assert c["todo"] == 2 and c["done"] == 1  # progress survived restart


@pytest.mark.parametrize("server,client", [
    (Master, MasterClient), (Master, JClient), (JMaster, MasterClient)],
    ids=["port-port", "port-jax", "jax-port"])
def test_master_tcp_roundtrip(server, client):
    m = server(timeout_s=5, failure_max=3)
    port = m.serve(0)
    c = client(f"127.0.0.1:{port}")
    assert c.ping() is True          # liveness probe (PING op)
    c.set_dataset(["x", "y"])
    tid, payload = c.get_task()
    assert payload in ("x", "y")
    c.task_finished(tid)
    assert c.counts()["done"] == 1
    assert c.request_save_model("t0", 30.0) is True
    assert c.request_save_model("t1", 30.0) is False  # t0 holds the lease
    c.close()


@pytest.mark.slow
def test_master_live_serve_snapshot_recovery(tmp_path):
    """The TCP-serving master, SIGKILLed mid-pass and restarted from its
    snapshot, recovers the same state that the in-process pins of
    test_master_snapshot_recover assert: done survives, the unheard
    lease re-queues, the epoch counter persists."""
    from paddle_tpu_torch.testing.fault import MasterServerProcess

    snap = str(tmp_path / "snap")
    srv = MasterServerProcess(snap, timeout_s=5, failure_max=3)
    srv.start()
    try:
        c = MasterClient(srv.addr, retry_max=10, retry_base_s=0.05,
                         retry_cap_s=0.5)
        c.set_dataset(["a", "b", "c"])
        tid, _ = c.get_task()
        c.task_finished(tid)         # snapshotted: done=1, todo=2
        c.get_task()                 # live lease at kill time
        srv.kill()
        srv.start()                  # same port, recovered from snapshot
        assert c.ping() is True      # the client re-dials transparently
        cc = c.counts()
        assert cc["todo"] == 2 and cc["done"] == 1   # the in-process pins
        assert cc["pending"] == 0    # pending lease re-queued as todo
        assert c.current_epoch() == 0
        # drain + epoch handshake still work against the recovered master
        got = []
        while True:
            tid, payload = c.get_task()
            if payload is None:
                break
            got.append(payload)
            c.task_finished(tid)
        assert sorted(got) == ["b", "c"]
        c.reset_epoch(1)
        assert c.current_epoch() == 1
        c.close()
    finally:
        srv.kill()


@pytest.mark.parametrize("server,client", [
    (Master, MasterClient), (Master, JClient), (JMaster, MasterClient)],
    ids=["port-port", "port-jax", "jax-port"])
def test_master_payload_escaping_tcp_and_snapshot(tmp_path, server, client):
    """Payloads containing framing bytes (newline/tab/%/0x1f) survive both
    the TCP line protocol and a snapshot/recover round-trip, whichever
    package escapes and whichever unescapes."""
    nasty = ["a\nb", "c\td", "50%\x1fdone", "  leading spaces", "plain"]
    snap = str(tmp_path / "snap")
    m = server(timeout_s=5, failure_max=3, snapshot_path=snap)
    port = m.serve(0)
    c = client(f"127.0.0.1:{port}")
    c.set_dataset(nasty)
    got = []
    while True:
        tid, payload = c.get_task()
        if payload is None:
            break
        got.append(payload)
        if len(got) < len(nasty):
            c.task_finished(tid)   # leave the last lease pending → snapshot
    assert sorted(got) == sorted(nasty)
    m.snapshot()
    c.close()
    del m
    m2 = Master(timeout_s=5, failure_max=3, snapshot_path=snap)
    tid, payload = m2.get_task()   # the re-leased pending task
    assert payload in nasty


def test_elastic_consumer_failure_fails_lease():
    """A consumer-side (training) exception must FAIL the in-flight leased
    tasks so the master re-queues them immediately, and the samples of a
    task are only FINished after they were actually trained."""
    m = Master(timeout_s=1e6, failure_max=10)   # no lease-timeout rescue
    m.set_dataset([f"s{i}" for i in range(3)])

    def load(payload):
        return [(payload, i) for i in range(4)]

    class _Boom(Exception):
        pass

    class FlakyTrainer:
        """Counts batches; raises on the first call only."""
        samples_seen = 0
        calls = 0

        def resume(self, d):
            return False

        def train_one_batch(self, feed):
            FlakyTrainer.calls += 1
            if FlakyTrainer.calls == 1:
                raise _Boom("transient consumer failure")
            return 0.0

        def save(self, d, e):
            pass

    et = ElasticTrainer(FlakyTrainer(), m, load, save_dir="/tmp/none",
                        checkpoint_every_s=1e9)
    et.train(feeder=None, batch_size=4, num_epochs=1)
    c = m.counts()
    # every shard ends the epoch done (the failed lease was re-queued and
    # retrained), nothing stuck pending on a dead lease
    assert c["pending"] == 0 and c["failed"] == 0
    assert FlakyTrainer.calls >= 4   # 3 shards + the retried one


class _CountingTrainer:
    """Minimal Trainer stand-in: records batch sizes."""

    samples_seen = 0

    def __init__(self):
        self.batches = []

    def resume(self, d):
        return False

    def train_one_batch(self, feed):
        self.batches.append(len(feed))
        return 0.0

    def save(self, d, e):
        pass


def test_elastic_tail_remainder_no_deadlock():
    """Sub-batch task remainders held by THIS trainer must not deadlock
    the epoch: on WAIT/DONE the buffered tail is flushed so our own
    leases can FIN (no lease-timeout stall, no duplicate training)."""
    m = Master(timeout_s=1e6, failure_max=3)   # timeout rescue disabled
    m.set_dataset([f"s{i}" for i in range(3)])

    def load(payload):
        return [(payload, i) for i in range(4)]

    tr = _CountingTrainer()
    et = ElasticTrainer(tr, m, load, save_dir="/tmp/none",
                        checkpoint_every_s=1e9)
    t0 = time.monotonic()
    et.train(feeder=None, batch_size=8, num_epochs=1)   # 12 % 8 != 0
    assert time.monotonic() - t0 < 30           # no lease-timeout stall
    assert sum(tr.batches) == 12                # every sample exactly once
    c = m.counts()
    assert c["pending"] == 0 and c["failed"] == 0


def test_elastic_empty_shard_finishes():
    """A shard with zero samples is FINished, not left to burn
    failure_max lease timeouts."""
    m = Master(timeout_s=1e6, failure_max=3)
    m.set_dataset(["full", "empty"])

    def load(payload):
        return [] if payload == "empty" else [(payload, i)
                                              for i in range(4)]

    tr = _CountingTrainer()
    et = ElasticTrainer(tr, m, load, save_dir="/tmp/none",
                        checkpoint_every_s=1e9)
    t0 = time.monotonic()
    et.train(feeder=None, batch_size=4, num_epochs=1)
    assert time.monotonic() - t0 < 30
    assert sum(tr.batches) == 4
    c = m.counts()
    assert c["pending"] == 0 and c["failed"] == 0


def test_payload_unescape_tolerates_legacy_literals(tmp_path):
    """Snapshots/payloads written before escaping existed (raw '%') must
    not crash recovery or the client decoder."""
    from paddle_tpu_torch.distributed.master import _unescape_payload
    assert _unescape_payload("50%zz") == "50%zz"     # non-hex follower
    assert _unescape_payload("tail%4") == "tail%4"   # truncated
    assert _unescape_payload("a%09b") == "a\tb"      # well-formed
    snap = tmp_path / "snap"
    snap.write_text("todo\t0\t0\t50%zz done\ntodo\t1\t0\tplain\n")
    m = Master(timeout_s=5, failure_max=3, snapshot_path=str(snap))
    c = m.counts()                                   # no SIGABRT
    assert c["todo"] == 2
    payloads = {m.get_task()[1], m.get_task()[1]}
    assert "50%zz done" in payloads


def test_master_reader_drains_and_requeues_failures():
    m = Master(timeout_s=5, failure_max=2)
    m.set_dataset(["good1", "bad", "good2"])

    def load(payload):
        if payload == "bad":
            raise ValueError("poison shard")
        return [(payload, i) for i in range(2)]

    got = []
    for _ in range(3):  # retry loop over poison failures
        try:
            for s in master_reader(m, load)():
                got.append(s)
            break
        except ValueError:
            pass
    c = m.counts()
    assert c["done"] == 2 and c["failed"] == 1
    assert len(got) == 4


# ---------------------------------------------------- elastic trainer
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
    net = NeuralNetwork(cfg)
    tr = Trainer(net, opt_config=OptimizationConfig(
        learning_method="momentum", momentum=0.9, learning_rate=0.05),
        seed=seed, device="cpu")
    feeder = DataFeeder([("x", dense_vector(8)), ("label", integer_value(2))])
    return tr, feeder


def _shard_samples(payload, rng_seed=0):
    rng = np.random.RandomState(hash(payload) % (2 ** 31))
    for _ in range(8):
        lab = int(rng.randint(0, 2))
        yield (rng.randn(8).astype(np.float32) + 2 * lab, lab)


def test_elastic_kill_and_resume(tmp_path):
    """Kill a trainer mid-epoch; a fresh one resumes from the checkpoint
    and the master re-leases unfinished shards."""
    from paddle_tpu_torch.utils import FLAGS
    FLAGS.set("save_dir", "")
    save_dir = str(tmp_path / "ckpt")
    snap = str(tmp_path / "master_snap")

    m = Master(timeout_s=5, failure_max=3, snapshot_path=snap)
    m.set_dataset([f"shard-{i}" for i in range(6)])

    tr, feeder = _tiny_trainer()
    et = ElasticTrainer(tr, m, _shard_samples, save_dir,
                        checkpoint_every_s=0.0)  # checkpoint every batch

    # process half the shards, then "die"
    consumed = 0
    reader = master_reader(m, _shard_samples)
    batch = []
    for s in reader():
        batch.append(s)
        if len(batch) == 8:
            et.trainer.train_one_batch(feeder.convert(batch))
            et._maybe_checkpoint(0, force=True)
            batch = []
            consumed += 1
        if consumed == 3:
            break  # simulated preemption (lease for shard 3 stays pending)
    del et, tr

    # fresh trainer + recovered master: finish the epoch
    m2 = Master(timeout_s=0.01, failure_max=3, snapshot_path=snap)
    time.sleep(0.05)
    tr2, feeder2 = _tiny_trainer(seed=123)
    et2 = ElasticTrainer(tr2, m2, _shard_samples, save_dir,
                         checkpoint_every_s=1e9)
    assert et2.resume() is True
    assert et2.trainer.samples_seen > 0   # checkpoint carried progress
    et2.train(feeder2, batch_size=8, num_epochs=1)
    c = m2.counts()
    assert c["todo"] == 6 and c["pending"] == 0  # epoch reset after drain
