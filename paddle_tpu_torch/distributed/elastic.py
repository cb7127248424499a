"""Elastic, preemption-tolerant training loop (counterpart of
``paddle_tpu/distributed/elastic.py``).

Re-expresses the gen-2 fault-tolerance story
(``doc/design/cluster_train/README.md``): trainers are stateless — data
progress lives in the master's leased task queue (snapshot/recover),
model+optimizer state lives in periodic checkpoints (the Go pserver's
``parameterCheckpoint``, ``go/pserver/service.go:146``).  Kill any trainer
at any point; a restart recovers the latest checkpoint and the master
re-leases unfinished shards.

The JAX trainer also registers its ``trainer_id`` as its fleet identity
(``observe.fleet``, queue A10b, not ported yet): the port keeps the id on
the trainer (``ElasticTrainer.trainer_id``) for that to wire.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

from ..observe import counter
from ..trainer.trainer import Trainer
from ..utils import get_logger

log = get_logger("elastic")


class ElasticTrainer:
    """Wraps a :class:`Trainer` with master-driven data tasks and
    periodic checkpoints; safe to kill+restart at any batch."""

    def __init__(self, trainer: Trainer, client, load_fn: Callable,
                 save_dir: str, trainer_id: str = "trainer-0",
                 checkpoint_every_s: float = 60.0,
                 ckpt_fail_max: int = 3):
        self.trainer = trainer
        self.client = client
        self.load_fn = load_fn
        self.save_dir = save_dir
        self.trainer_id = trainer_id
        self.checkpoint_every_s = checkpoint_every_s
        self.ckpt_fail_max = ckpt_fail_max
        self._last_ckpt = 0.0
        self._ckpt_failures = 0  # consecutive save failures

    def resume(self) -> bool:
        """Load the newest *valid* checkpoint if one exists (corrupt
        dirs are skipped + quarantined by ``Trainer.resume``)."""
        ok = self.trainer.resume(self.save_dir)
        if ok:
            log.info("resumed from checkpoint in %s "
                     "(samples_seen=%d)", self.save_dir,
                     self.trainer.samples_seen)
        return ok

    def _maybe_checkpoint(self, epoch: int, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_ckpt < self.checkpoint_every_s:
            return
        # save-model election: exactly one trainer checkpoints per window
        if not self.client.request_save_model(self.trainer_id,
                                              self.checkpoint_every_s):
            return
        try:
            self.trainer.save(self.save_dir, epoch)
        except OSError as e:
            # a transient disk fault (ENOSPC, EACCES, ...) must not kill
            # the training loop: skip this window, retry at the next one.
            # Only an epoch-end force save escalates, and only once the
            # disk has been bad for ckpt_fail_max consecutive attempts —
            # at that point progress durability is genuinely gone.
            self._ckpt_failures += 1
            counter("elastic_skipped_saves",
                    "checkpoint windows skipped after a failed save "
                    "(disk fault survived)").inc()
            try:
                # release the won election (interval < 0) so a healthy
                # peer can checkpoint this window instead of the fleet
                # silently losing it to our broken disk
                self.client.request_save_model(self.trainer_id, -1.0)
                counter("elastic_election_releases",
                        "save-model elections released to a peer after "
                        "a local save failure").inc()
            except Exception as rel_e:  # noqa: BLE001 — best-effort
                log.debug("save-model election release failed: %s: %s",
                          type(rel_e).__name__, rel_e)
            log.warning(
                "checkpoint save failed: epoch=%d force=%s dir=%s "
                "consecutive=%d/%d error=%s: %s — skipping this window",
                epoch, force, self.save_dir, self._ckpt_failures,
                self.ckpt_fail_max, type(e).__name__, e)
            if force and self._ckpt_failures >= self.ckpt_fail_max:
                raise
            self._last_ckpt = now  # full window before the next attempt
            return
        self._ckpt_failures = 0
        self._last_ckpt = now

    def _train_batch(self, feeder, samples, epoch: int,
                     event_handler: Optional[Callable]) -> None:
        feed = feeder.convert(samples) if feeder else samples
        loss = self.trainer.train_one_batch(feed)
        self._maybe_checkpoint(epoch)
        if event_handler is not None:
            event_handler(epoch, loss)

    def train(self, feeder, batch_size: int, num_epochs: int = 1,
              event_handler: Optional[Callable] = None) -> None:
        self.resume()
        # pass-number handshake, offset by the master's epoch so a
        # restarted trainer's resets keep advancing against a recovered
        # or long-lived master instead of no-opping (zero-sample passes)
        epoch_base = self.client.current_epoch()
        for epoch in range(num_epochs):
            self._train_one_epoch(feeder, batch_size, epoch, event_handler)
            self._maybe_checkpoint(epoch, force=True)
            self.client.reset_epoch(epoch_base + epoch + 1)
            log.info("epoch %d complete: %s", epoch, self.client.counts())

    def _train_one_epoch(self, feeder, batch_size: int, epoch: int,
                         event_handler: Optional[Callable]) -> None:
        """Lease tasks and train them, marking a task FINished only once
        every one of its samples has actually gone through a training
        step.  Any exception — in ``load_fn`` *or* on the consumer side
        (feeder/``train_one_batch``) — FAILs the leased tasks whose
        samples were in flight, so the master re-queues them instead of
        waiting out the lease; one bad shard must not kill the trainer
        (``go/master/service.go:313`` failure-tolerance contract).
        Samples buffered from earlier tasks are tracked per-task (at-least
        -once: a task is re-leased unless fully trained)."""
        buf: List[tuple] = []          # (task_id, sample) carried remainder
        open_tasks: List[int] = []     # leased ids not yet FIN/FAILed

        def _finish_drained() -> None:
            # a leased task is complete once it's fully loaded (always
            # true here — tasks enter open_tasks after their load loop
            # ends) and none of its samples await training; covers
            # zero-sample shards too
            remaining = {t for t, _ in buf}
            for t in list(open_tasks):
                if t not in remaining:
                    open_tasks.remove(t)
                    self.client.task_finished(t)

        def _train_buffered(flush_tail: bool) -> None:
            while len(buf) >= batch_size:
                chunk, rest = buf[:batch_size], buf[batch_size:]
                self._train_batch(feeder, [s for _, s in chunk],
                                  epoch, event_handler)
                buf[:] = rest
                _finish_drained()
            if flush_tail and buf:
                self._train_batch(feeder, [s for _, s in buf],
                                  epoch, event_handler)
                buf.clear()
            _finish_drained()

        def _fail_in_flight(e: Exception, what: str) -> None:
            for t in open_tasks:        # in-flight tasks → re-queue now
                self.client.task_failed(t)
            open_tasks.clear()
            buf.clear()
            log.warning("%s failed (%s: %s); continuing", what,
                        type(e).__name__, e)

        while True:
            tid, payload = self.client.get_task()
            if payload is None:
                # WAIT means every remaining task is leased elsewhere —
                # or by US (sub-batch remainders); flush so our own
                # leases can finish, else the epoch deadlocks on them
                try:
                    _train_buffered(flush_tail=True)
                except Exception as e:  # noqa: BLE001 — shard fault
                    _fail_in_flight(e, "tail batch")
                if tid == 1:
                    time.sleep(0.05)
                    continue
                break                   # epoch drained
            open_tasks.append(tid)
            try:
                for sample in self.load_fn(payload):
                    buf.append((tid, sample))
                _train_buffered(flush_tail=False)
            except Exception as e:      # noqa: BLE001 — shard fault
                _fail_in_flight(e, "shard")
