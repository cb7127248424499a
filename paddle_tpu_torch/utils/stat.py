"""Named wall-clock timers with aggregated stats (counterpart of
``paddle_tpu/utils/stat.py``).

Equivalent of the reference's ``StatSet``/``REGISTER_TIMER`` RAII timers
(``paddle/utils/Stat.h:63-242``): every scope accumulates count/total/max
under a name, and ``print_all_status`` dumps the table.  The trainer
times each step's dispatch under ``train_batch``.

CUDA runs asynchronously, so a timer around a step measures its launches
unless the value is waited for: ``timer(..., block_on=x)`` waits, before
the clock stops, for the work queued on the current stream of each CUDA
tensor in ``x`` (a tensor, or a dict, list or tuple of them); a CPU
tensor needs no wait.  ``--enable_timers=false`` makes every timer a
no-op.

Export: :meth:`StatSet.snapshot` returns a lock-consistent copy of the
table — the :mod:`paddle_tpu_torch.observe.report` reporter ships it on
every JSONL line and into the Prometheus dump alongside the typed
metrics, so timers and histograms share one export path.

Importing this module imports no torch: the wait imports it when a
timer is given something to wait for.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator

from ..analysis.lockorder import named_lock
from .flags import FLAGS


@dataclass
class StatItem:
    name: str
    count: int = 0
    total: float = 0.0
    max: float = 0.0
    min: float = float("inf")
    # updates and snapshots race (timer threads vs the reporter flush
    # thread); a per-item lock keeps count/total/max/min one consistent
    # tuple instead of a field-by-field torn read
    _lock: threading.Lock = field(
        default_factory=lambda: named_lock("stat.item"),
        repr=False, compare=False)

    def add(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            self.max = max(self.max, seconds)
            self.min = min(self.min, seconds)

    def snapshot(self) -> Dict[str, Any]:
        """Lock-consistent copy: every field read under the same lock
        acquisition, so count/total/avg always agree."""
        with self._lock:
            count, total = self.count, self.total
            mx, mn = self.max, self.min
        return {"name": self.name, "count": count, "total": total,
                "avg": total / count if count else 0.0,
                "max": mx, "min": mn if count else 0.0}

    @property
    def avg(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else 0.0


def block_until_ready(value: Any) -> None:
    """Wait until the work queued on the current stream of every CUDA
    tensor in ``value`` (a tensor, or a dict, list or tuple of them) has
    finished: an event recorded on that stream and waited for.  A CPU
    tensor, or anything else, is ready already."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            block_until_ready(v)
        return
    dev = getattr(value, "device", None)
    if getattr(dev, "type", None) != "cuda":
        return
    import torch

    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    ev.synchronize()


class StatSet:
    def __init__(self, name: str = "global"):
        self.name = name
        self._items: Dict[str, StatItem] = {}
        self._lock = named_lock("stat.set")
        self.enabled = True

    def item(self, name: str) -> StatItem:
        with self._lock:
            if name not in self._items:
                self._items[name] = StatItem(name)
            return self._items[name]

    @contextlib.contextmanager
    def timer(self, name: str, block_on: Any = None) -> Iterator[None]:
        if not self.enabled or not FLAGS.get("enable_timers"):
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                try:
                    block_until_ready(block_on)
                except Exception as e:  # noqa: BLE001 — timing fence is
                    # best-effort: a freed tensor must not kill the
                    # timed computation
                    from .logger import get_logger
                    get_logger("stat").debug(
                        "block_until_ready fence failed for timer %r: "
                        "%s: %s", name, type(e).__name__, e)
            self.item(name).add(time.perf_counter() - t0)

    def reset(self) -> None:
        with self._lock:
            self._items.clear()

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """``{name: {count,total,avg,max,min}}`` — each item's fields
        read atomically (the export path's view of the table)."""
        with self._lock:
            items = list(self._items.values())
        return {it.name: it.snapshot() for it in items}

    def print_all_status(self, log=print) -> None:
        snaps = sorted(self.snapshot().values(),
                       key=lambda s: -s["total"])
        if not snaps:
            return
        log(f"======= StatSet: [{self.name}] status ======")
        log(f"{'name':<40} {'calls':>8} {'total(ms)':>12} {'avg(ms)':>10} "
            f"{'max(ms)':>10} {'min(ms)':>10}")
        for s in snaps:
            log(
                f"{s['name']:<40} {s['count']:>8} "
                f"{s['total'] * 1e3:>12.2f} {s['avg'] * 1e3:>10.3f} "
                f"{s['max'] * 1e3:>10.3f} {s['min'] * 1e3:>10.3f}"
            )


global_stat = StatSet()
