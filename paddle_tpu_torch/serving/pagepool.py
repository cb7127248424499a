"""Page-pool allocator for the serving KV cache (a copy of
``paddle_tpu/serving/pagepool.py`` with a plain ``threading.Lock`` and
without the telemetry gauges).

One shared physical pool of ``n_pages`` uniform pages (the
``k_pages`` / ``v_pages`` axis of
:func:`~paddle_tpu_torch.ops.attention.paged_decode_attention`) backs
every in-flight request; each request holds a **page table** — the
ordered list of physical page ids its tokens live in — and returns the
pages on completion for immediate recycling.  Uniform page granularity
makes the allocator trivially fragmentation-free: an allocation of
``ceil(tokens / page_size)`` pages succeeds exactly when that many free
pages exist, regardless of how churned the free list is (the
no-starvation bound the tests pin).  Recycling needs no pool scrub —
the decode kernel reads only the pages a row's page table lists, up to
the row's length, so a page full of a dead request's K/V is invisible
the moment no live page table points at it.

Page 0 is reserved as the **scratch page**: the continuous-batching
decode loop pads its fixed-width batch with inactive slots whose page
table points at page 0 (length 1, zero query), so the kernel never
reads memory no slot owns.  Capacity is therefore ``n_pages - 1``.

Crash safety: :meth:`snapshot` persists the allocator state (tables +
lengths + a content checksum) with the write-tmp-fsync-rename
discipline, so a SIGKILL mid-write leaves either the previous complete
snapshot or a tmp file nobody reads.
:meth:`PagePool.restore` refuses anything torn — bad JSON, a checksum
mismatch, or tables that violate the pool invariants — with
:class:`TornSnapshot`, and the server then starts FRESH rather than
serving a corrupt page table.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from typing import Dict, List

from ..utils import enforce

SNAPSHOT_VERSION = 1

#: Physical page id every padded (inactive) decode slot points at.
SCRATCH_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """No free pages for the requested allocation (admission must wait
    for a release — the caller's backpressure signal, never a crash)."""


class TornSnapshot(ValueError):
    """A persisted pool snapshot failed validation (truncated write,
    bit rot, or tables violating the pool invariants).  The safe
    response is a fresh pool: recycling semantics make a cold start
    always correct, a torn table never."""


class PagePool:
    """Fixed-size physical page allocator with per-owner page tables.

    Thread-safe: admission and the decode loop share it, so every
    mutation runs under one lock.
    """

    def __init__(self, n_pages: int, page_size: int):
        enforce(n_pages >= 2,
                f"PagePool needs >= 2 pages (1 scratch + capacity), "
                f"got {n_pages}")
        enforce(page_size >= 1, f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # LIFO free list: the hottest (most recently released) pages are
        # reissued first — deliberate, it maximizes stale-data reuse and
        # keeps the kernel's stale-page immunity under permanent test
        self._free: List[int] = list(range(self.n_pages - 1, SCRATCH_PAGE,
                                           -1))
        self._tables: Dict[str, List[int]] = {}
        self._lengths: Dict[str, int] = {}

    # ------------------------------------------------------------ queries
    @property
    def capacity(self) -> int:
        """Allocatable pages (scratch page excluded)."""
        return self.n_pages - 1

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def used_pages(self) -> int:
        with self._lock:
            return sum(len(t) for t in self._tables.values())

    def pages_needed(self, n_tokens: int) -> int:
        return max((int(n_tokens) + self.page_size - 1) // self.page_size,
                   1)

    def table_of(self, owner: str) -> List[int]:
        with self._lock:
            enforce(owner in self._tables,
                    f"page pool: unknown owner {owner!r}")
            return list(self._tables[owner])

    def length_of(self, owner: str) -> int:
        with self._lock:
            enforce(owner in self._lengths,
                    f"page pool: unknown owner {owner!r}")
            return self._lengths[owner]

    def owners(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    # -------------------------------------------------------- allocation
    def alloc(self, owner: str, n_tokens: int) -> List[int]:
        """Issue a page table covering ``n_tokens`` to a new owner.

        Raises :class:`PagePoolExhausted` (taking nothing) when fewer
        free pages exist than needed — with uniform pages this is the
        ONLY failure mode, so no allocation pattern can starve a
        request while enough free pages exist.
        """
        need = self.pages_needed(n_tokens)
        with self._lock:
            enforce(owner not in self._tables,
                    f"page pool: owner {owner!r} already holds pages")
            if need > len(self._free):
                raise PagePoolExhausted(
                    f"{owner}: need {need} pages, {len(self._free)} free "
                    f"(capacity {self.capacity})")
            pages = [self._free.pop() for _ in range(need)]
            self._tables[owner] = pages
            self._lengths[owner] = int(n_tokens)
            return list(pages)

    def extend(self, owner: str, n_tokens: int) -> List[int]:
        """Grow an owner's table to cover ``n_tokens`` total (the decode
        loop calls this when a generated token crosses a page
        boundary).  Returns the full updated table."""
        with self._lock:
            enforce(owner in self._tables,
                    f"page pool: unknown owner {owner!r}")
            enforce(n_tokens >= self._lengths[owner],
                    f"page pool: {owner!r} cannot shrink "
                    f"({n_tokens} < {self._lengths[owner]})")
            need = self.pages_needed(n_tokens)
            grow = need - len(self._tables[owner])
            if grow > len(self._free):
                raise PagePoolExhausted(
                    f"{owner}: extend needs {grow} pages, "
                    f"{len(self._free)} free")
            for _ in range(grow):
                self._tables[owner].append(self._free.pop())
            self._lengths[owner] = int(n_tokens)
            return list(self._tables[owner])

    def release(self, owner: str) -> int:
        """Return an owner's pages to the free list; returns how many.
        Releasing an unknown owner is a no-op returning 0 (the crash-
        recovery path releases optimistically)."""
        with self._lock:
            pages = self._tables.pop(owner, None)
            self._lengths.pop(owner, None)
            if pages is None:
                return 0
            self._free.extend(reversed(pages))
            return len(pages)

    # -------------------------------------------------------- invariants
    def verify(self) -> None:
        """Assert the pool invariants; raises ``ValueError`` naming the
        first breach.  A passing pool can always serve its tables:
        every page id in range, scratch never issued, no page owned
        twice or simultaneously free and owned, free + used = capacity.
        """
        with self._lock:
            seen: Dict[int, str] = {}
            for owner, pages in self._tables.items():
                if not pages:
                    raise ValueError(f"owner {owner!r}: empty page table")
                want = self.pages_needed(self._lengths.get(owner, -1))
                if len(pages) != want:
                    raise ValueError(
                        f"owner {owner!r}: table has {len(pages)} pages, "
                        f"length {self._lengths.get(owner)} needs {want}")
                for p in pages:
                    if not (SCRATCH_PAGE < p < self.n_pages):
                        raise ValueError(
                            f"owner {owner!r}: page id {p} out of range")
                    if p in seen:
                        raise ValueError(
                            f"page {p} owned by both {seen[p]!r} "
                            f"and {owner!r}")
                    seen[p] = owner
            for p in self._free:
                if not (SCRATCH_PAGE < p < self.n_pages):
                    raise ValueError(f"free-list page id {p} out of range")
                if p in seen:
                    raise ValueError(
                        f"page {p} both free and owned by {seen[p]!r}")
            if len(set(self._free)) != len(self._free):
                raise ValueError("free list holds duplicate page ids")
            if len(self._free) + len(seen) != self.capacity:
                raise ValueError(
                    f"page leak: {len(self._free)} free + {len(seen)} "
                    f"used != capacity {self.capacity}")

    # --------------------------------------------------------- snapshots
    def _state(self) -> Dict:
        return {"version": SNAPSHOT_VERSION, "n_pages": self.n_pages,
                "page_size": self.page_size,
                "free": list(self._free),
                "tables": {k: list(v) for k, v in self._tables.items()},
                "lengths": dict(self._lengths)}

    @staticmethod
    def _checksum(state: Dict) -> str:
        payload = json.dumps(state, sort_keys=True).encode()
        return hashlib.sha256(payload).hexdigest()

    def snapshot(self, path: str) -> str:
        """Atomically persist the allocator state: write to a tmp file
        in the target directory, fsync, then ``os.replace`` — a SIGKILL
        at any instant leaves either the old complete snapshot or none,
        never a half-written one under the real name."""
        with self._lock:
            state = self._state()
        doc = dict(state, checksum=self._checksum(state))
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".pagepool-", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    @classmethod
    def restore(cls, path: str) -> "PagePool":
        """Rebuild a pool from a snapshot, REFUSING anything torn with
        :class:`TornSnapshot` — unparseable, checksum-mismatched, or
        invariant-violating state never becomes a servable pool."""
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise TornSnapshot(f"{path}: unreadable snapshot ({e})")
        if not isinstance(doc, dict) \
                or doc.get("version") != SNAPSHOT_VERSION:
            raise TornSnapshot(
                f"{path}: unknown snapshot version "
                f"{doc.get('version') if isinstance(doc, dict) else doc!r}")
        claimed = doc.pop("checksum", None)
        if claimed != cls._checksum(doc):
            raise TornSnapshot(f"{path}: checksum mismatch (torn write "
                               "or corruption)")
        try:
            pool = cls(doc["n_pages"], doc["page_size"])
            with pool._lock:
                pool._free = [int(p) for p in doc["free"]]
                pool._tables = {str(k): [int(p) for p in v]
                                for k, v in doc["tables"].items()}
                pool._lengths = {str(k): int(v)
                                 for k, v in doc["lengths"].items()}
            pool.verify()
        except (KeyError, TypeError, ValueError) as e:
            raise TornSnapshot(f"{path}: invalid snapshot state ({e})")
        return pool
