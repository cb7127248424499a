"""Runtime lock-order checker (counterpart of
``paddle_tpu/analysis/lockorder.py``; standard library only).

Every framework lock is created through :func:`named_lock` /
:func:`named_condition`, and in debug mode each *blocking* acquire
records an edge from every lock the thread already holds to the one it
is about to take.  The accumulated graph must stay acyclic; a cycle
means two threads can acquire the same pair of locks in opposite
orders — a potential deadlock — and is recorded as a violation
**before** the acquire blocks, so the checker reports the deadlock it
just prevented from going silent instead of hanging with it.  (The
static half of the reference's lock-order rule comes with queue A10c.)

Production cost is one module-global bool test per acquire: with the
checker off (the default), ``_NamedLock.acquire`` is a flag check and a
delegation to the underlying ``threading`` primitive.  Debug mode is
enabled with the reference's environment variable::

    PADDLE_TPU_LOCK_ORDER_CHECK=1 python -m pytest tests/test_torch_lockorder.py

or programmatically with :func:`enable`; violations accumulate in
:func:`violations` (and raise immediately when
``PADDLE_TPU_LOCK_ORDER_RAISE=1``), so a suite can run to completion
and assert the list is empty at teardown.

Naming: instances share a node per *name* — ``named_lock("stat.item")``
called N times yields N locks but one graph node, because lock-order
discipline is a property of the code path, not the instance.  Two
different instances under one name never form a self-edge (peers of one
class are unordered by design); re-acquiring the *same* non-reentrant
lock object on one thread is a guaranteed self-deadlock and is flagged.

The graph is this package's own: the JAX package's checker, in the same
process, keeps a separate one.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["named_lock", "named_condition", "enable", "disable",
           "enabled", "reset", "edges", "violations", "check_acyclic",
           "LockOrderError"]

ENV_CHECK = "PADDLE_TPU_LOCK_ORDER_CHECK"
ENV_RAISE = "PADDLE_TPU_LOCK_ORDER_RAISE"


class LockOrderError(RuntimeError):
    """A lock-acquisition order violated the derived hierarchy."""


# The checker's own state guard.  Deliberately a PLAIN lock, not a
# named one: it is acquired while arbitrary production locks are held
# (production -> _graph_lock edges only, never the reverse — nothing
# under it acquires anything), so it can neither deadlock nor recurse.
_graph_lock = threading.Lock()
#: held-name -> {acquired-while-held names}
_edges: Dict[str, Set[str]] = {}
#: (src, dst) -> first witness "thread: held [..] -> acquired dst"
_edge_sites: Dict[Tuple[str, str], str] = {}
_violations: List[str] = []

_tls = threading.local()        # .held: List[(name, lock_obj_id)]

_enabled = os.environ.get(ENV_CHECK, "") not in ("", "0")
_raise = os.environ.get(ENV_RAISE, "") not in ("", "0")


def enabled() -> bool:
    return _enabled


def enable(raise_on_violation: Optional[bool] = None) -> None:
    """Turn the checker on (tests).  Locks created earlier participate
    too — checked-ness is a process-wide mode, not a creation-time
    property, so module-global locks born at import are covered."""
    global _enabled, _raise
    if raise_on_violation is not None:
        _raise = bool(raise_on_violation)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop the accumulated graph and violations (tests)."""
    with _graph_lock:
        _edges.clear()
        _edge_sites.clear()
        del _violations[:]


def edges() -> Dict[str, Set[str]]:
    """Copy of the observed acquisition graph: held -> {acquired}."""
    with _graph_lock:
        return {k: set(v) for k, v in _edges.items()}


def violations() -> List[str]:
    """Every recorded ordering violation (empty = hierarchy held)."""
    with _graph_lock:
        return list(_violations)


def check_acyclic() -> None:
    """Raise :class:`LockOrderError` if any violation was recorded —
    the one-call teardown assertion for a test suite."""
    v = violations()
    if v:
        raise LockOrderError(
            "lock-order violations observed:\n  " + "\n  ".join(v))


# ------------------------------------------------------------ recording
def _held() -> List[Tuple[str, int]]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _path_exists(src: str, dst: str) -> bool:
    """DFS over _edges; caller holds _graph_lock."""
    stack, seen = [src], set()
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_edges.get(n, ()))
    return False


def _cycle_path(src: str, dst: str) -> List[str]:
    """One src->dst path (exists by construction); holds _graph_lock."""
    stack: List[Tuple[str, List[str]]] = [(src, [src])]
    seen = set()
    while stack:
        n, path = stack.pop()
        if n == dst:
            return path
        if n in seen:
            continue
        seen.add(n)
        for m in _edges.get(n, ()):
            stack.append((m, path + [m]))
    return [src, dst]           # pragma: no cover — defensive


def _record_violation(msg: str) -> None:
    # caller holds _graph_lock
    _violations.append(msg)
    if _raise:
        raise LockOrderError(msg)


def _before_acquire(name: str, obj_id: int, deadlockable: bool) -> None:
    """Record ordering edges for a blocking acquire of ``name`` given
    the thread's current hold set — BEFORE blocking, so a true cycle is
    reported rather than demonstrated."""
    held = _held()
    if not held:
        return
    tname = threading.current_thread().name
    with _graph_lock:
        for hname, hid in held:
            if hname == name:
                if hid == obj_id and deadlockable:
                    _record_violation(
                        f"self-deadlock: thread {tname!r} re-acquiring "
                        f"non-reentrant lock {name!r} it already holds")
                # a *different* instance under the same name: peers of
                # one class are unordered, no edge
                continue
            if (hname, name) in _edge_sites:
                continue        # edge already witnessed
            if _path_exists(name, hname):
                cyc = _cycle_path(name, hname) + [name]
                _record_violation(
                    f"lock-order cycle: thread {tname!r} holds "
                    f"{hname!r} and acquires {name!r}, but the reverse "
                    f"order {' -> '.join(cyc)} was already observed "
                    f"({_edge_sites.get((name, cyc[1]), 'unknown site')})")
            _edges.setdefault(hname, set()).add(name)
            _edge_sites[(hname, name)] = (
                f"thread {tname!r} held [" +
                ", ".join(h for h, _ in held) + f"] -> acquired {name!r}")


def _after_acquire(name: str, obj_id: int) -> None:
    _held().append((name, obj_id))


def _after_release(name: str, obj_id: int) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] == (name, obj_id):
            del held[i]
            return
    # release of a lock acquired before enable(): nothing tracked


# ------------------------------------------------------------- wrappers
class _NamedLock:
    """A ``threading.Lock``/``RLock`` under a graph-node name.

    Transparent when the checker is off; in debug mode every blocking
    acquire records hierarchy edges first.  Works as the lock argument
    of ``threading.Condition`` (bound ``acquire``/``release`` are all
    it uses), so condition waits release/re-acquire through the
    tracking too.
    """

    __slots__ = ("name", "_inner", "_reentrant")

    def __init__(self, name: str, inner, reentrant: bool):
        self.name = name
        self._inner = inner
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _enabled and blocking:
            # non-blocking probes (Condition._is_owned tests ownership
            # with acquire(False)) can't deadlock and are not ordering
            _before_acquire(self.name, id(self._inner),
                            deadlockable=(timeout < 0
                                          and not self._reentrant))
        got = self._inner.acquire(blocking, timeout)
        if got and _enabled:
            _after_acquire(self.name, id(self._inner))
        return got

    def release(self) -> None:
        self._inner.release()
        # always clean TLS, not only when enabled: a disable() between
        # acquire and release must not strand a held entry that fakes
        # hierarchy edges on this thread after the next enable()
        if getattr(_tls, "held", None):
            _after_release(self.name, id(self._inner))

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<named_lock {self.name!r} {self._inner!r}>"


def named_lock(name: str, reentrant: bool = False) -> _NamedLock:
    """A mutex that is a node named ``name`` in the lock-order graph.
    Drop-in for ``threading.Lock()`` (``reentrant=True`` for RLock)."""
    inner = threading.RLock() if reentrant else threading.Lock()
    return _NamedLock(name, inner, reentrant)


def named_condition(name: str) -> threading.Condition:
    """A ``threading.Condition`` whose underlying mutex is
    :func:`named_lock(name) <named_lock>` — waits release and
    re-acquire through the order tracking."""
    return threading.Condition(named_lock(name, reentrant=False))
