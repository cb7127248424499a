"""Logging setup (counterpart of ``paddle_tpu/utils/logger.py``).

Level: ``PADDLE_TPU_LOG_LEVEL`` in the environment at import, else INFO.
:func:`set_log_level` (``--log_level``) changes it; :func:`warn_once` logs
each distinct situation once per process; :func:`reset_warn_once`
re-arms it.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional, Set, Union

from ..analysis.lockorder import named_lock

_FMT = "%(levelname).1s %(asctime)s.%(msecs)03d %(name)s] %(message)s"
_DATEFMT = "%m%d %H:%M:%S"

_root = logging.getLogger("paddle_tpu_torch")
if not _root.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    _root.addHandler(_h)
    _level = (os.environ.get("PADDLE_TPU_LOG_LEVEL") or "info").upper()
    _root.setLevel(getattr(logging, _level, logging.INFO))
    _root.propagate = False


def get_logger(name: str = "") -> logging.Logger:
    return _root.getChild(name) if name else _root


_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "warn": logging.WARNING,
           "error": logging.ERROR, "fatal": logging.CRITICAL,
           "critical": logging.CRITICAL}


def set_log_level(level: Union[str, int]) -> None:
    """Set the framework-wide level ("debug"|"info"|"warning"|"error"|
    "fatal", or a :mod:`logging` constant); the CLI's ``--log_level``."""
    if isinstance(level, str):
        if level.strip().lower() not in _LEVELS:
            raise ValueError(f"unknown log level {level!r} "
                             f"(choose from {sorted(set(_LEVELS))})")
        level = _LEVELS[level.strip().lower()]
    _root.setLevel(level)


_warned: Set[str] = set()
_warned_lock = named_lock("logger.warn_once")


def warn_once(key: str, msg: str, *args,
              logger: Optional[logging.Logger] = None) -> bool:
    """Log ``msg % args`` as a warning the FIRST time ``key`` is seen in
    this process; later calls are no-ops.  Returns True iff it logged."""
    with _warned_lock:
        if key in _warned:
            return False
        _warned.add(key)
    (logger or _root).warning(msg, *args)
    return True


def reset_warn_once(key: Optional[str] = None) -> None:
    """Forget every warn_once key (tests) — or, with ``key``, re-arm
    just that one: a sink that RECOVERED from degradation wants its
    failure warning to fire again on the next incident, not stay
    silenced for the process lifetime."""
    with _warned_lock:
        if key is None:
            _warned.clear()
        else:
            _warned.discard(key)
