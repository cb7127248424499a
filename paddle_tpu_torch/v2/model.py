"""``paddle.v2.model`` (counterpart of ``paddle_tpu/v2/model.py``):
distributed-aware checkpointing.

Reference: ``python/paddle/v2/model.py`` — ``save_model`` asks the
master which trainer should checkpoint (save-model election,
``go/master/service.go:481``) and writes ``parameters.to_tar``;
``load_model`` is the inverse.  The Kubernetes/etcd discovery is
replaced by an explicit master handle: any object with
``request_save_model(trainer_id, interval_s)`` (the JAX package's
``Master``; the port's master waits for queue A9).
"""

from __future__ import annotations

import os
import uuid
from typing import Optional

__all__ = ["save_model", "load_model", "trainer_id"]

trainer_id = str(uuid.uuid4())


def save_model(parameters, path: str, master=None,
               interval_s: float = 60.0,
               trainer: Optional[str] = None) -> Optional[str]:
    """Write ``parameters`` to ``path``; with a ``master`` handle, only
    the elected trainer writes (returns None on the losers, the written
    path on the winner).

    ``trainer`` defaults to the per-process uuid — distinct across
    trainer *processes* (the reference deployment unit); in-process
    multi-trainer callers must pass distinct ids or they all win the
    election and race on the same file."""
    tid = trainer or trainer_id
    if master is not None:
        if not master.request_save_model(tid, interval_s):
            return None
        path = os.path.join(path, tid, "model.tar")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        parameters.to_tar(f)
    return path


def load_model(parameters, path: str) -> None:
    with open(path, "rb") as f:
        loaded = parameters.from_tar(f)
    for n in loaded.names():
        parameters.set(n, loaded.get(n))
