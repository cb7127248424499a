"""``paddle.v2.master`` (counterpart of ``paddle_tpu/v2/master.py``).

Reference: ``python/paddle/v2/master/client.py`` — a client of the
master that leases dataset chunks to trainers.  The JAX package's client
speaks to its in-tree master service (``paddle_tpu/distributed``); the
port's distributed code waits for queue A9, so :func:`client` refuses by
name.  The module exists so that ``paddle.v2.master`` imports, as the
era's scripts expect.
"""

from __future__ import annotations

from typing import Optional

from ..utils import PaddleTpuError


def client(addr: Optional[str] = None, timeout_sec: float = 5.0,
           buf_size: int = 0):
    """The JAX signature (``addr`` a master's host:port, or None for an
    in-process master); refuses: the master is not ported yet (A9)."""
    raise PaddleTpuError(
        "v2.master.client: the master (paddle_tpu/distributed) is not "
        "ported yet (queue A9)")
