"""``paddle.v2.master`` (counterpart of ``paddle_tpu/v2/master.py``).

Reference: ``python/paddle/v2/master/client.py`` — a ctypes client for
the Go master.  Here the master is the in-tree C++ service
(``native/master/master.cc``); ``client(addr)`` returns a TCP
:class:`~paddle_tpu_torch.distributed.MasterClient` speaking its line
protocol, or an in-process :class:`~paddle_tpu_torch.distributed.Master`
when ``addr`` is None (no etcd — addresses are explicit).
"""

from __future__ import annotations

from typing import Optional

from ..distributed.master import Master, MasterClient


def client(addr: Optional[str] = None, timeout_sec: float = 5.0,
           buf_size: int = 0):
    """The reference signature is ``client(etcd_endpoints, timeout_sec,
    buf_size)``; etcd endpoints are replaced by the master's host:port.
    ``buf_size`` is unused — buffering lives in the reader combinators
    (``buffered()``), not the client."""
    if addr is None:
        # timeout_sec is a CONNECTION timeout in the reference API; the
        # in-process master's lease timeout keeps its own default (60s,
        # go/master/service.go task re-dispatch semantics)
        return Master(timeout_s=60.0, failure_max=3)
    return MasterClient(addr, timeout=timeout_sec)
