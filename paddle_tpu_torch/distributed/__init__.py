"""Distributed runtime (counterpart of ``paddle_tpu/distributed``): the
gen-2 (Go master/pserver) equivalents and the multi-process launch.

- :mod:`launch`: ``PADDLE_COORDINATOR`` / ``PADDLE_NUM_NODES`` /
  ``PADDLE_NODE_ID`` → ``torch.distributed.init_process_group``, one
  process a device.
- :mod:`master`: the C++ data-task service (leases, failure re-queue,
  snapshot/recover, save-model election, PING liveness) over ctypes,
  plus a reconnecting TCP client (backoff + request replay,
  ``--master_retry_max``) — replaces ``go/master`` + etcd.
- :mod:`elastic`: preemption-tolerant checkpointed training loop —
  replaces the stateless-trainer + checkpointing pserver story
  (``doc/design/cluster_train/README.md``); recovery paths are exercised
  by fault injection (``paddle_tpu_torch/testing/fault.py``).

The parameter-server *gradient* path has no equivalent by design: the
gradients are all-reduced inside the train step (the ``Trainer`` on a
mesh).
"""

from .master import Master, MasterClient, master_reader  # noqa: F401
from .elastic import ElasticTrainer  # noqa: F401
