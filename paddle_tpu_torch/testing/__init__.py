"""Test-support utilities shipped with the package (counterpart of
``paddle_tpu/testing``).

:mod:`fault` is the chaos toolkit: deterministic fault injectors
(corrupted checkpoints and artifacts, failing saves, poisoned shards)
and SIGKILL-able child processes of the serving and rollout paths, used
by the tests to prove the recovery paths instead of assuming them.
"""

from . import fault  # noqa: F401

__all__ = ["fault"]
