"""The v2-API namespace (counterpart of ``paddle_tpu/v2``).

Mirrors ``python/paddle/v2``'s module layout so reference user code runs
with an import swap (or unchanged, through ``compat.install()``'s
``paddle.v2`` alias): ``layer``, ``activation``, ``pooling``, ``attr``,
``data_type``, ``optimizer``, ``trainer`` (``SGD`` over the port's
``Trainer``), ``event``, ``dataset`` (cached corpora or synthetic
surrogates; never a download), ``reader``, ``networks``, ``evaluator``,
``inference`` (``infer``), ``parameters`` (``Parameters``, npz tars the
JAX package reads too), ``model``, ``topology``, ``image``, ``plot`` and
``master``.  ``SGD`` and ``infer`` run on CUDA unless given
``device="cpu"``.  What waits for queue A9 refuses by name:
``master.client()``, ``init(trainer_count > 1)``, ``SGD(is_local=False)``
and ``reader.cloud_reader``.
"""

from . import activation, attr, data_type, dataset, evaluator, event
from . import image, inference, layer, master, model, networks, optimizer
from . import plot, pooling, reader, topology, trainer
from . import parameters
from .inference import infer
from .parameters import Parameters
from .reader import batch  # paddle.batch (v2/minibatch.py alias)

__all__ = [
    "activation", "attr", "data_type", "dataset", "evaluator", "event",
    "image", "inference", "infer", "layer", "master", "model", "networks",
    "optimizer", "parameters", "plot", "pooling", "reader", "topology",
    "trainer", "Parameters", "batch", "init",
]


def init(use_gpu: bool = False, trainer_count: int = 1, **kwargs) -> None:
    """v2 ``paddle.init``: the port runs on one card, chosen by each
    entry point's ``device`` (``use_gpu`` and the other keywords are
    accepted and unused); ``trainer_count`` > 1 refuses by name, the
    multi-trainer flag waits for queue A9."""
    from ..utils import PaddleTpuError

    if trainer_count and trainer_count > 1:
        raise PaddleTpuError(
            f"v2.init(trainer_count={trainer_count}): more than one "
            "trainer is not ported yet (queue A9)")
