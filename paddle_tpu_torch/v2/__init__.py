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
``device="cpu"``.  ``master.client()`` is the master's client,
``init(trainer_count=N)`` sets the ``trainer_count`` flag and
``SGD(is_local=False)`` is accepted, as in the JAX package (the
data-parallel job itself is the ``Trainer`` on a mesh:
``distributed.launch``).
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
    """v2 ``paddle.init``: each entry point's ``device`` picks the
    device (``use_gpu`` and the other keywords are accepted and unused);
    ``trainer_count`` sets its flag, as the JAX package's ``init`` does
    (one process a device: a job of N trainers is N processes,
    ``distributed.launch``)."""
    from ..utils import FLAGS

    if trainer_count:
        FLAGS.set("trainer_count", trainer_count)
