"""``paddle.v2.parameters`` (counterpart of ``paddle_tpu/v2/parameters.py``):
a numpy view of a trainer's parameters and the tar-style checkpoint.

Reference: ``python/paddle/v2/parameters.py`` (``to_tar:328`` /
``from_tar:358``).  The container is the JAX package's npz stream, so a
tar written by either package loads into the other bit for bit.

Attached to a trainer (``SGD.parameters``, or ``SGD(cost, parameters)``),
``get`` reads the trainer's tensor back as numpy and ``set`` writes a new
tensor of the stored dtype and shape on the trainer's device, so a host
array (numpy float64, say) never reaches the step as it is.  Detached,
the values live in a dict of numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils import enforce


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class Parameters:
    def __init__(self):
        self._trainer = None
        self._store: Dict[str, np.ndarray] = {}

    def attach(self, core_trainer) -> None:
        """Bind to ``core_trainer`` (a ``trainer.Trainer``); values set
        while detached are written into it first."""
        self._trainer = core_trainer
        store, self._store = self._store, {}
        for name, value in store.items():
            self.set(name, value)

    def names(self):
        if self._trainer is not None:
            return sorted(self._trainer.params)
        return sorted(self._store)

    def get(self, name: str) -> np.ndarray:
        if self._trainer is not None:
            return _host(self._trainer.params[name])
        return self._store[name]

    __getitem__ = get

    def set(self, name: str, value) -> None:
        if self._trainer is None:
            self._store[name] = _host(value)
            return
        params = self._trainer.params
        enforce(name in params,
                f"Parameters.set: the trainer has no parameter {name!r}")
        cur = params[name]
        arr = _host(value)
        enforce(tuple(arr.shape) == tuple(cur.shape),
                f"Parameters.set({name!r}): shape {tuple(arr.shape)} != "
                f"the trainer's {tuple(cur.shape)}")
        params[name] = torch.from_numpy(np.array(arr)).to(
            device=cur.device, dtype=cur.dtype)

    __setitem__ = set

    def to_tar(self, f) -> None:
        """Serialize to an npz stream (keeps the to_tar name for parity)."""
        data = {n: self.get(n) for n in self.names()}
        np.savez(f, **data)

    @staticmethod
    def from_tar(f) -> "Parameters":
        p = Parameters()
        with np.load(f) as z:
            for k in z.files:
                p._store[k] = z[k]
        return p

    def append_gradient_machine(self, *_args) -> None:  # legacy no-op
        pass
