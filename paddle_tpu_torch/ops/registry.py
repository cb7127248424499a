"""The op registry (counterpart of ``paddle_tpu/ops/registry.py``).

Replaces the reference's ``OpRegistry``/``REGISTER_OP`` machinery
(``paddle/framework/op_registry.h:150-217``): an op is a plain function
on tensors, registered under its reference name and aliases.  Gradients
come from autograd through whatever the caller runs, so the reference's
hand-written ``*_grad`` kernels have no entries here.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

from ..utils.registry import Registry


@dataclasses.dataclass
class OpDef:
    name: str
    fn: Callable
    doc: str = ""
    n_outputs: int = 1

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.fn(*args, **kwargs)


OPS: Registry = Registry("op")


def register_op(name: str, *aliases: str, n_outputs: int = 1):
    """Decorator: expose a function as a named framework op."""

    def deco(fn: Callable) -> Callable:
        OPS.register_value(
            name,
            OpDef(name=name, fn=fn, doc=inspect.getdoc(fn) or "",
                  n_outputs=n_outputs),
            *aliases)
        return fn

    return deco


def get_op(name: str) -> OpDef:
    return OPS.get(name)
