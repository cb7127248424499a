"""Backward "transpiler" — autodiff-native (counterpart of
``paddle_tpu/framework/backward.py``).

The reference walks the op list appending hand-written grad ops and
sum-merging duplicate gradients (``paddle/framework/backward.cc:336,382``).
Here ``append_backward`` plants a single ``backward`` marker op; the
Executor runs everything before it with autograd recording and takes
``torch.autograd.grad`` of the summed loss with respect to the named
parameters, emitting ``<param>@GRAD`` values for the optimizer ops that
follow.  Grad accumulation for shared parameters is what autograd does
natively (the reference needed explicit sum-merge).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..utils import enforce
from .program import Program, Variable, default_main_program


def grad_var_name(name: str) -> str:
    return name + "@GRAD"


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence[str]] = None,
                    no_grad_set: Optional[set] = None,
                    program: Optional[Program] = None
                    ) -> List[tuple]:
    """Append the backward pass for ``loss``; returns
    ``[(param_var, grad_var), ...]`` like the reference's
    ``append_backward_ops`` (``python/paddle/v2/framework/backward.py``)."""
    program = program or default_main_program()
    block = program.global_block
    no_grad = set(no_grad_set or ())

    if parameter_list:
        pnames = list(parameter_list)
    else:
        pnames = [p.name for p in program.parameters()
                  if p.trainable and p.name not in no_grad]
    enforce(len(pnames) > 0, "no trainable parameters to differentiate")

    grads = []
    for n in pnames:
        gv = block.create_var(name=grad_var_name(n),
                              shape=block.var(n).shape,
                              dtype=block.var(n).dtype)
        grads.append((block.var(n), gv))

    block.append_op(
        type="backward",
        inputs={"Loss": [loss]},
        outputs={"Grads": [g for _, g in grads]},
        attrs={"parameter_names": pnames, "loss": loss.name})
    return grads
