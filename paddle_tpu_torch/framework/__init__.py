"""Next-gen framework: Program IR → Executor (counterpart of
``paddle_tpu/framework``, with the same exported names).

The reference's fluid precursor (``paddle/framework`` +
``paddle/operators`` + ``python/paddle/v2/framework``):
``ProgramDesc/BlockDesc/OpDesc/VarDesc``
(``paddle/framework/framework.proto:33-137``) become a pure-Python IR;
``Executor::Run`` (``paddle/framework/executor.cc:81``) runs a block's
ops one by one in eager torch on the executor's device (CUDA unless the
CPU is asked for: ``Executor(place="cpu")``), the ``lstm`` op through the
fused LSTM kernels where the reference's dispatch sends its shape.
"""

from .program import (Program, Block, Operator, Variable, Parameter,
                      default_main_program, default_startup_program,
                      program_guard, unique_name)
from .ops import OPS, register_op
from .executor import Executor, Scope, global_scope
from .backward import append_backward
from . import layers, initializer, optimizer, regularizer, io, nets  # noqa: F401
from .evaluator import Accuracy
