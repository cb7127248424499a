"""Program IR: Program / Block / Operator / Variable (counterpart of
``paddle_tpu/framework/program.py``, the same pure-Python code).

Mirrors ``paddle/framework/framework.proto`` (``OpDesc:33``, ``VarDesc:112``,
``BlockDesc:127``, ``ProgramDesc:137``) and the Python wrappers in
``python/paddle/v2/framework/framework.py`` — but as plain dataclasses: the
IR never crosses a language boundary here, the Executor consumes it directly.

Blocks nest (``parent_idx``) exactly like the reference so control-flow ops
(recurrent, cond) own sub-blocks; the Executor runs a sub-block as the body
of a Python loop over time (recurrent) or of the branch it takes (cond).

Variable names come from this module's own ``unique_name`` counter, so a
program built here and the same program built by the JAX package in one
process carry different generated names; pair their parameters by
:meth:`Program.parameters` order
(``paddle_tpu_torch.utils.jax_interop.framework_scope_from_jax``).
"""

from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from ..utils import ConfigError

_name_counter = itertools.count()


def unique_name(prefix: str) -> str:
    return f"{prefix}_{next(_name_counter)}"


@dataclass
class Variable:
    """``VarDesc`` equivalent. ``persistable`` vars live in the Scope across
    runs (parameters, optimizer state); non-persistable vars are SSA values
    inside the traced computation."""

    name: str
    shape: tuple = ()
    dtype: str = "float32"
    persistable: bool = False
    lod_level: int = 0           # sequence nesting (LoD), kept for parity
    initializer: Optional[Dict[str, Any]] = None
    trainable: bool = True
    optimize_attr: Dict[str, Any] = field(default_factory=dict)
    regularizer: Optional[Any] = None
    stop_gradient: bool = False
    block: Optional["Block"] = None

    def __repr__(self):
        return f"Var({self.name}, {self.shape}, {self.dtype})"


class Parameter(Variable):
    """Persistable + trainable variable (``framework.py`` Parameter)."""

    def __init__(self, name, shape, dtype="float32", **kw):
        super().__init__(name=name, shape=tuple(shape), dtype=dtype,
                         persistable=True, **kw)


@dataclass
class Operator:
    """``OpDesc`` equivalent: type + name-keyed input/output var lists."""

    type: str
    inputs: Dict[str, List[str]]
    outputs: Dict[str, List[str]]
    attrs: Dict[str, Any] = field(default_factory=dict)

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def __repr__(self):
        return f"Op({self.type})"


class Block:
    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent(self) -> Optional["Block"]:
        return (self.program.blocks[self.parent_idx]
                if self.parent_idx >= 0 else None)

    def var(self, name: str) -> Variable:
        """Lookup through parent chain (scope nesting, ``scope.h:38``)."""
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        raise ConfigError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except ConfigError:
            return False

    def create_var(self, name: Optional[str] = None, **kw) -> Variable:
        name = name or unique_name("tmp")
        v = Variable(name=name, block=self, **kw)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype="float32",
                         **kw) -> Parameter:
        p = Parameter(name, shape, dtype, **kw)
        p.block = self
        self.vars[name] = p
        # parameters are global — also visible from the root block
        self.program.blocks[0].vars.setdefault(name, p)
        return p

    def append_op(self, type: str, inputs: Dict[str, Sequence] = None,
                  outputs: Dict[str, Sequence] = None,
                  attrs: Dict[str, Any] = None) -> Operator:
        def names(d):
            out = {}
            for k, vs in (d or {}).items():
                if not isinstance(vs, (list, tuple)):
                    vs = [vs]
                out[k] = [v.name if isinstance(v, Variable) else v
                          for v in vs]
            return out

        op = Operator(type=type, inputs=names(inputs), outputs=names(outputs),
                      attrs=dict(attrs or {}))
        self.ops.append(op)
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]


class Program:
    """``ProgramDesc``: a list of blocks; block 0 is global."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current = 0
        self.seed = 0

    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    @property
    def current_block(self) -> Block:
        return self.blocks[self._current]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        b = Block(self, len(self.blocks),
                  self._current if parent_idx is None else parent_idx)
        self.blocks.append(b)
        return b

    @contextlib.contextmanager
    def block_guard(self, block: Block):
        old = self._current
        self._current = block.idx
        try:
            yield block
        finally:
            self._current = old

    def parameters(self) -> List[Parameter]:
        seen, out = set(), []
        for b in self.blocks:
            for v in b.vars.values():
                if isinstance(v, Parameter) and v.name not in seen:
                    seen.add(v.name)
                    out.append(v)
        return out

    def prune(self, targets: Sequence[str]) -> "Program":
        """Dead-op elimination (``paddle/framework/prune.cc``): keep only ops
        in block 0 whose outputs (transitively) reach ``targets``."""
        needed = set(targets)
        kept: List[Operator] = []
        for op in reversed(self.global_block.ops):
            if any(o in needed for outs in op.outputs.values()
                   for o in outs):
                kept.append(op)
                for ins in op.inputs.values():
                    needed.update(ins)
        pruned = Program()
        pruned.blocks = list(self.blocks)
        import copy
        pruned.blocks[0] = copy.copy(self.global_block)
        pruned.blocks[0].program = pruned
        pruned.blocks[0].ops = list(reversed(kept))
        return pruned


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main: Program, startup: Optional[Program] = None):
    global _main_program, _startup_program
    old_m, old_s = _main_program, _startup_program
    _main_program = main
    if startup is not None:
        _startup_program = startup
    try:
        yield
    finally:
        _main_program, _startup_program = old_m, old_s
