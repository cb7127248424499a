"""Executor: run a Program block on the device, op by op (counterpart of
``paddle_tpu/framework/executor.py``).

The reference ``Executor::Run`` (``paddle/framework/executor.cc:81``)
creates variables then interprets ops one-by-one, each dispatching an
OpKernel by {DataType, Place} (``operator.h:349``).  The JAX package
traces the whole block into one jitted XLA computation.  This port runs
the block **eagerly**: each op adapter (:mod:`.ops`) is called in order
on tensors on the executor's device, and each launches its own kernels.
No ``torch.compile`` and no CUDA graph: the host's time per op is part
of a step here, and a chip run reads it beside the trainer's step on the
same model.

``backward`` (:func:`.backward.append_backward`): the ops before it run
with autograd recording from the named parameters (detached copies of
the scope's values that require grad); their gradients are
``torch.autograd.grad`` of ``sum(loss)``, ``allow_unused=True``, and a
parameter the loss does not reach gets zeros, as ``jax.value_and_grad``
gives.  The ops after it (optimizer and regularizer ops) run under
``torch.no_grad()``.  Every persistable written back to the scope is
detached, so no run keeps the previous run's graph alive.

Control flow recurses into sub-blocks as the reference does
(``RecurrentOp``/``CondOp`` own child scopes,
``operators/recurrent_op.cc``): ``recurrent`` (StaticRNN) is a Python
loop over T whose step outputs stack on axis 1, and ``cond`` a Python
branch on ``bool((pred > 0).all())``, which on the card waits for the
predicate: one host sync per ``cond`` op.  The collectives are the
identity on one device, as in the JAX package.

``place`` is the device: ``None`` means CUDA and raises without a CUDA
device (:func:`~paddle_tpu_torch.core.device.resolve_device`); the CPU
runs when asked for (``place="cpu"``).  Feeds go to the device by a
pinned, non-blocking copy.  Integer feeds keep their dtype (the JAX
package narrows int64 to int32); float64 feeds become float32, as the
JAX package's do.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.sequence import SequenceBatch, value_of
from ..trainer.trainer import _to_device
from ..utils import ConfigError, enforce
from .ops import OPS, OpContext
from .program import Block, Operator, Program, Variable

# ops the executor handles itself (not in the OPS registry)
_CONTROL = {"feed", "fetch", "recurrent", "dynamic_recurrent", "cond",
            "rnn_memory_helper", "rnn_memory_helper_grad",
            "save", "load", "backward",
            "ncclInit", "ncclAllReduce", "ncclBcast", "ncclReduce"}


class Scope:
    """name → value store for persistable variables (``scope.h:38``)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def find(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def set(self, name: str, value) -> None:
        self.vars[name] = value

    def has(self, name: str) -> bool:
        return self.find(name) is not None


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


class _Trace:
    """One pass over a block's ops: values flow through the op adapters."""

    def __init__(self, block: Block, ctx: OpContext, values: Dict[str, Any]):
        self.block = block
        self.ctx = ctx
        self.values = values
        self.written_persistables: Dict[str, Any] = {}

    def get(self, name: str):
        if name in self.values:
            return self.values[name]
        raise ConfigError(
            f"op input {name!r} has no value (missing feed or init?)")

    def run_op(self, op: Operator) -> None:
        if op.type in _CONTROL:
            self._run_control(op)
            return
        fn = OPS.get(op.type)
        if fn is None:
            raise ConfigError(f"unregistered op type {op.type!r}")
        ins = {slot: [self.get(n) for n in names]
               for slot, names in op.inputs.items() if names}
        outs = fn(self.ctx, ins, op.attrs)
        for slot, names in op.outputs.items():
            vals = outs.get(slot, [])
            for i, name in enumerate(names):
                if i < len(vals) and name:
                    self._write(name, vals[i])

    def _write(self, name: str, value) -> None:
        self.values[name] = value
        try:
            var = self.block.var(name)
            if var.persistable:
                self.written_persistables[name] = value
        except ConfigError:
            pass

    def _run_control(self, op: Operator) -> None:
        t = op.type
        if t in ("rnn_memory_helper", "rnn_memory_helper_grad"):
            src = op.input("X")[0]
            self._write(op.output("Out")[0], self.get(src))
        elif t in ("ncclInit",):
            pass  # one device: no communicator to bootstrap
        elif t in ("ncclAllReduce", "ncclReduce", "ncclBcast"):
            # the identity on one device's replicated value
            for ni, no in zip(op.input("X"), op.output("Out")):
                self._write(no, self.get(ni))
        elif t == "recurrent":
            self._run_recurrent(op)
        elif t == "cond":
            self._run_cond(op)
        elif t in ("feed", "fetch", "save", "load", "backward"):
            raise ConfigError(f"{t} op must be handled by Executor.run")
        else:
            raise ConfigError(f"unhandled control op {t!r}")

    # ---- recurrent: the sub-block once per timestep ---------------------
    def _run_recurrent(self, op: Operator) -> None:
        """StaticRNN semantics (``operators/recurrent_op.cc``): sequence
        inputs [B, T, D] are stepped over T; memories (ex-state → state)
        carry across steps; step outputs stack back to [B, T, D].

        Every step's ops draw with the same op counters, as the JAX
        package's ``lax.scan`` traces its body once: a random op inside
        the step draws the same values at every step."""
        sub = self.block.program.blocks[op.attrs["sub_block"]]
        seq_ins = op.input("inputs")          # outer seq vars
        inner_ins = op.attrs["inner_inputs"]  # inner per-step names
        init_states = op.input("initial_states")
        state_names = op.attrs["states"]          # inner state (output) name
        ex_state_names = op.attrs["ex_states"]    # inner memory (input) name
        out_names = op.output("outputs")
        inner_outs = op.attrs["inner_outputs"]

        seqs = [self.get(n) for n in seq_ins]
        lengths = next((s.length for s in seqs
                        if isinstance(s, SequenceBatch)), None)
        xs = [value_of(s) for s in seqs]      # [B, T, D]
        carry = [self.get(n) for n in init_states]
        captured = dict(self.values)          # outer values visible inside
        n0 = self.ctx._n
        steps = []
        for t in range(xs[0].shape[1]):
            self.ctx._n = n0
            vals = dict(captured)
            for name, v in zip(ex_state_names, carry):
                vals[name] = v
            for name, x in zip(inner_ins, xs):
                vals[name] = x[:, t]
            tr = _Trace(sub, self.ctx, vals)
            for sop in sub.ops:
                tr.run_op(sop)
            carry = [vals[n] for n in state_names]
            steps.append([vals[n] for n in inner_outs])
        for i, name in enumerate(out_names):
            y = torch.stack([outs[i] for outs in steps], 1)   # [B, T, D]
            self._write(name, SequenceBatch(y, lengths)
                        if lengths is not None else y)

    def _run_cond(self, op: Operator) -> None:
        """``cond_op.cc``: pred selects between two sub-blocks with the
        same output signature; the branch is chosen on the host."""
        pred = value_of(self.get(op.input("Cond")[0]))
        blk = self.block.program.blocks[
            op.attrs["true_block"] if bool((pred > 0).all())
            else op.attrs["false_block"]]
        vals = dict(self.values)
        tr = _Trace(blk, self.ctx, vals)
        for sop in blk.ops:
            tr.run_op(sop)
        for name in op.output("Out"):
            self._write(name, vals[name])


class Executor:
    """``Executor(place)``: runs a program's global block on ``place``
    (``None``: CUDA, raising without it; ``"cpu"`` when asked for)."""

    def __init__(self, place=None):
        self.place = resolve_device(place)
        self._run_count = 0

    # ------------------------------------------------------------- run
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Sequence = (),
            scope: Optional[Scope] = None,
            is_test: bool = False,
            seed: int = 0,
            return_numpy: bool = True) -> List[Any]:
        from .program import default_main_program
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = dict(feed or {})
        block = program.global_block

        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in fetch_list]

        # host-side load ops first, save ops after compute
        compute_ops, save_ops = [], []
        for op in block.ops:
            if op.type == "load":
                _host_load(op, scope, self.place)
            elif op.type == "save":
                save_ops.append(op)
            elif op.type == "feed":
                pass  # feed dict supersedes feed ops
            elif op.type == "fetch":
                for n in op.input("X"):
                    if n not in fetch_names:
                        fetch_names.append(n)
            else:
                compute_ops.append(op)

        # persistables the ops read or write
        init: Dict[str, Any] = {}
        for b in program.blocks:
            for name, var in b.vars.items():
                if var.persistable and scope.has(name):
                    init[name] = _place(scope.find(name), self.place)
        init.update({k: _place(v, self.place) for k, v in feed.items()})

        # the run counter goes into the seed so dropout and random ops
        # draw fresh values every batch even with the default seed
        self._run_count += 1
        ctx = OpContext(is_test=is_test, seed=seed, run=self._run_count,
                        device=self.place)
        values, written = self._run_ops(block, compute_ops, ctx, init)
        for name, v in written.items():
            scope.set(name, _detached(v))
        fetches = [_detached(values[n]) for n in fetch_names]
        for op in save_ops:
            _host_save(op, scope)
        if return_numpy:
            return [_host_array(f) for f in fetches]
        return fetches

    @staticmethod
    def _run_ops(block: Block, ops: List[Operator], ctx: OpContext,
                 init: Dict[str, Any]):
        """(values, written persistables) after ``ops``."""
        bi = next((i for i, op in enumerate(ops)
                   if op.type == "backward"), None)
        if bi is None:
            with torch.no_grad():
                tr = _Trace(block, ctx, dict(init))
                for op in ops:
                    tr.run_op(op)
            return tr.values, tr.written_persistables
        bop = ops[bi]
        pnames = [n for n in bop.attrs["parameter_names"] if n in init]
        params = {n: init[n].detach().requires_grad_(True) for n in pnames}
        values = dict(init)
        values.update(params)
        with torch.enable_grad():
            fwd = _Trace(block, ctx, values)
            for op in ops[:bi]:
                fwd.run_op(op)
            loss = torch.sum(value_of(values[bop.attrs["loss"]]))
            grads = torch.autograd.grad(
                loss, list(params.values()), allow_unused=True) \
                if loss.requires_grad else [None] * len(params)
        for (n, p), g in zip(params.items(), grads):
            values[n + "@GRAD"] = torch.zeros_like(p) if g is None else g
        with torch.no_grad():
            tr = _Trace(block, ctx, values)
            tr.written_persistables.update(fwd.written_persistables)
            for op in ops[bi + 1:]:
                tr.run_op(op)
        return values, tr.written_persistables


def _place(v, dev: torch.device):
    """A feed or scope value (tensor, numpy array, number or
    SequenceBatch) as tensors on ``dev``; float64 becomes float32."""
    if isinstance(v, SequenceBatch):
        return SequenceBatch(_place(v.data, dev), _place(v.length, dev))
    t = torch.as_tensor(v)
    if t.dtype == torch.float64:
        t = t.float()
    return _to_device(t, dev)


def _detached(v):
    if isinstance(v, SequenceBatch):
        return SequenceBatch(v.data.detach(), v.length)
    return v.detach() if isinstance(v, torch.Tensor) else v


def _host_array(v) -> np.ndarray:
    v = value_of(v)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _host_save(op: Operator, scope: Scope) -> None:
    # save_op.cc equivalent; npz (not pickle) so loading an untrusted
    # checkpoint cannot execute code
    path = op.attrs["file_path"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = {n: _host_array(scope.find(n)) for n in op.input("X")}
    with open(path, "wb") as f:
        np.savez(f, **data)


def _host_load(op: Operator, scope: Scope, dev: torch.device) -> None:
    path = op.attrs["file_path"]
    with np.load(path) as data:
        for n in op.output("Out"):
            enforce(n in data, f"checkpoint {path} lacks variable {n!r}")
            scope.set(n, torch.from_numpy(data[n]).to(dev))
