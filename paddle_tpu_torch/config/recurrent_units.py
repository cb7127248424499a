"""v1 ``recurrent_units`` helpers.

Reference: ``python/paddle/trainer/recurrent_units.py`` — config-parser-
level LSTM/GRU step builders usable inside recurrent groups, with
``para_prefix``-controlled parameter names so two units with the same
prefix share weights.  Bodies are re-expressed over this package's DSL
primitives (mixed projections + lstm_step/gru_step + memory); the
``*Naive`` variants, which the reference expands into per-gate mixed
layers purely as a CPU-kernel workaround, map to the same fused step,
whose math is the naive form's.  (Counterpart of
``paddle_tpu/config/recurrent_units.py``, the port's own copy.)
"""

from __future__ import annotations

from typing import List, Optional

from . import dsl
from .dsl import (
    ParamAttr,
    StepInput,
    full_matrix_projection,
    identity_projection,
    memory,
    mixed,
    recurrent_group,
)

__all__ = [
    "LstmRecurrentUnit", "LstmRecurrentUnitNaive",
    "LstmRecurrentLayerGroup", "GatedRecurrentUnit",
    "GatedRecurrentUnitNaive", "GatedRecurrentLayerGroup",
]


def LstmRecurrentUnit(name: str, size: int, active_type: str,
                      state_active_type: str, gate_active_type: str,
                      inputs: List, para_prefix: Optional[str] = None,
                      error_clipping_threshold: float = 0,
                      out_memory=None):
    """One LSTM step (``recurrent_units.py:35``): gates = Σ inputs +
    W·h_prev (+ bias), fed with the previous cell state."""
    if para_prefix is None:
        para_prefix = name
    if out_memory is None:
        out_memory = memory(name=name, size=size)
    state_memory = memory(name=f"{name}.state", size=size)
    gates = mixed(
        list(inputs) + [full_matrix_projection(
            out_memory.out if hasattr(out_memory, "out") else out_memory,
            size=size * 4,
            param_attr=ParamAttr(name=para_prefix + "_input_recurrent.w"))],
        size=size * 4, name=f"{name}_input_recurrent",
        bias_attr=ParamAttr(name=para_prefix + "_input_recurrent.b",
                            initial_std=0),
        layer_attr=dsl.ExtraAttr(
            error_clipping_threshold=error_clipping_threshold))
    out = dsl.lstm_step_layer(
        gates, state_memory.out, size=size, name=name,
        act=active_type, gate_act=gate_active_type,
        state_act=state_active_type,
        bias_attr=ParamAttr(name=para_prefix + "_check.b"))
    # the reference exposes the cell state as a named layer
    # (GetOutputLayer '{name}_state', recurrent_units.py:72) so configs
    # can consume it by name
    dsl.get_output_layer(out, "state", name=f"{name}_state")
    return out


# the reference's Naive variant exists only to avoid the fused CUDA
# kernel on CPU; the math is identical
LstmRecurrentUnitNaive = LstmRecurrentUnit


def LstmRecurrentLayerGroup(name: str, size: int, active_type: str,
                            state_active_type: str, gate_active_type: str,
                            inputs: List,
                            para_prefix: Optional[str] = None,
                            error_clipping_threshold: float = 0,
                            seq_reversed: bool = False):
    """LSTM over a sequence as a recurrent group
    (``recurrent_units.py:159``); ``inputs`` are projections of the
    sequence layer."""
    transformed = mixed(list(inputs), size=size * 4,
                        name=f"{name}_transform_input", bias_attr=False)

    def step(ipt):
        return LstmRecurrentUnit(
            name=name, size=size, active_type=active_type,
            state_active_type=state_active_type,
            gate_active_type=gate_active_type,
            inputs=[identity_projection(ipt)], para_prefix=para_prefix,
            error_clipping_threshold=error_clipping_threshold)

    return recurrent_group(step, [StepInput(transformed)],
                           name=f"{name}_layer_group",
                           reverse=seq_reversed)


def GatedRecurrentUnit(name: str, size: int, active_type: str,
                       gate_active_type: str, inputs,
                       para_prefix: Optional[str] = None,
                       error_clipping_threshold: float = 0,
                       out_memory=None):
    """One GRU step (``recurrent_units.py:205``); ``inputs`` is either a
    3H-projected step layer (group use) or a list of projections."""
    if para_prefix is None:
        para_prefix = name
    if isinstance(inputs, dsl.LayerOutput):
        projected = inputs
    else:
        projected = mixed(list(inputs), size=size * 3,
                          name=f"{name}_transform_input", bias_attr=False,
                          layer_attr=dsl.ExtraAttr(
                              error_clipping_threshold=error_clipping_threshold))
    if out_memory is None:
        out_memory = memory(name=name, size=size)
    return dsl.gru_step_layer(
        projected,
        out_memory.out if hasattr(out_memory, "out") else out_memory,
        size=size, name=name, act=active_type,
        gate_act=gate_active_type,
        param_attr=ParamAttr(name=para_prefix + "_gate.w"),
        bias_attr=ParamAttr(name=para_prefix + "_gate.b"),
        layer_attr=dsl.ExtraAttr(
            error_clipping_threshold=error_clipping_threshold))


GatedRecurrentUnitNaive = GatedRecurrentUnit


def GatedRecurrentLayerGroup(name: str, size: int, active_type: str,
                             gate_active_type: str, inputs: List,
                             para_prefix: Optional[str] = None,
                             error_clipping_threshold: float = 0,
                             seq_reversed: bool = False):
    """GRU over a sequence as a recurrent group — equivalent to
    ``GatedRecurrentLayer`` (``recurrent_units.py:300``)."""
    transformed = mixed(list(inputs), size=size * 3,
                        name=f"{name}_transform_input", bias_attr=False)

    def step(ipt):
        return GatedRecurrentUnit(
            name=name, size=size, active_type=active_type,
            gate_active_type=gate_active_type, inputs=ipt,
            para_prefix=para_prefix,
            error_clipping_threshold=error_clipping_threshold)

    return recurrent_group(step, [StepInput(transformed)],
                           name=f"{name}_layer_group",
                           reverse=seq_reversed)
