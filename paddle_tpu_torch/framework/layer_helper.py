"""LayerHelper: shared parameter/bias/activation plumbing for layer
functions (``python/paddle/v2/framework/layer_helper.py``).

Counterpart of ``paddle_tpu/framework/layer_helper.py``, the same code.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .initializer import ConstantInitializer, XavierInitializer
from .program import (Program, Variable, default_main_program,
                      default_startup_program, unique_name)


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        self.name = kwargs.get("name") or unique_name(layer_type)

    @property
    def main_program(self) -> Program:
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self) -> Program:
        return self.kwargs.get("startup_program") or \
            default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block

    def create_parameter(self, attr: Optional[Dict[str, Any]], shape,
                         dtype="float32", suffix="w",
                         initializer=None) -> Variable:
        attr = dict(attr or {})
        name = attr.get("name") or f"{self.name}.{suffix}"
        init = initializer or attr.get("initializer") or \
            (ConstantInitializer(0.0) if suffix == "b"
             else XavierInitializer())
        p = self.block.create_parameter(name, shape, dtype)
        p.optimize_attr = {"learning_rate": attr.get("learning_rate", 1.0)}
        p.regularizer = attr.get("regularizer")
        # startup program owns initialization (reference behavior)
        sp = self.startup_program.global_block
        sv = sp.create_parameter(name, shape, dtype)
        init(sv, sp)
        return p

    def create_tmp_variable(self, dtype="float32", shape=()) -> Variable:
        return self.block.create_var(
            name=unique_name(f"{self.name}.tmp"), dtype=dtype, shape=shape)

    def append_bias_op(self, input_var: Variable, dim_start=1,
                       bias_attr=None) -> Variable:
        size = input_var.shape[-1] if input_var.shape else 0
        b = self.create_parameter(bias_attr if isinstance(bias_attr, dict)
                                  else None,
                                  shape=(size,), suffix="b",
                                  initializer=ConstantInitializer(0.0))
        out = self.create_tmp_variable(input_var.dtype, input_var.shape)
        self.block.append_op("elementwise_add",
                             inputs={"X": [input_var], "Y": [b]},
                             outputs={"Out": [out]})
        return out

    def append_activation(self, input_var: Variable,
                          act: Optional[str]) -> Variable:
        if not act:
            return input_var
        out = self.create_tmp_variable(input_var.dtype, input_var.shape)
        self.block.append_op(act, inputs={"X": [input_var]},
                             outputs={"Out": [out]})
        return out
