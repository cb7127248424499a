"""``layer_math`` — arithmetic sugar over ``LayerOutput``.

Reference: ``python/paddle/trainer_config_helpers/layer_math.py`` —
unary math ops as activation-carrying mixed layers, plus operator
overloads (`+ - *` with scalars and layers) installed ON LayerOutput.
Used by the VAE demo config (``v1_api_demo/vae/vae_conf.py``) among
others; imported into the v1 config namespace as ``layer_math``.
Counterpart of ``paddle_tpu/config/layer_math.py``, the port's own copy.
"""

from __future__ import annotations

from . import dsl
from .dsl import LayerOutput
from ..utils import ConfigError

__all__ = []


def _register_unary(op_name: str, act_cls_name: str) -> None:
    act_cls = getattr(dsl, act_cls_name)

    def op(input, name=None):
        return dsl.mixed_layer(
            input=[dsl.identity_projection(input=input)], name=name,
            act=act_cls())

    op.__name__ = op_name
    globals()[op_name] = op
    __all__.append(op_name)


_register_unary("exp", "ExpActivation")
_register_unary("log", "LogActivation")
_register_unary("abs", "AbsActivation")
_register_unary("sigmoid", "SigmoidActivation")
_register_unary("tanh", "TanhActivation")
_register_unary("square", "SquareActivation")
_register_unary("relu", "ReluActivation")
_register_unary("sqrt", "SqrtActivation")
_register_unary("reciprocal", "ReciprocalActivation")


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def add(layeroutput, other):
    if _is_number(other):
        return dsl.slope_intercept_layer(input=layeroutput,
                                         intercept=float(other))
    if not isinstance(other, LayerOutput):
        raise ConfigError("LayerOutput can only be added with another "
                          "LayerOutput or a number")
    if layeroutput.size == other.size:
        return dsl.mixed_layer(input=[
            dsl.identity_projection(input=layeroutput),
            dsl.identity_projection(input=other)])
    if other.size != 1 and layeroutput.size != 1:
        raise ConfigError(
            "two LayerOutputs can be added only with equal sizes or one "
            f"size-1 operand; sizes are {layeroutput.size} and {other.size}")
    if layeroutput.size == 1:
        layeroutput, other = other, layeroutput
    other = dsl.repeat_layer(other, layeroutput.size)
    return dsl.mixed_layer(input=[
        dsl.identity_projection(input=layeroutput),
        dsl.identity_projection(input=other)])


def sub(layeroutput, other):
    if _is_number(other):
        return dsl.slope_intercept_layer(input=layeroutput,
                                         intercept=-float(other))
    if not isinstance(other, LayerOutput):
        raise ConfigError("LayerOutput can only be subtracted with "
                          "another LayerOutput or a number")
    neg = dsl.slope_intercept_layer(input=other, slope=-1.0)
    return add(layeroutput, neg)


def rsub(layeroutput, other):
    neg = dsl.slope_intercept_layer(input=layeroutput, slope=-1.0)
    return add(neg, other)


def mul(layeroutput, other):
    if _is_number(other):
        return dsl.slope_intercept_layer(input=layeroutput,
                                         slope=float(other))
    if not isinstance(other, LayerOutput):
        raise ConfigError("LayerOutput can only be multiplied with "
                          "another LayerOutput or a number")
    if layeroutput.size == 1:
        return dsl.scaling_layer(input=other, weight=layeroutput)
    if other.size == 1:
        return dsl.scaling_layer(input=layeroutput, weight=other)
    raise ConfigError("at least one operand of '*' must be a number or a "
                      "LayerOutput with size=1")


LayerOutput.__add__ = add
LayerOutput.__radd__ = add
LayerOutput.__sub__ = sub
LayerOutput.__rsub__ = rsub
LayerOutput.__mul__ = mul
LayerOutput.__rmul__ = mul
