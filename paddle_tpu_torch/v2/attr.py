"""``paddle.v2.attr`` (counterpart of ``paddle_tpu/v2/attr.py``): the
DSL's parameter, extra-layer and hook attributes under their v2 names."""

from ..config.dsl import ExtraAttr, HookAttr, HookAttribute, ParamAttr  # noqa: F401

Param = ParamAttr
Extra = ExtraAttr
Hook = HookAttribute
ParameterAttribute = ParamAttr
ExtraLayerAttribute = ExtraAttr
