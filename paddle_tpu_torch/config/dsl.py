"""Layer-construction DSL → ModelConfig compiler (counterpart of
``paddle_tpu/config/dsl.py``, the port's own copy: the same functions,
names, defaults and naming counter, so the same calls give the same
``ModelConfig.to_json()`` text in both packages).

Port of the v1/v2 user API surface: ``trainer_config_helpers/layers.py``
(131 layer functions compiled by ``config_parser.py``) and
``python/paddle/v2/layer.py`` (same functions as graph nodes).  Functions
here append :class:`LayerConfig` records to the active collector and return
:class:`LayerOutput` handles; ``topology(outputs)`` extracts the reachable
subgraph as a ModelConfig — the ``Topology.proto()`` equivalent
(``v2/topology.py:95``).

Naming parity: each function matches the reference DSL name (fc_layer is
``fc``, img_conv_layer is ``img_conv``, etc. — the v2 names, which drop the
``_layer`` suffix; v1 aliases are exported too).

A config is data: every layer-building function is here, and the
port's ``NeuralNetwork`` builds every one of the reference's 110 layer
types (projections and ``mixed``, generating groups and
``beam_search``, detection, 3-D, CRF and CTC included).  A type name no
package registers refuses by name when ``NeuralNetwork`` builds it
(``layers/base.get_layer_class``).  :meth:`LayerType.is_layer_type`
answers against the port's layer registry, which holds the same names
as the reference's.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from ..utils import ConfigError, enforce
from .model_config import (
    LayerConfig,
    LayerInput,
    ModelConfig,
    OptimizationConfig,
    ParameterConfig,
    ProjConfig,
    SubModelConfig,
)

# ----------------------------------------------------------- activations


class Activation:
    name = "linear"

    def __init__(self, name: Optional[str] = None):
        if name is not None:
            self.name = name


def _act_cls(act_name: str):
    return type(act_name.title().replace("_", "") + "Activation",
                (Activation,), {"name": act_name})


LinearActivation = _act_cls("")
ReluActivation = _act_cls("relu")
BReluActivation = _act_cls("brelu")
SigmoidActivation = _act_cls("sigmoid")
TanhActivation = _act_cls("tanh")
STanhActivation = _act_cls("stanh")
SoftmaxActivation = _act_cls("softmax")
SequenceSoftmaxActivation = _act_cls("sequence_softmax")
ExpActivation = _act_cls("exp")
LogActivation = _act_cls("log")
SquareActivation = _act_cls("square")
SqrtActivation = _act_cls("sqrt")
ReciprocalActivation = _act_cls("reciprocal")
AbsActivation = _act_cls("abs")
SoftReluActivation = _act_cls("soft_relu")


def _act_name(act) -> str:
    if act is None:
        return ""
    if isinstance(act, str):
        return act
    return act.name


# ------------------------------------------------------------ attributes


@dataclass
class HookAttribute:
    """``attrs.py`` HookAttribute — parameter updater hook spec.

    ``HookAttribute('pruning', sparsity_ratio=0.6)`` attaches the static
    pruning hook (``ParameterUpdaterHook.cpp:39`` StaticPruningHook): at
    init the smallest ``sparsity_ratio`` fraction of |w| is zeroed and the
    mask is applied to every subsequent gradient.
    """

    type: str = "pruning"
    sparsity_ratio: Optional[float] = 0.6

    def as_dict(self) -> Dict[str, Any]:
        enforce(self.type == "pruning",
                f"unknown parameter hook type {self.type!r}")
        if self.sparsity_ratio is not None:
            enforce(0.0 <= self.sparsity_ratio <= 1.0,
                    "sparsity_ratio must be in [0, 1]")
        return {"type": self.type, "sparsity_ratio": self.sparsity_ratio}


HookAttr = HookAttribute


@dataclass
class ParamAttr:
    """``attrs.py`` ParameterAttribute."""

    name: Optional[str] = None
    initial_mean: float = 0.0
    initial_std: Optional[float] = None
    learning_rate: float = 1.0
    momentum: float = 0.0
    l1_rate: float = 0.0
    l2_rate: float = 0.0
    is_static: bool = False
    sparse_update: bool = False
    initial_smart: bool = True
    update_hooks: Optional[Any] = None  # HookAttribute or list thereof


@dataclass
class ExtraAttr:
    """ExtraLayerAttribute: drop_rate, device (→ sharding hint),
    error_clipping_threshold (backward error clip)."""

    drop_rate: float = 0.0
    device: int = -1
    error_clipping_threshold: float = 0.0


# -------------------------------------------------------------- pooling


class BasePoolingType:
    name = "average"


class MaxPooling(BasePoolingType):
    name = "max"


class AvgPooling(BasePoolingType):
    name = "average"


class SumPooling(BasePoolingType):
    name = "sum"


class SqrtPooling(BasePoolingType):
    name = "sqrt"


# -------------------------------------------------------- the collector


class ConfigCollector(threading.local):
    def __init__(self):
        self.reset()

    def reset(self):
        self.layers: List[LayerConfig] = []
        self.by_name: Dict[str, LayerConfig] = {}
        self.parameters: List[ParameterConfig] = []
        self.sub_models: List[SubModelConfig] = []
        self.evaluators: List[Dict[str, Any]] = []
        self.counter = 0
        self.group_stack: List[SubModelConfig] = []
        # explicit input order from inputs() — empty means derive from
        # data layers in topological order
        self.declared_inputs: List[str] = []

    def unique_name(self, prefix: str) -> str:
        self.counter += 1
        return f"__{prefix}_{self.counter}__"

    def add(self, conf: LayerConfig) -> LayerConfig:
        if conf.name in self.by_name:
            raise ConfigError(f"duplicate layer name {conf.name!r}")
        self.layers.append(conf)
        self.by_name[conf.name] = conf
        if self.group_stack:
            self.group_stack[-1].layer_names.append(conf.name)
        return conf


_collector = ConfigCollector()


def reset_config() -> None:
    _collector.reset()


@dataclass
class LayerOutput:
    """Handle returned by every DSL function (v2 graph node)."""

    name: str
    layer_type: str
    size: int = 0
    # extra outputs (e.g. lstm step state) addressable as name.suffix
    parents: List["LayerOutput"] = field(default_factory=list)

    def __repr__(self):
        return f"LayerOutput({self.name}, {self.layer_type}, size={self.size})"


Input = Union[LayerOutput, Sequence[LayerOutput]]


def _as_list(x) -> List[LayerOutput]:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _mk_inputs(inputs: List[LayerOutput],
               param_attrs: Optional[List[Optional[ParamAttr]]] = None,
               projs: Optional[List[Optional[ProjConfig]]] = None
               ) -> List[LayerInput]:
    out = []
    for i, li in enumerate(inputs):
        pa = param_attrs[i] if param_attrs else None
        out.append(LayerInput(
            input_layer_name=li.name,
            input_parameter_name=(pa.name if pa and pa.name else ""),
            proj=projs[i] if projs else None))
    return out


def _register_param_attr(owner_name: str, pa: Optional[ParamAttr],
                         idx: Optional[int], bias: bool = False) -> None:
    """Record a ParameterConfig override from a ParamAttr."""
    if pa is None:
        return
    name = pa.name or (f"_{owner_name}.wbias" if bias else f"_{owner_name}.w{idx}")
    pc = ParameterConfig(
        name=name,
        learning_rate=pa.learning_rate,
        momentum=pa.momentum,
        decay_rate=pa.l2_rate,
        decay_rate_l1=pa.l1_rate,
        initial_mean=pa.initial_mean,
        initial_std=pa.initial_std if pa.initial_std is not None else 0.01,
        initial_smart=pa.initial_smart and pa.initial_std is None,
        is_static=pa.is_static,
        sparse_update=pa.sparse_update,
        update_hooks=[h.as_dict() for h in _as_list(pa.update_hooks)]
        if pa.update_hooks else [],
    )
    _collector.parameters.append(pc)


def _bias_info(bias_attr) -> (bool, Optional[ParamAttr]):
    if bias_attr is False:
        return False, None
    if bias_attr is None or bias_attr is True:
        return True, None
    return True, bias_attr


def _extra(attrs: Dict[str, Any], layer_attr: Optional[ExtraAttr]
           ) -> Dict[str, Any]:
    return attrs


def _add_layer(name: Optional[str], ltype: str, size: int,
               inputs: List[LayerInput], act=None, bias_attr=False,
               attrs: Optional[Dict[str, Any]] = None,
               layer_attr: Optional[ExtraAttr] = None,
               param_attrs: Optional[List[Optional[ParamAttr]]] = None
               ) -> LayerOutput:
    name = name or _collector.unique_name(ltype)
    with_bias, bias_pa = _bias_info(bias_attr)
    conf = LayerConfig(
        name=name, type=ltype, size=size, active_type=_act_name(act),
        inputs=inputs, with_bias=with_bias,
        bias_parameter_name=(bias_pa.name if bias_pa and bias_pa.name
                             else ""),
        drop_rate=layer_attr.drop_rate if layer_attr else 0.0,
        device=layer_attr.device if layer_attr else -1,
        error_clipping_threshold=(layer_attr.error_clipping_threshold
                                  if layer_attr else 0.0),
        attrs=attrs or {})
    _collector.add(conf)
    if param_attrs:
        for i, pa in enumerate(param_attrs):
            _register_param_attr(name, pa, i)
    if bias_pa:
        _register_param_attr(name, bias_pa, None, bias=True)
    return LayerOutput(name=name, layer_type=ltype, size=size)


# ------------------------------------------------------------ data layer


def data(name: str, type=None, height: int = 0, width: int = 0,
         size: Optional[int] = None, **_ignored) -> LayerOutput:
    """``data_layer``.  Two calling conventions:

    - v2 style: ``type`` is a :class:`paddle_tpu_torch.data.InputType`;
    - v1 style (reference configs): ``data_layer('x', size=N)`` — the
      actual input type comes from the data provider's input_types.
    """
    if isinstance(type, int):           # v1 positional: data_layer(name, size)
        size, type = type, None
    if type is None:
        enforce(size is not None, f"data layer {name!r}: pass type= or size=")
        from ..data.feeder import dense_vector
        type = dense_vector(size)
    conf = LayerConfig(name=name, type="data", size=type.dim,
                       attrs={"height": height, "width": width,
                              "seq_level": type.seq_level, "kind": type.kind})
    _collector.add(conf)
    return LayerOutput(name=name, layer_type="data", size=type.dim)


data_layer = data


# ----------------------------------------------------------- core layers


def fc(input: Input, size: int, act=None, name: Optional[str] = None,
       bias_attr=True, param_attr: Optional[ParamAttr] = None,
       layer_attr: Optional[ExtraAttr] = None) -> LayerOutput:
    ins = _as_list(input)
    pas = [param_attr] * len(ins) if param_attr else None
    return _add_layer(name, "fc", size, _mk_inputs(ins, pas), act,
                      bias_attr, layer_attr=layer_attr, param_attrs=pas)


fc_layer = fc


def embedding(input: Input, size: int, name: Optional[str] = None,
              param_attr: Optional[ParamAttr] = None,
              vocab_size: Optional[int] = None,
              sharded: bool = False) -> LayerOutput:
    inp = _as_list(input)[0]
    vocab = vocab_size or inp.size
    pas = [param_attr] if param_attr else None
    return _add_layer(None if name is None else name, "embedding", size,
                      _mk_inputs([inp], pas),
                      attrs={"vocab_size": vocab, "sharded": sharded},
                      param_attrs=pas)


embedding_layer = embedding


def addto(input: Input, act=None, name: Optional[str] = None,
          bias_attr=False, layer_attr=None) -> LayerOutput:
    ins = _as_list(input)
    return _add_layer(name, "addto", ins[0].size, _mk_inputs(ins), act,
                      bias_attr, layer_attr=layer_attr)


addto_layer = addto


def _proj_out_size(pc: ProjConfig) -> int:
    size = pc.resolved_output_size()
    enforce(size > 0,
            f"{pc.type} projection inside concat_layer needs an explicit "
            "size (pass size=N to the projection)")
    return size


def concat(input: Input, act=None, name: Optional[str] = None,
           bias_attr=False, layer_attr=None) -> LayerOutput:
    ins = _as_list(input)
    n_proj = sum(1 for i in ins if isinstance(i, tuple))
    if n_proj not in (0, len(ins)):
        raise ConfigError(
            "concat_layer inputs must be all layers or all projections, "
            f"got {n_proj} projection(s) among {len(ins)} inputs")
    if ins and isinstance(ins[0], tuple):
        # Projection inputs → 'concat2' (projection outputs concatenated;
        # reference layers.py:3309 CONCAT_PROJ_LAYER dispatch)
        lis = [t[0] for t in ins]
        pcs = [t[1] for t in ins]
        pas = [t[2] for t in ins]
        size = sum(_proj_out_size(pc) for pc in pcs)
        return _add_layer(name, "concat2", size, _mk_inputs(lis, pas, pcs),
                          act, bias_attr, layer_attr=layer_attr,
                          param_attrs=pas)
    return _add_layer(name, "concat", sum(i.size for i in ins),
                      _mk_inputs(ins), act, bias_attr,
                      layer_attr=layer_attr)


concat_layer = concat


def scaled_dot_product_attention(input: Input, size: int,
                                 num_heads: int = 1, causal: bool = False,
                                 name: Optional[str] = None, act=None,
                                 bias_attr=False,
                                 param_attr: Optional[ParamAttr] = None,
                                 layer_attr=None, block_q: int = 512,
                                 block_k: int = 512,
                                 packed: bool = False) -> LayerOutput:
    """Multi-head attention backed by the flash-attention kernels
    (``ops/attention.py``) — the kernel→layer→config wiring the
    reference used for ``hl_lstm``→``LstmLayer``→``lstmemory``.

    One input = self-attention; a ``[query, key, value]`` list =
    cross-attention.  Padded keys are masked from the sequence lengths.
    ``packed=True`` (self-attention only) runs the sequence-packing
    lowering: the padded batch shares one segment-id token axis and
    padding does zero work (``--attention_packing=false`` reverts).
    """
    ins = _as_list(input)
    if len(ins) not in (1, 3):
        raise ConfigError(
            "scaled_dot_product_attention takes 1 input (self-attention) "
            f"or 3 (query, key, value), got {len(ins)}")
    if packed and len(ins) != 1:
        raise ConfigError(
            "scaled_dot_product_attention(packed=True) is self-attention "
            f"only (1 input), got {len(ins)}")
    pas = [param_attr] + [None] * (len(ins) - 1) if param_attr else None
    return _add_layer(name, "scaled_dot_product_attention", size,
                      _mk_inputs(ins, pas), act, bias_attr,
                      attrs={"num_heads": num_heads, "causal": causal,
                             "block_q": block_q, "block_k": block_k,
                             "packed": packed},
                      layer_attr=layer_attr, param_attrs=pas)


multi_head_attention = scaled_dot_product_attention
scaled_dot_product_attention_layer = scaled_dot_product_attention


def layer_norm(input: Input, name: Optional[str] = None, act=None,
               bias_attr=True, epsilon: float = 1e-5,
               layer_attr=None) -> LayerOutput:
    """Layer normalization over the feature dim with learned gain/bias."""
    inp = _as_list(input)[0]
    return _add_layer(name, "layer_norm", inp.size, _mk_inputs([inp]),
                      act, bias_attr, attrs={"epsilon": epsilon},
                      layer_attr=layer_attr)


layer_norm_layer = layer_norm


def position_embedding(input: Input, max_len: int,
                       name: Optional[str] = None,
                       param_attr: Optional[ParamAttr] = None,
                       layer_attr=None) -> LayerOutput:
    """Adds a learned [max_len, size] position table to a sequence."""
    inp = _as_list(input)[0]
    pas = [param_attr] if param_attr else None
    return _add_layer(name, "position_embedding", inp.size,
                      _mk_inputs([inp], pas),
                      attrs={"max_len": max_len},
                      layer_attr=layer_attr, param_attrs=pas)


position_embedding_layer = position_embedding


def dropout(input: Input, dropout_rate: float = 0.5,
            name: Optional[str] = None) -> LayerOutput:
    """v2 ``dropout`` = addto with drop_rate."""
    return addto(input, name=name,
                 layer_attr=ExtraAttr(drop_rate=dropout_rate))


def dropout_layer(input: Input, dropout_rate: float = 0.5,
                  name: Optional[str] = None) -> LayerOutput:
    return dropout(input, dropout_rate, name)


# ------------------------------------------------------------------ mixed


def full_matrix_projection(input: LayerOutput, size: int,
                           param_attr: Optional[ParamAttr] = None):
    return (input, ProjConfig(type="fc", input_size=input.size,
                              output_size=size), param_attr)


def identity_projection(input: LayerOutput, offset: Optional[int] = None,
                        size: Optional[int] = None):
    if offset is not None:
        end = offset + (size or input.size)
        return (input, ProjConfig(type="slice", input_size=input.size,
                                  slice_begin=offset, slice_end=end), None)
    return (input, ProjConfig(type="identity", input_size=input.size,
                              output_size=input.size), None)


def dotmul_projection(input: LayerOutput,
                      param_attr: Optional[ParamAttr] = None):
    return (input, ProjConfig(type="dot_mul", input_size=input.size,
                              output_size=input.size), param_attr)


def scaling_projection(input: LayerOutput,
                       param_attr: Optional[ParamAttr] = None):
    return (input, ProjConfig(type="scaling", input_size=input.size,
                              output_size=input.size), param_attr)


def table_projection(input: LayerOutput, size: int,
                     param_attr: Optional[ParamAttr] = None):
    return (input, ProjConfig(type="table", input_size=input.size,
                              output_size=size), param_attr)


def context_projection(input: LayerOutput, context_len: int,
                       context_start: Optional[int] = None,
                       padding_attr=False):
    start = context_start if context_start is not None \
        else -(context_len // 2)
    trainable = padding_attr is not False and padding_attr is not None
    return (input, ProjConfig(type="context", input_size=input.size,
                              context_start=start, context_length=context_len,
                              trainable_padding=trainable),
            padding_attr if trainable else None)


@dataclass
class Operator:
    """A mixed-layer operator (``conv_operator``/``dotmul_operator``):
    parameter-free, reads other layers' VALUES (``Operator.h``)."""

    kind: str
    op_inputs: List["LayerOutput"]
    attrs: Dict[str, Any]
    output_size: int = 0


class _MixedLayerBuilder(LayerOutput):
    """Context-manager form of ``mixed_layer`` (reference
    ``MixedLayerType``):

        with mixed_layer(size=n) as m:
            m += full_matrix_projection(input=x)
            m += dotmul_operator(a, b)

    Items collect via ``+=``; the real layer is built at ``__exit__``
    and this handle's LayerOutput fields are filled in place, so the
    ``as`` variable is usable downstream like any other output."""

    def __init__(self, **kw):
        super().__init__(name="<unfinished-mixed>", layer_type="mixed")
        self._kw = kw
        self._items: list = []
        self._finalized = False

    def __iadd__(self, other):
        if self._finalized:
            # the handle is an ordinary LayerOutput now; += means
            # layer_math addition like on any other output
            from .layer_math import add
            return add(self, other)
        self._items.append(other)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        enforce(self._items, "mixed_layer context added no projections")
        built = mixed(input=self._items, **self._kw)
        self._finalized = True
        self.name = built.name
        self.layer_type = built.layer_type
        self.size = built.size
        self.parents = built.parents
        return False


def mixed(input=None, size: int = 0, name: Optional[str] = None, act=None,
          bias_attr=False, layer_attr=None, operators=None) -> LayerOutput:
    """``mixed_layer``: input is a list of projection tuples; operators
    are :class:`Operator` objects appended as extra (projection-less)
    inputs.  Called with ``input=None`` it returns the context-manager
    builder (the reference's ``with mixed_layer(...) as m`` protocol)."""
    if input is None and operators is None:
        return _MixedLayerBuilder(size=size, name=name, act=act,
                                  bias_attr=bias_attr,
                                  layer_attr=layer_attr)
    items = _as_list(input)
    ins, pcs, pas = [], [], []
    op_list = []
    for item in items:
        if isinstance(item, Operator):
            op_list.append(item)
            continue
        li, pc, pa = item
        ins.append(li)
        pcs.append(pc)
        pas.append(pa)
    op_list.extend(_as_list(operators))
    op_attrs = []
    for op in op_list:
        idx = []
        for li in op.op_inputs:
            ins.append(li)
            pcs.append(None)
            pas.append(None)
            idx.append(len(ins) - 1)
        op_attrs.append({**op.attrs, "type": op.kind,
                         "input_indices": tuple(idx)})
        if size == 0 and op.output_size:
            size = op.output_size
    if size == 0:
        for pc in pcs:
            if pc is not None and pc.output_size:
                size = pc.output_size
                break
        else:
            enforce(pcs and pcs[0] is not None,
                    "mixed layer needs a size, a sized projection, or an "
                    "operator with a known output size")
            size = pcs[0].context_length * pcs[0].input_size
    attrs = {"operators": op_attrs} if op_attrs else None
    return _add_layer(name, "mixed", size, _mk_inputs(ins, pas, pcs), act,
                      bias_attr, attrs=attrs, layer_attr=layer_attr,
                      param_attrs=pas)


mixed_layer = mixed


# ------------------------------------------------------------------ image


def img_conv(input: Input, filter_size: int, num_filters: int,
             num_channels: Optional[int] = None, stride: int = 1,
             padding: int = 0, groups: int = 1, act=None,
             name: Optional[str] = None, bias_attr=True,
             param_attr: Optional[ParamAttr] = None,
             img_size: Optional[int] = None,
             img_size_y: Optional[int] = None,
             trans: bool = False, layer_attr=None) -> LayerOutput:
    inp = _as_list(input)[0]
    c = num_channels or getattr(inp, "channels", 1)
    img = img_size or int(round((inp.size / c) ** 0.5))
    img_y = img_size_y or img
    out_x = conv_out(img, filter_size, padding, stride)
    out_y = conv_out(img_y, filter_size, padding, stride)
    attrs = {"channels": c, "filter_size": filter_size,
             "num_filters": num_filters, "stride": stride, "padding": padding,
             "groups": groups, "img_size": img, "img_size_y": img_y,
             "output_x": out_x, "output_y": out_y}
    pas = [param_attr] if param_attr else None
    out = _add_layer(name, "exconvt" if trans else "exconv",
                     num_filters * out_x * out_y,
                     _mk_inputs([inp], pas), act, bias_attr, attrs,
                     layer_attr, pas)
    out.channels = num_filters
    out.img_size = out_x
    out.img_size_y = out_y
    return out


img_conv_layer = img_conv


def conv_projection(input: Input, filter_size: int, num_filters: int,
                    num_channels: Optional[int] = None, stride: int = 1,
                    padding: int = 0,
                    param_attr: Optional[ParamAttr] = None,
                    name: Optional[str] = None) -> LayerOutput:
    """``conv_projection`` (reference ``ConvProjection``): a bias-free
    linear convolution.  The reference materializes it inside the
    consuming concat/mixed layer; here it is its own conv layer — the
    concat of projection outputs is identical math."""
    return img_conv(input, filter_size, num_filters,
                    num_channels=num_channels, stride=stride,
                    padding=padding, act=LinearActivation(),
                    bias_attr=False, param_attr=param_attr, name=name)


def conv_out(img: int, filt: int, pad: int, stride: int) -> int:
    return (img + 2 * pad - filt) // stride + 1


def img_pool(input: Input, pool_size: int, num_channels: Optional[int] = None,
             pool_type: Optional[BasePoolingType] = None, stride: int = 2,
             padding: int = 0, name: Optional[str] = None,
             img_size: Optional[int] = None, img_size_y: Optional[int] = None,
             layer_attr=None) -> LayerOutput:
    inp = _as_list(input)[0]
    c = num_channels or getattr(inp, "channels", 1)
    img = img_size or getattr(inp, "img_size", int(round((inp.size / c) ** 0.5)))
    img_y = img_size_y or getattr(inp, "img_size_y", img)
    ptype = (pool_type or MaxPooling()).name
    out_x = conv_out(img, pool_size, padding, stride)
    out_y = conv_out(img_y, pool_size, padding, stride)
    attrs = {"channels": c, "pool_size": pool_size, "stride": stride,
             "padding": padding, "img_size": img, "img_size_y": img_y,
             "pool_type": ptype + "-projection"}
    out = _add_layer(name, "pool", c * out_x * out_y, _mk_inputs([inp]),
                     None, False, attrs, layer_attr)
    out.channels = c
    out.img_size = out_x
    out.img_size_y = out_y
    return out


img_pool_layer = img_pool


def batch_norm(input: Input, act=None, name: Optional[str] = None,
               num_channels: Optional[int] = None, bias_attr=True,
               param_attr=None, use_global_stats: Optional[bool] = None,
               moving_average_fraction: float = 0.9,
               layer_attr=None) -> LayerOutput:
    inp = _as_list(input)[0]
    c = num_channels or getattr(inp, "channels", inp.size)
    attrs = {"channels": c,
             "moving_average_fraction": moving_average_fraction}
    if use_global_stats is not None:
        attrs["use_global_stats"] = use_global_stats
    if hasattr(inp, "img_size"):
        attrs["img_size"] = inp.img_size
        attrs["img_size_y"] = getattr(inp, "img_size_y", inp.img_size)
    pas = [param_attr] if param_attr else None
    out = _add_layer(name, "batch_norm", inp.size, _mk_inputs([inp], pas),
                     act, bias_attr, attrs, layer_attr, pas)
    for a in ("channels", "img_size", "img_size_y"):
        if hasattr(inp, a):
            setattr(out, a, getattr(inp, a))
    out.channels = c
    return out


batch_norm_layer = batch_norm


def img_cmrnorm(input: Input, size: int = 5, scale: float = 0.0128,
                power: float = 0.75, name: Optional[str] = None,
                num_channels: Optional[int] = None, layer_attr=None
                ) -> LayerOutput:
    inp = _as_list(input)[0]
    c = num_channels or getattr(inp, "channels", 1)
    attrs = {"channels": c, "norm_size": size, "scale": scale / size,
             "pow": power,
             "img_size": getattr(inp, "img_size", None),
             "img_size_y": getattr(inp, "img_size_y", None)}
    out = _add_layer(name, "norm", inp.size, _mk_inputs([inp]), None, False,
                     attrs, layer_attr)
    for a in ("channels", "img_size", "img_size_y"):
        if hasattr(inp, a):
            setattr(out, a, getattr(inp, a))
    return out


img_cmrnorm_layer = img_cmrnorm


def maxout(input: Input, groups: int, num_channels: Optional[int] = None,
           name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    c = num_channels or getattr(inp, "channels", 1)
    attrs = {"channels": c, "groups": groups,
             "img_size": getattr(inp, "img_size", None),
             "img_size_y": getattr(inp, "img_size_y", None)}
    out = _add_layer(name, "maxout", inp.size // groups, _mk_inputs([inp]),
                     None, False, attrs)
    out.channels = c // groups
    return out


maxout_layer = maxout


def spp(input: Input, pyramid_height: int, num_channels: Optional[int] = None,
        pool_type=None, name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    c = num_channels or getattr(inp, "channels", 1)
    size = c * sum((2 ** i) ** 2 for i in range(pyramid_height))
    attrs = {"channels": c, "pyramid_height": pyramid_height,
             "pool_type": (pool_type or MaxPooling()).name,
             "img_size": getattr(inp, "img_size", None),
             "img_size_y": getattr(inp, "img_size_y", None)}
    return _add_layer(name, "spp", size, _mk_inputs([inp]), None, False, attrs)


spp_layer = spp


def bilinear_interp(input: Input, out_size_x: int, out_size_y: int,
                    num_channels: Optional[int] = None,
                    name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    c = num_channels or getattr(inp, "channels", 1)
    attrs = {"channels": c, "out_size_x": out_size_x, "out_size_y": out_size_y,
             "img_size": getattr(inp, "img_size", None),
             "img_size_y": getattr(inp, "img_size_y", None)}
    out = _add_layer(name, "bilinear_interp", c * out_size_x * out_size_y,
                     _mk_inputs([inp]), None, False, attrs)
    out.channels = c
    out.img_size = out_size_x
    out.img_size_y = out_size_y
    return out


bilinear_interp_layer = bilinear_interp


# -------------------------------------------------------------- recurrent


def lstmemory(input: Input, name: Optional[str] = None, reverse: bool = False,
              act=None, gate_act=None, state_act=None, bias_attr=True,
              param_attr: Optional[ParamAttr] = None,
              size: Optional[int] = None, layer_attr=None) -> LayerOutput:
    inp = _as_list(input)[0]
    h = size or inp.size // 4
    attrs = {"reversed": reverse,
             "active_gate_type": _act_name(gate_act) or "sigmoid",
             "active_state_type": _act_name(state_act) or "tanh"}
    pas = [param_attr] if param_attr else None
    return _add_layer(name, "lstmemory", h, _mk_inputs([inp], pas),
                      act or TanhActivation(), bias_attr, attrs, layer_attr,
                      pas)


def grumemory(input: Input, name: Optional[str] = None, reverse: bool = False,
              act=None, gate_act=None, bias_attr=True,
              param_attr: Optional[ParamAttr] = None,
              size: Optional[int] = None, layer_attr=None) -> LayerOutput:
    inp = _as_list(input)[0]
    h = size or inp.size // 3
    attrs = {"reversed": reverse,
             "active_gate_type": _act_name(gate_act) or "sigmoid"}
    pas = [param_attr] if param_attr else None
    return _add_layer(name, "gated_recurrent", h, _mk_inputs([inp], pas),
                      act or TanhActivation(), bias_attr, attrs, layer_attr,
                      pas)


def gru_step_layer(input: Input, output_mem: LayerOutput,
                   size: Optional[int] = None, act=None, gate_act=None,
                   name: Optional[str] = None, bias_attr=True,
                   param_attr: Optional[ParamAttr] = None,
                   layer_attr=None) -> LayerOutput:
    """One GRU step for use inside recurrent groups (``GruStepLayer``);
    inputs: 3H projection of x, previous state (a memory link)."""
    inp = _as_list(input)[0]
    h = size or inp.size // 3
    # param_attr applies to the recurrent weight (input 0); the memory
    # link (input 1) carries no parameter
    pas = [param_attr, None] if param_attr else None
    return _add_layer(name, "gru_step", h,
                      _mk_inputs([inp, output_mem], pas),
                      act or TanhActivation(), bias_attr,
                      {"active_gate_type": _act_name(gate_act)
                       or "sigmoid"}, layer_attr, pas)


def lstm_step_layer(input: Input, state: LayerOutput,
                    size: Optional[int] = None, act=None, gate_act=None,
                    state_act=None, name: Optional[str] = None,
                    bias_attr=True, layer_attr=None) -> LayerOutput:
    """One LSTM step (``LstmStepLayer``); inputs: 4H projection, prev
    cell state.  Extra output ``.state`` is the new cell."""
    inp = _as_list(input)[0]
    h = size or inp.size // 4
    return _add_layer(name, "lstm_step", h, _mk_inputs([inp, state]),
                      act or TanhActivation(), bias_attr,
                      {"active_gate_type": _act_name(gate_act) or "sigmoid",
                       "active_state_type": _act_name(state_act)
                       or "tanh"}, layer_attr)


def recurrent(input: Input, act=None, bias_attr=True,
              param_attr: Optional[ParamAttr] = None, reverse: bool = False,
              name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    pas = [param_attr] if param_attr else None
    return _add_layer(name, "recurrent", inp.size, _mk_inputs([inp], pas),
                      act or TanhActivation(), bias_attr,
                      {"reversed": reverse}, None, pas)


recurrent_layer = recurrent


# -------------------------------------------------- recurrent groups


@dataclass
class StepInput:
    """Marks a sequence input scanned per-timestep inside a group."""

    layer: LayerOutput


class memory:
    """``memory(name=..., size=...)`` inside a recurrent group step
    (config_parser memory semantics: reads layer ``name``'s previous-step
    output; optional boot layer)."""

    def __init__(self, name: str, size: int, boot_layer: Optional[LayerOutput] = None,
                 boot_bias=None, is_seq: bool = False):
        enforce(_collector.group_stack, "memory() outside recurrent_group")
        group = _collector.group_stack[-1]
        self.link_name = f"{name}@pre@{group.name}"
        group.memories.append({
            "layer_name": name, "link_name": self.link_name, "size": size,
            "boot_layer_name": boot_layer.name if boot_layer else None,
        })
        self.out = LayerOutput(name=self.link_name, layer_type="memory",
                               size=size)

    def __getattr__(self, item):
        return getattr(self.out, item)


def recurrent_group(step: Callable, input, name: Optional[str] = None,
                    reverse: bool = False) -> Union[LayerOutput, List[LayerOutput]]:
    """``recurrent_group``: run ``step`` once to trace the per-step net.

    ``input``: StepInput(seq) entries are scanned; plain LayerOutputs are
    read-only (static) inputs visible at every step.
    """
    name = name or _collector.unique_name("recurrent_group")
    sub = SubModelConfig(name=name, reversed=reverse)
    ins = _as_list(input)
    step_args = []
    for i in ins:
        if isinstance(i, StepInput):
            sub.in_links.append(i.layer.name)
            # inside the group the step fn sees a per-frame view, same name
            step_args.append(LayerOutput(name=i.layer.name, layer_type="frame",
                                         size=i.layer.size))
        else:
            step_args.append(i)
    _collector.group_stack.append(sub)
    try:
        outs = step(*step_args)
    finally:
        _collector.group_stack.pop()
    out_list = _as_list(outs)
    sub.out_links = [o.name for o in out_list]
    _collector.sub_models.append(sub)
    results = [LayerOutput(name=o.name, layer_type="group_output", size=o.size)
               for o in out_list]
    return results[0] if len(results) == 1 else results


def simple_rnn_group(input, size, act=None, name=None, reverse=False):
    def step(x):
        mem = memory(name=f"{name or 'rnn'}_step", size=size)
        return fc([x, mem.out], size=size, act=act or TanhActivation(),
                  name=f"{name or 'rnn'}_step")

    return recurrent_group(step, [StepInput(_as_list(input)[0])],
                           name=name, reverse=reverse)


# ------------------------------------------------------- sequence layers


def pooling(input: Input, pooling_type: Optional[BasePoolingType] = None,
            name: Optional[str] = None, agg_level=None,
            stride: int = -1) -> LayerOutput:
    inp = _as_list(input)[0]
    ptype = (pooling_type or AvgPooling()).name
    lt = {"max": "max", "average": "average", "sum": "average",
          "sqrt": "average"}[ptype]
    attrs = {"stride": stride}
    if ptype in ("sum", "sqrt", "average"):
        attrs["average_strategy"] = {"average": "average", "sum": "sum",
                                     "sqrt": "squarerootn"}[ptype]
    return _add_layer(name, lt, inp.size, _mk_inputs([inp]), None, False,
                      attrs)


pooling_layer = pooling


def last_seq(input: Input, name: Optional[str] = None, agg_level=None,
             stride: int = -1, layer_attr=None) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "seqlastins", inp.size, _mk_inputs([inp]),
                      None, False, {"stride": stride},
                      layer_attr=layer_attr)


def first_seq(input: Input, name: Optional[str] = None,
              agg_level=None, layer_attr=None) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "seqfirstins", inp.size, _mk_inputs([inp]),
                      layer_attr=layer_attr)


def expand(input: Input, expand_as: LayerOutput, name: Optional[str] = None,
           expand_level=None) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "expand", inp.size,
                      _mk_inputs([inp, expand_as]))


expand_layer = expand


def seq_concat(a: LayerOutput, b: LayerOutput,
               name: Optional[str] = None) -> LayerOutput:
    return _add_layer(name, "seqconcat", a.size, _mk_inputs([a, b]))


seq_concat_layer = seq_concat


def seq_reshape(input: Input, reshape_size: int,
                name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "seqreshape", reshape_size, _mk_inputs([inp]))


seq_reshape_layer = seq_reshape


def seq_slice(input: Input, starts=None, ends=None,
              name: Optional[str] = None) -> LayerOutput:
    ins = [_as_list(input)[0]]
    if starts is not None:
        ins.append(starts)
    if ends is not None:
        ins.append(ends)
    return _add_layer(name, "seq_slice", ins[0].size, _mk_inputs(ins))


seq_slice_layer = seq_slice


def sub_seq(input: Input, offsets: LayerOutput, sizes: LayerOutput,
            name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "subseq", inp.size,
                      _mk_inputs([inp, offsets, sizes]))


def kmax_seq_score(input: Input, beam_size: int = 1,
                   name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "kmax_seq_score", beam_size, _mk_inputs([inp]),
                      None, False, {"beam_size": beam_size})


kmax_sequence_score_layer = kmax_seq_score


def max_id(input: Input, name: Optional[str] = None,
           beam_size: int = 1) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "maxid", beam_size, _mk_inputs([inp]), None,
                      False, {"beam_size": beam_size})


maxid_layer = max_id


def sampling_id(input: Input, name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "sampling_id", 1, _mk_inputs([inp]))


sampling_id_layer = sampling_id


def eos(input: Input, eos_id: int, name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "eos_id", 1, _mk_inputs([inp]), None, False,
                      {"eos_id": eos_id})


eos_layer = eos


# --------------------------------------------------- beam-search generation


class GeneratedInput:
    """Marks the feedback input of a generating group: the embedding of the
    previous step's generated token (reference ``GeneratedInput`` in
    ``trainer_config_helpers/layers.py``; machinery
    ``RecurrentGradientMachine.cpp:539 generateSequence``)."""

    def __init__(self, size: int, embedding_name: str, embedding_size: int):
        self.size = size                      # vocab size
        self.embedding_name = embedding_name  # shared table param name
        self.embedding_size = embedding_size


class StaticInput:
    """Read-only outer input visible at every generation step."""

    def __init__(self, input: LayerOutput, is_seq: bool = False):
        self.layer = _as_list(input)[0]
        self.is_seq = is_seq


def beam_search(step: Callable, input, bos_id: int, eos_id: int,
                beam_size: int = 5, max_length: int = 100,
                name: Optional[str] = None,
                num_results_per_sample: Optional[int] = None,
                candidate_adjust: Optional[Callable] = None,
                candidate_drop: Optional[Callable] = None) -> LayerOutput:
    """Build a generating recurrent group decoded by beam search
    (``beam_search`` in ``trainer_config_helpers/layers.py``).
    ``NeuralNetwork`` builds the decode with the net
    (``layers/beam_search.BeamSearchDecoder``).

    User candidate hooks — the ``beamSearchCandidateAdjust`` / drop
    callbacks of ``RecurrentGradientMachine.h:73-112``, re-designed as
    pure tensor functions of the decode loop (no host round-trips):

    - ``candidate_adjust(logp, tokens, t) -> logp``: per-step token
      log-probs ``[B, K, V]`` (before beam scores are added), tokens
      decoded so far ``[B, K, max_length]``, scalar step ``t``; returns
      adjusted same-shape log-probs.
    - ``candidate_drop(logp, tokens, t) -> bool [B, K, V]``: True where
      a candidate must be pruned (its score is forced to −inf before
      top-k).
    """
    name = name or _collector.unique_name("beam_search")
    sub = SubModelConfig(name=name, is_generating=True)
    ins = _as_list(input) if not isinstance(input, (list, tuple)) else \
        list(input)
    gen: Optional[GeneratedInput] = None
    gen_pos = -1
    step_args: List[Any] = []
    static_names: List[str] = []
    placeholder = f"__{name}_gen_id__"
    for pos, i in enumerate(ins):
        if isinstance(i, GeneratedInput):
            enforce(gen is None, "beam_search allows one GeneratedInput")
            gen, gen_pos = i, pos
            step_args.append(None)  # filled inside the group scope
        elif isinstance(i, StaticInput):
            static_names.append(i.layer.name)
            step_args.append(i.layer)
        else:
            static_names.append(_as_list(i)[0].name)
            step_args.append(_as_list(i)[0])
    enforce(gen is not None, "beam_search needs a GeneratedInput")

    _collector.group_stack.append(sub)
    try:
        # previous generated token id (runtime-injected frame) → shared
        # embedding inside the group, so the table parameter is created
        # and shared with the training topology by name
        id_ph = LayerOutput(name=placeholder, layer_type="frame",
                            size=gen.size)
        prev_emb = embedding(id_ph, size=gen.embedding_size,
                             name=f"__{name}_gen_emb__",
                             param_attr=ParamAttr(name=gen.embedding_name),
                             vocab_size=gen.size)
        step_args[gen_pos] = prev_emb
        prob = _as_list(step(*step_args))[0]
    finally:
        _collector.group_stack.pop()

    sub.out_links = [prob.name]
    sub.generator = {
        "bos_id": bos_id, "eos_id": eos_id, "beam_size": beam_size,
        "max_length": max_length, "placeholder": placeholder,
        "embedding_name": gen.embedding_name,
        "embedding_size": gen.embedding_size,
        "vocab_size": gen.size, "prob_layer": prob.name,
        "num_results_per_sample": num_results_per_sample or beam_size,
        "static_inputs": static_names,
        "candidate_adjust": candidate_adjust,
        "candidate_drop": candidate_drop,
    }
    _collector.sub_models.append(sub)
    # the group's visible result: generated token sequences (+scores);
    # a real LayerConfig so topology() pulls the group in
    out = _add_layer(f"{name}__beam_gen__", "beam_gen", beam_size,
                     _mk_inputs([LayerOutput(prob.name, "group_output",
                                             prob.size)] +
                                [LayerOutput(s, "static", 0)
                                 for s in static_names]),
                     None, False, {"group_name": name})
    return out


# ------------------------------------------------------------ glue layers


def _simple(ltype: str, size_of=None):
    def f(input: Input, name: Optional[str] = None, act=None,
          **attrs) -> LayerOutput:
        ins = _as_list(input)
        size = size_of(ins) if size_of else ins[0].size
        return _add_layer(name, ltype, size, _mk_inputs(ins), act,
                          False, attrs or {})

    f.__name__ = ltype
    return f


# For the weighted glue layers input 0 is the (scalar-per-row) weight and
# input 1 carries the data, so the output size comes from input 1.
interpolation_layer = _simple("interpolation", lambda ins: ins[1].size)
power_layer = _simple("power", lambda ins: ins[1].size)
scaling_layer = _simple("scaling", lambda ins: ins[1].size)
trans_layer = _simple("trans")
row_l2_norm_layer = _simple("row_l2_norm")
sum_to_one_norm_layer = _simple("sum_to_one_norm")
dot_prod_layer = _simple("dot_prod", lambda ins: 1)
out_prod_layer = _simple("out_prod",
                         lambda ins: ins[0].size * ins[1].size)
# weights [B, K] select among K vectors packed in input 1 of size K*D → D
convex_comb_layer = _simple(
    "convex_comb", lambda ins: ins[1].size // max(ins[0].size, 1))


def slope_intercept(input: Input, slope: float = 1.0, intercept: float = 0.0,
                    name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "slope_intercept", inp.size, _mk_inputs([inp]),
                      None, False, {"slope": slope, "intercept": intercept})


slope_intercept_layer = slope_intercept


def clip(input: Input, min: float, max: float,
         name: Optional[str] = None) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "clip", inp.size, _mk_inputs([inp]), None, False,
                      {"min": min, "max": max})


clip_layer = clip


def scale_shift(input: Input, name: Optional[str] = None,
                bias_attr=True) -> LayerOutput:
    inp = _as_list(input)[0]
    return _add_layer(name, "scale_shift", inp.size, _mk_inputs([inp]),
                      None, bias_attr)


scale_shift_layer = scale_shift


def cos_sim(a: LayerOutput, b: LayerOutput, scale: float = 1.0,
            size: int = 1, name: Optional[str] = None) -> LayerOutput:
    lt = "cos" if size == 1 else "cos_vm"
    return _add_layer(name, lt, size, _mk_inputs([a, b]), None, False,
                      {"cos_scale": scale})


def prelu(input: Input, partial_sum: int = 1,
          name: Optional[str] = None, param_attr=None) -> LayerOutput:
    inp = _as_list(input)[0]
    pas = [param_attr] if param_attr else None
    return _add_layer(name, "prelu", inp.size, _mk_inputs([inp], pas),
                      None, False, {"partial_sum": partial_sum},
                      param_attrs=pas)


prelu_layer = prelu


def multiplex(index: LayerOutput, inputs: Sequence[LayerOutput],
              name: Optional[str] = None) -> LayerOutput:
    ins = [index] + list(inputs)
    return _add_layer(name, "multiplex", inputs[0].size, _mk_inputs(ins))


multiplex_layer = multiplex


# ------------------------------------------------------------ cost layers


def classification_cost(input: LayerOutput, label: LayerOutput,
                        weight: Optional[LayerOutput] = None,
                        name: Optional[str] = None,
                        coeff: float = 1.0) -> LayerOutput:
    ins = [input, label] + ([weight] if weight else [])
    return _add_layer(name, "multi-class-cross-entropy", 1, _mk_inputs(ins),
                      None, False, {"coeff": coeff})


def cross_entropy_cost(input, label, name=None, coeff=1.0,
                       weight=None) -> LayerOutput:
    return classification_cost(input, label, weight, name, coeff)


cross_entropy = cross_entropy_cost


def cross_entropy_with_selfnorm_cost(input, label, name=None, coeff=1.0,
                                     softmax_selfnorm_alpha=0.1) -> LayerOutput:
    return _add_layer(name, "multi_class_cross_entropy_with_selfnorm", 1,
                      _mk_inputs([input, label]), None, False,
                      {"coeff": coeff,
                       "softmax_selfnorm_alpha": softmax_selfnorm_alpha})


def square_error_cost(input, label, name=None, coeff=1.0,
                      weight=None) -> LayerOutput:
    ins = [input, label] + ([weight] if weight else [])
    return _add_layer(name, "square_error", 1, _mk_inputs(ins), None, False,
                      {"coeff": coeff})


mse_cost = square_error_cost
regression_cost = square_error_cost


def multi_binary_label_cross_entropy_cost(input, label, name=None,
                                          coeff=1.0) -> LayerOutput:
    return _add_layer(name, "multi_binary_label_cross_entropy", 1,
                      _mk_inputs([input, label]), None, False, {"coeff": coeff})


def soft_binary_class_cross_entropy_cost(input, label, name=None,
                                         coeff=1.0) -> LayerOutput:
    return _add_layer(name, "soft_binary_class_cross_entropy", 1,
                      _mk_inputs([input, label]), None, False, {"coeff": coeff})


def rank_cost(left, right, label, weight=None, name=None,
              coeff=1.0) -> LayerOutput:
    ins = [left, right, label] + ([weight] if weight else [])
    return _add_layer(name, "rank-cost", 1, _mk_inputs(ins), None, False,
                      {"coeff": coeff})


def lambda_cost(input, score, name=None, NDCG_num=5,
                max_sort_size=-1) -> LayerOutput:
    return _add_layer(name, "lambda_cost", 1, _mk_inputs([input, score]),
                      None, False, {"NDCG_num": NDCG_num})


def huber_regression_cost(input, label, name=None, delta=1.0,
                          coeff=1.0) -> LayerOutput:
    return _add_layer(name, "huber_regression", 1, _mk_inputs([input, label]),
                      None, False, {"delta": delta, "coeff": coeff})


def huber_classification_cost(input, label, name=None,
                              coeff=1.0) -> LayerOutput:
    return _add_layer(name, "huber_classification", 1,
                      _mk_inputs([input, label]), None, False,
                      {"coeff": coeff})


def smooth_l1_cost(input, label, name=None, coeff=1.0) -> LayerOutput:
    return _add_layer(name, "smooth_l1", 1, _mk_inputs([input, label]),
                      None, False, {"coeff": coeff})


def sum_cost(input, name=None) -> LayerOutput:
    return _add_layer(name, "sum_cost", 1, _mk_inputs([_as_list(input)[0]]))


def crf(input: LayerOutput, label: LayerOutput, size: Optional[int] = None,
        weight=None, param_attr=None, name=None) -> LayerOutput:
    n = size or input.size
    ins = [input, label] + ([weight] if weight else [])
    pas = [param_attr] if param_attr else None
    return _add_layer(name, "crf", n, _mk_inputs(ins, pas), None, False,
                      param_attrs=pas)


crf_layer = crf


def crf_decoding(input: LayerOutput, size: Optional[int] = None,
                 label: Optional[LayerOutput] = None, param_attr=None,
                 name=None) -> LayerOutput:
    n = size or input.size
    ins = [input] + ([label] if label else [])
    pas = [param_attr] if param_attr else None
    return _add_layer(name, "crf_decoding", n, _mk_inputs(ins, pas), None,
                      False, param_attrs=pas)


crf_decoding_layer = crf_decoding


def ctc(input: LayerOutput, label: LayerOutput, size: Optional[int] = None,
        norm_by_times: bool = False, name=None) -> LayerOutput:
    return _add_layer(name, "ctc", size or input.size,
                      _mk_inputs([input, label]), None, False,
                      {"norm_by_times": norm_by_times})


ctc_layer = ctc


def warp_ctc(input: LayerOutput, label: LayerOutput, size=None, blank=0,
             norm_by_times=False, name=None) -> LayerOutput:
    return _add_layer(name, "warp_ctc", size or input.size,
                      _mk_inputs([input, label]), None, False,
                      {"blank": blank, "norm_by_times": norm_by_times})


warp_ctc_layer = warp_ctc


def nce(input: LayerOutput, label: LayerOutput, num_classes: int,
        num_neg_samples: int = 10, name=None, param_attr=None,
        bias_attr=True) -> LayerOutput:
    pas = [param_attr] if param_attr else None
    return _add_layer(name, "nce", 1, _mk_inputs([input, label], pas), None,
                      bias_attr, {"num_classes": num_classes,
                                  "num_neg_samples": num_neg_samples},
                      param_attrs=pas)


nce_layer = nce


def hsigmoid(input: LayerOutput, label: LayerOutput, num_classes: int,
             name=None, param_attr=None, bias_attr=True) -> LayerOutput:
    pas = [param_attr] if param_attr else None
    return _add_layer(name, "hsigmoid", 1, _mk_inputs([input, label], pas),
                      None, bias_attr, {"num_classes": num_classes},
                      param_attrs=pas)


hsigmoid_layer = hsigmoid


# --------------------------------------------------------------- topology


def topology(outputs: Input,
             extra_layers: Optional[Input] = None) -> ModelConfig:
    """Extract the reachable subgraph as a ModelConfig
    (``Topology``/``parse_network`` equivalent)."""
    outs = _as_list(outputs) + _as_list(extra_layers)
    by_name = _collector.by_name
    mem_links = {}
    for sm in _collector.sub_models:
        for m in sm.memories:
            mem_links.setdefault(m.get("link_name"), m["layer_name"])
    group_by_layer = {}
    for sm in _collector.sub_models:
        for ln in sm.layer_names:
            group_by_layer[ln] = sm

    needed: List[str] = []
    seen = set()

    def visit(name: str):
        if name in seen:
            return
        seen.add(name)
        if name in mem_links:
            visit(mem_links[name])
            return
        conf = by_name.get(name)
        if conf is None:
            return
        # pull the whole group when any member is needed
        sm = group_by_layer.get(name)
        if sm is not None:
            for l in sm.in_links:
                visit(l)
            for m in sm.memories:
                if m.get("boot_layer_name"):
                    visit(m["boot_layer_name"])
            for ln in sm.layer_names:
                if ln not in seen:
                    seen.add(ln)
                    for i in by_name[ln].inputs:
                        visit(i.input_layer_name)
                    needed.append(ln)
        for i in conf.inputs:
            visit(i.input_layer_name)
        needed.append(name)

    for o in outs:
        visit(o.name)
    # declared evaluators keep their input layers alive as extra graph
    # roots (reference: evaluator inputs are part of the model)
    for e in _collector.evaluators:
        for key in ("input_layer_name", "label_layer_name",
                    "weight_layer_name"):
            if e.get(key) in by_name:
                visit(e[key])

    # needed is already topologically ordered by the DFS append order
    layers = [by_name[n] for n in needed if n in by_name]
    used_groups = [sm for sm in _collector.sub_models
                   if any(ln in seen for ln in sm.layer_names)]
    layer_names = {l.name for l in layers}
    return ModelConfig(
        layers=layers,
        parameters=list(_collector.parameters),
        input_layer_names=(_validated_inputs(layers)
                           or [l.name for l in layers if l.type == "data"]),
        output_layer_names=[o.name for o in _as_list(outputs)],
        sub_models=([SubModelConfig(name="root")] + used_groups)
        if used_groups else [],
        evaluators=[e for e in _collector.evaluators
                    if e.get("input_layer_name") in layer_names],
    )


def inputs(layers, *args) -> None:
    """Declare the network input order explicitly
    (``networks.py:1485``) — the data provider must feed in this order."""
    ins = _as_list(layers) + list(args)
    _collector.declared_inputs = [
        l if isinstance(l, str) else l.name for l in ins]


def _validated_inputs(kept_layers) -> List[str]:
    """inputs() names checked against the final topology — a typo'd or
    pruned layer fails at config time, as the reference Inputs() does."""
    declared = _collector.declared_inputs
    if declared:
        kept = {l.name for l in kept_layers}
        unknown = [n for n in declared if n not in kept]
        if unknown:
            raise ConfigError(
                f"inputs() declares layers not in the topology: {unknown}")
    return list(declared)


@contextlib.contextmanager
def config_scope():
    """Isolated collector scope (parse one config independently)."""
    global _collector
    old = _collector
    _collector = ConfigCollector()
    try:
        yield _collector
    finally:
        _collector = old


# ---------------------------------------------------- v1 DSL parity layer
# The remaining ``trainer_config_helpers/layers.py`` ``__all__`` surface:
# thin wrappers over already-registered engine layer types (reference
# signatures kept; tests/test_dsl_parity.py asserts 1:1 name coverage).


class AggregateLevel:
    """``AggregateLevel`` (layers.py:275)."""

    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"
    # deprecated reference spellings
    EACH_TIMESTEP = "non-seq"
    EACH_SEQUENCE = "seq"


class ExpandLevel:
    FROM_NO_SEQUENCE = AggregateLevel.TO_NO_SEQUENCE
    FROM_SEQUENCE = AggregateLevel.TO_SEQUENCE
    FROM_TIMESTEP = AggregateLevel.TO_NO_SEQUENCE


class LayerType:
    """Layer type-string constants (``layers.py LayerType``) — the subset
    configs actually reference, mapped to this engine's registered names."""

    DATA = "data"
    FC_LAYER = "fc"
    MIXED_LAYER = "mixed"
    LSTMEMORY = "lstmemory"
    GRUMEMORY = "gated_recurrent"
    SEQUENCE_LAST_INSTANCE = "seqlastins"
    SEQUENCE_FIRST_INSTANCE = "seqfirstins"
    POOLING_MAX = "max"
    POOLING_AVG = "average"
    CONV_LAYER = "exconv"
    CONVTRANS_LAYER = "exconvt"
    POOL_LAYER = "pool"
    BATCH_NORM_LAYER = "batch_norm"
    NORM_LAYER = "norm"
    COST = "cost"
    CRF_LAYER = "crf"
    CTC_LAYER = "ctc"

    @staticmethod
    def is_layer_type(type_name: str) -> bool:
        from ..layers import network  # noqa: F401  (registers the layers)
        from ..layers.base import LAYERS
        return type_name in LAYERS


def layer_support(*attrs):
    """Reference decorator marking ExtraLayerAttribute support — the
    engine accepts ExtraAttr uniformly, so this is a no-op passthrough."""

    def deco(fn):
        return fn

    return deco


@dataclass
class SubsequenceInput:
    """Marks a nested-sequence in-link of a recurrent group
    (``SubsequenceInput``): the group steps over subsequences.  The
    group dispatches on the runtime NestedSequenceBatch type, so this is
    StepInput with intent documented."""

    layer: LayerOutput


class BaseGeneratedInput:
    """Base marker class (``layers.py BaseGeneratedInput``)."""


# ---- projections / operators


def trans_full_matrix_projection(input: LayerOutput, size: int = 0,
                                 param_attr: Optional[ParamAttr] = None):
    """``TransposedFullMatrixProjection``: y = x W^T with W [size, in]."""
    return (input, ProjConfig(type="trans_fc", input_size=input.size,
                              output_size=size), param_attr)


def slice_projection(input: LayerOutput, slices):
    """``SliceProjection``: concatenate [begin, end) column ranges."""
    slices = [tuple(s) for s in slices]
    for b, e in slices:
        enforce(0 <= b < e <= input.size,
                f"slice ({b}, {e}) out of range for input size {input.size}")
    return (input, ProjConfig(type="slice", input_size=input.size,
                              output_size=sum(e - b for b, e in slices),
                              slices=slices), None)


def dotmul_operator(a: LayerOutput = None, b: LayerOutput = None,
                    scale: float = 1.0, **kwargs) -> Operator:
    """``DotMulOperator``: elementwise a*b*scale inside a mixed layer."""
    a = a or kwargs.get("x")
    b = b or kwargs.get("y")
    enforce(a is not None and b is not None, "dotmul_operator needs a and b")
    return Operator(kind="dot_mul", op_inputs=[a, b],
                    attrs={"scale": scale}, output_size=a.size)


def conv_operator(img: LayerOutput, filter: LayerOutput, filter_size: int,
                  num_filters: int, num_channels: Optional[int] = None,
                  stride: int = 1, padding: int = 0,
                  filter_size_y: Optional[int] = None,
                  stride_y: Optional[int] = None,
                  padding_y: Optional[int] = None,
                  trans: bool = False) -> Operator:
    """``ConvOperator``: convolution whose per-sample filter comes from
    another layer's output (``ConvOperator.cpp``)."""
    enforce(not trans, "conv_operator: transposed conv operators are not "
            "supported (no reference config uses ConvTransOperator via "
            "the v1 DSL)")
    c = num_channels or getattr(img, "channels", 1)
    isz = getattr(img, "img_size", int(round((img.size / c) ** 0.5)))
    isz_y = getattr(img, "img_size_y", isz)
    fy = filter_size_y or filter_size
    sy = stride_y or stride
    py = padding_y if padding_y is not None else padding
    out_x = conv_out(isz, filter_size, padding, stride)
    out_y = conv_out(isz_y, fy, py, sy)
    return Operator(
        kind="conv", op_inputs=[img, filter],
        attrs={"channels": c, "img_size": isz, "img_size_y": isz_y,
               "filter_size": filter_size, "filter_size_y": fy,
               "num_filters": num_filters, "stride": stride, "stride_y": sy,
               "padding": padding, "padding_y": py},
        output_size=num_filters * out_x * out_y)


# ---- shape / image glue layers


def repeat_layer(input: LayerOutput, num_repeats: int,
                 as_row_vector: bool = True, act=None,
                 name: Optional[str] = None, layer_attr=None) -> LayerOutput:
    """``RepeatLayer`` (type featmap_expand): tile features num_repeats×."""
    inp = _as_list(input)[0]
    attrs = {"num_filters": num_repeats, "as_row_vector": as_row_vector}
    return _add_layer(name, "featmap_expand", inp.size * num_repeats,
                      _mk_inputs([inp]), act, False, attrs, layer_attr)


def rotate_layer(input: LayerOutput, height: int, width: int,
                 name: Optional[str] = None, layer_attr=None) -> LayerOutput:
    """``RotateLayer``: 90° CCW rotation of [H, W] feature matrices."""
    inp = _as_list(input)[0]
    return _add_layer(name, "rotate", inp.size, _mk_inputs([inp]), None,
                      False, {"height": height, "width": width}, layer_attr)


def resize_layer(input: LayerOutput, size: int,
                 name: Optional[str] = None) -> LayerOutput:
    """``ResizeLayer``: reshape the batch to rows of ``size``."""
    inp = _as_list(input)[0]
    return _add_layer(name, "resize", size, _mk_inputs([inp]), None, False)


def pad_layer(input: LayerOutput, pad_c=None, pad_h=None, pad_w=None,
              name: Optional[str] = None, layer_attr=None) -> LayerOutput:
    """``PadLayer``: zero-pad along channel/height/width."""
    inp = _as_list(input)[0]
    pad_c = list(pad_c or [0, 0])
    pad_h = list(pad_h or [0, 0])
    pad_w = list(pad_w or [0, 0])
    c = getattr(inp, "channels", 1)
    h = getattr(inp, "img_size_y", getattr(inp, "img_size", None))
    w = getattr(inp, "img_size", None)
    if w is None:
        w = h = int(round((inp.size / c) ** 0.5))
    oc, oh, ow = c + sum(pad_c), h + sum(pad_h), w + sum(pad_w)
    attrs = {"channels": c, "img_size": w, "img_size_y": h,
             "pad_c": pad_c, "pad_h": pad_h, "pad_w": pad_w}
    out = _add_layer(name, "pad", oc * oh * ow, _mk_inputs([inp]), None,
                     False, attrs, layer_attr)
    out.channels, out.img_size, out.img_size_y = oc, ow, oh
    return out


def crop_layer(input, offset, axis: int = 2, shape=None,
               name: Optional[str] = None, layer_attr=None) -> LayerOutput:
    """``CropLayer``: crop [H, W] windows (axis=2 → spatial crop, the only
    mode the reference demos use)."""
    inp = _as_list(input)[0]
    enforce(axis == 2 and shape is not None,
            "crop_layer: only spatial (axis=2) cropping with an explicit "
            "shape is supported")
    c = getattr(inp, "channels", 1)
    h = getattr(inp, "img_size_y", getattr(inp, "img_size", None))
    w = getattr(inp, "img_size", None)
    if w is None:
        w = h = int(round((inp.size / c) ** 0.5))
    ch, cw = shape[-2], shape[-1]
    attrs = {"channels": c, "img_size": w, "img_size_y": h,
             "crop_offsets": list(offset), "crop_shape": [ch, cw]}
    out = _add_layer(name, "crop", c * ch * cw, _mk_inputs([inp]), None,
                     False, attrs, layer_attr)
    out.channels, out.img_size, out.img_size_y = c, cw, ch
    return out


def switch_order_layer(input: LayerOutput, name: Optional[str] = None,
                       reshape_axis: Optional[int] = None, act=None,
                       layer_attr=None) -> LayerOutput:
    """``SwitchOrderLayer``: NCHW ↔ NHWC reorder (reshape_axis=3 ↔
    channels-last, the reference's only used mode)."""
    inp = _as_list(input)[0]
    to = "NHWC" if (reshape_axis or 3) == 3 else "NCHW"
    attrs = {"to": to, "channels": getattr(inp, "channels", 1),
             "img_size": getattr(inp, "img_size", None),
             "img_size_y": getattr(inp, "img_size_y", None)}
    return _add_layer(name, "switch_order", inp.size, _mk_inputs([inp]),
                      act, False, attrs, layer_attr)


def block_expand_layer(input: LayerOutput, block_x: int = 0, block_y: int = 0,
                       stride_x: int = 0, stride_y: int = 0,
                       padding_x: int = 0, padding_y: int = 0,
                       num_channels: Optional[int] = None,
                       name: Optional[str] = None,
                       layer_attr=None) -> LayerOutput:
    """``BlockExpandLayer``: im2col into a sequence of flattened blocks
    (OCR models; output is a sequence over block positions)."""
    inp = _as_list(input)[0]
    c = num_channels or getattr(inp, "channels", 1)
    attrs = {"channels": c, "block_x": block_x, "block_y": block_y,
             "stride_x": stride_x, "stride_y": stride_y,
             "padding_x": padding_x, "padding_y": padding_y,
             "img_size": getattr(inp, "img_size", None),
             "img_size_y": getattr(inp, "img_size_y", None)}
    return _add_layer(name, "blockexpand", c * block_x * block_y,
                      _mk_inputs([inp]), None, False, attrs, layer_attr)


# ---- dense / misc layers


def tensor_layer(a: LayerOutput, b: LayerOutput, size: int, act=None,
                 name: Optional[str] = None,
                 param_attr: Optional[ParamAttr] = None, bias_attr=True,
                 layer_attr=None) -> LayerOutput:
    """``TensorLayer``: out_k = a W_k b^T."""
    pas = [param_attr, None] if param_attr else None  # one weight, on input 0
    return _add_layer(name, "tensor", size, _mk_inputs([a, b], pas), act,
                      bias_attr, layer_attr=layer_attr, param_attrs=pas)


def selective_fc_layer(input, size: int, select: Optional[LayerOutput] = None,
                       act=None, name: Optional[str] = None,
                       pass_generation: bool = False,
                       has_selected_colums: bool = True,
                       mul_ratio: float = 0.02,
                       param_attr: Optional[ParamAttr] = None,
                       bias_attr=True, layer_attr=None) -> LayerOutput:
    """``SelectiveFullyConnectedLayer``: fc evaluated only on selected
    output columns."""
    ins = _as_list(input)
    if select is not None:
        ins = ins + [select]
    pas = [param_attr] * len(ins) if param_attr else None
    return _add_layer(name, "selective_fc", size, _mk_inputs(ins, pas), act,
                      bias_attr, layer_attr=layer_attr, param_attrs=pas)


def linear_comb_layer(weights: LayerOutput, vectors: LayerOutput,
                      size: Optional[int] = None, name: Optional[str] = None,
                      layer_attr=None) -> LayerOutput:
    """``ConvexCombinationLayer`` (type convex_comb): out = w · reshaped
    vectors."""
    size = size or vectors.size // max(weights.size, 1)
    return _add_layer(name, "convex_comb", size,
                      _mk_inputs([weights, vectors]), None, False,
                      layer_attr=layer_attr)


def conv_shift_layer(a: LayerOutput, b: LayerOutput,
                     name: Optional[str] = None, layer_attr=None
                     ) -> LayerOutput:
    """``ConvShiftLayer``: circular convolution (NTM addressing); b's
    width must be odd."""
    enforce(b.size % 2 == 1, "conv_shift: filter width must be odd")
    return _add_layer(name, "conv_shift", a.size, _mk_inputs([a, b]), None,
                      False, layer_attr=layer_attr)


def row_conv_layer(input: LayerOutput, context_len: int, act=None,
                   name: Optional[str] = None,
                   param_attr: Optional[ParamAttr] = None,
                   layer_attr=None) -> LayerOutput:
    """``RowConvLayer``: lookahead convolution (DeepSpeech2)."""
    pas = [param_attr] if param_attr else None
    return _add_layer(name, "row_conv", input.size, _mk_inputs([input], pas),
                      act, False, {"context_length": context_len},
                      layer_attr, pas)


def gated_unit_layer(input: LayerOutput, size: int, act=None,
                     name: Optional[str] = None, gate_attr=None,
                     gate_param_attr=None, gate_bias_attr=True,
                     inproj_attr=None, inproj_param_attr=None,
                     inproj_bias_attr=True, layer_attr=None) -> LayerOutput:
    """Gated linear unit (``gated_unit_layer``, Dauphin et al.): a
    composite of two fc layers joined by a dotmul operator — the
    reference builds the identical three-layer graph."""
    name = name or _collector.unique_name("gated_unit")
    proj = fc(input, size, act=act, name=f"{name}_input_proj",
              param_attr=inproj_param_attr, bias_attr=inproj_bias_attr,
              layer_attr=inproj_attr)
    gate = fc(input, size, act=SigmoidActivation(), name=f"{name}_gate",
              param_attr=gate_param_attr, bias_attr=gate_bias_attr,
              layer_attr=gate_attr)
    return mixed(operators=[dotmul_operator(proj, gate)], size=size,
                 name=name, layer_attr=layer_attr)


def print_layer(input, format: Optional[str] = None,
                name: Optional[str] = None) -> LayerOutput:
    """``PrintLayer``: host-side debug print of layer values."""
    ins = _as_list(input)
    return _add_layer(name, "print", ins[0].size, _mk_inputs(ins), None,
                      False, {"format": format})


printer_layer = print_layer


# ------------------------------------------------- config-time evaluators
# trainer_config_helpers/evaluators.py __all__: each call registers an
# EvaluatorConfig on the model; the Trainer instantiates and streams them
# during --job=test (reference: Evaluator::create from ModelConfig,
# paddle/gserver/evaluators/Evaluator.h:42).

def evaluator_base(input, type: str, label=None, name: Optional[str] = None,
                   weight=None, **attrs) -> None:
    inp = _as_list(input)[0]
    entry: Dict[str, Any] = {
        "type": type,
        "name": name or f"__{type}_evaluator_{len(_collector.evaluators)}__",
        "input_layer_name": inp.name if isinstance(inp, LayerOutput) else inp,
    }
    if label is not None:
        entry["label_layer_name"] = label.name \
            if isinstance(label, LayerOutput) else label
    if weight is not None:
        entry["weight_layer_name"] = weight.name \
            if isinstance(weight, LayerOutput) else weight
    entry.update({k: v for k, v in attrs.items() if v is not None})
    _collector.evaluators.append(entry)


def _mk_evaluator_fn(public: str, registry: str):
    def fn(input, label=None, name: Optional[str] = None, **kw) -> None:
        evaluator_base(input, registry, label=label, name=name, **kw)

    fn.__name__ = public
    fn.__doc__ = f"``{public}``: registers a ``{registry}`` evaluator " \
                 "on the model config."
    return fn


_EVALUATOR_NAME_MAP = {
    "classification_error_evaluator": "classification_error",
    "auc_evaluator": "auc",
    "pnpair_evaluator": "pnpair",
    "precision_recall_evaluator": "precision_recall",
    "ctc_error_evaluator": "ctc_edit_distance",
    "chunk_evaluator": "chunk",
    "sum_evaluator": "sum",
    "column_sum_evaluator": "column_sum",
    "value_printer_evaluator": "value_printer",
    "gradient_printer_evaluator": "gradient_printer",
    "maxid_printer_evaluator": "maxid_printer",
    "maxframe_printer_evaluator": "maxframe_printer",
    "seqtext_printer_evaluator": "seq_text_printer",
    "classification_error_printer_evaluator": "classification_error_printer",
    "detection_map_evaluator": "detection_map",
}
for _pub, _reg in _EVALUATOR_NAME_MAP.items():
    globals()[_pub] = _mk_evaluator_fn(_pub, _reg)


def get_output_layer(input: LayerOutput, arg_name: str,
                     name: Optional[str] = None, layer_attr=None
                     ) -> LayerOutput:
    """``GetOutputLayer``: select a named extra output (e.g. lstm ``state``)
    of a layer — addressed here as the dotted value ``layer.arg_name``."""
    src = input.name if arg_name in ("", "out") else f"{input.name}.{arg_name}"
    return _add_layer(name, "get_output", input.size,
                      [LayerInput(input_layer_name=src)], None, False,
                      layer_attr=layer_attr)


def gru_step_naive_layer(input: LayerOutput, output_mem: LayerOutput,
                         size: Optional[int] = None,
                         name: Optional[str] = None, act=None,
                         gate_act=None, bias_attr=None, param_attr=None,
                         layer_attr=None) -> LayerOutput:
    """``gru_step_naive_layer``: the reference re-derives the GRU step from
    primitive layers (identical math to the fused ``gru_step``); here both
    names drive the same fused step."""
    return gru_step_layer(input, output_mem, size=size, name=name, act=act,
                          gate_act=gate_act, bias_attr=bias_attr,
                          param_attr=param_attr, layer_attr=layer_attr)


def sub_nested_seq_layer(input: LayerOutput, selected_indices: LayerOutput,
                         name: Optional[str] = None) -> LayerOutput:
    """``SubNestedSequenceLayer``: select subsequences by index."""
    return _add_layer(name, "sub_nested_seq", input.size,
                      _mk_inputs([input, selected_indices]), None, False)


kmax_seq_score_layer = kmax_sequence_score_layer


# ---- SSD detection layers


def priorbox_layer(input: LayerOutput, image: LayerOutput, aspect_ratio,
                   variance, min_size, max_size=[],
                   name: Optional[str] = None) -> LayerOutput:
    """``PriorBoxLayer`` (SSD): generate prior boxes over the feature map
    grid of ``input`` relative to ``image`` dimensions."""
    from ..ops.detection_ops import num_priors_per_cell

    c = getattr(input, "channels", 1)
    lw = getattr(input, "img_size", int(round((input.size / c) ** 0.5)))
    lh = getattr(input, "img_size_y", lw)
    img_conf = _collector.by_name.get(image.name)
    iw = ih = None
    if img_conf is not None:
        iw = img_conf.attrs.get("width") or None
        ih = img_conf.attrs.get("height") or None
    if not iw:
        ic = getattr(image, "channels", 3)
        iw = ih = int(round((image.size / ic) ** 0.5))
    n = lh * lw * num_priors_per_cell(min_size, max_size, aspect_ratio)
    attrs = {"layer_width": lw, "layer_height": lh,
             "image_width": iw, "image_height": ih,
             "min_size": list(min_size), "max_size": list(max_size),
             "aspect_ratio": list(aspect_ratio), "variance": list(variance)}
    return _add_layer(name, "priorbox", n * 8, _mk_inputs([input, image]),
                      None, False, attrs)


def cross_channel_norm_layer(input: LayerOutput, name: Optional[str] = None,
                             param_attr: Optional[ParamAttr] = None
                             ) -> LayerOutput:
    """``CrossChannelNormLayer`` (SSD conv4_3 L2 norm with learned scale)."""
    c = getattr(input, "channels", 1)
    pas = [param_attr] if param_attr else None
    out = _add_layer(name, "cross-channel-norm", input.size,
                     _mk_inputs([input], pas), None, False,
                     {"channels": c}, param_attrs=pas)
    for a in ("channels", "img_size", "img_size_y"):
        if hasattr(input, a):
            setattr(out, a, getattr(input, a))
    return out


def multibox_loss_layer(input_loc, input_conf, priorbox: LayerOutput,
                        label: LayerOutput, num_classes: int,
                        overlap_threshold: float = 0.5,
                        neg_pos_ratio: float = 3.0,
                        neg_overlap: float = 0.5, background_id: int = 0,
                        name: Optional[str] = None) -> LayerOutput:
    """``MultiBoxLossLayer`` (SSD training loss)."""
    locs = _as_list(input_loc)
    confs = _as_list(input_conf)
    enforce(len(locs) == len(confs),
            "multibox_loss: need matching loc/conf input lists")
    attrs = {"num_classes": num_classes, "input_num": len(locs),
             "overlap_threshold": overlap_threshold,
             "neg_pos_ratio": neg_pos_ratio, "neg_overlap": neg_overlap,
             "background_id": background_id}
    return _add_layer(name, "multibox_loss", 1,
                      _mk_inputs([priorbox, label] + locs + confs), None,
                      False, attrs)


def detection_output_layer(input_loc, input_conf, priorbox: LayerOutput,
                           num_classes: int, nms_threshold: float = 0.45,
                           nms_top_k: int = 400, keep_top_k: int = 200,
                           confidence_threshold: float = 0.01,
                           background_id: int = 0,
                           name: Optional[str] = None) -> LayerOutput:
    """``DetectionOutputLayer`` (SSD inference: decode + NMS)."""
    locs = _as_list(input_loc)
    confs = _as_list(input_conf)
    enforce(len(locs) == len(confs),
            "detection_output: need matching loc/conf input lists")
    attrs = {"num_classes": num_classes, "input_num": len(locs),
             "nms_threshold": nms_threshold, "nms_top_k": nms_top_k,
             "keep_top_k": keep_top_k,
             "confidence_threshold": confidence_threshold,
             "background_id": background_id}
    return _add_layer(name, "detection_output", keep_top_k * 7,
                      _mk_inputs([priorbox] + locs + confs), None, False,
                      attrs)


# ---- 3-D image layers


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def img_conv3d_layer(input: LayerOutput, filter_size, num_filters: int,
                     name: Optional[str] = None,
                     num_channels: Optional[int] = None, act=None,
                     groups: int = 1, stride=1, padding=0, bias_attr=None,
                     param_attr: Optional[ParamAttr] = None,
                     shared_biases: bool = True, layer_attr=None,
                     trans: bool = False,
                     layer_type: Optional[str] = None) -> LayerOutput:
    """``Conv3DLayer``/``DeConv3DLayer`` over NDHWC volumes."""
    inp = _as_list(input)[0]
    c = num_channels or getattr(inp, "channels", 1)
    fz, fy, fx = _triple(filter_size)
    sz, sy, sx = _triple(stride)
    pz, py, px = _triple(padding)
    d = getattr(inp, "img_size_z", None)
    h = getattr(inp, "img_size_y", None)
    w = getattr(inp, "img_size", None)
    if w is None:
        side = int(round((inp.size / c) ** (1.0 / 3.0)))
        d = h = w = side
    from ..layers.image3d import conv3d_out_shape

    od, oh, ow = conv3d_out_shape(d, h, w, (fz, fy, fx), (pz, py, px),
                                  (sz, sy, sx))
    attrs = {"channels": c, "num_filters": num_filters, "groups": groups,
             "filter_size": fx, "filter_size_y": fy, "filter_size_z": fz,
             "stride": sx, "stride_y": sy, "stride_z": sz,
             "padding": px, "padding_y": py, "padding_z": pz,
             "img_size": w, "img_size_y": h, "img_size_z": d}
    pas = [param_attr] if param_attr else None
    ltype = layer_type or ("deconv3d" if trans else "conv3d")
    out = _add_layer(name, ltype, num_filters * od * oh * ow,
                     _mk_inputs([inp], pas), act,
                     True if bias_attr is None else bias_attr, attrs,
                     layer_attr, pas)
    out.channels = num_filters
    out.img_size, out.img_size_y, out.img_size_z = ow, oh, od
    return out


def img_pool3d_layer(input: LayerOutput, pool_size,
                     name: Optional[str] = None,
                     num_channels: Optional[int] = None, pool_type=None,
                     stride=2, padding=0, layer_attr=None,
                     pool_size_y=None, stride_y=None, padding_y=None,
                     pool_size_z=None, stride_z=None, padding_z=None,
                     ceil_mode: bool = True) -> LayerOutput:
    """``Pool3DLayer`` over NDHWC volumes."""
    inp = _as_list(input)[0]
    c = num_channels or getattr(inp, "channels", 1)
    kx = pool_size if isinstance(pool_size, int) else pool_size[-1]
    ky = pool_size_y or kx
    kz = pool_size_z or kx
    sx = stride if isinstance(stride, int) else stride[-1]
    sy = stride_y or sx
    sz = stride_z or sx
    px = padding if isinstance(padding, int) else padding[-1]
    py = padding_y if padding_y is not None else px
    pz = padding_z if padding_z is not None else px
    d = getattr(inp, "img_size_z", None)
    h = getattr(inp, "img_size_y", None)
    w = getattr(inp, "img_size", None)
    if w is None:
        side = int(round((inp.size / c) ** (1.0 / 3.0)))
        d = h = w = side
    from ..layers.image3d import conv3d_out_shape

    od, oh, ow = conv3d_out_shape(d, h, w, (kz, ky, kx), (pz, py, px),
                                  (sz, sy, sx), caffe_mode=not ceil_mode)
    attrs = {"channels": c, "pool_type": (pool_type or MaxPooling()).name,
             "pool_size": kx, "pool_size_y": ky, "pool_size_z": kz,
             "stride": sx, "stride_y": sy, "stride_z": sz,
             "padding": px, "padding_y": py, "padding_z": pz,
             "img_size": w, "img_size_y": h, "img_size_z": d}
    out = _add_layer(name, "pool3d", c * od * oh * ow, _mk_inputs([inp]),
                     None, False, attrs, layer_attr)
    out.channels = c
    out.img_size, out.img_size_y, out.img_size_z = ow, oh, od
    return out


# ---- beam cost


@dataclass
class BeamInput:
    """One beam-expansion triple for :func:`cross_entropy_over_beam`
    (``layers.py:6014``)."""

    candidate_scores: LayerOutput
    selected_candidates: LayerOutput
    gold: LayerOutput


def cross_entropy_over_beam(input, name: Optional[str] = None) -> LayerOutput:
    """``cross_entropy_over_beam`` (globally-normalized beam CE,
    ``CrossEntropyOverBeam.cpp``): input is a list of BeamInput triples."""
    beams = _as_list(input)
    ins: List[LayerOutput] = []
    for bi in beams:
        ins.extend([bi.candidate_scores, bi.selected_candidates, bi.gold])
    return _add_layer(name, "cross_entropy_over_beam", 1, _mk_inputs(ins),
                      None, False)


# ---- cost-name aliases (reference __all__ spellings)

cross_entropy_with_selfnorm = cross_entropy_with_selfnorm_cost
multi_binary_label_cross_entropy = multi_binary_label_cross_entropy_cost
