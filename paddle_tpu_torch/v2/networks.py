"""Composite network helpers.

Reference: ``trainer_config_helpers/networks.py`` — the full ``__all__``
set: sequence_conv_pool/text_conv_pool, simple_img_conv_pool,
img_conv_bn_pool, img_conv_group, small_vgg, vgg_16_network, simple_lstm,
lstmemory_unit, lstmemory_group, gru_unit, gru_group, simple_gru,
simple_gru2, bidirectional_gru, bidirectional_lstm, simple_attention,
dot_product_attention, inputs, outputs (+ stacked_lstm_net from the
sentiment demo).  Counterpart of ``paddle_tpu/v2/networks.py``, the
port's own copy: the composites a config file's namespace holds.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..config import dsl
from ..utils import ConfigError, enforce
from ..config.dsl import (
    AvgPooling,
    LinearActivation,
    MaxPooling,
    ReluActivation,
    SequenceSoftmaxActivation,
    SigmoidActivation,
    SoftmaxActivation,
    StepInput,
    TanhActivation,
    batch_norm,
    concat,
    data,
    dropout,
    expand,
    fc,
    first_seq,
    full_matrix_projection,
    grumemory,
    img_conv,
    img_pool,
    last_seq,
    lstmemory,
    memory,
    mixed,
    pooling,
    recurrent_group,
)


def simple_img_conv_pool(input, filter_size: int, num_filters: int,
                         pool_size: int, num_channel: Optional[int] = None,
                         pool_stride: int = 2, act=None, padding: int = 1,
                         img_size: Optional[int] = None, name=None):
    conv = img_conv(input, filter_size=filter_size, num_filters=num_filters,
                    num_channels=num_channel, padding=padding,
                    img_size=img_size, act=act or ReluActivation(),
                    name=name and f"{name}_conv")
    return img_pool(conv, pool_size=pool_size, stride=pool_stride,
                    pool_type=MaxPooling(), name=name and f"{name}_pool")


def img_conv_group(input, conv_num_filter: Sequence[int],
                   conv_filter_size: int = 3, num_channels=None,
                   pool_size: int = 2, pool_stride: int = 2,
                   conv_padding: int = 1, conv_act=None,
                   conv_with_batchnorm: bool = False,
                   conv_batchnorm_drop_rate=None, pool_type=None,
                   img_size: Optional[int] = None, **_ignored):
    tmp = input
    channels = num_channels
    for i, nf in enumerate(conv_num_filter):
        tmp = img_conv(tmp, filter_size=conv_filter_size, num_filters=nf,
                       num_channels=channels, padding=conv_padding,
                       img_size=img_size,
                       act=LinearActivation() if conv_with_batchnorm
                       else (conv_act or ReluActivation()))
        img_size = None
        channels = None
        if conv_with_batchnorm:
            drop = 0.0
            if conv_batchnorm_drop_rate:
                drop = conv_batchnorm_drop_rate[i] \
                    if isinstance(conv_batchnorm_drop_rate, (list, tuple)) \
                    else conv_batchnorm_drop_rate
            tmp = batch_norm(tmp, act=conv_act or ReluActivation(),
                             layer_attr=dsl.ExtraAttr(drop_rate=drop))
    return img_pool(tmp, pool_size=pool_size, stride=pool_stride,
                    pool_type=pool_type or MaxPooling())


def vgg_16_network(input_image, num_channels: int, num_classes: int = 1000,
                   img_size: int = 224):
    """``vgg_16_network`` (networks.py): 5 conv groups + 2×fc4096."""
    tmp = img_conv_group(input_image, [64, 64], num_channels=num_channels,
                         conv_with_batchnorm=True, img_size=img_size)
    tmp = img_conv_group(tmp, [128, 128], conv_with_batchnorm=True)
    tmp = img_conv_group(tmp, [256, 256, 256], conv_with_batchnorm=True)
    tmp = img_conv_group(tmp, [512, 512, 512], conv_with_batchnorm=True)
    tmp = img_conv_group(tmp, [512, 512, 512], conv_with_batchnorm=True)
    tmp = fc(tmp, size=4096, act=ReluActivation(),
             layer_attr=dsl.ExtraAttr(drop_rate=0.5))
    tmp = fc(tmp, size=4096, act=ReluActivation(),
             layer_attr=dsl.ExtraAttr(drop_rate=0.5))
    return fc(tmp, size=num_classes, act=SoftmaxActivation())


def simple_lstm(input, size: int, name=None, reverse: bool = False,
                mat_param_attr=None, bias_param_attr=None,
                inner_param_attr=None, act=None, gate_act=None,
                state_act=None):
    """fc(4H) + lstmemory (``simple_lstm`` in networks.py)."""
    proj = fc(input, size=size * 4, act=LinearActivation(), bias_attr=False,
              param_attr=mat_param_attr, name=name and f"{name}_transform")
    return lstmemory(proj, name=name, reverse=reverse, act=act,
                     gate_act=gate_act, state_act=state_act,
                     bias_attr=bias_param_attr if bias_param_attr is not None
                     else True,
                     param_attr=inner_param_attr)


def simple_gru(input, size: int, name=None, reverse: bool = False, act=None,
               gate_act=None, **kw):
    proj = fc(input, size=size * 3, act=LinearActivation(), bias_attr=False,
              name=name and f"{name}_transform")
    return grumemory(proj, name=name, reverse=reverse, act=act,
                     gate_act=gate_act)


def bidirectional_lstm(input, size: int, name=None, return_seq: bool = False):
    fwd = simple_lstm(input, size, name=name and f"{name}_fwd")
    bwd = simple_lstm(input, size, name=name and f"{name}_bwd", reverse=True)
    if return_seq:
        return concat([fwd, bwd])
    return concat([last_seq(fwd), first_seq(bwd)])


def stacked_lstm_net(input, hid_dim: int, stacked_num: int = 3,
                     act=None):
    """Stacked alternating-direction LSTM (sentiment demo topology)."""
    lstm = simple_lstm(input, hid_dim)
    inputs = [input, lstm]
    for i in range(2, stacked_num + 1):
        nxt = fc(inputs, size=hid_dim * 4, act=LinearActivation(),
                 bias_attr=False)
        lstm = lstmemory(nxt, reverse=(i % 2 == 0))
        inputs = [nxt, lstm]
    return lstm


def sequence_conv_pool(input, context_len: int, hidden_size: int,
                       name=None, context_start=None, pool_type=None,
                       context_proj_param_attr=None, fc_act=None):
    """context projection + fc + seq pooling (text conv)."""
    ctx = mixed(
        [dsl.context_projection(input, context_len, context_start)],
        size=input.size * context_len, name=name and f"{name}_ctx")
    h = fc(ctx, size=hidden_size, act=fc_act or LinearActivation(),
           name=name and f"{name}_fc")
    return pooling(h, pooling_type=pool_type or MaxPooling(),
                   name=name and f"{name}_pool")


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     name=None):
    """Bahdanau attention (``simple_attention`` in networks.py):
    score = v·tanh(enc_proj + dec_proj); context = Σ softmax(score)·enc."""
    name = name or dsl._collector.unique_name("attention")
    decoder_proj = fc(decoder_state, size=encoded_proj.size,
                      act=LinearActivation(), bias_attr=False,
                      param_attr=transform_param_attr,
                      name=f"{name}_transform")
    expanded = expand(decoder_proj, encoded_proj)
    combined = dsl.addto([encoded_proj, expanded], act=TanhActivation(),
                         name=f"{name}_combine")
    attention_weight = fc(combined, size=1, act=SequenceSoftmaxActivation(),
                          bias_attr=False, param_attr=softmax_param_attr,
                          name=f"{name}_weight")
    scaled = dsl.scaling_layer([attention_weight, encoded_sequence],
                               name=f"{name}_scale")
    return pooling(scaled, pooling_type=dsl.SumPooling(),
                   name=f"{name}_context")


def img_conv_bn_pool(input, filter_size: int, num_filters: int,
                     pool_size: int, name=None, pool_type=None, act=None,
                     groups: int = 1, conv_stride: int = 1,
                     conv_padding: int = 0, conv_bias_attr=None,
                     num_channel=None, conv_param_attr=None,
                     pool_stride: int = 1,
                     img_size: Optional[int] = None, **_ignored):
    """conv(linear) → batch_norm(act) → pool (``networks.py:231``)."""
    conv = img_conv(input, filter_size=filter_size, num_filters=num_filters,
                    num_channels=num_channel, groups=groups,
                    stride=conv_stride, padding=conv_padding,
                    act=LinearActivation(), img_size=img_size,
                    bias_attr=conv_bias_attr
                    if conv_bias_attr is not None else True,
                    param_attr=conv_param_attr,
                    name=name and f"{name}_conv")
    bn = batch_norm(conv, act=act or ReluActivation(),
                    name=name and f"{name}_bn")
    return img_pool(bn, pool_size=pool_size, stride=pool_stride,
                    pool_type=pool_type or MaxPooling(),
                    name=name and f"{name}_pool")


def small_vgg(input_image, num_channels: int, num_classes: int,
              img_size: int = 32):
    """The CIFAR VGG (``networks.py:438``): 4 BN-conv groups (64/128/
    256/512) + pool + dropout + fc512 + bn + softmax fc."""
    def group(ipt, num_filter, times, dropouts, channels=None, size=None):
        return img_conv_group(
            ipt, [num_filter] * times, num_channels=channels,
            pool_size=2, pool_stride=2, conv_filter_size=3,
            conv_act=ReluActivation(), conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type=MaxPooling(),
            img_size=size)

    tmp = group(input_image, 64, 2, [0.3, 0], num_channels, img_size)
    tmp = group(tmp, 128, 2, [0.4, 0])
    tmp = group(tmp, 256, 3, [0.4, 0.4, 0])
    tmp = group(tmp, 512, 3, [0.4, 0.4, 0])
    tmp = img_pool(tmp, pool_size=2, stride=2, pool_type=MaxPooling())
    tmp = dsl.dropout_layer(tmp, dropout_rate=0.5)
    tmp = fc(tmp, size=512, act=LinearActivation(),
             layer_attr=dsl.ExtraAttr(drop_rate=0.5))
    tmp = batch_norm(tmp, act=ReluActivation())
    return fc(tmp, size=num_classes, act=SoftmaxActivation())


def lstmemory_unit(input, out_memory=None, name=None,
                   size: Optional[int] = None, param_attr=None, act=None,
                   gate_act=None, state_act=None,
                   input_proj_bias_attr=None, lstm_bias_attr=None,
                   **_ignored):
    """One LSTM time step for use inside ``recurrent_group``
    (``networks.py:638``): the layer's own output memory carries h, a
    ``.state`` memory carries c; gates = input + W·h_prev."""
    if size is None:
        enforce(input.size % 4 == 0,
                f"lstmemory_unit input size {input.size} not divisible by 4")
        size = input.size // 4
    name = name or dsl._collector.unique_name("lstmemory_unit")
    out_mem = out_memory if out_memory is not None \
        else memory(name=name, size=size)
    state_mem = memory(name=f"{name}.state", size=size)
    m = mixed(
        [dsl.identity_projection(input),
         full_matrix_projection(out_mem.out if hasattr(out_mem, "out")
                                else out_mem, size=size * 4,
                                param_attr=param_attr)],
        size=size * 4, name=f"{name}_input_recurrent",
        bias_attr=input_proj_bias_attr
        if input_proj_bias_attr is not None else False)
    return dsl.lstm_step_layer(
        m, state_mem.out, size=size, name=name, act=act,
        gate_act=gate_act, state_act=state_act,
        bias_attr=lstm_bias_attr if lstm_bias_attr is not None else True)


def lstmemory_group(input, size: Optional[int] = None, name=None,
                    out_memory=None, reverse: bool = False, param_attr=None,
                    act=None, gate_act=None, state_act=None,
                    input_proj_bias_attr=None, lstm_bias_attr=None,
                    **_ignored):
    """``recurrent_group`` version of lstmemory (``networks.py:749``) —
    same math, but the per-step hidden/cell states are addressable."""
    name = name or dsl._collector.unique_name("lstmemory_group")

    def step(ipt):
        return lstmemory_unit(
            ipt, out_memory=out_memory, name=name, size=size,
            param_attr=param_attr, act=act, gate_act=gate_act,
            state_act=state_act,
            input_proj_bias_attr=input_proj_bias_attr,
            lstm_bias_attr=lstm_bias_attr)

    return recurrent_group(step, [StepInput(input)],
                           name=f"{name}_recurrent_group", reverse=reverse)


def gru_unit(input, memory_boot=None, size: Optional[int] = None,
             name=None, gru_bias_attr=None, gru_param_attr=None,
             act=None, gate_act=None, naive: bool = False, **_ignored):
    """One GRU time step inside ``recurrent_group``
    (``networks.py:845``); input is the 3H projection."""
    enforce(input.size % 3 == 0,
            f"gru_unit input size {input.size} not divisible by 3")
    if size is None:
        size = input.size // 3
    name = name or dsl._collector.unique_name("gru_unit")
    out_mem = memory(name=name, size=size, boot_layer=memory_boot)
    step_fn = dsl.gru_step_naive_layer if naive else dsl.gru_step_layer
    return step_fn(input, out_mem.out, size=size, name=name,
                   bias_attr=gru_bias_attr
                   if gru_bias_attr is not None else True,
                   param_attr=gru_param_attr, act=act, gate_act=gate_act)


def gru_group(input, memory_boot=None, size: Optional[int] = None,
              name=None, reverse: bool = False, gru_bias_attr=None,
              gru_param_attr=None, act=None, gate_act=None,
              naive: bool = False, **_ignored):
    """``recurrent_group`` version of grumemory (``networks.py:907``)."""
    name = name or dsl._collector.unique_name("gru_group")

    def step(ipt):
        return gru_unit(ipt, memory_boot=memory_boot, name=name, size=size,
                        gru_bias_attr=gru_bias_attr,
                        gru_param_attr=gru_param_attr, act=act,
                        gate_act=gate_act, naive=naive)

    return recurrent_group(step, [StepInput(input)],
                           name=f"{name}_recurrent_group", reverse=reverse)


def simple_gru2(input, size: int, name=None, reverse: bool = False,
                mixed_param_attr=None, mixed_bias_attr=None,
                gru_param_attr=None, gru_bias_attr=None, act=None,
                gate_act=None, **_ignored):
    """Like simple_gru but through ``grumemory`` (``networks.py:1068``)
    — faster, states not addressable."""
    name = name or dsl._collector.unique_name("simple_gru2")
    m = mixed([full_matrix_projection(input, size=size * 3,
                                      param_attr=mixed_param_attr)],
              size=size * 3, name=f"{name}_transform",
              bias_attr=mixed_bias_attr
              if mixed_bias_attr is not None else False)
    return grumemory(m, name=name, reverse=reverse,
                     bias_attr=gru_bias_attr
                     if gru_bias_attr is not None else True,
                     param_attr=gru_param_attr, act=act, gate_act=gate_act)


def bidirectional_gru(input, size: int, name=None,
                      return_seq: bool = False, **kw):
    """Forward + backward simple_gru2, concatenated
    (``networks.py:1130``); kwargs prefixed fwd_/bwd_ route to the
    respective direction."""
    name = name or dsl._collector.unique_name("bidirectional_gru")
    allowed_plain = {"concat_act", "concat_attr", "last_seq_attr",
                     "first_seq_attr"}
    unknown = [k for k in kw
               if not (k.startswith("fwd_") or k.startswith("bwd_")
                       or k in allowed_plain)]
    if unknown:
        raise ConfigError(
            f"bidirectional_gru: unknown kwargs {unknown} — direction "
            "attrs must be prefixed fwd_/bwd_ (e.g. fwd_gru_bias_attr)")
    fwd_kw = {k[len("fwd_"):]: v for k, v in kw.items()
              if k.startswith("fwd_")}
    bwd_kw = {k[len("bwd_"):]: v for k, v in kw.items()
              if k.startswith("bwd_")}
    fw = simple_gru2(input, size, name=f"{name}_fw", **fwd_kw)
    bw = simple_gru2(input, size, name=f"{name}_bw", reverse=True,
                     **bwd_kw)
    if return_seq:
        return concat([fw, bw], act=kw.get("concat_act"),
                      layer_attr=kw.get("concat_attr"))
    return concat([last_seq(fw, layer_attr=kw.get("last_seq_attr")),
                   first_seq(bw, layer_attr=kw.get("first_seq_attr"))],
                  act=kw.get("concat_act"),
                  layer_attr=kw.get("concat_attr"))


def dot_product_attention(encoded_sequence, attended_sequence,
                          transformed_state, softmax_param_attr=None,
                          name=None):
    """Dot-product attention (``networks.py:1402``): score =
    stateᵀ·h_j, context = Σ softmax(score)·z_j over attended_sequence."""
    enforce(transformed_state.size == encoded_sequence.size,
            "dot_product_attention: transformed_state and encoded_sequence "
            f"sizes differ ({transformed_state.size} vs "
            f"{encoded_sequence.size})")
    name = name or dsl._collector.unique_name("dot_product_attention")
    expanded = expand(transformed_state, encoded_sequence,
                      name=f"{name}_expand")
    m = dsl.linear_comb_layer(weights=expanded, vectors=encoded_sequence,
                              name=f"{name}_dot-product")
    attention_weight = fc(m, size=1, act=SequenceSoftmaxActivation(),
                          param_attr=softmax_param_attr, bias_attr=False,
                          name=f"{name}_softmax")
    scaled = dsl.scaling_layer([attention_weight, attended_sequence],
                               name=f"{name}_scaling")
    return pooling(scaled, pooling_type=dsl.SumPooling(),
                   name=f"{name}_pooling")


# text_conv_pool is the reference's other name for the same composite
text_conv_pool = sequence_conv_pool

# input/output declarations (networks.py:1485/1503) — the v1 config-file
# forms live in config_parser; re-exported here for helper parity
from ..config.config_parser import outputs  # noqa: E402,F401
from ..config.dsl import inputs  # noqa: E402,F401
