"""Op-emitting layer functions (``python/paddle/v2/framework/layers.py``;
counterpart of ``paddle_tpu/framework/layers.py``, the same code):
fc, embedding, conv2d, pool2d, batch_norm, dropout, losses, StaticRNN…
Each appends ops to the current block and returns the output Variable.
Shapes use -1 for the batch dimension.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils import ConfigError, enforce
from .layer_helper import LayerHelper
from .program import Variable, default_main_program, unique_name


def data(name: str, shape: Sequence[int], dtype="float32",
         lod_level: int = 0, main_program=None, **kw) -> Variable:
    prog = main_program or default_main_program()
    shape = tuple(shape)
    if not shape or shape[0] != -1:
        shape = (-1,) + shape
    return prog.global_block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=True)


def fc(input, size: int, act: Optional[str] = None, name=None,
       num_flatten_dims: int = 1, param_attr=None, bias_attr=True,
       main_program=None, startup_program=None) -> Variable:
    helper = LayerHelper("fc", name=name, main_program=main_program,
                         startup_program=startup_program)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for i, x in enumerate(inputs):
        in_dim = int(np.prod(x.shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, shape=(in_dim, size),
                                    suffix=f"w_{i}" if i else "w")
        tmp = helper.create_tmp_variable(shape=x.shape[:num_flatten_dims]
                                         + (size,))
        helper.block.append_op(
            "mul", inputs={"X": [x], "Y": [w]}, outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims,
                   "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre = mul_results[0]
    else:
        pre = helper.create_tmp_variable(shape=mul_results[0].shape)
        helper.block.append_op("sum", inputs={"X": mul_results},
                               outputs={"Out": [pre]})
    if bias_attr:
        pre = helper.append_bias_op(
            pre, bias_attr=bias_attr if isinstance(bias_attr, dict)
            else None)
    return helper.append_activation(pre, act)


def embedding(input, size: Sequence[int], is_sparse: bool = False,
              param_attr=None, dtype="float32", name=None,
              main_program=None, startup_program=None) -> Variable:
    helper = LayerHelper("embedding", name=name, main_program=main_program,
                         startup_program=startup_program)
    w = helper.create_parameter(param_attr, shape=tuple(size), dtype=dtype,
                                suffix="w")
    out = helper.create_tmp_variable(
        dtype, shape=input.shape + (size[1],))
    helper.block.append_op("lookup_table", inputs={"W": [w],
                                                   "Ids": [input]},
                           outputs={"Out": [out]},
                           attrs={"is_sparse": is_sparse})
    return out


def conv2d(input, num_filters: int, filter_size, stride=1, padding=0,
           groups: int = 1, act=None, name=None, param_attr=None,
           bias_attr=True, main_program=None,
           startup_program=None) -> Variable:
    helper = LayerHelper("conv2d", name=name, main_program=main_program,
                         startup_program=startup_program)
    if isinstance(filter_size, int):
        filter_size = (filter_size, filter_size)
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(padding, int):
        padding = (padding, padding)
    n, c, h, w_sz = input.shape
    flt = helper.create_parameter(
        param_attr,
        shape=(num_filters, c // groups) + tuple(filter_size), suffix="w")
    oh = (h + 2 * padding[0] - filter_size[0]) // stride[0] + 1
    ow = (w_sz + 2 * padding[1] - filter_size[1]) // stride[1] + 1
    out = helper.create_tmp_variable(shape=(n, num_filters, oh, ow))
    helper.block.append_op(
        "conv2d", inputs={"Input": [input], "Filter": [flt]},
        outputs={"Output": [out]},
        attrs={"strides": list(stride), "paddings": list(padding),
               "groups": groups, "dilations": [1, 1]})
    if bias_attr:
        b = helper.create_parameter(None, shape=(num_filters,), suffix="b")
        tmp = helper.create_tmp_variable(shape=out.shape)
        helper.block.append_op("elementwise_add",
                               inputs={"X": [out], "Y": [b]},
                               outputs={"Out": [tmp]}, attrs={"axis": 1})
        out = tmp
    return helper.append_activation(out, act)


def pool2d(input, pool_size, pool_type: str = "max", pool_stride=None,
           pool_padding=0, global_pooling: bool = False, name=None,
           main_program=None, startup_program=None) -> Variable:
    helper = LayerHelper("pool2d", name=name, main_program=main_program,
                         startup_program=startup_program)
    if isinstance(pool_size, int):
        pool_size = (pool_size, pool_size)
    pool_stride = pool_stride or pool_size
    if isinstance(pool_stride, int):
        pool_stride = (pool_stride, pool_stride)
    if isinstance(pool_padding, int):
        pool_padding = (pool_padding, pool_padding)
    n, c, h, w = input.shape
    if global_pooling:
        oh = ow = 1
    else:
        oh = (h + 2 * pool_padding[0] - pool_size[0]) // pool_stride[0] + 1
        ow = (w + 2 * pool_padding[1] - pool_size[1]) // pool_stride[1] + 1
    out = helper.create_tmp_variable(shape=(n, c, oh, ow))
    helper.block.append_op(
        "pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": list(pool_size),
               "strides": list(pool_stride),
               "paddings": list(pool_padding),
               "global_pooling": global_pooling})
    return out


def batch_norm(input, act=None, is_test: bool = False, momentum=0.9,
               epsilon=1e-5, name=None, param_attr=None,
               main_program=None, startup_program=None) -> Variable:
    helper = LayerHelper("batch_norm", name=name,
                         main_program=main_program,
                         startup_program=startup_program)
    c = input.shape[1]
    from .initializer import ConstantInitializer
    scale = helper.create_parameter(param_attr, shape=(c,), suffix="scale",
                                    initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(None, shape=(c,), suffix="bias",
                                   initializer=ConstantInitializer(0.0))
    mean = helper.create_parameter(None, shape=(c,), suffix="mean",
                                   initializer=ConstantInitializer(0.0))
    var = helper.create_parameter(None, shape=(c,), suffix="variance",
                                  initializer=ConstantInitializer(1.0))
    mean.trainable = False
    var.trainable = False
    out = helper.create_tmp_variable(shape=input.shape)
    helper.block.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [var]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [var],
                 "SavedMean": [helper.create_tmp_variable(shape=(c,))],
                 "SavedVariance": [helper.create_tmp_variable(shape=(c,))]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test})
    return helper.append_activation(out, act)


def dropout(x, dropout_prob: float = 0.5, is_test: bool = False, name=None,
            main_program=None, startup_program=None) -> Variable:
    helper = LayerHelper("dropout", name=name, main_program=main_program,
                         startup_program=startup_program)
    out = helper.create_tmp_variable(shape=x.shape)
    mask = helper.create_tmp_variable(shape=x.shape)
    helper.block.append_op("dropout", inputs={"X": [x]},
                           outputs={"Out": [out], "Mask": [mask]},
                           attrs={"dropout_prob": dropout_prob,
                                  "is_test": is_test})
    return out


def cross_entropy(input, label, soft_label: bool = False, name=None,
                  main_program=None, **kw) -> Variable:
    helper = LayerHelper("cross_entropy", name=name,
                         main_program=main_program)
    out = helper.create_tmp_variable(shape=(input.shape[0], 1))
    helper.block.append_op("cross_entropy",
                           inputs={"X": [input], "Label": [label]},
                           outputs={"Y": [out]},
                           attrs={"soft_label": soft_label})
    return out


def softmax(input, name=None, main_program=None, **kw) -> Variable:
    helper = LayerHelper("softmax", name=name, main_program=main_program)
    out = helper.create_tmp_variable(shape=input.shape)
    helper.block.append_op("softmax", inputs={"X": [input]},
                           outputs={"Out": [out]})
    return out


def square_error_cost(input, label, name=None, main_program=None,
                      **kw) -> Variable:
    helper = LayerHelper("square_error_cost", name=name,
                         main_program=main_program)
    minus_out = helper.create_tmp_variable(shape=input.shape)
    helper.block.append_op("elementwise_sub",
                           inputs={"X": [input], "Y": [label]},
                           outputs={"Out": [minus_out]})
    out = helper.create_tmp_variable(shape=input.shape)
    helper.block.append_op("square", inputs={"X": [minus_out]},
                           outputs={"Out": [out]})
    return out


def mean(x, name=None, main_program=None, **kw) -> Variable:
    helper = LayerHelper("mean", name=name, main_program=main_program)
    out = helper.create_tmp_variable(shape=())
    helper.block.append_op("mean", inputs={"X": [x]},
                           outputs={"Out": [out]})
    return out


def accuracy(input, label, k: int = 1, name=None, main_program=None,
             **kw) -> Variable:
    helper = LayerHelper("accuracy", name=name, main_program=main_program)
    acc = helper.create_tmp_variable(shape=())
    correct = helper.create_tmp_variable(shape=())
    total = helper.create_tmp_variable(shape=())
    helper.block.append_op("accuracy",
                           inputs={"Out": [input], "Label": [label]},
                           outputs={"Accuracy": [acc],
                                    "Correct": [correct],
                                    "Total": [total]}, attrs={"k": k})
    return acc


def concat(input: List[Variable], axis: int = 1, name=None,
           main_program=None, **kw) -> Variable:
    helper = LayerHelper("concat", name=name, main_program=main_program)
    shape = list(input[0].shape)
    shape[axis] = sum(v.shape[axis] for v in input)
    out = helper.create_tmp_variable(shape=tuple(shape))
    helper.block.append_op("concat", inputs={"X": list(input)},
                           outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input: List[Variable], name=None, main_program=None,
         **kw) -> Variable:
    helper = LayerHelper("sum", name=name, main_program=main_program)
    out = helper.create_tmp_variable(shape=input[0].shape)
    helper.block.append_op("sum", inputs={"X": list(input)},
                           outputs={"Out": [out]})
    return out


def elementwise_add(x, y, axis: int = -1, act=None, name=None,
                    main_program=None, **kw) -> Variable:
    helper = LayerHelper("elementwise_add", name=name,
                         main_program=main_program)
    out = helper.create_tmp_variable(shape=x.shape)
    helper.block.append_op("elementwise_add",
                           inputs={"X": [x], "Y": [y]},
                           outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def scale(x, scale_val: float = 1.0, bias: float = 0.0, name=None,
          main_program=None, **kw) -> Variable:
    helper = LayerHelper("scale", name=name, main_program=main_program)
    out = helper.create_tmp_variable(shape=x.shape)
    helper.block.append_op("scale", inputs={"X": [x]},
                           outputs={"Out": [out]},
                           attrs={"scale": scale_val, "bias": bias})
    return out


def reshape(x, shape: Sequence[int], name=None, main_program=None,
            **kw) -> Variable:
    helper = LayerHelper("reshape", name=name, main_program=main_program)
    out = helper.create_tmp_variable(shape=tuple(shape))
    helper.block.append_op("reshape", inputs={"X": [x]},
                           outputs={"Out": [out]},
                           attrs={"shape": list(shape)})
    return out


def transpose(x, perm: Sequence[int], name=None, main_program=None,
              **kw) -> Variable:
    helper = LayerHelper("transpose", name=name, main_program=main_program)
    out = helper.create_tmp_variable(
        shape=tuple(x.shape[i] for i in perm))
    helper.block.append_op("transpose", inputs={"X": [x]},
                           outputs={"Out": [out]},
                           attrs={"axis": list(perm)})
    return out


def sequence_pool(input, pool_type: str = "AVERAGE", name=None,
                  main_program=None, **kw) -> Variable:
    helper = LayerHelper("sequence_pool", name=name,
                         main_program=main_program)
    out = helper.create_tmp_variable(shape=(input.shape[0],
                                            input.shape[-1]))
    helper.block.append_op("sequence_pool", inputs={"X": [input]},
                           outputs={"Out": [out]},
                           attrs={"pooltype": pool_type})
    return out


def sequence_conv(input, num_filters: int, filter_size: int = 3,
                  filter_stride: int = 1, act=None, padding=None,
                  name=None, param_attr=None, bias_attr=True,
                  main_program=None, startup_program=None) -> Variable:
    helper = LayerHelper("sequence_conv", name=name,
                         main_program=main_program,
                         startup_program=startup_program)
    in_dim = input.shape[-1]
    flt = helper.create_parameter(
        param_attr, shape=(filter_size * in_dim, num_filters), suffix="w")
    out = helper.create_tmp_variable(shape=input.shape[:-1]
                                     + (num_filters,))
    helper.block.append_op(
        "sequence_conv", inputs={"X": [input], "Filter": [flt]},
        outputs={"Out": [out]},
        attrs={"contextStart": -int(filter_size // 2),
               "contextLength": filter_size,
               "contextStride": filter_stride})
    if bias_attr:
        out = helper.append_bias_op(out)
    return helper.append_activation(out, act)


def lstm(input, size: int, is_reverse: bool = False, name=None,
         param_attr=None, bias_attr=True, gate_activation="sigmoid",
         cell_activation="tanh", main_program=None,
         startup_program=None):
    """Full-sequence LSTM op (``paddle/operators/lstm_op.cc``): input is
    the 4H projection [B, T, 4H]; returns (hidden, cell) LoD outputs."""
    helper = LayerHelper("lstm", name=name, main_program=main_program,
                         startup_program=startup_program)
    w = helper.create_parameter(param_attr, shape=(size, 4 * size),
                                suffix="w")
    inputs = {"Input": [input], "Weight": [w]}
    if bias_attr:
        b = helper.create_parameter(None, shape=(4 * size,), suffix="b")
        inputs["Bias"] = [b]
    hidden = helper.create_tmp_variable(shape=input.shape[:-1] + (size,))
    cell = helper.create_tmp_variable(shape=input.shape[:-1] + (size,))
    bg = helper.create_tmp_variable(shape=input.shape)
    bc = helper.create_tmp_variable(shape=input.shape)
    helper.block.append_op(
        "lstm", inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell], "BatchGate": [bg],
                 "BatchCellPreAct": [bc]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation})
    return hidden, cell


def cast(x, dtype: str, name=None, main_program=None, **kw) -> Variable:
    helper = LayerHelper("cast", name=name, main_program=main_program)
    out = helper.create_tmp_variable(dtype=dtype, shape=x.shape)
    helper.block.append_op("cast", inputs={"X": [x]},
                           outputs={"Out": [out]},
                           attrs={"dtype": dtype})
    return out


def topk(input, k: int = 1, name=None, main_program=None, **kw):
    helper = LayerHelper("top_k", name=name, main_program=main_program)
    vals = helper.create_tmp_variable(shape=input.shape[:-1] + (k,))
    idx = helper.create_tmp_variable(dtype="int32",
                                     shape=input.shape[:-1] + (k,))
    helper.block.append_op("top_k", inputs={"X": [input]},
                           outputs={"Out": [vals], "Indices": [idx]},
                           attrs={"k": k})
    return vals, idx


class StaticRNN:
    """Static (padded) RNN builder over a sub-block
    (``python/paddle/v2/framework/layers.py`` StaticRNN → recurrent op);
    run by the Executor as a Python loop over time."""

    def __init__(self, name=None, main_program=None):
        self.helper = LayerHelper("static_rnn", name=name,
                                  main_program=main_program)
        self.prog = self.helper.main_program
        self.sub_block = None
        self.seq_inputs: List[Variable] = []     # outer sequence vars
        self.inner_inputs: List[Variable] = []   # per-step views
        self.memories: List[tuple] = []          # (init, inner_mem, state)
        self.outputs: List[tuple] = []           # (inner, outer)
        self._entered = False

    def step(self):
        rnn = self

        class _Guard:
            def __enter__(self):
                rnn.sub_block = rnn.prog.create_block()
                rnn.prog._current = rnn.sub_block.idx
                return rnn

            def __exit__(self, *a):
                rnn.prog._current = rnn.sub_block.parent_idx
                rnn._complete()
                return False

        return _Guard()

    def step_input(self, x: Variable) -> Variable:
        self.seq_inputs.append(x)
        inner = self.sub_block.create_var(
            name=unique_name("rnn_step_in"),
            shape=(x.shape[0],) + tuple(x.shape[2:]), dtype=x.dtype)
        self.inner_inputs.append(inner)
        return inner

    def memory(self, init: Optional[Variable] = None, shape=None,
               batch_ref: Optional[Variable] = None,
               init_value: float = 0.0) -> Variable:
        if init is None:
            enforce(batch_ref is not None or shape is not None,
                    "memory needs init or shape/batch_ref")
            b = self.prog.blocks[self.sub_block.parent_idx]
            init = b.create_var(name=unique_name("rnn_mem_init"),
                                shape=tuple(shape), dtype="float32")
            with self.prog.block_guard(b):
                b.append_op("fill_constant_batch_size_like",
                            inputs={"Input": [batch_ref or
                                              self.seq_inputs[0]]},
                            outputs={"Out": [init]},
                            attrs={"shape": [s if s != -1 else 1
                                             for s in init.shape],
                                   "value": init_value})
        mem = self.sub_block.create_var(name=unique_name("rnn_mem"),
                                        shape=init.shape,
                                        dtype=init.dtype)
        self.memories.append([init, mem, None])
        return mem

    def update_memory(self, mem: Variable, new: Variable) -> None:
        for rec in self.memories:
            if rec[1] is mem:
                rec[2] = new
                return
        raise ConfigError("update_memory on unknown memory")

    def output(self, *outputs: Variable) -> None:
        for o in outputs:
            outer = self.prog.blocks[self.sub_block.parent_idx].create_var(
                name=unique_name("rnn_out"),
                shape=(o.shape[0], -1) + tuple(o.shape[1:]),
                dtype=o.dtype)
            self.outputs.append((o, outer))

    def _complete(self):
        for rec in self.memories:
            enforce(rec[2] is not None,
                    "every memory needs update_memory before step ends")
        parent = self.prog.blocks[self.sub_block.parent_idx]
        parent.append_op(
            "recurrent",
            inputs={"inputs": self.seq_inputs,
                    "initial_states": [m[0] for m in self.memories]},
            outputs={"outputs": [o for _, o in self.outputs]},
            attrs={"sub_block": self.sub_block.idx,
                   "inner_inputs": [v.name for v in self.inner_inputs],
                   "ex_states": [m[1].name for m in self.memories],
                   "states": [m[2].name for m in self.memories],
                   "inner_outputs": [o.name for o, _ in self.outputs]})

    def __call__(self):
        outs = [o for _, o in self.outputs]
        return outs[0] if len(outs) == 1 else outs
