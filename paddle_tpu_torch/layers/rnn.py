"""Recurrent layers (counterpart of ``paddle_tpu/layers/rnn.py``):
``lstmemory``, ``gated_recurrent`` (``grumemory``), ``recurrent``, the
step layers ``lstm_step`` and ``gru_step`` that recurrent groups use,
and the 2-D ``mdlstmemory``.

Like the reference, ``lstmemory``, ``gated_recurrent`` and ``recurrent``
take their input already projected (to 4H, 3H, H) by an upstream fc
layer.  Like the JAX layers, they and ``mdlstmemory`` return their value
without ``finalize``: a ``drop_rate`` or ``error_clipping_threshold`` on
them has no effect; the step layers take dropout and the error clip
alone (``apply_extras``).
"""

from __future__ import annotations

import math

import torch

from ..core.sequence import SequenceBatch, like, value_of
from ..ops import recurrent_ops
from ..ops.activations import get_activation
from ..ops.recurrent_ops import LstmState
from ..utils import enforce
from .base import Layer, register_layer


@register_layer("lstmemory")
class LstmLayer(Layer):
    """Input: a sequence of ``[B, T, 4H]`` pre-projected gates; output
    ``[B, T, H]``.  Parameters: recurrent weight ``[H, 4H]`` and bias
    ``[7H]`` = 4H gate bias + 3H peephole checks (i, f, o)."""

    def param_specs(self):
        h = self.conf.size
        specs = [self._weight_spec(0, (h, 4 * h), initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((7 * h,)))
        return specs

    def forward(self, params, inputs, ctx):
        seq = inputs[0]
        enforce(isinstance(seq, SequenceBatch),
                "lstmemory needs sequence input")
        h = self.conf.size
        gate_bias = check_i = check_f = check_o = None
        if self.conf.with_bias:
            bias = params[self.bias_name()]
            gate_bias = bias[:4 * h]
            check_i = bias[4 * h:5 * h]
            check_f = bias[5 * h:6 * h]
            check_o = bias[6 * h:7 * h]
        # reference routing: active_type acts on the candidate input,
        # active_state_type on the cell output
        out, _ = recurrent_ops.lstm_sequence(
            seq, None, params[self.weight_name(0)], gate_bias, check_i,
            check_f, check_o,
            reverse=self.conf.attrs.get("reversed", False),
            gate_act=self.conf.attrs.get("active_gate_type", "sigmoid"),
            cell_act=self.conf.active_type or "tanh",
            out_act=self.conf.attrs.get("active_state_type", "tanh"))
        return out


@register_layer("gated_recurrent", "grumemory")
class GatedRecurrentLayer(Layer):
    """Input: a sequence of ``[B, T, 3H]`` pre-projected gates (u, r, c);
    output ``[B, T, H]``.  Parameters: recurrent weight ``[H, 3H]`` and
    bias ``[3H]``."""

    def param_specs(self):
        h = self.conf.size
        specs = [self._weight_spec(0, (h, 3 * h), initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((3 * h,)))
        return specs

    def forward(self, params, inputs, ctx):
        seq = inputs[0]
        enforce(isinstance(seq, SequenceBatch),
                "grumemory needs sequence input")
        out, _ = recurrent_ops.gru_sequence(
            seq, None, params[self.weight_name(0)],
            params[self.bias_name()] if self.conf.with_bias else None,
            reverse=self.conf.attrs.get("reversed", False),
            gate_act=self.conf.attrs.get("active_gate_type", "sigmoid"),
            act=self.conf.active_type or "tanh")
        return out


@register_layer("gru_step")
class GruStepLayer(Layer):
    """One GRU step inside a recurrent group: inputs [0] the projected
    input ``[B, 3H]``, [1] the previous state ``[B, H]`` (a memory);
    weight ``[H, 3H]``, bias ``[3H]`` added to the input.  The
    activations happen inside the step, so it takes dropout and the
    error clip alone (``apply_extras``), as the JAX layer."""

    def param_specs(self):
        h = self.conf.size
        specs = [self._weight_spec(0, (h, 3 * h), initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((3 * h,)))
        return specs

    def forward(self, params, inputs, ctx):
        x = value_of(inputs[0])
        if self.conf.with_bias:
            x = x + params[self.bias_name()]
        out = recurrent_ops.gru_unit(
            x, value_of(inputs[1]), params[self.weight_name(0)],
            gate_act=self.conf.attrs.get("active_gate_type", "sigmoid"),
            act=self.conf.active_type or "tanh")
        return self.apply_extras(like(inputs[0], out), ctx)


@register_layer("recurrent")
class RecurrentLayer(Layer):
    """The plain recurrence over a pre-projected sequence
    (``RecurrentLayer``): weight ``[H, H]``, bias ``[H]``."""

    def param_specs(self):
        h = self.conf.size
        specs = [self._weight_spec(0, (h, h), initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec((h,)))
        return specs

    def forward(self, params, inputs, ctx):
        out, _ = recurrent_ops.simple_rnn(
            inputs[0], params[self.weight_name(0)],
            params[self.bias_name()] if self.conf.with_bias else None,
            reverse=self.conf.attrs.get("reversed", False),
            act=self.conf.active_type or "tanh")
        return out


@register_layer("lstm_step")
class LstmStepLayer(Layer):
    """One LSTM step inside a recurrent group (``LstmStepLayer``): inputs
    [0] the gates ``[B, 4H]`` with every contribution in them (no
    weight), [1] the previous cell ``[B, H]``; the bias ``[3H]`` holds
    the peephole checks (i, f, o).  Its value is h, and ``.state`` the
    new cell (``get_output`` reads it)."""

    def param_specs(self):
        if self.conf.with_bias:
            return [self._bias_spec((3 * self.conf.size,))]
        return []

    def forward(self, params, inputs, ctx):
        x = value_of(inputs[0])
        c_prev = value_of(inputs[1])
        h = self.conf.size
        ci = cf = co = None
        if self.conf.with_bias:
            checks = params[self.bias_name()]
            ci, cf, co = checks[:h], checks[h:2 * h], checks[2 * h:3 * h]
        state, out = recurrent_ops.lstm_gate_step(
            x, LstmState(h=torch.zeros_like(c_prev), c=c_prev), None,
            ci, cf, co,
            gate_act=self.conf.attrs.get("active_gate_type", "sigmoid"),
            cell_act=self.conf.active_type or "tanh",
            out_act=self.conf.attrs.get("active_state_type", "tanh"))
        return {"out": self.apply_extras(like(inputs[0], out), ctx),
                "state": like(inputs[0], state.c)}


@register_layer("mdlstmemory")
class MDLstmLayer(Layer):
    """2-D multi-dimensional LSTM (``MDLstmLayer``, Graves' MD-LSTM) over
    an H×W grid of pre-projected gates: dense ``[B, H·W·5D]`` or a
    SequenceBatch ``[B, H·W, 5D]``, each cell's columns ``[inode | ig |
    fg×2 | og]``.  Weight ``[D, 5D]`` shared by both predecessors (above
    and to the left); bias ``[9D]`` = the local gate bias 5D + checks ig
    (D), fg (2D), og (D).  ``height`` / ``width`` attributes, else (dense
    input) a square grid; ``directions`` flips the grid per axis before
    the walk and back after.

    The walk is the JAX layer's: rows in order, and in each row the
    columns in order, batched over B (a Python double loop: neither
    package has a kernel for it).  Output ``[B, H·W·D]``, or
    ``[B, H·W, D]`` for a sequence input."""

    ND = 2

    def param_specs(self):
        d, nd = self.conf.size, self.ND
        specs = [self._weight_spec(0, (d, (3 + nd) * d), initial_smart=True)]
        if self.conf.with_bias:
            specs.append(self._bias_spec(((5 + 2 * nd) * d,)))
        return specs

    def forward(self, params, inputs, ctx):
        d, nd = self.conf.size, self.ND
        gw = (3 + nd) * d
        height = self.conf.attrs.get("height")
        width = self.conf.attrs.get("width")
        v = value_of(inputs[0])
        b = v.shape[0]
        if v.dim() == 3:                    # SequenceBatch frames
            enforce(height is not None and width is not None,
                    "mdlstmemory on sequences needs height/width attrs")
        elif height is None or width is None:
            hw = v.shape[1] // gw
            side = int(math.isqrt(hw))
            enforce(side * side == hw,
                    "mdlstmemory: supply height/width attrs for "
                    "non-square grids")
            height = width = side
        x = v.reshape(b, height, width, gw)
        w = params[self.weight_name(0)]
        if self.conf.with_bias:
            bias = params[self.bias_name()]
            local = bias[:gw]
            check_ig = bias[gw:gw + d]
            check_fg = bias[gw + d:gw + d + nd * d].reshape(nd, d)
            check_og = bias[gw + (1 + nd) * d:gw + (2 + nd) * d]
        else:
            local = x.new_zeros((gw,))
            check_ig = check_og = x.new_zeros((d,))
            check_fg = x.new_zeros((nd, d))
        ga = get_activation(self.conf.attrs.get("active_gate_type",
                                                "sigmoid"))
        sa = get_activation(self.conf.attrs.get("active_state_type",
                                                "tanh"))
        na = get_activation(self.conf.active_type or "tanh")
        # canonical walk: top-left to bottom-right
        flip = [i + 1 for i, fwd in enumerate(
            self.conf.attrs.get("directions", [True, True])) if not fwd]
        if flip:
            x = torch.flip(x, flip)
        zero = x.new_zeros((b, d))
        h_up = c_up = [zero] * width
        rows = []
        for i in range(height):
            h_left = c_left = zero
            hs, cs = [], []
            for j in range(width):
                g = x[:, i, j] + local + h_up[j] @ w + h_left @ w
                ig = g[:, d:2 * d] + c_up[j] * check_ig + c_left * check_ig
                fg0 = g[:, 2 * d:3 * d] + c_up[j] * check_fg[0]
                fg1 = g[:, 3 * d:4 * d] + c_left * check_fg[1]
                c = (ga(fg0) * c_up[j] + ga(fg1) * c_left
                     + na(g[:, :d]) * ga(ig))
                h_left = sa(c) * ga(g[:, 4 * d:5 * d] + c * check_og)
                c_left = c
                hs.append(h_left)
                cs.append(c)
            h_up, c_up = hs, cs
            rows.append(torch.stack(hs, 1))
        out = torch.stack(rows, 1)                   # [B, H, W, D]
        if flip:
            out = torch.flip(out, flip)
        if isinstance(inputs[0], SequenceBatch):
            return like(inputs[0], out.reshape(b, height * width, d))
        return out.reshape(b, height * width * d)
