"""Recurrent layers the ported slices use (counterpart of
``paddle_tpu/layers/rnn.py``): ``lstmemory``, ``gated_recurrent``
(``grumemory``) and ``gru_step``.

Like the reference, ``lstmemory`` and ``gated_recurrent`` take their
input already projected (to 4H, 3H) by an upstream fc layer.
"""

from __future__ import annotations

from ..core.sequence import SequenceBatch, like, value_of
from ..ops import recurrent_ops
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
    activations happen inside the step (no ``finalize``)."""

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
        return like(inputs[0], out)
