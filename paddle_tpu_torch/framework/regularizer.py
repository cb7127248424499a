"""Weight-decay regularizers appended as ops on the gradient
(``python/paddle/v2/framework/regularizer.py``).

Counterpart of ``paddle_tpu/framework/regularizer.py``, the same code.
"""

from __future__ import annotations

from .program import default_main_program


class WeightDecayRegularizer:
    def append(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append(self, param, grad, block):
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff})
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [grad]})


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append(self, param, grad, block):
        sign = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff})
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [grad]})


def append_regularization_ops(params_grads, regularization=None,
                              program=None):
    program = program or default_main_program()
    block = program.global_block
    for p, g in params_grads:
        reg = p.regularizer or regularization
        if reg is not None:
            reg.append(p, g, block)
    return params_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
