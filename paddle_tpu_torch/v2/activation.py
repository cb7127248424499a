"""``paddle.v2.activation`` (counterpart of ``paddle_tpu/v2/activation.py``):
the DSL's activations under their v2 names."""

from ..config.dsl import (  # noqa: F401
    AbsActivation as Abs,
    BReluActivation as BRelu,
    ExpActivation as Exp,
    LinearActivation as Linear,
    LogActivation as Log,
    ReciprocalActivation as Reciprocal,
    ReluActivation as Relu,
    SequenceSoftmaxActivation as SequenceSoftmax,
    SigmoidActivation as Sigmoid,
    SoftmaxActivation as Softmax,
    SoftReluActivation as SoftRelu,
    SqrtActivation as Sqrt,
    SquareActivation as Square,
    STanhActivation as STanh,
    TanhActivation as Tanh,
)
