"""``paddle.v2.data_type`` (counterpart of ``paddle_tpu/v2/data_type.py``):
the feeder's input types."""

from ..data.feeder import (  # noqa: F401
    InputType,
    dense_vector,
    dense_vector_sequence,
    dense_vector_sub_sequence,
    integer_value,
    integer_value_sequence,
    integer_value_sub_sequence,
    sparse_binary_vector,
    sparse_binary_vector_sequence,
    sparse_float_vector,
    sparse_float_vector_sequence,
)
