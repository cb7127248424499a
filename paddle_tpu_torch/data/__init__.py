"""Feeding (counterpart of ``paddle_tpu/data``): input types and the
feeder, the reader decorators, ``@provider`` and the async input
pipeline.  The datasets and the record-file format wait for queue A8."""

from . import pipeline, reader
from .feeder import (
    DataFeeder,
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
from .pipeline import AsyncPipeline, prefetch_reader
from .provider import CacheType, provider

__all__ = [
    "AsyncPipeline",
    "CacheType",
    "DataFeeder",
    "InputType",
    "dense_vector",
    "dense_vector_sequence",
    "dense_vector_sub_sequence",
    "integer_value",
    "integer_value_sequence",
    "integer_value_sub_sequence",
    "pipeline",
    "prefetch_reader",
    "provider",
    "reader",
    "sparse_binary_vector",
    "sparse_binary_vector_sequence",
    "sparse_float_vector",
    "sparse_float_vector_sequence",
]
