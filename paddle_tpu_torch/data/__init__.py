"""Feeding (counterpart of ``paddle_tpu/data``): input types and the
feeder, the reader decorators, ``@provider``, the async input pipeline,
the record-file format (:mod:`.recordio`), the dataset cache and shard
tools (:mod:`.download`, which never downloads) and the corpora's
parsers, loaders and synthetic surrogates (:mod:`.datasets`)."""

from . import datasets, pipeline, reader, recordio
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
    "datasets",
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
    "recordio",
    "sparse_binary_vector",
    "sparse_binary_vector_sequence",
    "sparse_float_vector",
    "sparse_float_vector_sequence",
]
