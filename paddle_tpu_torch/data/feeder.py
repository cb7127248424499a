"""Input-type declarations and the batch feeder (counterpart of
``paddle_tpu/data/feeder.py``).

The reference's data-type vocabulary (``dense_vector``,
``sparse_binary_vector``, ``sparse_float_vector``, ``integer_value``,
their ``_sequence`` and ``_sub_sequence`` variants) and the v2
``DataFeeder`` that turns a minibatch of sample tuples into a feed
dict.  Sequences become a padded :class:`SequenceBatch` (lengths
bucketed by ``buckets``, else to a multiple of 8), sub-sequences
(``seq_level`` 2) a :class:`NestedSequenceBatch` (``pad_nested_batch``:
S the most subsequences of a row, T a multiple of 8); sparse vectors are
densified.

The feed holds CPU tensors: placing it on the device is the trainer's
job (``Trainer._place_feed``), on the step's thread or on the input
pipeline's workers.  A ``"bfloat16"`` dense input is densified in
float32 and cast once at the end (numpy has no bfloat16 here), which
matches the reference's direct cast for float32 rows.  ``convert`` is
timed into ``data_feed_convert_seconds`` (``observe/``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.sequence import pad_batch, pad_nested_batch


@dataclasses.dataclass(frozen=True)
class InputType:
    dim: int
    seq_level: int = 0  # 0: none, 1: sequence, 2: sub-sequence
    kind: str = "dense"  # dense | sparse_binary | sparse_float | index
    # storage dtype of dense feeds ("float32" default; "bfloat16" halves
    # the feed's host-to-device bytes).  Index kinds always feed int32.
    dtype: str = "float32"


def dense_vector(dim: int, dtype: str = "float32") -> InputType:
    return InputType(dim, 0, "dense", dtype)


def dense_vector_sequence(dim: int, dtype: str = "float32") -> InputType:
    return InputType(dim, 1, "dense", dtype)


def sparse_binary_vector(dim: int) -> InputType:
    return InputType(dim, 0, "sparse_binary")


def sparse_binary_vector_sequence(dim: int) -> InputType:
    return InputType(dim, 1, "sparse_binary")


def sparse_float_vector(dim: int) -> InputType:
    return InputType(dim, 0, "sparse_float")


def sparse_float_vector_sequence(dim: int) -> InputType:
    return InputType(dim, 1, "sparse_float")


def integer_value(value_range: int) -> InputType:
    return InputType(value_range, 0, "index")


def integer_value_sequence(value_range: int) -> InputType:
    return InputType(value_range, 1, "index")


def integer_value_sub_sequence(value_range: int) -> InputType:
    return InputType(value_range, 2, "index")


def dense_vector_sub_sequence(dim: int) -> InputType:
    return InputType(dim, 2, "dense")


def _host_dtype(name: str):
    """(numpy dtype to densify in, torch dtype of the feed)."""
    if name == "bfloat16":
        return np.dtype(np.float32), torch.bfloat16
    dt = np.dtype(name)
    return dt, torch.from_numpy(np.zeros(0, dt)).dtype


class DataFeeder:
    """feeding: list of (data_layer_name, InputType) in sample tuple order."""

    def __init__(self, feeding: Sequence,
                 buckets: Optional[Sequence[int]] = None):
        self.feeding = [(name, t) for name, t in feeding]
        self.buckets = buckets

    @staticmethod
    def _densify(row, dim: int, kind: str, dt: np.dtype) -> np.ndarray:
        if kind == "sparse_binary":
            out = np.zeros(dim, dt)
            out[np.asarray(row, np.int64)] = 1.0
            return out
        if kind == "sparse_float":
            ids, vals = zip(*row) if row else ((), ())
            out = np.zeros(dim, dt)
            out[np.asarray(ids, np.int64)] = np.asarray(vals, np.float32)
            return out
        return np.asarray(row).astype(dt, copy=False)

    @staticmethod
    def _materialize(row):
        """List-ify one-shot iterators (providers that ``yield map(int,
        xs)``)."""
        if isinstance(row, (list, tuple, np.ndarray, int, float, str,
                            bytes)):
            return row
        if hasattr(row, "__iter__"):
            return list(row)
        return row

    def convert(self, batch: List[Sequence]) -> Dict[str, Any]:
        """minibatch (list of sample tuples OR dicts keyed by data-layer
        name) → feed dict of CPU tensors (a SequenceBatch for a
        sequence, a NestedSequenceBatch for a sub-sequence).  Timed into
        the ``data_feed_convert_seconds`` histogram."""
        from ..observe import histogram

        with histogram(
                "data_feed_convert_seconds",
                "host time densifying/padding a minibatch into device "
                "arrays (DataFeeder.convert)").time():
            return self._convert(batch)

    def _convert(self, batch: List[Sequence]) -> Dict[str, Any]:
        feed: Dict[str, Any] = {}
        for slot, (name, itype) in enumerate(self.feeding):
            col = [self._materialize(sample[name]
                                     if isinstance(sample, dict)
                                     else sample[slot])
                   for sample in batch]
            np_dt, torch_dt = _host_dtype(itype.dtype)
            if itype.seq_level == 0:
                if itype.kind == "index":
                    feed[name] = torch.from_numpy(np.asarray(col, np.int32))
                else:
                    rows = [self._densify(r, itype.dim, itype.kind, np_dt)
                            for r in col]
                    feed[name] = torch.from_numpy(
                        np.stack(rows)).to(torch_dt)
            elif itype.seq_level >= 2:
                if itype.kind == "index":
                    nested = [[np.asarray(x, np.int32) for x in r]
                              for r in col]
                    feed[name] = pad_nested_batch(nested, dtype=np.int32)
                else:
                    nested = [[np.stack([self._densify(v, itype.dim,
                                                       itype.kind, np_dt)
                                         for v in x]) for x in r]
                              for r in col]
                    nb = pad_nested_batch(nested)
                    feed[name] = dataclasses.replace(
                        nb, data=nb.data.to(torch_dt))
            elif itype.kind == "index":
                seqs = [np.asarray(r, np.int32) for r in col]
                feed[name] = pad_batch(seqs, buckets=self.buckets,
                                       dtype=np.int32)
            else:
                seqs = [np.stack([self._densify(x, itype.dim, itype.kind,
                                                np_dt) for x in r])
                        if len(r) else np.zeros((0, itype.dim), np_dt)
                        for r in col]
                sb = pad_batch(seqs, buckets=self.buckets)
                feed[name] = sb.with_data(sb.data.to(torch_dt))
        return feed
