"""Row-sparse parameter machinery (counterpart of
``paddle_tpu/parallel/sparse.py``).

- :class:`SelectedRows`: a row-sparse value, ``rows`` plus a ``values``
  block (``-1`` rows are padding).
- Fixed-capacity dedupe (:func:`unique_rows`, :func:`unique_rows_sorted`),
  gathers and scatters of row blocks, :func:`touched_row_mask` and the
  prefetch pattern (:func:`prefetch_rows`,
  :func:`sparse_embedding_lookup`).
- The sparse gradient exchange of the trainer (``--sparse_grads``): each
  ``sparse_update`` table's batch ids are deduped once into a sorted
  row set, the touched rows gathered into a ``[K, D]`` block
  (``ops/embedding.gather_rows``), and every lookup of the table routed
  through the block (:func:`exchange_scope`, :func:`exchange_entry`,
  :func:`lookup_rows`), so autograd hands back a ``[K, D]`` block
  gradient and the dense ``[V, D]`` one is never formed.

On the card two things differ from the JAX version, by design:

- No data-dependent shapes.  ``jnp.unique(size=, fill_value=)`` becomes
  a sort, a first-of-run mark, a cumsum and a scatter into a buffer of
  ``capacity + 1`` slots (the last one a dump slot), so a step never
  waits for the device to learn how many ids are unique.
- No index out of range.  JAX drops an out-of-range scatter index
  (``mode="drop"``) and fills an out-of-range gather; on CUDA such an
  index is a device-side assert.  Here gathers clamp pads to a real row
  (their values are discarded), a scatter-add sends a pad to row 0 with
  a zero value, and a scatter-set sends it to a row that a real slot
  writes, with that slot's value (duplicate writes of one value agree),
  or, when no slot is real, to row 0 with row 0's own value.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch


class SelectedRows(NamedTuple):
    """Row-sparse value: ``values[i]`` belongs to dense row ``rows[i]``;
    ``rows`` may contain -1 padding (ignored)."""

    rows: torch.Tensor       # [K] int, -1 = empty slot
    values: torch.Tensor     # [K, ...] row block
    height: int              # dense row count

    def to_dense(self) -> torch.Tensor:
        """Scatter-add the values into a zero dense tensor (duplicate
        rows accumulate)."""
        dense = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                            dtype=self.values.dtype,
                            device=self.values.device)
        return row_scatter_add(dense, self.rows, self.values)


def _dedupe(ids: torch.Tensor, capacity: int, fill: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``capacity`` smallest distinct ids, ascending, then ``fill``;
    and each id's index into them (exact when capacity >= the unique
    count).  Fixed shapes, no host sync."""
    flat = ids.reshape(-1).to(torch.int32)
    srt, order = torch.sort(flat)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    dest = torch.where(first & (pos < capacity), pos, capacity)
    buf = torch.full((capacity + 1,), fill, dtype=torch.int32,
                     device=flat.device)
    buf.index_put_((dest,), srt)          # slot ``capacity`` is a dump
    inverse = torch.empty_like(pos).index_copy_(0, order, pos)
    return buf[:capacity], inverse.reshape(ids.shape)


def unique_rows(ids: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deduplicate ids into a fixed-capacity row set: ``(rows
    [capacity] int32, sorted, padded with -1, inverse)`` with
    ``rows[inverse] == ids``.  Over capacity the smallest ids are
    kept."""
    return _dedupe(ids, capacity, -1)


def row_gather(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Gather table rows; pad slots (-1, or >= V) read a clamped row
    whose value callers discard."""
    return table[rows.to(torch.int64).clamp(0, table.shape[0] - 1)]


def row_scatter_add(table: torch.Tensor, rows: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """``table[rows] += values`` (out of place); pad slots add nothing."""
    rows = rows.to(torch.int64)
    real = (rows >= 0) & (rows < table.shape[0])
    vals = values.to(table.dtype)
    vals = torch.where(real.reshape((-1,) + (1,) * (vals.dim() - 1)), vals,
                       torch.zeros_like(vals))
    return table.index_add(0, torch.where(real, rows, 0), vals)


def row_scatter_set_(table: torch.Tensor, rows: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """``table[rows] = values`` IN PLACE, pad slots (-1, or >= V)
    ignored; real rows must be distinct (a :func:`unique_rows` set).
    Returns ``table``."""
    if rows.numel() == 0:
        return table
    rows = rows.to(torch.int64)
    real = (rows >= 0) & (rows < table.shape[0])
    vals = values.to(table.dtype)
    # a pad writes what a real slot writes to that slot's row (the first
    # real slot), or row 0's own value when there is no real slot
    donor = torch.argmax(real.to(torch.int8)).reshape(1)
    any_real = real.any()
    d_row = torch.where(any_real, rows.index_select(0, donor)[0], 0)
    d_val = torch.where(any_real, vals.index_select(0, donor)[0], table[0])
    shape = (-1,) + (1,) * (vals.dim() - 1)
    return table.index_copy_(0, torch.where(real, rows, d_row),
                             torch.where(real.reshape(shape), vals, d_val))


def row_scatter_set(table: torch.Tensor, rows: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """``table[rows] = values`` (out of place), pad slots ignored."""
    return row_scatter_set_(table.clone(), rows, values)


def touched_row_mask(grad: torch.Tensor,
                     ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[V]`` bool mask of the rows a batch touched: from ``ids`` when
    the caller has them, else the rows whose gradient is not all zero
    (untouched rows get exactly-zero gradients from a gather)."""
    v = grad.shape[0]
    if ids is not None:
        flat = ids.reshape(-1).to(torch.int64)
        flat = torch.where((flat >= 0) & (flat < v), flat, v)
        mask = torch.zeros((v + 1,), dtype=torch.bool, device=grad.device)
        return mask.index_fill_(0, flat, True)[:v]
    if grad.dim() == 1:
        return grad != 0
    return (grad != 0).flatten(1).any(dim=1)


def prefetch_rows(table: torch.Tensor, ids: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dedupe a batch's ids and gather that fixed-capacity row block
    once: ``(rows [K], block [K, D], inverse ids.shape)``; downstream
    compute uses ``block[inverse]`` and differentiates with respect to
    ``block``."""
    rows, inverse = unique_rows(ids, capacity)
    return rows, row_gather(table, rows), inverse


def sparse_embedding_lookup(block: torch.Tensor, inverse: torch.Tensor
                            ) -> torch.Tensor:
    """ids-shaped embedding from a prefetched block: ``[K, D]`` →
    ``inverse.shape + [D]``."""
    return block[inverse.to(torch.int64)]


# ================================================ sparse gradient exchange
def unique_rows_sorted(ids: torch.Tensor, capacity: int, height: int
                       ) -> torch.Tensor:
    """Dedupe ids into a SORTED fixed-capacity row set padded with
    ``height`` (one past the end, so the set stays sorted and presence
    lookups are a searchsorted).  Over capacity the smallest ids are
    kept, so the largest drop out of the update."""
    return _dedupe(ids, capacity, height)[0]


def lookup_rows(rows: torch.Tensor, block: torch.Tensor, ids: torch.Tensor
                ) -> torch.Tensor:
    """ids-shaped embedding from a sorted row set and its gathered
    block: ``block[searchsorted(rows, ids)]``.  Exact whenever every id
    is in ``rows`` (the exchange's contract); an id past every row reads
    the last slot instead of faulting."""
    pos = torch.searchsorted(rows, ids.to(rows.dtype).contiguous())
    return block[pos.clamp(max=rows.shape[0] - 1)]


# Param name → (rows, block) substitutions of the step being run.  The
# trainer pushes an entry around its forward and the EmbeddingLayer reads
# it during that forward; the finally rebalances when the forward raises.
_exchange_scope: list = []


@contextlib.contextmanager
def exchange_scope(entries):
    """Route embedding lookups of the named tables through their
    prefetched ``(rows, block)`` pair for the duration of this block
    (``entries``: param name → (rows [K], block [K, D]))."""
    _exchange_scope.append(dict(entries))
    try:
        yield
    finally:
        _exchange_scope.pop()


def exchange_entry(param_name: str):
    """The active ``(rows, block)`` substitution for ``param_name``, else
    None (the dense lookup path)."""
    if _exchange_scope:
        return _exchange_scope[-1].get(param_name)
    return None


def exchange_payload_bytes(capacity: int, dim: int,
                           value_itemsize: int = 4) -> int:
    """Exchanged gradient bytes of one (rows, values) pair: K int32 row
    indices and the ``[K, D]`` value block."""
    return int(capacity) * (4 + int(dim) * int(value_itemsize))
