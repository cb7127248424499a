"""Chunked record files (counterpart of ``paddle_tpu/data/recordio.py``,
the port's own copy with the same chunk layout, so a file written by
either package reads in the other).

The reference's master leases dataset *chunks* to trainers
(``go/master/service.go:56-75`` ``Chunk``/``Task`` over
``github.com/PaddlePaddle/recordio`` files; trainers stream records via
``python/paddle/v2/reader/creator.py:60`` ``recordio`` and ``:91``
``cloud_reader``).  The format has the same capabilities:

- an append-only **writer** batching records into chunks (optionally
  gzip-compressed, crc32-checked);
- a **chunk index** built by scanning headers only (no record decode) so
  a coordinator can partition work by chunk, like ``recordio.LoadIndex``
  (``service.go:253``);
- **readers** for a whole file/glob or one chunk at a byte offset (the
  unit the master hands out).

An uncompressed file is the same bytes in both packages; a gzip chunk
carries ``gzip.compress``'s time stamp in its body, so two gzip writes
of the same records differ in bytes and agree record by record.

Layout per chunk::

    magic 'PTRC' | u32 num_records | u32 body_len | u32 crc32(body) |
    u8 compressor (0 none, 1 gzip) | body
    body = repeat(u32 record_len | record_bytes)

All integers little-endian.
"""

from __future__ import annotations

import glob as _glob
import gzip
import os
import struct
import zlib
from typing import Iterator, List, Sequence, Tuple, Union

from ..utils import PaddleTpuError, enforce

MAGIC = b"PTRC"
_HEADER = struct.Struct("<4sIIIB")
NO_COMPRESS, GZIP = 0, 1


class Writer:
    """Append records (bytes) into chunked files.

    >>> with Writer("part-00000.recordio") as w:
    ...     w.write(b"sample")
    """

    def __init__(self, path: str, max_records_per_chunk: int = 1000,
                 compressor: int = NO_COMPRESS):
        enforce(compressor in (NO_COMPRESS, GZIP),
                f"unknown compressor {compressor}")
        self._f = open(path, "wb")
        self._max = max_records_per_chunk
        self._compressor = compressor
        self._pending: List[bytes] = []

    def write(self, record: bytes) -> None:
        if isinstance(record, str):
            record = record.encode("utf-8")
        self._pending.append(bytes(record))
        if len(self._pending) >= self._max:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        body = b"".join(struct.pack("<I", len(r)) + r
                        for r in self._pending)
        if self._compressor == GZIP:
            body = gzip.compress(body)
        self._f.write(_HEADER.pack(MAGIC, len(self._pending), len(body),
                                   zlib.crc32(body) & 0xFFFFFFFF,
                                   self._compressor))
        self._f.write(body)
        self._pending = []

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_index(path: str) -> List[Tuple[int, int]]:
    """Scan chunk headers only; returns ``[(byte_offset, num_records)]``
    — the partitioning unit for master data tasks."""
    index = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        off = 0
        while off < size:
            head = f.read(_HEADER.size)
            if len(head) < _HEADER.size:
                raise PaddleTpuError(f"{path}: truncated chunk header "
                                     f"at offset {off}")
            magic, n, body_len, _crc, _comp = _HEADER.unpack(head)
            if magic != MAGIC:
                raise PaddleTpuError(f"{path}: bad chunk magic at "
                                     f"offset {off}")
            index.append((off, n))
            off += _HEADER.size + body_len
            f.seek(off)
    return index


def read_chunk(path: str, offset: int) -> List[bytes]:
    """Decode the records of the single chunk at ``offset``."""
    with open(path, "rb") as f:
        f.seek(offset)
        head = f.read(_HEADER.size)
        enforce(len(head) == _HEADER.size, f"{path}: truncated chunk")
        magic, n, body_len, crc, comp = _HEADER.unpack(head)
        enforce(magic == MAGIC, f"{path}: bad chunk magic @{offset}")
        body = f.read(body_len)
    enforce(len(body) == body_len, f"{path}: truncated chunk body")
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise PaddleTpuError(f"{path}: chunk crc mismatch @{offset}")
    if comp == GZIP:
        body = gzip.decompress(body)
    records, off = [], 0
    for _ in range(n):
        (rlen,) = struct.unpack_from("<I", body, off)
        off += 4
        records.append(body[off:off + rlen])
        off += rlen
    return records


def expand_paths(paths: Union[str, Sequence[str]]) -> List[str]:
    """Reference path convention: comma-separated string or list, glob
    patterns supported (``creator.py:62``)."""
    if isinstance(paths, str):
        paths = paths.split(",")
    out: List[str] = []
    for p in paths:
        matches = sorted(_glob.glob(p))
        out.extend(matches if matches else [p])
    return out


def reader(paths: Union[str, Sequence[str]]) -> Iterator[bytes]:
    """Stream raw records across files/globs in order."""
    for path in expand_paths(paths):
        for off, _n in load_index(path):
            yield from read_chunk(path, off)


def chunk_payloads(paths: Union[str, Sequence[str]]) -> List[str]:
    """Master task payloads addressing individual chunks
    (``"path\\toffset"``, the format the master-leased reader,
    ``data.reader.cloud_reader``, parses)."""
    return [f"{p}\t{off}" for p in expand_paths(paths)
            for off, _n in load_index(p)]
