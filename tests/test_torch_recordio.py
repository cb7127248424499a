"""The port's record files (``paddle_tpu_torch/data/recordio.py``), its
``convert`` and ``reader.recordio`` against the JAX package's.

The cases of ``tests/test_datasets.py``'s record-file tests (round
trip, the chunk index, the crc check, ``convert`` then the creator) run
through the port, and files written by each package are read by the
other: an uncompressed file is the same bytes from both; a gzip chunk
carries ``gzip.compress``'s time stamp in its body, so gzip files are
compared record by record.
"""

import numpy as np
import pytest

from paddle_tpu.data import download as jdl
from paddle_tpu.data import reader as jreader
from paddle_tpu.data import recordio as jrio
from paddle_tpu_torch.data import download as tdl
from paddle_tpu_torch.data import reader as treader
from paddle_tpu_torch.data import recordio as trio
from paddle_tpu_torch.utils import PaddleTpuError

RECORDS = [b"rec%d" % i for i in range(8)] + [b"", b"x" * 3000, "café"]


def _write(rio, path, compressor, per_chunk=3):
    with rio.Writer(path, max_records_per_chunk=per_chunk,
                    compressor=compressor) as w:
        for r in RECORDS:
            w.write(r)
    return path


def _want():
    return [r.encode("utf-8") if isinstance(r, str) else r for r in RECORDS]


def test_roundtrip_index_and_crc(tmp_path):
    path = _write(trio, str(tmp_path / "part-00000"), trio.GZIP)
    idx = trio.load_index(path)
    assert [n for _, n in idx] == [3, 3, 3, 2]
    assert list(trio.reader(path)) == _want()
    assert trio.read_chunk(path, idx[1][0]) == _want()[3:6]
    assert trio.chunk_payloads(path) == [f"{path}\t{off}" for off, _ in idx]
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(PaddleTpuError, match="crc"):
        trio.read_chunk(path, idx[3][0])
    open(path, "wb").write(bytes(data[:-5]))
    with pytest.raises(PaddleTpuError, match="truncated"):
        trio.read_chunk(path, idx[3][0])
    with pytest.raises(PaddleTpuError, match="unknown compressor"):
        trio.Writer(str(tmp_path / "bad"), compressor=7)


def test_bad_magic_and_truncated_header(tmp_path):
    path = _write(trio, str(tmp_path / "a"), trio.NO_COMPRESS)
    data = open(path, "rb").read()
    open(path, "wb").write(b"XXXX" + data[4:])
    with pytest.raises(PaddleTpuError, match="magic"):
        trio.load_index(path)
    open(path, "wb").write(data + b"PTR")
    with pytest.raises(PaddleTpuError, match="truncated chunk header"):
        trio.load_index(path)


def test_uncompressed_files_are_the_same_bytes(tmp_path):
    tp = _write(trio, str(tmp_path / "t"), trio.NO_COMPRESS)
    jp = _write(jrio, str(tmp_path / "j"), jrio.NO_COMPRESS)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    assert trio.load_index(tp) == jrio.load_index(jp)


@pytest.mark.parametrize("compressor", [0, 1])
def test_files_read_across_the_packages(tmp_path, compressor):
    tp = _write(trio, str(tmp_path / "t"), compressor, per_chunk=4)
    jp = _write(jrio, str(tmp_path / "j"), compressor, per_chunk=4)
    assert list(jrio.reader(tp)) == _want()
    assert list(trio.reader(jp)) == _want()
    assert trio.load_index(jp) == jrio.load_index(jp)
    for off, _ in jrio.load_index(tp):
        assert trio.read_chunk(tp, off) == jrio.read_chunk(tp, off)


def test_expand_paths_matches(tmp_path):
    for i in (2, 0, 1):
        _write(trio, str(tmp_path / f"s-{i:05d}"), trio.NO_COMPRESS)
    for paths in (str(tmp_path / "s-*"),
                  f"{tmp_path}/s-00001,{tmp_path}/s-0000[02]",
                  [str(tmp_path / "s-00002"), str(tmp_path / "missing")]):
        assert trio.expand_paths(paths) == jrio.expand_paths(paths)


def test_convert_then_recordio_matches_jax(tmp_path):
    samples = [(np.float32(i), i % 3, [i, i + 1]) for i in range(10)]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tpaths = tdl.convert(str(tmp_path / "t"), lambda: iter(samples), 4,
                         "train", shuffle_seed=3)
    jpaths = jdl.convert(str(tmp_path / "j"), lambda: iter(samples), 4,
                         "train", shuffle_seed=3)
    assert [p.rsplit("/", 1)[1] for p in tpaths] == \
        ["train-00000", "train-00001", "train-00002"]
    assert [p.rsplit("/", 1)[1] for p in jpaths] == \
        [p.rsplit("/", 1)[1] for p in tpaths]
    for tp, jp in zip(tpaths, jpaths):
        assert open(tp, "rb").read() == open(jp, "rb").read()
    got = list(treader.recordio(str(tmp_path / "t" / "train-*"), 2)())
    assert sorted(got, key=lambda s: s[1:]) == \
        sorted(samples, key=lambda s: s[1:])
    assert repr(got) == repr(list(jreader.recordio(
        str(tmp_path / "j" / "train-*"))()))
    # the order convert writes: one Random(seed) shuffles each shard
    import random
    rand, order = random.Random(3), []
    for i in range(0, 10, 4):
        buf = samples[i:i + 4]
        rand.shuffle(buf)
        order += buf
    assert repr(got) == repr(order)
