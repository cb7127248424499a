"""The dataset cache and the shard tools (counterpart of
``paddle_tpu/data/download.py``).

Reference: ``python/paddle/v2/dataset/common.py:33-98`` and ``:121-230``
— corpora live under ``~/.cache/paddle/dataset/<module>/`` and are
verified by md5; ``split`` / ``cluster_files_reader`` shard a reader
into pickle files and ``convert`` into record files.  The cache layout
is the reference's and the JAX package's (``PADDLE_TPU_DATASET_CACHE``
moves it), so a cache either of them filled is read as it is.

The port never opens a socket: :func:`download` returns the cached file
when its md5 matches and raises :class:`DownloadError` otherwise — what
the JAX function does under ``PADDLE_TPU_NO_DOWNLOAD``.  The loaders of
:mod:`.datasets` catch that error and take their synthetic surrogates.
"""

from __future__ import annotations

import glob
import hashlib
import os
import pickle
import random

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATASET_CACHE", "~/.cache/paddle/dataset"))


class DownloadError(RuntimeError):
    pass


def md5file(fname: str) -> str:
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def cached_path(url: str, module_name: str) -> str:
    return os.path.join(DATA_HOME, module_name, url.split("/")[-1])


def download(url: str, module_name: str, md5sum: str,
             retry_limit: int = 3, backoff_base_s: float = 0.5) -> str:
    """The cached path of ``url`` when the file is there with md5
    ``md5sum``; else :class:`DownloadError`.  ``retry_limit`` and
    ``backoff_base_s`` keep the JAX signature and are unused: the port
    does not download."""
    filename = cached_path(url, module_name)
    if os.path.exists(filename) and md5file(filename) == md5sum:
        return filename
    raise DownloadError(
        f"{filename} is not cached (or its md5 differs) and the port does "
        f"not download: place {url} there by hand")


def split(reader, line_count: int, suffix: str = "%05d.pickle",
          dumper=None) -> int:
    """Split a reader's samples into fixed-size pickle shard files
    (``v2/dataset/common.py:121``); returns the number of files
    written."""
    dumper = dumper or (lambda obj, f: pickle.dump(obj, f))
    lines, indx_f = [], 0
    for sample in reader():
        lines.append(sample)
        if len(lines) == line_count:
            with open(suffix % indx_f, "wb") as f:
                dumper(lines, f)
            lines, indx_f = [], indx_f + 1
    if lines:
        with open(suffix % indx_f, "wb") as f:
            dumper(lines, f)
        indx_f += 1
    return indx_f


def cluster_files_reader(files_pattern: str, trainer_count: int,
                         trainer_id: int, loader=None):
    """Reader over the shard files produced by :func:`split`, taking
    every ``trainer_count``-th file starting at ``trainer_id``
    (``v2/dataset/common.py:158``)."""
    loader = loader or pickle.load

    def reader():
        file_list = sorted(glob.glob(files_pattern))
        for idx, fn in enumerate(file_list):
            if idx % trainer_count != trainer_id:
                continue
            with open(fn, "rb") as f:
                for sample in loader(f):
                    yield sample

    return reader


def convert(output_path: str, reader, line_count: int,
            name_prefix: str, shuffle_seed: int = 0) -> list:
    """Convert a reader's samples to record-file shards
    ``<name_prefix>-%05d`` (``v2/dataset/common.py:194``); returns the
    shard paths.  Samples are pickled, the reference's convention; each
    shard's buffer is shuffled by one ``random.Random(shuffle_seed)``
    before it is written, as in the JAX package."""
    from . import recordio as rio

    rand = random.Random(shuffle_seed)
    paths, lines, indx_f = [], [], 0

    def write_shard(idx, buf):
        rand.shuffle(buf)
        path = os.path.join(output_path, "%s-%05d" % (name_prefix, idx))
        with rio.Writer(path) as w:
            for sample in buf:
                w.write(pickle.dumps(sample))
        paths.append(path)

    for sample in reader():
        lines.append(sample)
        if len(lines) == line_count:
            write_shard(indx_f, lines)
            lines, indx_f = [], indx_f + 1
    if lines:
        write_shard(indx_f, lines)
    return paths
