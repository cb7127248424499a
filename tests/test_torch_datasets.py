"""The port's datasets (``paddle_tpu_torch/data/datasets.py``) and its
cache and shard tools (``data/download.py``) against the JAX package's.

- Every parser of ``tests/test_datasets.py`` runs on the same fixture in
  ``tests/fixtures/`` through both packages: the outputs are equal
  (types, dtypes, shapes and values).
- The first 16 samples of every loader's synthetic surrogate are equal
  between the packages (the same seeds and ``RandomState`` calls); a
  loader whose corpus sits in the cache with its md5 reads it in both.
- ``download`` returns a cached file whose md5 matches and otherwise
  raises ``DownloadError`` without touching the network
  (``urllib.request.urlopen`` fails the test if it is called).
- ``split`` and ``cluster_files_reader`` write and read the same files.
"""

import logging
import os
import urllib.request

import numpy as np
import pytest

from paddle_tpu.data import datasets as jds
from paddle_tpu.data import download as jdl
from paddle_tpu_torch.data import datasets as tds
from paddle_tpu_torch.data import download as tdl

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
N_FIRST = 16


def _same(a, b, where="sample"):
    assert type(a) is type(b), f"{where}: {type(a)} != {type(b)}"
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.generic):
        assert a.dtype == b.dtype and a == b, where
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _first(reader, n=N_FIRST):
    out = []
    for s in reader():
        out.append(s)
        if len(out) == n:
            break
    return out


@pytest.fixture
def port_log():
    """The messages the port's dataset logger emits during the test (the
    port's loggers do not propagate to the root)."""
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines(logging.WARNING)
    logger = logging.getLogger("paddle_tpu_torch.dataset")
    logger.addHandler(handler)
    yield lines
    logger.removeHandler(handler)


@pytest.fixture
def hermetic(tmp_path, monkeypatch):
    """Both packages' caches point at an empty directory, every memo of
    a failed download or a resolved corpus is fresh, and a call of
    ``urlopen`` fails the test."""
    for dl in (jdl, tdl):
        monkeypatch.setattr(dl, "DATA_HOME", str(tmp_path))
    for ds in (jds, tds):
        monkeypatch.setattr(ds, "CACHE_ROOT", str(tmp_path))
        monkeypatch.setattr(ds, "_download_failed", set())
        monkeypatch.setattr(ds, "_MOVIELENS", ds._MovielensMeta())
        monkeypatch.setattr(ds, "_SENTIMENT_CACHE", {})
    monkeypatch.setenv("PADDLE_TPU_NO_DOWNLOAD", "1")

    def no_network(*a, **kw):
        raise AssertionError("the port opened a connection")

    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    return tmp_path


PARSERS = {
    "cifar_train": lambda d: list(d.parse_cifar(
        os.path.join(FIX, "cifar10_tiny.tar.gz"), "data_batch")),
    "cifar_test": lambda d: list(d.parse_cifar(
        os.path.join(FIX, "cifar10_tiny.tar.gz"), "test_batch")),
    "imdb_dict": lambda d: d.imdb_build_dict(
        os.path.join(FIX, "aclImdb_tiny.tar.gz"),
        r"aclImdb/train/((pos)|(neg))/.*\.txt$", cutoff=1),
    "imdb": lambda d: list(d.parse_imdb(
        os.path.join(FIX, "aclImdb_tiny.tar.gz"),
        r"aclImdb/train/pos/.*\.txt$", r"aclImdb/train/neg/.*\.txt$",
        d.imdb_build_dict(os.path.join(FIX, "aclImdb_tiny.tar.gz"),
                          r"aclImdb/train/((pos)|(neg))/.*\.txt$",
                          cutoff=1))),
    "uci_housing": lambda d: d.parse_uci_housing(
        os.path.join(FIX, "housing_tiny.data")),
    "wmt14_dicts": lambda d: [d.wmt14_read_dicts(
        os.path.join(FIX, "wmt14_tiny.tgz"), n) for n in (3, 8)],
    "wmt14": lambda d: list(d.parse_wmt14(
        os.path.join(FIX, "wmt14_tiny.tgz"), "train/train", 8)),
    "movielens_meta": lambda d: d.parse_movielens_meta(
        os.path.join(FIX, "ml1m_tiny.zip")),
    "movielens_ratings": lambda d: [
        list(d.parse_movielens_ratings(
            os.path.join(FIX, "ml1m_tiny.zip"),
            *d.parse_movielens_meta(os.path.join(FIX, "ml1m_tiny.zip"))[:2],
            is_test=t)) for t in (False, True)],
    "sentiment": lambda d: d.parse_sentiment(
        os.path.join(FIX, "movie_reviews_tiny.zip")),
    "voc2012": lambda d: [list(d.parse_voc2012(
        os.path.join(FIX, "voc2012_tiny.tar"), s))
        for s in ("trainval", "val")],
    "flowers": lambda d: [list(d.parse_flowers(
        os.path.join(FIX, "102flowers_tiny.tgz"),
        os.path.join(FIX, "imagelabels_tiny.mat"),
        os.path.join(FIX, "setid_tiny.mat"), flag))
        for flag in (d.FLOWERS_TRAIN_FLAG, d.FLOWERS_TEST_FLAG,
                     d.FLOWERS_VALID_FLAG)],
    "flowers_mapper": lambda d: [d.flowers_default_mapper(
        train, next(iter(d.parse_flowers(
            os.path.join(FIX, "102flowers_tiny.tgz"),
            os.path.join(FIX, "imagelabels_tiny.mat"),
            os.path.join(FIX, "setid_tiny.mat"), d.FLOWERS_VALID_FLAG))))
        for train in (False,)],
    "mq2007": lambda d: d.parse_mq2007(os.path.join(FIX, "mq2007_tiny.txt")),
    "mq2007_pairwise": lambda d: [list(d._mq2007_pairwise(docs)) for _, docs
                                  in d.parse_mq2007(os.path.join(
                                      FIX, "mq2007_tiny.txt"))],
    "mq2007_lines": lambda d: [d.parse_mq2007_line(ln) for ln in (
        "# comment only", "2 qid:7 1:0.5 3:1.0 #docid = x",
        "0 qid:1 1:NULL 46:2", "bad line")],
}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_matches_jax(name):
    want = PARSERS[name](jds)
    got = PARSERS[name](tds)
    _same(got, want, name)


def test_constants_match_jax():
    names = [n for n in dir(jds) if n.isupper() and not n.startswith("_")]
    assert len(names) > 20
    for n in names:
        _same(getattr(tds, n), getattr(jds, n), n)


LOADERS = {
    "mnist_train": lambda d: d.mnist_train(n_synth=64),
    "mnist_test": lambda d: d.mnist_test(n_synth=32),
    "cifar10_train": lambda d: d.cifar10_train(n_synth=32),
    "cifar10_test": lambda d: d.cifar10_test(n_synth=32),
    "imdb_train": lambda d: d.imdb_train(n_synth=40),
    "imdb_test": lambda d: d.imdb_test(n_synth=40),
    "imikolov_train": lambda d: d.imikolov_train(n_synth=40),
    "uci_housing_train": lambda d: d.uci_housing_train(),
    "uci_housing_test": lambda d: d.uci_housing_test(),
    "wmt14_train": lambda d: d.wmt14_train(n_synth=40),
    "wmt14_test": lambda d: d.wmt14_test(n_synth=40),
    "conll05_train": lambda d: d.conll05_train(n_synth=40),
    "criteo_ctr_train": lambda d: d.criteo_ctr_train(n_synth=40),
    "movielens_train": lambda d: d.movielens_train(),
    "movielens_test": lambda d: d.movielens_test(),
    "sentiment_train": lambda d: d.sentiment_train(),
    "sentiment_test": lambda d: d.sentiment_test(),
    "voc2012_train": lambda d: d.voc2012_train(n_synth=4),
    "voc2012_test": lambda d: d.voc2012_test(n_synth=4),
    "voc2012_val": lambda d: d.voc2012_val(n_synth=4),
    "flowers_train": lambda d: d.flowers_train(n_synth=4),
    "flowers_test": lambda d: d.flowers_test(n_synth=4),
    "flowers_valid": lambda d: d.flowers_valid(n_synth=4),
    "mq2007_pairwise": lambda d: d.mq2007_train(n_synth_queries=6),
    "mq2007_pointwise": lambda d: d.mq2007_test("pointwise", 6),
    "mq2007_listwise": lambda d: d.mq2007_train("listwise", 6),
}


#: loaders with no corpus to look for (the JAX package's are synthetic
#: only) or one read from a cache path without a download
NO_DOWNLOAD = ("imikolov", "conll05", "criteo", "mq2007")


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_surrogate_matches_jax(hermetic, port_log, name):
    np.random.seed(0)       # the flowers mapper crops from np.random
    want = _first(LOADERS[name](jds))
    np.random.seed(0)
    got = _first(LOADERS[name](tds))
    assert got, name
    _same(got, want, name)
    if not name.startswith(NO_DOWNLOAD):
        assert any("using synthetic surrogate" in m for m in port_log), name


def test_metadata_matches_jax(hermetic):
    for f in ("imdb_word_dict", "wmt14_dicts", "sentiment_word_dict",
              "movielens_movie_categories",
              "movielens_get_movie_title_dict", "movielens_max_user_id",
              "movielens_max_movie_id", "movielens_max_job_id",
              "movielens_user_info", "movielens_movie_info"):
        _same(getattr(tds, f)(), getattr(jds, f)(), f)


def test_a_failed_download_is_remembered(hermetic, port_log):
    _first(tds.cifar10_train(n_synth=4))
    tds.cifar10_test(n_synth=4)
    warned = [m for m in port_log if m.startswith("cifar unavailable")]
    assert len(warned) == 1 and "does not download" in warned[0]
    assert tds.CIFAR10_URL in tds._download_failed


def test_a_cached_corpus_is_read_in_both(hermetic, monkeypatch):
    """housing_tiny.data placed in the cache under the corpus's name,
    its md5 the expected one: both loaders parse it."""
    src = os.path.join(FIX, "housing_tiny.data")
    md5 = tdl.md5file(src)
    assert md5 == jdl.md5file(src)
    dst = hermetic / "uci_housing" / "housing.data"
    dst.parent.mkdir()
    dst.write_bytes(open(src, "rb").read())
    for ds in (jds, tds):
        monkeypatch.setattr(ds, "UCI_HOUSING_MD5", md5)
    for split in ("uci_housing_train", "uci_housing_test"):
        got = list(getattr(tds, split)()())
        _same(got, list(getattr(jds, split)()()), split)
    assert len(got) == 4 and got[0][0].shape == (13,)


def test_download_reads_the_cache_and_never_the_network(hermetic):
    cached = hermetic / "m" / "file.bin"
    cached.parent.mkdir()
    cached.write_bytes(b"hello")
    md5 = tdl.md5file(str(cached))
    url = "http://example.invalid/file.bin"
    assert tdl.download(url, "m", md5) == str(cached)
    assert tdl.cached_path(url, "m") == jdl.cached_path(url, "m")
    with pytest.raises(tdl.DownloadError, match="does not download"):
        tdl.download(url, "m", "0" * 32)        # md5 differs
    with pytest.raises(tdl.DownloadError, match="other.bin"):
        tdl.download("http://example.invalid/other.bin", "m", md5)
    assert not (hermetic / "n").exists()        # nothing is created


def test_split_and_cluster_files_reader_match_jax(tmp_path):
    samples = [(i, [i] * (i % 3)) for i in range(10)]
    counts = {}
    for tag, dl in (("t", tdl), ("j", jdl)):
        counts[tag] = dl.split(lambda: iter(samples), 3,
                               suffix=str(tmp_path / (tag + "-%05d.pickle")))
    assert counts == {"t": 4, "j": 4}
    for i in range(4):
        assert (tmp_path / f"t-{i:05d}.pickle").read_bytes() == \
            (tmp_path / f"j-{i:05d}.pickle").read_bytes()
    for tid in (0, 1):
        got = list(tdl.cluster_files_reader(
            str(tmp_path / "t-*.pickle"), 2, tid)())
        assert got == list(jdl.cluster_files_reader(
            str(tmp_path / "j-*.pickle"), 2, tid)())
    assert [s[0] for s in tdl.cluster_files_reader(
        str(tmp_path / "t-*.pickle"), 2, 0)()] == [0, 1, 2, 6, 7, 8]
