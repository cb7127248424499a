"""Bundled datasets (counterpart of ``paddle_tpu/data/datasets.py``, the
port's own copy).

Port of ``python/paddle/v2/dataset`` (mnist, cifar, imdb, imikolov,
uci_housing, movielens, conll05, wmt14, sentiment, voc2012, flowers,
mq2007): the corpus constants, the parsers of the reference's formats,
and a loader per split.  A loader reads the corpus from the download
cache (``~/.cache/paddle/dataset``, :mod:`.download`) when it is there
with its md5, and otherwise logs that it is unavailable and yields a
deterministic synthetic surrogate with the corpus's shapes and vocab
sizes.  The port never downloads.  The surrogates draw numpy exactly as
the JAX package's do (the same seeds, the same ``RandomState`` calls in
the same order), so one loader gives equal samples in both packages.

``PIL`` and ``scipy.io`` are imported inside the functions that need
them (VOC2012, flowers), so importing this module needs neither.
"""

from __future__ import annotations

import gzip
import os
import pickle
import re
import string
import struct
import tarfile
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from .download import DownloadError, download
from ..utils import get_logger

log = get_logger("dataset")

# Official corpus URLs + md5s (python/paddle/v2/dataset/*.py constants)
MNIST_URL_PREFIX = "http://yann.lecun.com/exdb/mnist/"
MNIST_MD5 = {
    "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
    "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
    "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
    "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
}
CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
CIFAR10_MD5 = "c58f30108f718f92721af3b95e74349a"
IMDB_URL = "http://ai.stanford.edu/%7Eamaas/data/sentiment/aclImdb_v1.tar.gz"
IMDB_MD5 = "7c2ac02c03563afcf9b574c7e56c153a"
UCI_HOUSING_URL = ("https://archive.ics.uci.edu/ml/machine-learning-"
                   "databases/housing/housing.data")
UCI_HOUSING_MD5 = "d4accdce7a25600298819f8e28e8d593"
WMT14_TRAIN_URL = ("http://paddlepaddle.cdn.bcebos.com/demo/"
                   "wmt_shrinked_data/wmt14.tgz")
WMT14_TRAIN_MD5 = "0791583d57d5beb693b9414c5b36798c"


_download_failed: set = set()


def _try_download(url: str, module: str, md5: str) -> Optional[str]:
    """Cached-or-downloaded path, or None (loaders then fall back to
    their synthetic surrogate).  A failed URL is not retried within the
    process — readers re-run every pass."""
    if url in _download_failed:
        return None
    try:
        return download(url, module, md5)
    except DownloadError as e:
        log.warning("%s unavailable (%s); using synthetic surrogate",
                    module, e)
        _download_failed.add(url)
        return None

CACHE_ROOT = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATASET_CACHE", "~/.cache/paddle/dataset"))


def _cache_path(*parts: str) -> str:
    return os.path.join(CACHE_ROOT, *parts)


# --------------------------------------------------------------------- mnist

def _synthetic_images(n: int, side: int, classes: int, seed: int,
                      proto_seed: int = 1234):
    """Deterministic class-conditional blobs — learnable but non-trivial.
    Prototypes come from ``proto_seed`` (shared by train/test splits so the
    test set measures generalization); only the sample draw uses ``seed``."""
    protos = np.random.RandomState(proto_seed).randn(
        classes, side * side).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    noise = rng.randn(n, side * side).astype(np.float32) * 0.7
    imgs = np.clip(protos[labels] * 0.8 + noise, -1, 1)
    return imgs, labels.astype(np.int64)


def _read_idx_images(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
        return data.astype(np.float32) / 127.5 - 1.0


def _read_idx_labels(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), np.uint8).astype(np.int64)


def _mnist_paths(img_name, lab_name):
    img_p = _cache_path("mnist", img_name)
    lab_p = _cache_path("mnist", lab_name)
    if not (os.path.exists(img_p) and os.path.exists(lab_p)):
        for name in (img_name, lab_name):
            _try_download(MNIST_URL_PREFIX + name, "mnist", MNIST_MD5[name])
    return img_p, lab_p


def mnist_train(n_synth: int = 8192):
    """Reader of (image[784] in [-1,1], label) — ``v2/dataset/mnist.py``."""
    img_p, lab_p = _mnist_paths("train-images-idx3-ubyte.gz",
                                "train-labels-idx1-ubyte.gz")

    def reader():
        if os.path.exists(img_p) and os.path.exists(lab_p):
            imgs, labs = _read_idx_images(img_p), _read_idx_labels(lab_p)
        else:
            imgs, labs = _synthetic_images(n_synth, 28, 10, seed=7)
        for i in range(len(labs)):
            yield imgs[i], int(labs[i])

    return reader


def mnist_test(n_synth: int = 1024):
    img_p, lab_p = _mnist_paths("t10k-images-idx3-ubyte.gz",
                                "t10k-labels-idx1-ubyte.gz")

    def reader():
        if os.path.exists(img_p) and os.path.exists(lab_p):
            imgs, labs = _read_idx_images(img_p), _read_idx_labels(lab_p)
        else:
            imgs, labs = _synthetic_images(n_synth, 28, 10, seed=8)
        for i in range(len(labs)):
            yield imgs[i], int(labs[i])

    return reader




# ----------------------------------------------------- real-corpus parsers
# Each takes LOCAL file paths (unit-tested on bundled tiny fixtures); the
# public loaders below wire them to the download cache with synthetic
# fallback.  Formats match the reference parsers exactly
# (``python/paddle/v2/dataset/{cifar,imdb,uci_housing,wmt14}.py``).

def parse_cifar(tar_path: str, sub_name: str
                ) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (image[3072] float in [0,1] CHW, label) from a CIFAR python
    tarball (pickled batches; ``cifar.py:46`` reads b'data' +
    b'labels'/b'fine_labels')."""
    with tarfile.open(tar_path, mode="r") as f:
        names = sorted(m.name for m in f if sub_name in m.name)
        for name in names:
            batch = pickle.load(f.extractfile(name), encoding="bytes")
            data = batch[b"data"]
            labels = batch.get(b"labels", batch.get(b"fine_labels"))
            assert labels is not None
            for sample, label in zip(data, labels):
                yield (sample / 255.0).astype(np.float32), int(label)


def imdb_tokenize(tar_path: str, pattern: "re.Pattern"
                  ) -> Iterator[list]:
    """Tokenized docs from the aclImdb tarball (``imdb.py:38``:
    punctuation stripped, lowercased, whitespace split; sequential
    tarfile.next() access)."""
    table = str.maketrans("", "", string.punctuation)
    with tarfile.open(tar_path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if bool(pattern.match(tf.name)):
                text = tarf.extractfile(tf).read().decode(
                    "utf-8", errors="ignore")
                yield text.rstrip("\n\r").translate(table).lower().split()
            tf = tarf.next()


def imdb_build_dict(tar_path: str, pattern_str: str, cutoff: int = 150
                    ) -> Dict[str, int]:
    """Frequency-sorted word dict with trailing <unk> (``imdb.py:62``)."""
    import collections
    word_freq: Dict[str, int] = collections.defaultdict(int)
    for doc in imdb_tokenize(tar_path, re.compile(pattern_str)):
        for word in doc:
            word_freq[word] += 1
    items = [x for x in word_freq.items() if x[1] > cutoff]
    items.sort(key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(items)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def parse_imdb(tar_path: str, pos_pattern: str, neg_pattern: str,
               word_idx: Dict[str, int]
               ) -> Iterator[Tuple[list, int]]:
    """Yield (word_ids, label) pairs, label 0=positive 1=negative as the
    reference encodes them (``imdb.py:91``: pos first, label 0)."""
    unk = word_idx["<unk>"]
    for label, pat in ((0, pos_pattern), (1, neg_pattern)):
        for doc in imdb_tokenize(tar_path, re.compile(pat)):
            yield [word_idx.get(w, unk) for w in doc], label


def parse_uci_housing(path: str, feature_num: int = 14, ratio: float = 0.8
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) arrays, features mean-centered and range-scaled
    (``uci_housing.py:57`` load_data, 80/20 split)."""
    data = np.fromfile(path, sep=" ")
    data = data.reshape(data.shape[0] // feature_num, feature_num)
    maximums = data.max(axis=0)
    minimums = data.min(axis=0)
    avgs = data.sum(axis=0) / data.shape[0]
    for i in range(feature_num - 1):
        data[:, i] = (data[:, i] - avgs[i]) / (maximums[i] - minimums[i])
    offset = int(data.shape[0] * ratio)
    return data[:offset], data[offset:]


def wmt14_read_dicts(tar_path: str, dict_size: int
                     ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(src_dict, trg_dict) from the wmt14 tarball's src.dict/trg.dict
    members (``wmt14.py:45`` __read_to_dict__)."""
    def to_dict(fd, size):
        out = {}
        for i, line in enumerate(fd):
            if i >= size:
                break
            out[line.strip().decode("utf-8", errors="ignore")] = i
        return out

    with tarfile.open(tar_path, mode="r") as f:
        src_name = [m.name for m in f if m.name.endswith("src.dict")]
        trg_name = [m.name for m in f if m.name.endswith("trg.dict")]
        assert len(src_name) == 1 and len(trg_name) == 1
        src = to_dict(f.extractfile(src_name[0]), dict_size)
        trg = to_dict(f.extractfile(trg_name[0]), dict_size)
    return src, trg


def parse_wmt14(tar_path: str, file_name: str, dict_size: int,
                max_len: int = 80) -> Iterator[Tuple[list, list, list]]:
    """Yield (src_ids, trg_ids_with_<s>, trg_next_ids) triples
    (``wmt14.py:72`` reader_creator: <s>/<e> wrapping, UNK id 2,
    sentences over ``max_len`` dropped)."""
    src_dict, trg_dict = wmt14_read_dicts(tar_path, dict_size)
    start_tok, end_tok = "<s>", "<e>"
    with tarfile.open(tar_path, mode="r") as f:
        names = [m.name for m in f if m.name.endswith(file_name)]
        for name in names:
            for line in f.extractfile(name):
                parts = line.decode("utf-8", errors="ignore").strip() \
                    .split("\t")
                if len(parts) != 2:
                    continue
                src_words = [start_tok] + parts[0].split() + [end_tok]
                src_ids = [src_dict.get(w, UNK) for w in src_words]
                trg_words = parts[1].split()
                trg_ids = [trg_dict.get(w, UNK) for w in trg_words]
                if len(src_ids) > max_len or len(trg_ids) > max_len:
                    continue
                trg_next = trg_ids + [trg_dict[end_tok]]
                trg_ids = [trg_dict[start_tok]] + trg_ids
                yield src_ids, trg_ids, trg_next


# --------------------------------------------------------------------- cifar

def _cifar_reader(sub_name: str, n_synth: int, seed: int):
    # resolved ONCE (download() md5-hashes the tarball; per-epoch would
    # re-hash 163MB every pass)
    tar = _try_download(CIFAR10_URL, "cifar", CIFAR10_MD5)

    def reader():
        if tar:
            yield from parse_cifar(tar, sub_name)
            return
        imgs, labs = _synthetic_images(n_synth, 32, 10, seed=seed)
        imgs3 = np.repeat(imgs, 3, axis=1)[:, : 3 * 32 * 32]
        for i in range(len(labs)):
            yield imgs3[i], int(labs[i])

    return reader


def cifar10_train(n_synth: int = 4096):
    """Reader of (image[3072] CHW float, label) — ``v2/dataset/cifar.py``."""
    return _cifar_reader("data_batch", n_synth, seed=9)


def cifar10_test(n_synth: int = 512):
    return _cifar_reader("test_batch", n_synth, seed=10)


# ---------------------------------------------------------------------- imdb

def _synthetic_text(n: int, vocab: int, classes: int, min_len: int,
                    max_len: int, seed: int, proto_seed: int = 4321):
    """Class-dependent unigram distributions; label recoverable from text.
    Boost vocabularies come from ``proto_seed`` (shared across splits)."""
    prng = np.random.RandomState(proto_seed)
    class_boost = [prng.permutation(vocab)[: vocab // 4]
                   for _ in range(classes)]
    rng = np.random.RandomState(seed)
    for _ in range(n):
        y = int(rng.randint(classes))
        length = int(rng.randint(min_len, max_len + 1))
        base = rng.randint(2, vocab, length)
        boost_mask = rng.rand(length) < 0.5
        boosted = class_boost[y][rng.randint(0, len(class_boost[y]), length)]
        words = np.where(boost_mask, boosted, base)
        yield words.astype(np.int64), y


def imdb_word_dict(vocab: int = 5148):
    """Real corpus dict when available (``imdb.py`` build_dict over the
    train split, cutoff 150), else a synthetic stand-in."""
    tar = _try_download(IMDB_URL, "imdb", IMDB_MD5)
    if tar:
        return imdb_build_dict(
            tar, "aclImdb/((train)|(test))/((pos)|(neg))/.*\\.txt$", 150)
    return {f"w{i}": i for i in range(vocab)}


def _imdb_reader(split: str, word_dict, n_synth: int, seed: int):
    vocab = len(word_dict) if word_dict else 5148
    tar = _try_download(IMDB_URL, "imdb", IMDB_MD5)

    def reader():
        if tar and word_dict and "<unk>" in word_dict:
            yield from parse_imdb(
                tar, f"aclImdb/{split}/pos/.*\\.txt$",
                f"aclImdb/{split}/neg/.*\\.txt$", word_dict)
            return
        yield from _synthetic_text(n_synth, vocab, 2, 10, 120, seed=seed)

    return reader


def imdb_train(word_dict=None, n_synth: int = 2000):
    return _imdb_reader("train", word_dict, n_synth, seed=11)


def imdb_test(word_dict=None, n_synth: int = 400):
    return _imdb_reader("test", word_dict, n_synth, seed=12)


# ------------------------------------------------------------------ imikolov

def imikolov_train(word_dict=None, n: int = 5, n_synth: int = 5000):
    """n-gram LM samples (``v2/dataset/imikolov.py``)."""
    vocab = len(word_dict) if word_dict else 2000

    def reader():
        rng = np.random.RandomState(13)
        for _ in range(n_synth):
            yield tuple(int(x) for x in rng.randint(0, vocab, n))

    return reader


# --------------------------------------------------------------- uci_housing

def _uci_housing_reader(test: bool, n_synth: int, seed: int):
    path = _try_download(UCI_HOUSING_URL, "uci_housing", UCI_HOUSING_MD5)

    def reader():
        if path:
            train, tst = parse_uci_housing(path)
            for row in (tst if test else train):
                yield (row[:-1].astype(np.float32),
                       row[-1:].astype(np.float32))
            return
        rng = np.random.RandomState(seed + 100)
        w = np.random.RandomState(14).randn(13).astype(np.float32)
        for _ in range(n_synth):
            x = rng.randn(13).astype(np.float32)
            y = float(x @ w + 0.1 * rng.randn())
            yield x, np.array([y], np.float32)

    return reader


def uci_housing_train(n_synth: int = 404):
    return _uci_housing_reader(False, n_synth, seed=14)


def uci_housing_test(n_synth: int = 102):
    return _uci_housing_reader(True, n_synth, seed=15)


# --------------------------------------------------------------------- wmt14

def wmt14_dicts(dict_size: int = 30000):
    tar = _try_download(WMT14_TRAIN_URL, "wmt14", WMT14_TRAIN_MD5)
    if tar:
        return wmt14_read_dicts(tar, dict_size)
    src = {f"s{i}": i for i in range(dict_size)}
    trg = {f"t{i}": i for i in range(dict_size)}
    return src, trg


START, END, UNK = 0, 1, 2


def wmt14_train(dict_size: int = 30000, n_synth: int = 2000):
    """Reader of (src_ids, trg_ids_with_<s>, trg_next_ids) triples
    (``v2/dataset/wmt14.py`` convention)."""

    tar = _try_download(WMT14_TRAIN_URL, "wmt14", WMT14_TRAIN_MD5)

    def reader():
        if tar:
            yield from parse_wmt14(tar, "train/train", dict_size)
            return
        rng = np.random.RandomState(16)
        for _ in range(n_synth):
            slen = int(rng.randint(5, 30))
            src = rng.randint(3, dict_size, slen).astype(np.int64)
            # synthetic transduction: reverse + offset, bounded vocab
            trg = ((src[::-1] * 7) % (dict_size - 3) + 3)[: max(3, slen - 2)]
            trg_in = np.concatenate([[START], trg])
            trg_next = np.concatenate([trg, [END]])
            yield src, trg_in, trg_next

    return reader


def wmt14_test(dict_size: int = 30000, n_synth: int = 200):
    tar = _try_download(WMT14_TRAIN_URL, "wmt14", WMT14_TRAIN_MD5)

    def reader():
        if tar:
            yield from parse_wmt14(tar, "test/test", dict_size)
            return
        rng = np.random.RandomState(17)
        for _ in range(n_synth):
            slen = int(rng.randint(5, 30))
            src = rng.randint(3, dict_size, slen).astype(np.int64)
            trg = ((src[::-1] * 7) % (dict_size - 3) + 3)[: max(3, slen - 2)]
            yield src, np.concatenate([[START], trg]), np.concatenate([trg, [END]])

    return reader


# ------------------------------------------------------------------- conll05

def conll05_train(n_synth: int = 1000, vocab: int = 5000, num_labels: int = 19):
    """SRL sequence-tagging samples: (words, predicate, labels)."""

    def reader():
        rng = np.random.RandomState(18)
        for _ in range(n_synth):
            length = int(rng.randint(5, 40))
            words = rng.randint(0, vocab, length).astype(np.int64)
            pred = int(rng.randint(0, length))
            labels = ((words + pred) % num_labels).astype(np.int64)
            yield words, pred, labels

    return reader


# -------------------------------------------------------------------- criteo

def criteo_ctr_train(n_synth: int = 5000, dense_dim: int = 13,
                     sparse_dim: int = 10 ** 6, slots: int = 26):
    """Wide&deep CTR samples: (dense[13], sparse_ids[26], label) —
    the sparse large-model workload (BASELINE config 5)."""

    def reader():
        rng = np.random.RandomState(19)
        w_dense = rng.randn(dense_dim).astype(np.float32)
        for _ in range(n_synth):
            dense = rng.randn(dense_dim).astype(np.float32)
            ids = rng.randint(0, sparse_dim, slots).astype(np.int64)
            logit = dense @ w_dense + 0.3 * ((ids[0] % 97) / 48.5 - 1.0)
            yield dense, ids, int(logit + 0.2 * rng.randn() > 0)

    return reader


# ----------------------------------------------------------------- movielens

MOVIELENS_URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
MOVIELENS_MD5 = "c4d9eecfca2ab87c1945afe126590906"

AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]     # movielens.py:41 age buckets


def parse_movielens_meta(zip_path: str):
    """Parse ``ml-1m/{movies,users}.dat`` from the MovieLens-1M zip
    (reference ``movielens.py:102`` ``__initialize_meta_info__``).

    Returns ``(movies, users, title_dict, categories_dict)`` where
    ``movies[id] = (category_ids, title_word_ids)`` and
    ``users[id] = [uid, gender(0=M,1=F), age_index, job_id]``.
    """
    import zipfile

    title_pattern = re.compile(r"^(.*)\((\d+)\)\s*$")
    raw_movies: Dict[int, Tuple[list, str]] = {}
    title_words: set = set()
    categories: set = set()
    with zipfile.ZipFile(zip_path) as z:
        with z.open("ml-1m/movies.dat") as f:
            for line in f:
                movie_id, title, cats = \
                    line.decode("latin-1").strip().split("::")
                cats = cats.split("|")
                categories.update(cats)
                m = title_pattern.match(title)
                title = m.group(1).strip() if m else title
                raw_movies[int(movie_id)] = (cats, title)
                title_words.update(w.lower() for w in title.split())
        users: Dict[int, list] = {}
        with z.open("ml-1m/users.dat") as f:
            for line in f:
                uid, gender, age, job, _zip = \
                    line.decode("latin-1").strip().split("::")
                users[int(uid)] = [int(uid), 0 if gender == "M" else 1,
                                   AGE_TABLE.index(int(age)), int(job)]
    title_dict = {w: i for i, w in enumerate(sorted(title_words))}
    categories_dict = {c: i for i, c in enumerate(sorted(categories))}
    movies = {mid: ([categories_dict[c] for c in cats],
                    [title_dict[w.lower()] for w in title.split()])
              for mid, (cats, title) in raw_movies.items()}
    return movies, users, title_dict, categories_dict


def parse_movielens_ratings(zip_path: str, movies, users, is_test: bool,
                            test_ratio: float = 0.1, rand_seed: int = 0):
    """Yield reference-format rating records from ``ml-1m/ratings.dat``:
    ``[uid, gender, age_idx, job, movie_id, category_ids, title_ids,
    [rating*2-5]]`` with the same random train/test split
    (``movielens.py:145``)."""
    import random
    import zipfile

    rand = random.Random(x=rand_seed)
    with zipfile.ZipFile(zip_path) as z:
        with z.open("ml-1m/ratings.dat") as f:
            for line in f:
                if (rand.random() < test_ratio) != is_test:
                    continue
                uid, mov_id, rating, _ts = \
                    line.decode("latin-1").strip().split("::")
                mov = movies[int(mov_id)]
                yield (users[int(uid)]
                       + [int(mov_id), mov[0], mov[1]]
                       + [[float(rating) * 2 - 5.0]])


class _MovielensMeta:
    """Lazily-resolved corpus metadata with a synthetic surrogate
    (120 users x 80 movies, 6 categories, latent-factor ratings)."""

    N_USERS, N_MOVIES, N_CATS, N_JOBS, N_TITLE_WORDS = 120, 80, 6, 21, 40

    def __init__(self):
        self._resolved = False

    def resolve(self):
        if self._resolved:
            return self
        self.zip_path = _try_download(MOVIELENS_URL, "movielens",
                                      MOVIELENS_MD5)
        if self.zip_path:
            (self.movies, self.users, self.title_dict,
             self.categories_dict) = parse_movielens_meta(self.zip_path)
        else:
            rng = np.random.RandomState(77)
            self.categories_dict = {f"cat{i}": i for i in range(self.N_CATS)}
            self.title_dict = {f"word{i}": i
                               for i in range(self.N_TITLE_WORDS)}
            self.movies = {
                m: (sorted(set(rng.randint(0, self.N_CATS, 2).tolist())),
                    rng.randint(0, self.N_TITLE_WORDS, 3).tolist())
                for m in range(1, self.N_MOVIES + 1)}
            self.users = {
                u: [u, int(rng.randint(2)), int(rng.randint(len(AGE_TABLE))),
                    int(rng.randint(self.N_JOBS))]
                for u in range(1, self.N_USERS + 1)}
        self._resolved = True
        return self

    def synthetic_ratings(self, is_test: bool, n: int = 3000,
                          test_ratio: float = 0.1):
        rng = np.random.RandomState(177)
        u_f = np.random.RandomState(78).randn(self.N_USERS + 1, 4)
        m_f = np.random.RandomState(79).randn(self.N_MOVIES + 1, 4)
        for _ in range(n):
            if (rng.rand() < test_ratio) != is_test:
                continue
            u = int(rng.randint(1, self.N_USERS + 1))
            m = int(rng.randint(1, self.N_MOVIES + 1))
            score = float(np.clip(np.round(
                2.5 + 1.2 * (u_f[u] @ m_f[m]) + 0.5 * rng.randn()), 1, 5))
            mov = self.movies[m]
            yield self.users[u] + [m, mov[0], mov[1]] + [[score * 2 - 5.0]]


_MOVIELENS = _MovielensMeta()


def _movielens_reader(is_test: bool):
    def reader():
        meta = _MOVIELENS.resolve()
        if meta.zip_path:
            yield from parse_movielens_ratings(
                meta.zip_path, meta.movies, meta.users, is_test)
        else:
            yield from meta.synthetic_ratings(is_test)

    return reader


def movielens_train():
    """Reader of [uid, gender, age, job, mov_id, cats, title, [rating]]
    — ``v2/dataset/movielens.py``."""
    return _movielens_reader(is_test=False)


def movielens_test():
    return _movielens_reader(is_test=True)


def movielens_movie_categories():
    return _MOVIELENS.resolve().categories_dict


def movielens_get_movie_title_dict():
    return _MOVIELENS.resolve().title_dict


def movielens_max_user_id():
    return max(u[0] for u in _MOVIELENS.resolve().users.values())


def movielens_max_movie_id():
    return max(_MOVIELENS.resolve().movies)


def movielens_max_job_id():
    return max(u[3] for u in _MOVIELENS.resolve().users.values())


def movielens_user_info():
    return dict(_MOVIELENS.resolve().users)


def movielens_movie_info():
    return dict(_MOVIELENS.resolve().movies)


# ----------------------------------------------------------------- sentiment

# the nltk_data package mirror (reference sentiment.py downloads via
# nltk.download('movie_reviews'))
SENTIMENT_URL = ("https://raw.githubusercontent.com/nltk/nltk_data/"
                 "gh-pages/packages/corpora/movie_reviews.zip")
SENTIMENT_MD5 = "385ca9ac1d150113358dd62a1b600e99"


def parse_sentiment(zip_path: str):
    """Parse the nltk ``movie_reviews`` zip (``movie_reviews/{neg,pos}/
    *.txt``) into the reference's format (``sentiment.py:87``):
    a freq-sorted word dict and an interleaved neg/pos sample list of
    ``(word_ids, label)`` with label 0=neg, 1=pos."""
    import collections
    import zipfile

    token_re = re.compile(r"[a-z0-9']+|[^\sa-z0-9']", re.I)
    docs = {"neg": [], "pos": []}
    with zipfile.ZipFile(zip_path) as z:
        for info in sorted(z.infolist(), key=lambda i: i.filename):
            parts = info.filename.split("/")
            if len(parts) == 3 and parts[1] in docs \
                    and parts[2].endswith(".txt"):
                words = token_re.findall(
                    z.read(info).decode("latin-1").lower())
                docs[parts[1]].append(words)
    freq = collections.defaultdict(int)
    for cat in ("neg", "pos"):
        for words in docs[cat]:
            for w in words:
                freq[w] += 1
    # frequency-sorted ids (ties broken lexically for determinism)
    word_dict = {w: i for i, (w, _) in enumerate(
        sorted(freq.items(), key=lambda kv: (-kv[1], kv[0])))}
    data = []
    # cross-read neg/pos (sentiment.py:74 sort_files interleaving)
    for neg, pos in zip(docs["neg"], docs["pos"]):
        data.append(([word_dict[w] for w in neg], 0))
        data.append(([word_dict[w] for w in pos], 1))
    return word_dict, data


_SENTIMENT_CACHE: dict = {}


def _sentiment_data():
    if "data" in _SENTIMENT_CACHE:
        return _SENTIMENT_CACHE["word_dict"], _SENTIMENT_CACHE["data"]
    zip_path = _try_download(SENTIMENT_URL, "sentiment", SENTIMENT_MD5)
    if zip_path:
        word_dict, data = parse_sentiment(zip_path)
    else:
        word_dict = {f"w{i}": i for i in range(5000)}
        data = [(w.tolist(), y) for w, y in
                _synthetic_text(1600, 5000, 2, 20, 200, seed=21)]
    _SENTIMENT_CACHE.update(word_dict=word_dict, data=data)
    return word_dict, data


def sentiment_word_dict():
    return _sentiment_data()[0]


def sentiment_train(train_ratio: float = 0.8):
    def reader():
        _, data = _sentiment_data()
        yield from data[: int(len(data) * train_ratio)]

    return reader


def sentiment_test(train_ratio: float = 0.8):
    def reader():
        _, data = _sentiment_data()
        yield from data[int(len(data) * train_ratio):]

    return reader


# ------------------------------------------------------------------- voc2012

VOC_URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
           "VOCtrainval_11-May-2012.tar")
VOC_MD5 = "6cd6e144f989b92b3379bac3b3de84fd"
_VOC_SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
_VOC_DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
_VOC_LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"


def parse_voc2012(tar_path: str, sub_name: str):
    """Yield ``(image HWC uint8, label HW uint8)`` pairs for the given
    segmentation split (reference ``voc2012.py:42``)."""
    import io

    from PIL import Image

    with tarfile.open(tar_path) as tar:
        members = {m.name: m for m in tar.getmembers()}
        set_file = tar.extractfile(members[_VOC_SET_FILE.format(sub_name)])
        for line in set_file.read().decode().splitlines():
            line = line.strip()
            if not line:
                continue
            img = np.array(Image.open(io.BytesIO(
                tar.extractfile(members[_VOC_DATA_FILE.format(line)]).read())))
            lab = np.array(Image.open(io.BytesIO(
                tar.extractfile(
                    members[_VOC_LABEL_FILE.format(line)]).read())))
            yield img, lab


def _voc_reader(sub_name: str, n_synth: int, seed: int):
    tar = _try_download(VOC_URL, "voc2012", VOC_MD5)

    def reader():
        if tar:
            yield from parse_voc2012(tar, sub_name)
            return
        rng = np.random.RandomState(seed)
        for _ in range(n_synth):
            h, w = int(rng.randint(96, 160)), int(rng.randint(96, 160))
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            lab = rng.randint(0, 21, (h, w)).astype(np.uint8)
            yield img, lab

    return reader


def voc2012_train(n_synth: int = 64):
    """Segmentation reader of (image, label) — ``v2/dataset/voc2012.py``
    (train() reads the 'trainval' split, as the reference does)."""
    return _voc_reader("trainval", n_synth, seed=31)


def voc2012_test(n_synth: int = 16):
    return _voc_reader("train", n_synth, seed=32)


def voc2012_val(n_synth: int = 16):
    return _voc_reader("val", n_synth, seed=33)


# ------------------------------------------------------------------- flowers

FLOWERS_DATA_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
                    "102flowers.tgz")
FLOWERS_LABEL_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
                     "imagelabels.mat")
FLOWERS_SETID_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
                     "setid.mat")
FLOWERS_DATA_MD5 = "52808999861908f626f3c1f4e79d11fa"
FLOWERS_LABEL_MD5 = "e0620be6f572b9609742df49c70aed4d"
FLOWERS_SETID_MD5 = "a5357ecc9cb78c4bef273ce3793fc85c"
# flowers.py:50-55 — official readme flags, train/test deliberately
# exchanged (tstid is the larger split)
FLOWERS_TRAIN_FLAG, FLOWERS_TEST_FLAG, FLOWERS_VALID_FLAG = \
    "tstid", "trnid", "valid"


def flowers_default_mapper(is_train: bool, sample):
    """jpeg bytes → (flat float32 CHW 3x224x224 image, 0-based label)
    (reference ``flowers.py:58``)."""
    from ..v2 import image as v2_image

    img_bytes, label = sample
    img = v2_image.load_image_bytes(img_bytes)
    # the reference's mean is BGR-ordered (cv2 loader); our loader
    # decodes RGB, so reverse it to hit the right channels
    img = v2_image.simple_transform(
        img, 256, 224, is_train, mean=[123.68, 116.78, 103.94])
    return img.flatten().astype(np.float32), label


def parse_flowers(data_tgz: str, label_mat: str, setid_mat: str,
                  set_flag: str):
    """Yield ``(jpeg_bytes, 0-based_label)`` for the images in the given
    setid split (reference ``flowers.py:73`` minus the on-disk pickle
    batching, which was an optimization for cPickle-era IO)."""
    import scipy.io as scio

    labels = scio.loadmat(label_mat)["labels"][0]
    indexes = scio.loadmat(setid_mat)[set_flag][0]
    wanted = {"jpg/image_%05d.jpg" % i: int(labels[i - 1]) for i in indexes}
    with tarfile.open(data_tgz) as tar:
        for m in tar.getmembers():
            if m.name in wanted:
                yield tar.extractfile(m).read(), wanted[m.name] - 1


def _flowers_reader(set_flag: str, is_train: bool, mapper, n_synth: int,
                    seed: int):
    data = _try_download(FLOWERS_DATA_URL, "flowers", FLOWERS_DATA_MD5)
    label = _try_download(FLOWERS_LABEL_URL, "flowers", FLOWERS_LABEL_MD5)
    setid = _try_download(FLOWERS_SETID_URL, "flowers", FLOWERS_SETID_MD5)
    mapper = mapper or (lambda s: flowers_default_mapper(is_train, s))

    def reader():
        if data and label and setid:
            samples = parse_flowers(data, label, setid, set_flag)
        else:
            samples = _synthetic_flowers_jpegs(n_synth, seed)
        for sample in samples:
            yield mapper(sample)

    return reader


def _synthetic_flowers_jpegs(n: int, seed: int):
    """(jpeg_bytes, label) surrogates so the fallback path exercises the
    SAME mapper contract as real data (raw bytes in, mapper out)."""
    import io

    from PIL import Image

    imgs, labs = _synthetic_images(n, 64, 102, seed=seed)
    for i in range(len(labs)):
        arr = ((imgs[i].reshape(64, 64) + 1) * 127.5).astype(np.uint8)
        rgb = np.stack([arr] * 3, axis=-1)
        buf = io.BytesIO()
        Image.fromarray(rgb, "RGB").save(buf, "JPEG")
        yield buf.getvalue(), int(labs[i])


def flowers_train(mapper=None, n_synth: int = 512):
    """Reader of (flat 3x224x224 float image, label in [0,102)) —
    ``v2/dataset/flowers.py``."""
    return _flowers_reader(FLOWERS_TRAIN_FLAG, True, mapper, n_synth, 41)


def flowers_test(mapper=None, n_synth: int = 128):
    return _flowers_reader(FLOWERS_TEST_FLAG, False, mapper, n_synth, 42)


def flowers_valid(mapper=None, n_synth: int = 128):
    return _flowers_reader(FLOWERS_VALID_FLAG, False, mapper, n_synth, 43)


# -------------------------------------------------------------------- mq2007

# LETOR 4.0 MQ2007; the reference URL serves a .rar (mq2007.py:34) —
# stdlib cannot extract rar, so the loader consumes an already-extracted
# Fold directory from the cache (or any user-supplied path) and otherwise
# falls back to synthetic query lists.
MQ2007_FEATURES = 46


def parse_mq2007_line(line: str, fill_missing: float = -1.0):
    """One LETOR line: ``label qid:N 1:v ... 46:v #docid = X ...`` →
    ``(qid, label, feature_vector[46])`` (reference ``mq2007.py:49``
    ``Query._parse_``); returns None on malformed lines."""
    body = line.split("#")[0].strip()
    if not body:
        return None
    parts = body.split()
    try:
        label = float(parts[0])
        qid = int(parts[1].split(":")[1])
    except (IndexError, ValueError):
        return None
    feats = np.full(MQ2007_FEATURES, fill_missing, np.float32)
    for tok in parts[2:]:
        k, _, v = tok.partition(":")
        try:
            feats[int(k) - 1] = float(v)
        except (IndexError, ValueError):
            continue
    return qid, label, feats


def parse_mq2007(path: str, fill_missing: float = -1.0):
    """Parse a LETOR text file into ordered query lists:
    ``[(qid, [(label, features), ...]), ...]`` (``mq2007.py:268``
    load_from_text, without the shuffle)."""
    queries: Dict[int, list] = {}
    order = []
    with open(path) as f:
        for line in f:
            rec = parse_mq2007_line(line, fill_missing)
            if rec is None:
                continue
            qid, label, feats = rec
            if qid not in queries:
                queries[qid] = []
                order.append(qid)
            queries[qid].append((label, feats))
    return [(qid, queries[qid]) for qid in order]


def _mq2007_pairwise(docs):
    """All (higher, lower) relevance pairs within one query
    (``mq2007.py:187`` gen_pair, full partial order)."""
    for i, (li, fi) in enumerate(docs):
        for lj, fj in docs[i + 1:]:
            if li > lj:
                yield 1.0, fi, fj
            elif lj > li:
                yield 1.0, fj, fi


def _synthetic_querylists(n_queries: int, seed: int):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(49).randn(MQ2007_FEATURES).astype(np.float32)
    out = []
    for q in range(n_queries):
        n_docs = int(rng.randint(5, 40))
        feats = rng.randn(n_docs, MQ2007_FEATURES).astype(np.float32)
        scores = feats @ w + 0.5 * rng.randn(n_docs)
        labels = np.digitize(scores, np.percentile(scores, [60, 90]))
        out.append((q, [(float(labels[i]), feats[i])
                        for i in range(n_docs)]))
    return out


def _mq2007_reader(split: str, format: str, n_synth_queries: int,
                   seed: int):
    path = _cache_path("MQ2007", "MQ2007", "Fold1", f"{split}.txt")

    def reader():
        querylists = parse_mq2007(path) if os.path.exists(path) \
            else _synthetic_querylists(n_synth_queries, seed)
        for qid, docs in querylists:
            if format == "pointwise":
                for label, feats in docs:
                    yield label, feats
            elif format == "pairwise":
                yield from _mq2007_pairwise(docs)
            elif format == "listwise":
                yield [l for l, _ in docs], [f for _, f in docs]
            else:
                raise ValueError(f"unknown mq2007 format {format!r}")

    return reader


def mq2007_train(format: str = "pairwise", n_synth_queries: int = 300):
    """LETOR learning-to-rank reader — ``v2/dataset/mq2007.py``.
    pointwise: (label, feat[46]); pairwise: (1.0, better, worse);
    listwise: (labels, feats)."""
    return _mq2007_reader("train", format, n_synth_queries, seed=51)


def mq2007_test(format: str = "pairwise", n_synth_queries: int = 60):
    return _mq2007_reader("test", format, n_synth_queries, seed=52)
