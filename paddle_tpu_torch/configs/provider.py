"""Synthetic data providers of the configs beside them (stand-ins for
``benchmark/paddle/rnn/provider.py``, which loads IMDB, and
``benchmark/paddle/image/provider.py``), in the reference's provider
idiom: they import only ``paddle.trainer.PyDataProvider2`` and numpy.

``process`` (``image.py``) yields ``num_samples`` samples ``(pixels,
label)``: ``3·height·width`` floats uniform in [−1, 1) (``height·width``
without ``color``) and a label below ``num_class``, drawn from
``RandomState(0)`` in that order, sample by sample, never shuffled, as
``benchmark/provider.py`` draws them.

``process_rnn`` yields ``num_samples`` samples ``(ids, label)``: 100 ids
in ``[0, vocab_size)`` and a label in {0, 1}, drawn from
``RandomState(0)`` in that order, sample by sample, never shuffled.
"""

import numpy as np
from paddle.trainer.PyDataProvider2 import *  # noqa: F401,F403


def _image_types(settings, **kwargs):
    h = kwargs.get("height", 32)
    w = kwargs.get("width", 32)
    c = 3 if kwargs.get("color", True) else 1
    settings.input_types = [dense_vector(h * w * c),
                            integer_value(kwargs.get("num_class", 10))]
    settings.kw = kwargs


@provider(init_hook=_image_types, should_shuffle=False)
def process(settings, _file):
    kw = settings.kw
    h, w = kw.get("height", 32), kw.get("width", 32)
    c = 3 if kw.get("color", True) else 1
    nc = kw.get("num_class", 10)
    rng = np.random.RandomState(0)
    for _ in range(kw.get("num_samples", 2048)):
        yield (rng.uniform(-1, 1, h * w * c).astype(np.float32),
               int(rng.randint(nc)))


def _rnn_types(settings, **kwargs):
    settings.input_types = [
        integer_value_sequence(kwargs.get("vocab_size", 30000)),
        integer_value(2)]
    settings.kw = kwargs


@provider(init_hook=_rnn_types, should_shuffle=False)
def process_rnn(settings, _file):
    kw = settings.kw
    vocab = kw.get("vocab_size", 30000)
    maxlen = kw.get("maxlen", 100)
    n = kw.get("num_samples", 2048)
    rng = np.random.RandomState(0)
    for _ in range(n):
        yield (rng.randint(0, vocab, maxlen).astype(np.int64).tolist(),
               int(rng.randint(2)))


def _tagging_types(settings, **kwargs):
    settings.input_types = [
        integer_value_sequence(kwargs.get("vocab_size", 50)),
        integer_value_sequence(kwargs.get("num_tags", 5))]
    settings.kw = kwargs


@provider(init_hook=_tagging_types, should_shuffle=False)
def process_tagging(settings, _file):
    """The sequence-tagging demo's synthetic task (``tagging.py`` beside
    this file): ``num_samples`` samples ``(words, tags)`` of a length in
    ``[seq_len // 2, seq_len]``, each tag its word's class (id mod
    ``num_tags``) moved on by one where the previous word's class is the
    same, from ``RandomState(0)``."""
    kw = settings.kw
    vocab, tags = kw.get("vocab_size", 50), kw.get("num_tags", 5)
    t = kw.get("seq_len", 12)
    rng = np.random.RandomState(0)
    for _ in range(kw.get("num_samples", 1024)):
        words = rng.randint(0, vocab, t)
        cls = words % tags
        tag = cls.copy()
        tag[1:] = (cls[1:] + (cls[:-1] == cls[1:])) % tags
        n = int(rng.randint(t // 2, t + 1))
        yield words[:n].tolist(), tag[:n].tolist()
