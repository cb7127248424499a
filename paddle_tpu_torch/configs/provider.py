"""Synthetic data provider of ``rnn.py`` beside it (stands in for
``benchmark/paddle/rnn/provider.py``, which loads IMDB), in the
reference's provider idiom: it imports only
``paddle.trainer.PyDataProvider2`` and numpy.

``process_rnn`` yields ``num_samples`` samples ``(ids, label)``: 100 ids
in ``[0, vocab_size)`` and a label in {0, 1}, drawn from
``RandomState(0)`` in that order, sample by sample, never shuffled.
"""

import numpy as np
from paddle.trainer.PyDataProvider2 import *  # noqa: F401,F403


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
