"""PyDataProvider2-compatible ``@provider`` decorator (counterpart of
``paddle_tpu/data/provider.py``).

Reference: ``python/paddle/trainer/PyDataProvider2.py:365`` — users
declare a generator of samples with input types.  The decorator wraps
the generator into the reader protocol plus its metadata; the trainer's
feeder consumes it directly.
"""

from __future__ import annotations

import functools
import random
from typing import Callable, Optional


class CacheType:
    """``PyDataProvider2.CacheType`` (cache levels NO_CACHE /
    CACHE_PASS_IN_MEM)."""

    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class Settings:
    """Provider settings object handed to ``init_hook`` / the generator.

    Init hooks set either ``settings.input_types`` or the older alias
    ``settings.slots``; both names point at the same list.
    """

    def __init__(self, input_types=None):
        self.input_types = input_types

    @property
    def slots(self):
        return self.input_types

    @slots.setter
    def slots(self, value):
        self.input_types = value


class ProviderWrapper:
    def __init__(self, generator: Callable, input_types, cache: bool,
                 should_shuffle: bool, pool_size: int,
                 init_hook: Optional[Callable]):
        self.generator = generator
        self.input_types = input_types
        self.cache = cache
        self.should_shuffle = should_shuffle
        self.pool_size = pool_size
        self.init_hook = init_hook
        self._cached = None
        self.settings = Settings(input_types)

    def reader(self, *file_list, **kwargs):
        """Build a reader over the provider's generator."""
        if self.init_hook:
            self.init_hook(self.settings, file_list=file_list, **kwargs)

        def read():
            if self.cache and self._cached is not None:
                data = self._cached
            else:
                data = []
                files = file_list or [None]
                for fname in files:
                    for sample in self.generator(self.settings, fname):
                        if self.cache:
                            data.append(sample)
                        else:
                            yield sample
                if self.cache:
                    self._cached = data
                else:
                    return
            if self.should_shuffle:
                data = list(data)
                random.shuffle(data)
            yield from data

        if self.should_shuffle and not self.cache:
            from .reader import shuffle

            return shuffle(read, max(self.pool_size, 1) or 1000)
        return read


def provider(input_types=None, cache=False, should_shuffle=True,
             pool_size=1000, min_pool_size=-1, calc_batch_size=None,
             init_hook=None, **_ignored):
    """``@provider(input_types=[...])`` decorator (PyDataProvider2 API)."""

    def deco(fn):
        wrapper = ProviderWrapper(fn, input_types, cache, should_shuffle,
                                  pool_size, init_hook)
        functools.update_wrapper(wrapper, fn, updated=[])
        return wrapper

    return deco
