"""Reference-config compatibility: the ``paddle.*`` import surface
(counterpart of ``paddle_tpu/compat/__init__.py``).

Reference v1 configs begin with ``from paddle.trainer_config_helpers
import *`` and their data providers with ``from paddle.trainer.
PyDataProvider2 import *`` (e.g. ``benchmark/paddle/image/alexnet.py:3``,
``provider.py:4``).  So that those files run unmodified, :func:`install`
registers alias modules under ``sys.modules['paddle'...]`` that re-export
the port's config DSL and provider protocol:

- ``paddle.trainer_config_helpers``: the config namespace
  (``config_parser.config_namespace``);
- ``paddle.trainer.PyDataProvider2``: ``provider``, ``CacheType`` and the
  input types;
- ``paddle.trainer.config_parser``: ``parse_config``.

``paddle.v2`` refuses by name: the port's ``v2/`` holds only
``networks`` until queue A8 ports the rest.

Both packages claim ``sys.modules['paddle']``.  The port marks its own
aliases with :data:`MARK` (the JAX package marks its own with another
attribute), and :func:`install` refuses a ``paddle`` module it did not
make instead of shadowing it.  :func:`swapped` moves every ``paddle`` /
``paddle.*`` entry (and any other module named) aside for a block and
restores them after it, so a process that holds another package's
aliases can parse a config through the port's.

Because the era's configs are Python 2 (``xrange``, ``file``,
``cPickle`` — ``benchmark/paddle/rnn/rnn.py:29``, ``imdb.py:38``),
:func:`install` also adds those three names as py2 compatibility shims.
"""

from __future__ import annotations

import builtins
import contextlib
import importlib.abc
import pickle
import sys
import types
from typing import Iterator, Sequence

from ..utils import ConfigError

#: the attribute that marks the port's ``paddle`` alias module
MARK = "_paddle_tpu_torch_compat"

_V2_REFUSAL = ("paddle.v2 is not ported yet: the port's v2/ holds only "
               "networks (paddle_tpu_torch.v2.networks); the trainer, "
               "inference, parameters, datasets and the rest of v2 come "
               "with queue A8")


def _mk_module(name: str, attrs: dict) -> types.ModuleType:
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    mod.__all__ = [k for k in attrs if not k.startswith("_")]
    sys.modules[name] = mod
    return mod


def _ours(mod) -> bool:
    return bool(getattr(mod, MARK, False))


class _RefuseV2(importlib.abc.MetaPathFinder):
    """Refuses ``import paddle.v2`` (and its submodules) by name while
    the ``paddle`` module is the port's alias."""

    def find_spec(self, fullname, path=None, target=None):
        if (fullname == "paddle.v2" or fullname.startswith("paddle.v2.")) \
                and _ours(sys.modules.get("paddle")):
            raise ImportError(_V2_REFUSAL, name=fullname)
        return None


def install() -> None:
    """Register the ``paddle``, ``paddle.trainer_config_helpers``,
    ``paddle.trainer.PyDataProvider2`` and ``paddle.trainer.
    config_parser`` aliases and the py2 shims.  Idempotent while the
    aliases are in ``sys.modules``; raises :class:`ConfigError` when a
    ``paddle`` module the port did not make is already imported."""
    present = sys.modules.get("paddle")
    if present is not None:
        if not _ours(present):
            where = getattr(present, "__file__", None) or \
                ("the JAX package's alias" if getattr(
                    present, "_paddle_tpu_compat", False) else repr(present))
            raise ConfigError(
                f"a 'paddle' module the port did not make is already "
                f"imported ({where}); the port will not shadow it.  Parse "
                "the config in a process of its own, or inside "
                "paddle_tpu_torch.compat.swapped()")
        _install_py2_shims()
        return

    from ..config import config_parser
    from ..data import feeder
    from ..data.provider import CacheType, provider

    paddle = _mk_module("paddle", {})
    setattr(paddle, MARK, True)
    paddle.__path__ = []        # a package: 'import paddle.v2' asks finders
    trainer = _mk_module("paddle.trainer", {})
    trainer.__path__ = []
    _mk_module("paddle.trainer_config_helpers",
               config_parser.config_namespace())
    pdp2 = {"provider": provider, "CacheType": CacheType}
    for k in ("dense_vector", "integer_value", "integer_value_sequence",
              "sparse_binary_vector", "sparse_float_vector",
              "dense_vector_sequence", "sparse_binary_vector_sequence",
              "sparse_float_vector_sequence"):
        pdp2[k] = getattr(feeder, k)
    _mk_module("paddle.trainer.PyDataProvider2", pdp2)
    _mk_module("paddle.trainer.config_parser",
               {"parse_config": config_parser.parse_config})

    paddle.trainer = trainer
    paddle.trainer_config_helpers = sys.modules[
        "paddle.trainer_config_helpers"]
    trainer.PyDataProvider2 = sys.modules["paddle.trainer.PyDataProvider2"]
    trainer.config_parser = sys.modules["paddle.trainer.config_parser"]
    if not any(isinstance(f, _RefuseV2) for f in sys.meta_path):
        sys.meta_path.insert(0, _RefuseV2())
    _install_py2_shims()


def _alias_names(extra: Sequence[str]) -> list:
    return [k for k in sys.modules
            if k == "paddle" or k.startswith("paddle.") or k in extra]


@contextlib.contextmanager
def swapped(extra: Sequence[str] = ()) -> Iterator[None]:
    """Move every ``paddle`` / ``paddle.*`` entry of ``sys.modules`` and
    the modules named in ``extra`` (a config's provider module, say)
    aside for the block; after it, drop what the block registered under
    those names and put the old entries back."""
    saved = {k: sys.modules.pop(k) for k in _alias_names(extra)}
    try:
        yield
    finally:
        for k in _alias_names(extra):
            del sys.modules[k]
        sys.modules.update(saved)


def _install_py2_shims() -> None:
    if not hasattr(builtins, "xrange"):
        builtins.xrange = range
    if not hasattr(builtins, "file"):
        builtins.file = open
    if "cPickle" not in sys.modules:
        sys.modules["cPickle"] = pickle
