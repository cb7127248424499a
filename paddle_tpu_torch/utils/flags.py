"""Runtime flags this slice reads (counterpart of
``paddle_tpu/utils/flags.py``): same names and defaults, settable from
code (``FLAGS.set``) or the environment (``PADDLE_TPU_<NAME>``)."""

from __future__ import annotations

import os
from typing import Any, Callable, Dict


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


class FlagRegistry:
    def __init__(self) -> None:
        self._parsers: Dict[str, Callable[[str], Any]] = {}
        self._values: Dict[str, Any] = {}

    def define(self, name: str, default: Any, help: str = "") -> None:
        if name in self._parsers:
            raise ValueError(f"flag {name!r} is already registered")
        if isinstance(default, bool):
            parser: Callable[[str], Any] = _parse_bool
        elif isinstance(default, (int, float)):
            parser = type(default)
        else:
            parser = str
        self._parsers[name] = parser
        env = os.environ.get("PADDLE_TPU_" + name.upper())
        self._values[name] = parser(env) if env is not None else default

    def get(self, name: str) -> Any:
        return self._values[name]

    def set(self, name: str, value: Any) -> None:
        if name not in self._parsers:
            raise KeyError(f"unknown flag {name!r}")
        self._values[name] = value


FLAGS = FlagRegistry()

FLAGS.define("serve_port", 0,
             "serving HTTP endpoint: POST /v1/generate, GET /healthz; "
             "0 picks a free port")
FLAGS.define("serve_bind", "",
             "bind host for the serving endpoint; empty = loopback only")
FLAGS.define("serve_max_batch", 8,
             "continuous-batching decode width: at most this many "
             "requests share one paged_decode_attention launch")
FLAGS.define("serve_continuous", True,
             "continuous batching in the inference server; false = "
             "sequential single-request serving, byte-for-byte the same "
             "generated tokens")
FLAGS.define("kv_pool_pages", 128,
             "physical pages in the shared serving KV pool")
FLAGS.define("kv_page_size", 16, "tokens per KV page")
