"""Name → factory registries (counterpart of
``paddle_tpu/utils/registry.py``): the reference's ``ClassRegistrar``,
one generic class that each subsystem instantiates (the evaluators
register into one)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, Iterable, List, TypeVar

from .error import PaddleTpuError

T = TypeVar("T")


class Registry(Generic[T]):
    """A named collection of factories, filled by the :meth:`register`
    decorator at import time."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}
        self._aliases: Dict[str, str] = {}

    def register(self, name: str, *aliases: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._entries:
                raise PaddleTpuError(
                    f"duplicate {self.kind} registration: {name!r}")
            self._entries[name] = obj
            for a in aliases:
                self._aliases[a] = name
            return obj

        return deco

    def register_value(self, name: str, obj: T, *aliases: str) -> T:
        self.register(name, *aliases)(obj)
        return obj

    def contains(self, name: str) -> bool:
        return name in self._entries or name in self._aliases

    __contains__ = contains

    def get(self, name: str) -> T:
        key = self._aliases.get(name, name)
        try:
            return self._entries[key]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise PaddleTpuError(
                f"unknown {self.kind} {name!r}; registered: {known}"
            ) from None

    def names(self) -> List[str]:
        return sorted(self._entries)

    def items(self) -> Iterable[tuple]:
        return self._entries.items()

    def create(self, name: str, *args: Any, **kwargs: Any) -> Any:
        """Instantiate a registered factory/class."""
        return self.get(name)(*args, **kwargs)
