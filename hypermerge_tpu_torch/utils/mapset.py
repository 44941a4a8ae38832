"""Map-of-sets helper with reverse lookup (reference src/MapSet.ts:1-64).

The port's copy of hypermerge_tpu/utils/mapset.py.
"""

from __future__ import annotations

from typing import Dict, Generic, Iterable, Iterator, List, Set, Tuple, TypeVar

A = TypeVar("A")
B = TypeVar("B")


class MapSet(Generic[A, B]):
    def __init__(self) -> None:
        self._map: Dict[A, Set[B]] = {}

    def add(self, key: A, value: B) -> bool:
        s = self._map.setdefault(key, set())
        if value in s:
            return False
        s.add(value)
        return True

    def merge(self, key: A, values: Iterable[B]) -> None:
        self._map.setdefault(key, set()).update(values)

    def delete(self, key: A) -> None:
        self._map.pop(key, None)

    def remove(self, key: A, value: B) -> None:
        s = self._map.get(key)
        if s is not None:
            s.discard(value)
            if not s:
                del self._map[key]

    def get(self, key: A) -> Set[B]:
        return self._map.get(key, set())

    def has(self, key: A, value: B) -> bool:
        return value in self._map.get(key, ())

    def keys(self) -> List[A]:
        return list(self._map.keys())

    def keys_with(self, value: B) -> List[A]:
        """All keys whose set contains `value` (reference MapSet.keysWith)."""
        return [k for k, s in self._map.items() if value in s]

    def __iter__(self) -> Iterator[Tuple[A, Set[B]]]:
        return iter(self._map.items())

    def __len__(self) -> int:
        return len(self._map)
