"""Table — a collection of uuid-keyed rows.

Parity: Automerge's Table type (reference re-exports, src/index.ts:9-12).
CRDT-wise a table is a map whose keys are row ids and whose values are row
objects; this class is the materialized read view.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List


class Table:
    __slots__ = ("_rows",)

    def __init__(self, rows: "Dict[str, Any] | None" = None) -> None:
        self._rows = dict(rows or {})

    @property
    def ids(self) -> List[str]:
        return sorted(self._rows.keys())

    def by_id(self, row_id: str) -> Any:
        return self._rows.get(row_id)

    @property
    def count(self) -> int:
        return len(self._rows)

    @property
    def rows(self) -> List[Any]:
        return [self._rows[i] for i in self.ids]

    def __len__(self) -> int:
        return len(self._rows)

    def __iter__(self) -> Iterator[Any]:
        return iter(self.rows)

    def __eq__(self, other) -> bool:
        if isinstance(other, Table):
            return self._rows == other._rows
        return NotImplemented

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Table({self._rows!r})"
