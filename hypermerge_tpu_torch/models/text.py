"""Text — a collaboratively editable character sequence (RGA of chars).

Parity: Automerge's Text type (reference re-exports, src/index.ts:9-12).
Materialized snapshots behave like strings; edits go through the change-fn
proxy (insert/delete by index). Device-side, text is just a list object
whose values are single-character strings — the RGA kernels don't care.
"""

from __future__ import annotations

from typing import Iterator, List


class Text:
    __slots__ = ("_chars",)

    def __init__(self, chars: "List[str] | str" = "") -> None:
        self._chars = list(chars)

    def __str__(self) -> str:
        return "".join(self._chars)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Text({str(self)!r})"

    def __len__(self) -> int:
        return len(self._chars)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return "".join(self._chars[i])
        return self._chars[i]

    def __iter__(self) -> Iterator[str]:
        return iter(self._chars)

    def __eq__(self, other) -> bool:
        if isinstance(other, Text):
            return self._chars == other._chars
        if isinstance(other, str):
            return str(self) == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(str(self))
