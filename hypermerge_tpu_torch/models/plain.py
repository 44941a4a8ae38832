"""to_plain — render a materialized document as plain JSON-able data.

Display form for tools/examples: Text becomes a str, Counter an int,
Table a {id: row} dict. (Tests use their own *tagged* normalizer so
type identity stays assertable; this one is for humans and JSON.)
"""

from __future__ import annotations

from typing import Any

from .counter import Counter
from .table import Table
from .text import Text


def to_plain(v: Any) -> Any:
    if isinstance(v, Text):
        return str(v)
    if isinstance(v, Table):
        return {k: to_plain(v.by_id(k)) for k in v.ids}
    if isinstance(v, Counter):
        return int(v)
    if isinstance(v, dict):
        return {k: to_plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [to_plain(x) for x in v]
    return v
