"""Document value models: the rich CRDT value types a materialized doc
exposes (Counter, Text, Table) — the framework's 'model families'."""

from .counter import Counter  # noqa: F401
from .table import Table  # noqa: F401
from .text import Text  # noqa: F401

__all__ = ["Counter", "Text", "Table"]
