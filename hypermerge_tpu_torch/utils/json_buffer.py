"""JSON <-> bytes helpers (reference src/JsonBuffer.ts:1-22).

`parse_all_valid` mirrors the reference's corrupt-ledger tolerance: invalid
entries are skipped, not fatal (reference src/JsonBuffer.ts:11-22) — part of
the failure-tolerance story (SURVEY.md §5).
"""

from __future__ import annotations

import json
from typing import Any, Iterable, List


def bufferify(obj: Any) -> bytes:
    return json.dumps(obj, separators=(",", ":"), sort_keys=True).encode("utf-8")


def parse(data: bytes) -> Any:
    return json.loads(data.decode("utf-8"))


def parse_all_valid(buffers: Iterable[bytes]) -> List[Any]:
    out: List[Any] = []
    for buf in buffers:
        try:
            out.append(parse(buf))
        except (ValueError, UnicodeDecodeError):
            continue
    return out
