"""Patch / Diff — what the backend sends the frontend after each apply.

Parity: the reference frontend consumes Automerge patches with `.clock`,
`.deps`, `.diffs` and skips empty-diff patches (reference
src/DocFrontend.ts:157-179). Diffs here are self-contained instructions a
frontend can apply mechanically to its materialized state:

- create: a new object (id, type) came into existence
- set:    map key / list elem now has a value (or link to an object),
          with any concurrent-conflict losers attached
- insert: list gained an element at index (with its stable elem id)
- remove: map key / list elem disappeared

Diffs for one change are ordered so that `create` precedes any `set`/
`insert` linking the created object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class Conflict:
    """A losing concurrent value at the same location (winner excluded)."""

    op_id: str
    value: Any = None
    link: bool = False
    datatype: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"op": self.op_id}
        if self.value is not None:
            d["v"] = self.value
        if self.link:
            d["l"] = True
        if self.datatype:
            d["d"] = self.datatype
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Conflict":
        return Conflict(d["op"], d.get("v"), bool(d.get("l")), d.get("d"))


@dataclass(frozen=True)
class Diff:
    action: str  # 'create' | 'set' | 'insert' | 'remove'
    obj: str  # container object id ('0@_root' for the root map)
    obj_type: str  # 'map' | 'table' | 'list' | 'text'
    key: Optional[str] = None  # map/table location
    index: Optional[int] = None  # list/text location (live index)
    elem_id: Optional[str] = None  # stable elem identity for list/text
    value: Any = None
    link: bool = False  # value is an object id string
    datatype: Optional[str] = None
    conflicts: tuple = ()  # Tuple[Conflict, ...]

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"ac": self.action, "o": self.obj, "t": self.obj_type}
        if self.key is not None:
            d["k"] = self.key
        if self.index is not None:
            d["x"] = self.index
        if self.elem_id is not None:
            d["e"] = self.elem_id
        if self.value is not None:
            d["v"] = self.value
        if self.link:
            d["l"] = True
        if self.datatype:
            d["d"] = self.datatype
        if self.conflicts:
            d["c"] = [c.to_json() for c in self.conflicts]
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Diff":
        return Diff(
            action=d["ac"],
            obj=d["o"],
            obj_type=d["t"],
            key=d.get("k"),
            index=d.get("x"),
            elem_id=d.get("e"),
            value=d.get("v"),
            link=bool(d.get("l")),
            datatype=d.get("d"),
            conflicts=tuple(Conflict.from_json(c) for c in d.get("c", ())),
        )


@dataclass(frozen=True)
class Patch:
    clock: Dict[str, int]
    deps: Dict[str, int]
    max_op: int
    diffs: tuple  # Tuple[Diff, ...]
    actor: Optional[str] = None  # set for the local-change echo
    seq: Optional[int] = None

    @property
    def is_empty(self) -> bool:
        return not self.diffs

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "clock": dict(self.clock),
            "deps": dict(self.deps),
            "maxOp": self.max_op,
            "diffs": [x.to_json() for x in self.diffs],
        }
        if self.actor is not None:
            d["actor"] = self.actor
        if self.seq is not None:
            d["seq"] = self.seq
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Patch":
        return Patch(
            clock=dict(d["clock"]),
            deps=dict(d["deps"]),
            max_op=d["maxOp"],
            diffs=tuple(Diff.from_json(x) for x in d["diffs"]),
            actor=d.get("actor"),
            seq=d.get("seq"),
        )
