"""Change/Op data model — the unit of CRDT replication.

Semantic parity target: the Automerge 0.14 change format used by the
reference (SURVEY.md §2.2: change identity = (actor, seq), seq equals feed
length + 1, deps are a vector clock; ops create objects / set keys / insert
list elements). The op model here is redesigned for columnar encoding
(BASELINE.json: `(actor, seq, lamport, ref, action)` int32 arrays):

- Every op has a lamport **counter** (`ctr`); its identity is the OpId
  `(ctr, actor)`. A change's ops get consecutive counters starting at
  `start_op`; `start_op` is assigned by the writer's backend as
  `max_op_seen + 1`, which guarantees any op referencing object/element X
  has ctr > X.ctr (causal lamport property — the device RGA kernel's
  sibling ordering relies on it).
- Supersession is explicit: `pred` lists the OpIds a SET/DEL/MAKE op
  overwrites (observed-remove semantics). A value is *visible* iff no
  applied op names it in `pred`. Concurrent SETs leave multiple visible
  ops = a conflict; display winner is the max OpId.
- List ops address elements by OpId (`ref`); `insert=True` creates a new
  element after `ref` (HEAD for the front). RGA ordering: among elements
  inserted after the same ref, descending OpId order.

Changes are canonically serialized as JSON dicts (wire + feed block format;
block compression lives in storage/block.py). This is the port's copy of
hypermerge_tpu/crdt/change.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

# ---------------------------------------------------------------------------
# identities


class OpId(NamedTuple):
    """Lamport-ordered op identity. Ordering = (ctr, actor) — the conflict
    tie-break used everywhere (host and device kernels must agree).
    A NamedTuple, not a dataclass: OpIds are hashed/compared millions of
    times (opset dict keys, supersession maps) and tuple hash/eq run in
    C — measurably faster on the interactive change path."""

    ctr: int
    actor: str

    def __str__(self) -> str:
        return f"{self.ctr}@{self.actor}"

    @staticmethod
    def parse(s: str) -> "OpId":
        ctr, _, actor = s.partition("@")
        return OpId(int(ctr), actor)


ROOT = OpId(0, "_root")  # the document root map
HEAD = OpId(0, "_head")  # list front sentinel for insert-after


class Action(IntEnum):
    """Op actions. IntEnum values are the device-side action codes
    (ops/columnar.py packs these verbatim into int32 lanes)."""

    MAKE_MAP = 0
    MAKE_LIST = 1
    MAKE_TEXT = 2
    MAKE_TABLE = 3
    SET = 4
    DEL = 5
    INC = 6
    PAD = 7  # device-only padding lane; never appears in a Change

    @property
    def makes_object(self) -> bool:
        return self in (
            Action.MAKE_MAP,
            Action.MAKE_LIST,
            Action.MAKE_TEXT,
            Action.MAKE_TABLE,
        )


OBJ_TYPE_BY_MAKE = {
    Action.MAKE_MAP: "map",
    Action.MAKE_LIST: "list",
    Action.MAKE_TEXT: "text",
    Action.MAKE_TABLE: "table",
}


# ---------------------------------------------------------------------------
# ops & changes (backend/wire form — fully resolved ids)


@dataclass(frozen=True)
class Op:
    action: Action
    obj: OpId  # container object id (ROOT for the root map)
    key: Optional[str] = None  # map/table key (None for list ops)
    ref: Optional[OpId] = None  # list element addressed (HEAD = front)
    insert: bool = False  # True: create new elem after ref
    value: Any = None  # scalar payload (SET/INS) or INC delta
    datatype: Optional[str] = None  # 'counter' | 'timestamp' | None
    pred: Tuple[OpId, ...] = ()  # ops this op supersedes/deletes

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"a": int(self.action), "o": str(self.obj)}
        if self.key is not None:
            d["k"] = self.key
        if self.ref is not None:
            d["r"] = str(self.ref)
        if self.insert:
            d["i"] = True
        if self.value is not None:
            d["v"] = self.value
        if self.datatype is not None:
            d["d"] = self.datatype
        if self.pred:
            d["p"] = [str(p) for p in self.pred]
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Op":
        return Op(
            action=Action(d["a"]),
            obj=OpId.parse(d["o"]),
            key=d.get("k"),
            ref=OpId.parse(d["r"]) if "r" in d else None,
            insert=bool(d.get("i", False)),
            value=d.get("v"),
            datatype=d.get("d"),
            pred=tuple(OpId.parse(p) for p in d.get("p", ())),
        )


@dataclass(frozen=True)
class Change:
    actor: str
    seq: int  # 1-based, == writer feed length + 1 (append-only order)
    start_op: int  # ctr of ops[0]; ops[i].ctr == start_op + i
    deps: Dict[str, int]  # vector clock of causal dependencies (excl. self)
    ops: Tuple[Op, ...]
    time: int = 0
    message: str = ""

    def op_id(self, i: int) -> OpId:
        return OpId(self.start_op + i, self.actor)

    @property
    def max_op(self) -> int:
        return self.start_op + len(self.ops) - 1 if self.ops else self.start_op - 1

    def to_json(self) -> Dict[str, Any]:
        return {
            "actor": self.actor,
            "seq": self.seq,
            "startOp": self.start_op,
            "deps": dict(self.deps),
            "time": self.time,
            "message": self.message,
            "ops": [op.to_json() for op in self.ops],
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Change":
        return Change(
            actor=d["actor"],
            seq=d["seq"],
            start_op=d["startOp"],
            deps=dict(d["deps"]),
            time=d.get("time", 0),
            message=d.get("message", ""),
            ops=tuple(Op.from_json(o) for o in d["ops"]),
        )


# ---------------------------------------------------------------------------
# frontend intents (request form — ids unresolved, assigned by the writer's
# backend at applyLocalChange time, mirroring the reference's
# Frontend.change -> RequestMsg -> Backend.applyLocalChange flow,
# reference src/DocFrontend.ts:137, src/DocBackend.ts:187-205)


@dataclass(frozen=True)
class OpIntent:
    """One user mutation recorded by the change-fn proxy.

    `obj` is either a resolved OpId string (existing object) or a temp id
    `"tmp:<n>"` for objects created earlier in the same change fn. List
    positions are indices into the list as the frontend displayed it.
    """

    action: Action
    obj: str  # OpId str | "tmp:<n>" | "_root"
    key: Optional[str] = None
    index: Optional[int] = None  # list index (for insert: insert-before idx)
    insert: bool = False
    value: Any = None
    datatype: Optional[str] = None
    temp_id: Optional[str] = None  # set for MAKE_*: id used later in the fn

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"a": int(self.action), "o": self.obj}
        for name, v in (
            ("k", self.key),
            ("x", self.index),
            ("v", self.value),
            ("d", self.datatype),
            ("t", self.temp_id),
        ):
            if v is not None:
                d[name] = v
        if self.insert:
            d["i"] = True
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "OpIntent":
        return OpIntent(
            action=Action(d["a"]),
            obj=d["o"],
            key=d.get("k"),
            index=d.get("x"),
            insert=bool(d.get("i", False)),
            value=d.get("v"),
            datatype=d.get("d"),
            temp_id=d.get("t"),
        )


@dataclass(frozen=True)
class ChangeRequest:
    """Frontend -> backend local change request (reference RequestMsg)."""

    actor: str
    seq: int
    time: int
    message: str
    intents: Tuple[OpIntent, ...]

    def to_json(self) -> Dict[str, Any]:
        return {
            "actor": self.actor,
            "seq": self.seq,
            "time": self.time,
            "message": self.message,
            "intents": [i.to_json() for i in self.intents],
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ChangeRequest":
        return ChangeRequest(
            actor=d["actor"],
            seq=d["seq"],
            time=d.get("time", 0),
            message=d.get("message", ""),
            intents=tuple(OpIntent.from_json(i) for i in d["intents"]),
        )
