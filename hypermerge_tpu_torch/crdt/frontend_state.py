"""FrontendDoc — materialized document state + change-fn proxy.

Semantic twin of Automerge's Frontend as the reference uses it
(SURVEY.md §2.2: Frontend.init/change/applyPatch/setActorId). The frontend
holds ONLY patch-derived state — the backend (OpSet or the batched device
path) is the single source of truth — so frontend and backend can live on
different threads/processes exactly like the reference's split
(reference README.md:160-184, src/DocFrontend.ts).

`change(fn)` runs the user's mutation function against a scratch mirror of
the current state, records OpIntents, and returns (request, preview):
- the preview is pushed to subscribers immediately («change preview»,
  reference src/DocFrontend.ts:142),
- the request goes to the backend, whose patch echo produces the canonical
  state («change final», reference src/RepoBackend.ts:348-362).
"""

from __future__ import annotations

import itertools
import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..models import Counter, Table, Text
from .change import Action, ChangeRequest, OpIntent
from .patch import Diff, Patch

ROOT_STR = "0@_root"


@dataclass
class _Cell:
    value: Any = None
    link: bool = False  # value is an object-id str into FrontendDoc.objs
    datatype: Optional[str] = None
    conflicts: tuple = ()


@dataclass
class _FObj:
    type: str
    data: Dict[str, _Cell] = field(default_factory=dict)  # map/table
    items: List[_Cell] = field(default_factory=list)  # list/text
    elem_ids: List[str] = field(default_factory=list)


class FrontendDoc:
    def __init__(self) -> None:
        self.objs: Dict[str, _FObj] = {ROOT_STR: _FObj("map")}
        self.clock: Dict[str, int] = {}
        self.max_op = 0
        self._cache: Any = None
        self._dirty = True

    # ------------------------------------------------------------------
    # patch application (backend -> frontend)

    def apply_patch(self, patch: Patch) -> None:
        for diff in patch.diffs:
            self._apply_diff(diff)
        self.clock = dict(patch.clock)
        self.max_op = patch.max_op
        self._dirty = True

    def _apply_diff(self, d: Diff) -> None:
        if d.action == "create":
            self.objs[d.obj] = _FObj(d.obj_type)
            return
        obj = self.objs.get(d.obj)
        if obj is None:
            return
        if d.action == "set":
            cell = _Cell(d.value, d.link, d.datatype, d.conflicts)
            if d.key is not None:
                obj.data[d.key] = cell
            elif d.index is not None and 0 <= d.index < len(obj.items):
                obj.items[d.index] = cell
                if d.elem_id:
                    obj.elem_ids[d.index] = d.elem_id
        elif d.action == "insert":
            cell = _Cell(d.value, d.link, d.datatype)
            idx = d.index if d.index is not None else len(obj.items)
            idx = max(0, min(idx, len(obj.items)))
            obj.items.insert(idx, cell)
            obj.elem_ids.insert(idx, d.elem_id or "")
        elif d.action == "remove":
            if d.key is not None:
                obj.data.pop(d.key, None)
            elif d.index is not None and 0 <= d.index < len(obj.items):
                del obj.items[d.index]
                del obj.elem_ids[d.index]

    # ------------------------------------------------------------------
    # reads

    def materialize(self) -> Any:
        if self._dirty:
            self._cache = self._mat_obj(ROOT_STR)
            self._dirty = False
        return self._cache

    def _mat_obj(self, obj_id: str) -> Any:
        obj = self.objs.get(obj_id)
        if obj is None:
            return None
        if obj.type in ("list", "text"):
            values = [self._mat_cell(c) for c in obj.items]
            if obj.type == "text":
                return Text([str(v) for v in values])
            return values
        data = {k: self._mat_cell(c) for k, c in obj.data.items()}
        if obj.type == "table":
            return Table(data)
        return data

    def _mat_cell(self, cell: _Cell) -> Any:
        if cell.link:
            return self._mat_obj(cell.value)
        if cell.datatype == "counter":
            return Counter(cell.value)
        return cell.value

    def conflicts_at(self, obj_id: str, key: str):
        obj = self.objs.get(obj_id)
        if not obj:
            return {}
        cell = obj.data.get(key)
        if not cell:
            return {}
        return {c.op_id: c.value for c in cell.conflicts}

    # ------------------------------------------------------------------
    # local change recording

    def change(
        self,
        fn: Callable[[Any], None],
        actor: str,
        seq: int,
        message: str = "",
    ) -> Tuple[Optional[ChangeRequest], Any]:
        """Run fn over a mutable scratch mirror; returns (request|None if no
        mutations, preview materialized doc)."""
        rec = _Recorder()
        scratch = _scratch_from(self, ROOT_STR)
        fn(_proxy_for(scratch, rec))
        if not rec.intents:
            return None, self.materialize()
        request = ChangeRequest(
            actor=actor,
            seq=seq,
            time=int(_time.time()),
            message=message,
            intents=tuple(rec.intents),
        )
        return request, _scratch_to_plain(scratch)


# ---------------------------------------------------------------------------
# scratch mirror + proxies


class _Scratch:
    __slots__ = ("type", "obj_id", "entries", "items")

    def __init__(self, type_: str, obj_id: str) -> None:
        self.type = type_
        self.obj_id = obj_id  # real op-id str or "tmp:<n>"
        self.entries: Dict[str, Any] = {}
        self.items: List[Any] = []


def _scratch_from(doc: FrontendDoc, obj_id: str) -> _Scratch:
    obj = doc.objs[obj_id]
    s = _Scratch(obj.type, obj_id)
    if obj.type in ("list", "text"):
        s.items = [_scratch_cell(doc, c) for c in obj.items]
    else:
        s.entries = {k: _scratch_cell(doc, c) for k, c in obj.data.items()}
    return s


def _scratch_cell(doc: FrontendDoc, cell: _Cell) -> Any:
    if cell.link:
        return _scratch_from(doc, cell.value)
    if cell.datatype == "counter":
        return Counter(cell.value)
    return cell.value


def _scratch_to_plain(s: _Scratch) -> Any:
    if s.type == "text":
        return Text([str(_plain(v)) for v in s.items])
    if s.type == "list":
        return [_plain(v) for v in s.items]
    data = {k: _plain(v) for k, v in s.entries.items()}
    if s.type == "table":
        return Table(data)
    return data


def _plain(v: Any) -> Any:
    return _scratch_to_plain(v) if isinstance(v, _Scratch) else v


class _Recorder:
    def __init__(self) -> None:
        self.intents: List[OpIntent] = []
        self._tmp = itertools.count()

    def next_tmp(self) -> str:
        return f"tmp:{next(self._tmp)}"


_MAKE_BY_VALUE = (
    (dict, Action.MAKE_MAP, "map"),
    (list, Action.MAKE_LIST, "list"),
    (Text, Action.MAKE_TEXT, "text"),
    (Table, Action.MAKE_TABLE, "table"),
)


def _classify(value: Any):
    for cls, action, type_ in _MAKE_BY_VALUE:
        if isinstance(value, cls):
            return action, type_
    return None, None


def _proxy_for(s: _Scratch, rec: _Recorder):
    if s.type in ("list",):
        return ListProxy(s, rec)
    if s.type == "text":
        return TextProxy(s, rec)
    if s.type == "table":
        return TableProxy(s, rec)
    return MapProxy(s, rec)


class _BaseProxy:
    def __init__(self, scratch: _Scratch, rec: _Recorder) -> None:
        self._s = scratch
        self._rec = rec

    @property
    def _obj(self) -> str:
        return self._s.obj_id

    def _ingest(self, value: Any, key=None, index=None, insert=False):
        """Record intents for assigning `value` at a location; returns the
        scratch representation. Container values expand into MAKE + child
        population (deep create, like Automerge's proxy assignment)."""
        action, type_ = _classify(value)
        if action is None:
            datatype = "counter" if isinstance(value, Counter) else None
            self._rec.intents.append(
                OpIntent(
                    action=Action.SET,
                    obj=self._obj,
                    key=key,
                    index=index,
                    insert=insert,
                    value=int(value) if datatype == "counter" else value,
                    datatype=datatype,
                )
            )
            return value
        tmp = self._rec.next_tmp()
        self._rec.intents.append(
            OpIntent(
                action=action,
                obj=self._obj,
                key=key,
                index=index,
                insert=insert,
                temp_id=tmp,
            )
        )
        child = _Scratch(type_, tmp)
        child_proxy = _proxy_for(child, self._rec)
        if isinstance(value, dict):
            for k, v in value.items():
                child_proxy[k] = v
        elif isinstance(value, Table):
            for rid in value.ids:
                child_proxy.add(rid, value.by_id(rid))
        elif isinstance(value, Text):
            for i, ch in enumerate(value):
                child_proxy.insert(i, ch)
        elif isinstance(value, list):
            for i, v in enumerate(value):
                child_proxy.insert(i, v)
        return child


class MapProxy(_BaseProxy):
    def __getitem__(self, key: str) -> Any:
        v = self._s.entries[key]
        return _proxy_for(v, self._rec) if isinstance(v, _Scratch) else v

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key: str) -> bool:
        return key in self._s.entries

    def keys(self):
        return self._s.entries.keys()

    def __setitem__(self, key: str, value: Any) -> None:
        self._s.entries[key] = self._ingest(value, key=key)

    def __delitem__(self, key: str) -> None:
        if key in self._s.entries:
            del self._s.entries[key]
            self._rec.intents.append(
                OpIntent(action=Action.DEL, obj=self._obj, key=key)
            )

    def increment(self, key: str, delta: int = 1) -> None:
        cur = self._s.entries.get(key)
        if not isinstance(cur, Counter):
            raise TypeError(f"{key!r} is not a Counter")
        self._rec.intents.append(
            OpIntent(action=Action.INC, obj=self._obj, key=key, value=delta)
        )
        self._s.entries[key] = Counter(int(cur) + delta)


class TableProxy(_BaseProxy):
    def add(self, row_id: str, row: Any) -> str:
        self._s.entries[row_id] = self._ingest(row, key=row_id)
        return row_id

    def remove(self, row_id: str) -> None:
        if row_id in self._s.entries:
            del self._s.entries[row_id]
            self._rec.intents.append(
                OpIntent(action=Action.DEL, obj=self._obj, key=row_id)
            )

    def by_id(self, row_id: str) -> Any:
        v = self._s.entries.get(row_id)
        return _proxy_for(v, self._rec) if isinstance(v, _Scratch) else v

    @property
    def ids(self):
        return sorted(self._s.entries.keys())


class ListProxy(_BaseProxy):
    def __len__(self) -> int:
        return len(self._s.items)

    def __getitem__(self, i: int) -> Any:
        v = self._s.items[i]
        return _proxy_for(v, self._rec) if isinstance(v, _Scratch) else v

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def insert(self, i: int, value: Any) -> None:
        i = max(0, min(i, len(self._s.items)))
        self._s.items.insert(i, self._ingest(value, index=i, insert=True))

    def append(self, value: Any) -> None:
        self.insert(len(self._s.items), value)

    def __setitem__(self, i: int, value: Any) -> None:
        if not 0 <= i < len(self._s.items):
            raise IndexError(i)
        self._s.items[i] = self._ingest(value, index=i)

    def __delitem__(self, i: int) -> None:
        if not 0 <= i < len(self._s.items):
            raise IndexError(i)
        del self._s.items[i]
        self._rec.intents.append(
            OpIntent(action=Action.DEL, obj=self._obj, index=i)
        )

    def increment(self, i: int, delta: int = 1) -> None:
        cur = self._s.items[i]
        if not isinstance(cur, Counter):
            raise TypeError(f"index {i} is not a Counter")
        self._rec.intents.append(
            OpIntent(action=Action.INC, obj=self._obj, index=i, value=delta)
        )
        self._s.items[i] = Counter(int(cur) + delta)


class TextProxy(_BaseProxy):
    def __len__(self) -> int:
        return len(self._s.items)

    def __str__(self) -> str:
        return "".join(str(v) for v in self._s.items)

    def insert(self, i: int, text: str) -> None:
        i = max(0, min(i, len(self._s.items)))
        for offset, ch in enumerate(text):
            self._rec.intents.append(
                OpIntent(
                    action=Action.SET,
                    obj=self._obj,
                    index=i + offset,
                    insert=True,
                    value=ch,
                )
            )
            self._s.items.insert(i + offset, ch)

    def delete(self, i: int, count: int = 1) -> None:
        for _ in range(count):
            if not 0 <= i < len(self._s.items):
                return
            del self._s.items[i]
            self._rec.intents.append(
                OpIntent(action=Action.DEL, obj=self._obj, index=i)
            )
