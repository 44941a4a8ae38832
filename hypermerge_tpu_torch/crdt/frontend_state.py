"""FrontendDoc — materialized document state built from patches.

Semantic twin of Automerge's Frontend as the reference uses it
(SURVEY.md §2.2: Frontend.init/change/applyPatch/setActorId). The frontend
holds ONLY patch-derived state — the backend (OpSet or the batched device
path) is the single source of truth — so frontend and backend can live on
different threads/processes exactly like the reference's split
(reference README.md:160-184, src/DocFrontend.ts).

This is the port's copy of hypermerge_tpu/crdt/frontend_state.py, cut to
the read side the materialize slice needs: patch application and
materialization. The change-fn proxy stays with the write-path slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..models import Counter, Table, Text
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
