"""OpSet — the CRDT state machine (host incremental path).

This is the semantic twin of Automerge's Backend as the reference uses it
(SURVEY.md §2.2: Backend.init/applyChanges/applyLocalChange returning
[state', patch]); the interactive O(1)-latency path of the dual-path design
(SURVEY.md §7.3.4). The bulk path — ops/materialize.py — replays the same
changes as one batched device dispatch; tests assert both materialize
identically for arbitrary histories.

Semantics:
- Causal order: a change (actor, seq) applies when seq == clock[actor]+1
  and every dep is satisfied; otherwise it parks in a pending set
  (reference DocBackend queues via its remoteChangesQ + syncChanges window).
- Map/table keys and list elements hold a *visible set* of value ops.
  An op's `pred` list removes the ops it supersedes (observed-remove).
  Winner for display = max OpId; the rest surface as conflicts.
- List order: RGA insert-after with descending-OpId sibling order. The
  lamport property (child.ctr > parent.ctr, enforced at change creation)
  makes the sequential skip-scan insertion below equivalent to the
  tree-DFS formulation the device kernel uses.
- Counters: INC ops accumulate on a specific counter value op (`ref`);
  superseding the counter op discards its increments.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from ..models import Counter, Table, Text
from .change import (
    HEAD,
    OBJ_TYPE_BY_MAKE,
    ROOT,
    Action,
    Change,
    ChangeRequest,
    Op,
    OpId,
)
from .patch import Conflict, Diff, Patch

ROOT_STR = str(ROOT)


def resolve_intent(
    intent, opid: OpId, temp_map: Dict[str, OpId], objects_get, live_elems
) -> Optional[Op]:
    """Translate one frontend intent into a concrete Op against the
    current visible state. ONE implementation shared by the host OpSet
    and the live apply engine (backend/live.py) so the HM_LIVE=1/0
    twins cannot drift on local-change resolution — parameterized over
    the state representation: `objects_get(obj_id)` returns an object
    with `.is_sequence` + `.fields` (or None), `live_elems(obj)` its
    live element order."""
    if intent.obj in temp_map:
        obj_id = temp_map[intent.obj]
    elif intent.obj == ROOT_STR or intent.obj == "_root":
        obj_id = ROOT
    elif intent.obj.startswith("tmp:"):
        return None  # references a temp id whose MAKE failed
    else:
        try:
            obj_id = OpId.parse(intent.obj)
        except ValueError:
            return None
    obj = objects_get(obj_id)
    if obj is None:
        return None
    op = build_intent_op(intent, obj_id, obj, live_elems)
    if op is not None and intent.temp_id is not None:
        # register only on success: a failed intent must not alias its
        # temp id onto the OpId the next successful op will consume
        temp_map[intent.temp_id] = opid
    return op


def build_intent_op(intent, obj_id: OpId, obj, live_elems) -> Optional[Op]:
    action = intent.action
    if obj.is_sequence:
        if intent.insert:
            live = live_elems(obj)
            idx = intent.index if intent.index is not None else len(live)
            if idx < 0 or idx > len(live):
                return None
            ref = HEAD if idx == 0 else live[idx - 1]
            return Op(
                action=action,
                obj=obj_id,
                ref=ref,
                insert=True,
                value=intent.value,
                datatype=intent.datatype,
            )
        live = live_elems(obj)
        if intent.index is None or not (0 <= intent.index < len(live)):
            return None
        elem = live[intent.index]
        visible = obj.fields.get(elem, {})
        if action == Action.INC:
            target = max(visible) if visible else None
            if target is None:
                return None
            return Op(
                action=action, obj=obj_id, ref=elem, value=intent.value,
                pred=(target,),
            )
        return Op(
            action=action,
            obj=obj_id,
            ref=elem,
            value=intent.value,
            datatype=intent.datatype,
            pred=tuple(sorted(visible)),
        )
    # map/table
    visible = obj.fields.get(intent.key, {})
    if action == Action.INC:
        target = max(visible) if visible else None
        if target is None:
            return None
        return Op(
            action=action, obj=obj_id, key=intent.key,
            value=intent.value, pred=(target,),
        )
    return Op(
        action=action,
        obj=obj_id,
        key=intent.key,
        value=intent.value,
        datatype=intent.datatype,
        pred=tuple(sorted(visible)),
    )


@dataclass
class _Obj:
    """State of one object (map/table/list/text)."""

    type: str  # 'map' | 'table' | 'list' | 'text'
    # map/table: key -> {OpId: Op}; list/text: elem OpId -> {OpId: Op}
    fields: Dict[Any, Dict[OpId, Op]] = field(default_factory=dict)
    order: List[OpId] = field(default_factory=list)  # list/text: RGA order
    # elem liveness cache: an elem is live iff its visible set is non-empty

    @property
    def is_sequence(self) -> bool:
        return self.type in ("list", "text")


class OpSet:
    def __init__(self) -> None:
        self.objects: Dict[OpId, _Obj] = {ROOT: _Obj("map")}
        self.clock: Dict[str, int] = {}
        self.max_op: int = 0
        self.history: List[Change] = []
        self._history_index: Set[Tuple[str, int]] = set()
        self._pending: List[Change] = []
        self._inc_totals: Dict[OpId, float] = {}

    # ------------------------------------------------------------------
    # public api

    def apply_changes(self, changes: Iterable[Change]) -> Patch:
        """Apply remote/loaded changes in causal order; returns one Patch
        covering everything that became applicable."""
        diffs: List[Diff] = []
        for change in changes:
            self._enqueue(change, diffs)
        self._drain_pending(diffs)
        return self._patch(diffs)

    def apply_local_request(self, req: ChangeRequest) -> Tuple[Change, Patch]:
        """Resolve a frontend ChangeRequest into a fully-identified Change
        (assigning start_op, object ids, refs, preds — the writer-side half
        of Backend.applyLocalChange) and apply it."""
        expected = self.clock.get(req.actor, 0) + 1
        if req.seq != expected:
            raise ValueError(
                f"out-of-order local change: seq {req.seq} != {expected}"
            )
        start_op = self.max_op + 1
        deps = {a: s for a, s in self.clock.items() if a != req.actor}
        temp_map: Dict[str, OpId] = {}
        ops: List[Op] = []
        diffs: List[Diff] = []
        ctr = start_op
        for intent in req.intents:
            op = self._resolve_intent(intent, OpId(ctr, req.actor), temp_map)
            if op is None:
                continue  # unresolvable intent (e.g. index out of range)
            self._apply_op(OpId(ctr, req.actor), op, diffs)
            ops.append(op)
            ctr += 1
        change = Change(
            actor=req.actor,
            seq=req.seq,
            start_op=start_op,
            deps=deps,
            ops=tuple(ops),
            time=req.time,
            message=req.message,
        )
        self._commit(change)
        patch = self._patch(diffs, actor=req.actor, seq=req.seq)
        return change, patch

    def materialize(self) -> Any:
        """Full read of the document as plain Python values."""
        return self._materialize_obj(ROOT)

    def materialize_at(self, n_changes: int) -> Any:
        """Time travel: replay the first n history entries into a fresh
        OpSet (reference MaterializeMsg path, src/RepoBackend.ts:570-579)."""
        sub = OpSet()
        sub.apply_changes(self.history[:n_changes])
        return sub.materialize()

    def snapshot_patch(self) -> Patch:
        """A from-scratch patch reconstructing current state — used for
        DocReady messages to new frontends (reference ReadyMsg carries the
        init patch, src/DocBackend.ts:144-167)."""
        diffs: List[Diff] = []
        self._snapshot_obj(ROOT, diffs)
        return self._patch(diffs)

    def missing_deps(self) -> Dict[str, int]:
        """Smallest clock that would unblock pending changes."""
        need: Dict[str, int] = {}
        for change in self._pending:
            for actor, seq in change.deps.items():
                if self.clock.get(actor, 0) < seq:
                    need[actor] = max(need.get(actor, 0), seq)
            if self.clock.get(change.actor, 0) + 1 < change.seq:
                need[change.actor] = max(
                    need.get(change.actor, 0), change.seq - 1
                )
        return need

    def get_changes_since(self, clock: Dict[str, int]) -> List[Change]:
        return [
            c for c in self.history if c.seq > clock.get(c.actor, 0)
        ]

    # ------------------------------------------------------------------
    # intent resolution (writer side)

    def _resolve_intent(
        self, intent, opid: OpId, temp_map: Dict[str, OpId]
    ) -> Optional[Op]:
        return resolve_intent(
            intent, opid, temp_map, self.objects.get, self._live_elems
        )

    # ------------------------------------------------------------------
    # causal application

    def _enqueue(self, change: Change, diffs: List[Diff]) -> None:
        if (change.actor, change.seq) in self._history_index:
            return  # duplicate
        if self._applicable(change):
            self._apply_change(change, diffs)
        else:
            self._pending.append(change)

    def _drain_pending(self, diffs: List[Diff]) -> None:
        progressed = True
        while progressed and self._pending:
            progressed = False
            still: List[Change] = []
            for change in self._pending:
                if (change.actor, change.seq) in self._history_index:
                    progressed = True
                    continue
                if self._applicable(change):
                    self._apply_change(change, diffs)
                    progressed = True
                else:
                    still.append(change)
            self._pending = still

    def _applicable(self, change: Change) -> bool:
        if change.seq != self.clock.get(change.actor, 0) + 1:
            return False
        return all(
            self.clock.get(a, 0) >= s for a, s in change.deps.items()
        )

    def _apply_change(self, change: Change, diffs: List[Diff]) -> None:
        for i, op in enumerate(change.ops):
            self._apply_op(change.op_id(i), op, diffs)
        self._commit(change)

    def _commit(self, change: Change) -> None:
        self.clock[change.actor] = change.seq
        self.max_op = max(self.max_op, change.max_op)
        self.history.append(change)
        self._history_index.add((change.actor, change.seq))

    # ------------------------------------------------------------------
    # op application

    def _apply_op(self, opid: OpId, op: Op, diffs: List[Diff]) -> None:
        obj = self.objects.get(op.obj)
        if obj is None:
            return  # tolerate ops against unknown objects (corrupt feeds)
        if op.action.makes_object and opid not in self.objects:
            child_type = OBJ_TYPE_BY_MAKE[op.action]
            self.objects[opid] = _Obj(child_type)
            diffs.append(
                Diff(action="create", obj=str(opid), obj_type=child_type)
            )
        if obj.is_sequence:
            self._apply_seq_op(obj, opid, op, diffs)
        else:
            self._apply_map_op(obj, opid, op, diffs)

    def _apply_map_op(self, obj: _Obj, opid: OpId, op: Op, diffs) -> None:
        key = op.key
        if key is None:
            return
        visible = obj.fields.setdefault(key, {})
        had = bool(visible)
        if op.action == Action.INC:
            for p in op.pred:
                if p in visible:
                    self._inc_totals[p] = self._inc_totals.get(p, 0) + (
                        op.value or 0
                    )
        else:
            for p in op.pred:
                removed = visible.pop(p, None)
                if removed is not None:
                    self._inc_totals.pop(p, None)
            if op.action in (Action.SET,) or op.action.makes_object:
                visible[opid] = op
        self._emit_map_diff(obj, op.obj, key, visible, had, diffs)

    def _emit_map_diff(self, obj, obj_id, key, visible, had, diffs) -> None:
        if not visible:
            if had:
                diffs.append(
                    Diff(
                        action="remove",
                        obj=str(obj_id),
                        obj_type=obj.type,
                        key=key,
                    )
                )
            else:
                obj.fields.pop(key, None)
            return
        winner_id = max(visible)
        value, link, datatype = self._op_value(winner_id, visible[winner_id])
        conflicts = tuple(
            Conflict(str(oid), *self._op_value(oid, visible[oid]))
            for oid in sorted(visible, reverse=True)
            if oid != winner_id
        )
        diffs.append(
            Diff(
                action="set",
                obj=str(obj_id),
                obj_type=obj.type,
                key=key,
                value=value,
                link=link,
                datatype=datatype,
                conflicts=conflicts,
            )
        )

    def _apply_seq_op(self, obj: _Obj, opid: OpId, op: Op, diffs) -> None:
        if op.insert:
            # RGA insert-after with descending-OpId skip scan. Causal lamport
            # property guarantees any descendant of a skipped sibling also
            # has a larger OpId, so a flat forward scan is sufficient.
            if op.ref == HEAD:
                pos = 0
            else:
                try:
                    pos = obj.order.index(op.ref) + 1
                except ValueError:
                    return  # unknown predecessor (corrupt / out of order)
            while pos < len(obj.order) and obj.order[pos] > opid:
                pos += 1
            obj.order.insert(pos, opid)
            obj.fields[opid] = {opid: op}
            live_index = self._live_index(obj, opid)
            value, link, datatype = self._op_value(opid, op)
            diffs.append(
                Diff(
                    action="insert",
                    obj=str(op.obj),
                    obj_type=obj.type,
                    index=live_index,
                    elem_id=str(opid),
                    value=value,
                    link=link,
                    datatype=datatype,
                )
            )
            return
        elem = op.ref
        if elem is None or elem not in obj.fields:
            return
        visible = obj.fields[elem]
        had = bool(visible)
        if op.action == Action.INC:
            for p in op.pred:
                if p in visible:
                    self._inc_totals[p] = self._inc_totals.get(p, 0) + (
                        op.value or 0
                    )
        else:
            for p in op.pred:
                removed = visible.pop(p, None)
                if removed is not None:
                    self._inc_totals.pop(p, None)
            if op.action in (Action.SET,) or op.action.makes_object:
                visible[opid] = op
        # emit diff with live index (computed before tombstone collapse)
        if visible:
            live_index = self._live_index(obj, elem)
            winner_id = max(visible)
            value, link, datatype = self._op_value(winner_id, visible[winner_id])
            conflicts = tuple(
                Conflict(str(oid), *self._op_value(oid, visible[oid]))
                for oid in sorted(visible, reverse=True)
                if oid != winner_id
            )
            diffs.append(
                Diff(
                    # a tombstoned element coming back to life (concurrent
                    # set vs delete) is an *insert* from the frontend's
                    # point of view — it removed the elem already
                    action="set" if had else "insert",
                    obj=str(op.obj),
                    obj_type=obj.type,
                    index=live_index,
                    elem_id=str(elem),
                    value=value,
                    link=link,
                    datatype=datatype,
                    conflicts=conflicts,
                )
            )
        elif had:
            live_index = self._live_index_before_removal(obj, elem)
            diffs.append(
                Diff(
                    action="remove",
                    obj=str(op.obj),
                    obj_type=obj.type,
                    index=live_index,
                    elem_id=str(elem),
                )
            )

    # ------------------------------------------------------------------
    # reads

    def _op_value(self, opid: OpId, op: Op):
        """-> (value, link, datatype) for a visible value op."""
        if op.action.makes_object:
            return str(opid), True, None
        if op.datatype == "counter":
            base = op.value or 0
            return base + self._inc_totals.get(opid, 0), False, "counter"
        return op.value, False, op.datatype

    def _live_elems(self, obj: _Obj) -> List[OpId]:
        return [e for e in obj.order if obj.fields.get(e)]

    def _live_index(self, obj: _Obj, elem: OpId) -> int:
        idx = 0
        for e in obj.order:
            if e == elem:
                return idx
            if obj.fields.get(e):
                idx += 1
        return idx

    def _live_index_before_removal(self, obj: _Obj, elem: OpId) -> int:
        # elem just became a tombstone; its live index is the count of live
        # elems before it
        return self._live_index(obj, elem)

    def _materialize_obj(self, obj_id: OpId) -> Any:
        obj = self.objects[obj_id]
        if obj.is_sequence:
            values = []
            for elem in obj.order:
                visible = obj.fields.get(elem)
                if not visible:
                    continue
                winner = max(visible)
                values.append(self._materialize_value(winner, visible[winner]))
            if obj.type == "text":
                return Text([str(v) for v in values])
            return values
        data = {}
        for key, visible in obj.fields.items():
            if not visible:
                continue
            winner = max(visible)
            data[key] = self._materialize_value(winner, visible[winner])
        if obj.type == "table":
            return Table(data)
        return data

    def _materialize_value(self, opid: OpId, op: Op) -> Any:
        if op.action.makes_object:
            return self._materialize_obj(opid)
        value, _, datatype = self._op_value(opid, op)
        if datatype == "counter":
            return Counter(value)
        return value

    def _snapshot_obj(self, obj_id: OpId, diffs: List[Diff]) -> None:
        obj = self.objects[obj_id]
        if obj_id != ROOT:
            diffs.append(
                Diff(action="create", obj=str(obj_id), obj_type=obj.type)
            )
        if obj.is_sequence:
            index = 0
            for elem in obj.order:
                visible = obj.fields.get(elem)
                if not visible:
                    continue
                winner = max(visible)
                op = visible[winner]
                if op.action.makes_object:
                    self._snapshot_obj(winner, diffs)
                value, link, datatype = self._op_value(winner, op)
                conflicts = tuple(
                    Conflict(str(oid), *self._op_value(oid, visible[oid]))
                    for oid in sorted(visible, reverse=True)
                    if oid != winner
                )
                diffs.append(
                    Diff(
                        action="insert",
                        obj=str(obj_id),
                        obj_type=obj.type,
                        index=index,
                        elem_id=str(elem),
                        value=value,
                        link=link,
                        datatype=datatype,
                        conflicts=conflicts,
                    )
                )
                index += 1
        else:
            for key in sorted(obj.fields):
                visible = obj.fields[key]
                if not visible:
                    continue
                winner = max(visible)
                op = visible[winner]
                if op.action.makes_object:
                    self._snapshot_obj(winner, diffs)
                value, link, datatype = self._op_value(winner, op)
                conflicts = tuple(
                    Conflict(str(oid), *self._op_value(oid, visible[oid]))
                    for oid in sorted(visible, reverse=True)
                    if oid != winner
                )
                diffs.append(
                    Diff(
                        action="set",
                        obj=str(obj_id),
                        obj_type=obj.type,
                        key=key,
                        value=value,
                        link=link,
                        datatype=datatype,
                        conflicts=conflicts,
                    )
                )

    def _patch(self, diffs, actor=None, seq=None) -> Patch:
        return Patch(
            clock=dict(self.clock),
            deps=dict(self.clock),
            max_op=self.max_op,
            diffs=tuple(diffs),
            actor=actor,
            seq=seq,
        )
