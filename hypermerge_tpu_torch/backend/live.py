"""Live apply engine — incremental changes as per-tick device batches
(the port's copy of hypermerge_tpu/backend/live.py).

A bulk-loaded doc would otherwise pay a FULL host replay of its history
the moment one live edit arrives (DocBackend._ensure_opset). This
module routes the live path through the same batching argument the
cold open already won: each hot doc's packed columnar op history stays
cached host-side (ops/columnar.py LiveColumns — appendable, no feed IO,
no repack), and a short tick coalesces all dirty docs' newly arrived
changes into ONE padded, shape-bucketed kernel dispatch
(ops/crdt_kernels.py materialize_live_device: the CUDA kernel
kernels/csrc/doc_kernel.cu on the backend's GPU, its plain PyTorch
version on a CPU backend), or its numpy twin below the device-min-cells
threshold (HM_DEVICE_MIN_CELLS — the reference's host/device cutover,
not a fallback: a tick over it launches the kernel or raises). A burst
of N edits across M docs costs O(ticks) kernel launches, not O(N)
Python replays.

Adoption (a bulk-loaded doc going hot) is lock-free: the O(doc) build
(pack from sidecars on the host, exact-size numpy kernel, lane-driven
vectorized decode, winner-lane reachability) runs WITHOUT the engine
lock — other hot docs keep ticking — and installs under it with a
recheck (opset still None, serving clock unmoved, doc still open).

The engine lock is tick/dirty-set COORDINATION only. Emission ordering
is PER DOC: every {compute patch -> feed append -> push} pair holds its
own doc's `doc.emit` emission domain (backend/emission.py) and nothing
else ordered. The tick resolves each dirty doc with a GIL-atomic table
snapshot and takes ONE domain at a time; catch-up kernel groups batch
ACROSS docs with no locks held (the per-doc install-and-recheck
discards a result the doc outran). The tick runs on the debouncer's
thread: the kernel launches on the backend's device (the wrapper enters
it) and the lanes come back in one synchronizing copy.
HM_LIVE_MAX_BYTES byte-bounds resident LiveColumns: least-recently-
ticked idle docs demote back to the lazy path after a tick and
re-adopt from the sidecars on their next live change (demotion
refuses docs whose state the sidecars cannot rebuild).

Twin semantics (HM_LIVE=0 keeps the host-OpSet path):
- causal admission (seq continuity + deps) mirrors OpSet's pending set
  change-for-change, so clocks are bit-identical;
- local changes resolve intents against the engine's decoded state and
  emit patches bit-identical to OpSet.apply_local_request (a local op
  always wins: its lamport counter is the doc maximum);
- remote changes surface as ONE state-delta patch per tick per doc —
  the same final frontend state as the host path's per-window patches
  (per-op intermediate diffs are coalesced away), pinned by the fuzz
  twin test (tests/test_torch_live.py);
- snapshot patches (Ready, reopen) diff the decoded state against an
  empty doc and are bit-identical to OpSet.snapshot_patch.

Host OpSet reconstruction remains only behind the explicit history /
time-travel APIs (DocBackend.materialize_at / history_patch).
"""

from __future__ import annotations

import gc
import os
import threading
import time
from contextlib import contextmanager
from itertools import repeat
from typing import Any, Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from ..analysis.lockdep import make_lock, make_rlock
from ..crdt.change import (
    HEAD,
    OBJ_TYPE_BY_MAKE,
    ROOT,
    Action,
    Change,
    ChangeRequest,
    Op,
    OpId,
)
from ..crdt.patch import Conflict, Diff, Patch
from ..ops.columnar import LiveColumns
from ..utils.debounce import Debouncer
from ..utils.debug import log
from .. import telemetry

ROOT_ID = "0@_root"

# engine stats series (telemetry registry, labeled per engine). The
# key lists drive both the handle table and the `stats` property, so
# the dict shape stays the reference's: event counts first, then the
# resident gauges, then seconds.
_LIVE_COUNTS = (
    "adopted", "refused", "ticks", "tick_docs", "tick_changes",
    "inc_changes", "kernel_runs", "device_dispatches",
    "local_changes", "adopt_retries", "demoted", "readopted",
)
_LIVE_GAUGES = ("live_bytes", "live_docs")
_LIVE_TIMES = (
    "t_live_append", "t_live_apply", "t_live_kernel",
    "t_live_decode", "t_live_diff",
    "t_adopt_pack", "t_adopt_kernel", "t_adopt_decode",
    "t_adopt_reach", "t_adopt_lock_free", "t_adopt_lock_held",
)


def _tick_window_s() -> float:
    return float(os.environ.get("HM_LIVE_TICK_MS", "2")) / 1e3


def _tick_window_max_s() -> float:
    return float(os.environ.get("HM_LIVE_TICK_MAX_MS", "25")) / 1e3


def _device_min_cells() -> int:
    return int(os.environ.get("HM_DEVICE_MIN_CELLS", "131072"))


def _inc_budget_cells() -> int:
    """Incremental-vs-kernel crossover for one doc's tick: apply
    directly when tick_ops x doc_rows stays under this (the per-op
    live-index scans cost O(rows); the kernel's vectorized rebuild has
    a fixed overhead that only amortizes on big catch-ups)."""
    return int(os.environ.get("HM_LIVE_INC_BUDGET", "2000000"))


# ---------------------------------------------------------------------------
# decoded doc state (OpId space — stable across repacks/ticks)


class _Val(NamedTuple):
    """One visible value op at a location. A NamedTuple: the decode
    builds one per visible row (hundreds of thousands on adoption) and
    tuple construction runs in C — same argument as OpId."""

    base: Any
    link: bool
    datatype: Any


class _Obj:
    __slots__ = ("type", "fields", "order")

    def __init__(self, type_: str) -> None:
        self.type = type_
        # map/table: key -> {OpId: _Val}; list/text: elem OpId -> {...}
        # (an elem whose dict is empty is a TOMBSTONE — it stays in
        # `order` and `fields`, exactly like OpSet, because remote RGA
        # inserts may reference it and the skip-scan walks it)
        self.fields: Dict[Any, Dict[OpId, _Val]] = {}
        self.order: List[OpId] = []  # ALL elems in RGA order

    @property
    def is_sequence(self) -> bool:
        return self.type in ("list", "text")

    def live(self) -> List[OpId]:
        return [e for e in self.order if self.fields.get(e)]


class _DocState:
    __slots__ = ("objs", "inc", "reachable")

    def __init__(self) -> None:
        self.objs: Dict[OpId, _Obj] = {ROOT: _Obj("map")}
        self.inc: Dict[OpId, int] = {}
        # objects whose CURRENT contents the frontend holds (emitted as
        # winner links). An object re-attached after mutating while
        # detached re-emits create + full contents (create resets the
        # frontend's copy), keeping frontends self-healing.
        self.reachable: Set[OpId] = set()


def _op_value(state: _DocState, opid: OpId, val: _Val):
    """(display value, link, datatype) — OpSet._op_value twin."""
    if val.link:
        return str(opid), True, None
    if val.datatype == "counter":
        base = val.base or 0
        return base + state.inc.get(opid, 0), False, "counter"
    return val.base, False, val.datatype


def _conflicts(state: _DocState, cell: Dict[OpId, _Val], winner: OpId):
    return tuple(
        Conflict(str(oid), *_op_value(state, oid, cell[oid]))
        for oid in sorted(cell, reverse=True)
        if oid != winner
    )


def _display(state: _DocState, cell: Dict[OpId, _Val]):
    """(winner, value, link, datatype, conflicts) for a visible set."""
    winner = max(cell)
    value, link, datatype = _op_value(state, winner, cell[winner])
    return winner, value, link, datatype, _conflicts(state, cell, winner)


# ---------------------------------------------------------------------------
# state decode from kernel lanes

_DT_NAME = (None, "counter", "timestamp")
_OBJ_TYPE_BY_CODE = tuple(
    OBJ_TYPE_BY_MAKE[Action(a)] for a in range(4)
)


def _decode_state(lv: LiveColumns, lanes) -> _DocState:
    """Rebuild the decoded doc state from one kernel run over `lv`'s
    rows (visible/elem_live/rank/inc_total lanes, [n]).

    Lane-driven: np.nonzero/lexsort batch passes plus the vectorized
    value decode (`LiveColumns.decode_values`) replace the old per-row
    Python loops — one _Val is pre-built per visible row (each row
    contributes to exactly one cell), containers resolve through a
    memo, and element order lands as one run-sliced list per container
    instead of an append per row. Bit-identical to OpSet's state
    (pinned in tests/test_torch_live.py)."""
    n = lv.n
    state = _DocState()
    if n == 0:
        return state
    c = lv.cols
    action = c["action"][:n]
    opids = lv.opids
    obj_col = c["obj"][:n]
    key_col = c["key"][:n]
    ref_col = c["ref"][:n]
    insert_col = c["insert"][:n]
    dt_col = c["dt"][:n]
    visible = np.asarray(lanes.visible[:n]).astype(bool, copy=False)
    rank = lanes.rank[:n]
    inc_total = lanes.inc_total[:n]

    # objects (dead MAKEs included — OpSet retains them)
    objs = state.objs
    make_rows = np.nonzero(action <= 3)[0]
    if len(make_rows):
        types = _OBJ_TYPE_BY_CODE
        for r, a in zip(
            make_rows.tolist(), action[make_rows].tolist()
        ):
            objs[opids[r]] = _Obj(types[a])

    inc_rows = np.nonzero(inc_total != 0)[0]
    if len(inc_rows):
        state.inc = dict(
            zip(
                [opids[r] for r in inc_rows.tolist()],
                inc_total[inc_rows].tolist(),
            )
        )

    # full element order FIRST (descending rank within each container,
    # tombstones INCLUDED — OpSet keeps dead elems in `order`: remote
    # RGA inserts reference them and the skip-scan walks them), with
    # the per-elem cell dicts prefilled so the visible-row pass below
    # assigns straight into them. lexsort is stable, so within a
    # container ties keep row order — the same sequence the global
    # stable -rank argsort + per-row append produced.
    ins_rows = np.nonzero(insert_col == 1)[0]
    if len(ins_rows):
        o_ins = obj_col[ins_rows]
        order = np.lexsort((-rank[ins_rows], o_ins))
        sorted_rows = ins_rows[order].tolist()
        o_sorted = o_ins[order]
        bounds = np.nonzero(o_sorted[1:] != o_sorted[:-1])[0] + 1
        starts = np.concatenate(([0], bounds)).tolist()
        ends = np.concatenate((bounds, [len(sorted_rows)])).tolist()
        o_list = o_sorted.tolist()
        for s, e in zip(starts, ends):
            o = o_list[s]
            obj = objs[ROOT] if o < 0 else objs[opids[o]]
            elems = [opids[r] for r in sorted_rows[s:e]]
            obj.order = elems
            fields = obj.fields
            if fields:
                for el in elems:
                    if el not in fields:
                        fields[el] = {}
            else:
                obj.fields = {el: {} for el in elems}

    vis_rows = np.nonzero(visible)[0]
    if len(vis_rows):
        # one _Val per visible row, built in a single batch pass (each
        # row contributes to exactly one cell)
        bases = lv.decode_values(vis_rows)
        dts = dt_col[vis_rows]
        link_rows = np.nonzero(action[vis_rows] <= 3)[0]
        if dts.any() or len(link_rows):
            dt_name = _DT_NAME
            vals = list(
                map(
                    _Val._make,
                    zip(
                        bases,
                        repeat(False),
                        map(dt_name.__getitem__, dts.tolist()),
                    ),
                )
            )
            link_val = _Val(None, True, None)
            for j in link_rows.tolist():
                vals[j] = link_val
        else:  # no datatypes, no links: the dominant value shape
            vals = list(
                map(_Val._make, zip(bases, repeat(False), repeat(None)))
            )
        # container per visible row (memoized: rows repeat containers)
        root_obj = objs[ROOT]
        cont_of: Dict[int, _Obj] = {}
        conts: List[_Obj] = []
        ap = conts.append
        for o in obj_col[vis_rows].tolist():
            co = cont_of.get(o)
            if co is None:
                co = root_obj if o < 0 else objs[opids[o]]
                cont_of[o] = co
            ap(co)

        vr = vis_rows.tolist()
        kv = key_col[vis_rows]
        iv = insert_col[vis_rows]
        rv = ref_col[vis_rows]
        kvl = kv.tolist()
        rvl = rv.tolist()
        # map cells: visible ops with a key, grouped by (container, key)
        keys_items = lv.keys.items
        for j in np.nonzero(kv >= 0)[0].tolist():
            conts[j].fields.setdefault(keys_items[kvl[j]], {})[
                opids[vr[j]]
            ] = vals[j]
        # element cells: own insert values (their cell dicts exist —
        # every insert row is in its container's prefilled order) +
        # non-insert elem updates
        for j in np.nonzero(iv == 1)[0].tolist():
            e = opids[vr[j]]
            conts[j].fields[e][e] = vals[j]
        for j in np.nonzero(
            (iv == 0) & (kv < 0) & (rv >= 0)
        )[0].tolist():
            conts[j].fields.setdefault(opids[rvl[j]], {})[
                opids[vr[j]]
            ] = vals[j]
    return state


_gc_pause_lock = make_lock("live.gc")
_gc_pause_depth = 0
_gc_pause_was_on = False


@contextmanager
def _gc_paused():
    """Pause the cyclic GC across a bulk decode: building a doc's
    state allocates O(rows) small objects (_Vals, cell dicts) and the
    gen0 scans those allocations trigger were ~half the decode wall
    time. Depth-counted so concurrent lock-free adoption builds nest;
    never re-enables a GC the application had off."""
    global _gc_pause_depth, _gc_pause_was_on
    with _gc_pause_lock:
        _gc_pause_depth += 1
        if _gc_pause_depth == 1:
            _gc_pause_was_on = gc.isenabled()
            gc.disable()
    try:
        yield
    finally:
        with _gc_pause_lock:
            _gc_pause_depth -= 1
            if _gc_pause_depth == 0 and _gc_pause_was_on:
                gc.enable()


def _reachable_from_lanes(lv: LiveColumns, out) -> Set[OpId]:
    """Winner-link closure from ROOT, straight from the kernel's
    map_winner/elem_winner lanes (adoption has the host kernel's full
    lane set in hand): a MAKE row that wins its cell is a link edge
    container->child, every row wins at most one cell, so the edges
    form a forest walked in O(makes). Bit-identical to
    _compute_reachable's state walk."""
    n = lv.n
    if n == 0:
        return {ROOT}
    action = lv.cols["action"][:n]
    winner = (
        np.asarray(out.map_winner)[:n]
        | np.asarray(out.elem_winner)[:n]
    )
    link_rows = np.nonzero(winner & (action <= 3))[0]
    children: Dict[int, List[int]] = {}
    obj_col = lv.cols["obj"][:n]
    for r, p in zip(link_rows.tolist(), obj_col[link_rows].tolist()):
        children.setdefault(p, []).append(r)
    seen: Set[int] = set()
    stack = [-1]  # obj sentinel for ROOT
    while stack:
        for r in children.get(stack.pop(), ()):
            if r not in seen:
                seen.add(r)
                stack.append(r)
    opids = lv.opids
    reach = {opids[r] for r in seen}
    reach.add(ROOT)
    return reach


def _compute_reachable(state: _DocState) -> None:
    """Set `state.reachable` to the winner-link closure from ROOT —
    exactly the set `_diff_states(_DocState(), state)` would record,
    without building any Diff/Conflict objects (the adoption path only
    needs the baseline reachability; the full snapshot diff walk was
    the single biggest adoption cost)."""
    objs = state.objs
    reach: Set[OpId] = {ROOT}
    stack: List[OpId] = [ROOT]
    while stack:
        obj = objs[stack.pop()]
        if obj.is_sequence:
            fields = obj.fields
            cells = [
                c_ for c_ in (fields.get(e) for e in obj.order) if c_
            ]
        else:
            cells = [c_ for c_ in obj.fields.values() if c_]
        for cell in cells:
            winner = max(cell)
            if (
                cell[winner].link
                and winner not in reach
                and winner in objs
            ):
                reach.add(winner)
                stack.append(winner)
    state.reachable = reach


# ---------------------------------------------------------------------------
# state diffing (delta patches + snapshots)


def _diff_states(old: _DocState, new: _DocState) -> List[Diff]:
    """Diffs transforming a frontend at `old` into `new`, walking the
    reachable object graph exactly as OpSet._snapshot_obj does (so a
    diff against the empty state is bit-identical to snapshot_patch).
    Updates new.reachable as a side effect."""
    diffs: List[Diff] = []
    new.reachable = set()
    visited: Set[OpId] = set()

    def emit_obj(opid: OpId, fresh: bool) -> None:
        if opid in visited:
            return
        visited.add(opid)
        new.reachable.add(opid)
        obj = new.objs[opid]
        oid = ROOT_ID if opid == ROOT else str(opid)
        old_obj = None
        if not fresh:
            old_obj = old.objs.get(opid)
        if obj.is_sequence:
            _emit_seq(opid, oid, obj, old_obj, fresh)
        else:
            _emit_map(oid, obj, old_obj, fresh)

    def recurse_link(winner: OpId, link: bool) -> None:
        if not link:
            return
        if winner in old.reachable and winner in old.objs:
            emit_obj(winner, fresh=False)
        else:
            obj = new.objs[winner]
            diffs.append(
                Diff(action="create", obj=str(winner), obj_type=obj.type)
            )
            emit_obj(winner, fresh=True)

    def _emit_map(oid, obj, old_obj, fresh) -> None:
        old_fields = old_obj.fields if old_obj is not None else {}
        for key in sorted(set(obj.fields) | set(old_fields)):
            cell = obj.fields.get(key)
            if not cell:
                if old_fields.get(key):
                    diffs.append(
                        Diff(
                            action="remove",
                            obj=oid,
                            obj_type=obj.type,
                            key=key,
                        )
                    )
                continue
            winner, value, link, datatype, conflicts = _display(new, cell)
            changed = True
            old_cell = old_fields.get(key)
            if not fresh and old_cell:
                changed = _display(old, old_cell)[1:] != (
                    value, link, datatype, conflicts
                )
            recurse_link(winner, link)
            if changed:
                diffs.append(
                    Diff(
                        action="set",
                        obj=oid,
                        obj_type=obj.type,
                        key=key,
                        value=value,
                        link=link,
                        datatype=datatype,
                        conflicts=conflicts,
                    )
                )

    def _emit_seq(opid, oid, obj, old_obj, fresh) -> None:
        old_live = old_obj.live() if old_obj is not None else []
        new_live = obj.live()
        new_set = set(new_live)
        old_set = set(old_live)
        kept = 0
        for e in old_live:
            if e in new_set:
                kept += 1
            else:
                diffs.append(
                    Diff(
                        action="remove",
                        obj=oid,
                        obj_type=obj.type,
                        index=kept,
                        elem_id=str(e),
                    )
                )
        for j, e in enumerate(new_live):
            cell = obj.fields[e]
            winner, value, link, datatype, conflicts = _display(new, cell)
            is_new = fresh or e not in old_set
            changed = True
            if not is_new:
                old_cell = (
                    old_obj.fields.get(e) if old_obj is not None else None
                )
                changed = not old_cell or _display(old, old_cell)[1:] != (
                    value, link, datatype, conflicts
                )
            recurse_link(winner, link)
            if is_new:
                diffs.append(
                    Diff(
                        action="insert",
                        obj=oid,
                        obj_type=obj.type,
                        index=j,
                        elem_id=str(e),
                        value=value,
                        link=link,
                        datatype=datatype,
                        conflicts=conflicts,
                    )
                )
            elif changed:
                diffs.append(
                    Diff(
                        action="set",
                        obj=oid,
                        obj_type=obj.type,
                        index=j,
                        elem_id=str(e),
                        value=value,
                        link=link,
                        datatype=datatype,
                        conflicts=conflicts,
                    )
                )

    emit_obj(ROOT, fresh=False)
    # objects the frontend still holds that are now DETACHED: the host
    # path streams their mutations too (FrontendDoc retains detached
    # objects and applies diffs addressed to them), so a later
    # re-attach links a CURRENT copy — dropping them here would leave
    # the frontend's copy stale and diverge from the HM_LIVE=0 twin.
    # Keeping them in new.reachable keeps successive ticks streaming.
    for opid in sorted(old.reachable):
        if opid in visited or opid not in new.objs or opid not in old.objs:
            continue
        emit_obj(opid, fresh=False)
    return diffs


# ---------------------------------------------------------------------------
# per-doc live state


class _LiveDoc:
    # every field is guarded by the doc's emission domain (doc.emit)

    def __init__(self, doc, cols, state, clock, max_op, history_len):
        self.doc = doc
        self.cols: LiveColumns = cols
        self.state: _DocState = state
        self.clock: Dict[str, int] = clock
        self.max_op: int = max_op
        self.history_len: int = history_len
        self.pending: Dict[Tuple[str, int], Change] = {}
        self.queued: List[Change] = []
        # rows appended to `cols` but not yet decoded into `state`
        # (tick phase 1 defers big catch-ups to the shared batched
        # kernel; any reader under the domain catches up first)
        self.undecoded: bool = False
        self.tick_rows: int = 0  # phase-3 install-and-recheck token
        self.last_use: int = 0  # engine use-clock (LRU demotion order)
        # demotability memo: (serving clock at last check, verdict) —
        # the sidecar serveability scan costs IO under the emission
        # domain, so it runs at most once per clock value
        self.demotable_at: Optional[Tuple[Dict[str, int], bool]] = None

    def resident_bytes(self) -> int:
        """Host bytes this hot doc pins: the packed columns plus an
        estimate of the decoded state (~one _Val + dict slot per
        row)."""
        return self.cols.nbytes + self.cols.n * 120


class _AdoptGate:
    """In-flight adoption marker: the adopting thread constructs the
    doc's live state OUTSIDE the engine lock; other threads submitting
    changes for the same doc wait on `event` instead of replaying the
    doc host-side (and instead of serializing behind the engine lock,
    which stays free for other docs' ticks)."""

    __slots__ = ("thread", "event", "outcome")

    def __init__(self) -> None:
        self.thread = threading.current_thread()
        self.event = threading.Event()
        self.outcome = "refused"


def _live_max_bytes() -> int:
    """HM_LIVE_MAX_BYTES: resident-bytes cap across all adopted docs'
    LiveColumns (0 / unset = unbounded). Read per enforcement pass so
    tests and operators can adjust it live."""
    return int(os.environ.get("HM_LIVE_MAX_BYTES", "0"))


class LiveApplyEngine:
    """Dirty set + tick loop + shape-bucketed batch dispatch over the
    live docs' cached columns. One engine per RepoBackend."""

    def __init__(self, backend) -> None:
        self._back = backend
        self._lock = make_rlock("live.engine")
        # `live.engine` — tick/dirty-set COORDINATION only since the
        # write-plane split: the doc table and adoption/demotion
        # bookkeeping mutate under it, and it is NEVER held across a
        # feed append, fsync, or frontend push (those run under the
        # per-doc emission domains, backend/emission.py, which rank
        # ABOVE it). Nothing blocks under it.
        self._docs: Dict[str, _LiveDoc] = {}
        self._refused: Set[str] = set()  # adoption failed: host path
        # in-flight adoptions (doc_id -> gate). Builds run OUTSIDE the
        # engine lock; the gate both blocks same-doc submitters and
        # guards the recursive window (opening a cursor actor during
        # adoption can replay a window back into the same doc on the
        # adopting thread before its _LiveDoc is registered).
        self._adopting: Dict[str, _AdoptGate] = {}
        self._demoted_ids: Set[str] = set()  # for the readopted stat
        self._use_clock = 0  # monotone LRU counter — guarded by
        # live.engine like every field of this class
        # stats live on the PROCESS telemetry registry: one labeled
        # series per engine so concurrent repos stay exact, per-thread
        # sharded adds so no bump needs the engine lock, and the
        # `stats` property rebuilds the dict shape callers read.
        inst = str(telemetry.next_instance())
        reg = telemetry.REGISTRY
        self._m: Dict[str, Any] = {
            k: reg.counter("live." + k, inst=inst)
            for k in _LIVE_COUNTS + _LIVE_TIMES
        }
        for k in _LIVE_GAUGES:
            self._m[k] = reg.gauge("live." + k, inst=inst)
        self._ticker = Debouncer(
            self._on_tick,
            window_s=_tick_window_s(),
            max_window_s=_tick_window_max_s(),
            name="live-tick",
            # work-conserving: under a sustained stream the next tick
            # starts the moment the previous one ends (its duration IS
            # the coalescing window); the 2ms window only pads the
            # leading edge of a burst
            eager=True,
        )

    @property
    def stats(self) -> Dict[str, Any]:
        """The engine's stats as the historical dict (registry-backed;
        read-only — a write to the returned dict mutates a copy)."""
        m = self._m
        out: Dict[str, Any] = {}
        for k in _LIVE_COUNTS:
            out[k] = int(m[k].value())
        for k in _LIVE_GAUGES:
            out[k] = int(m[k].value())
        for k in _LIVE_TIMES:
            out[k] = round(m[k].value(), 6)
        return out

    # ------------------------------------------------------------------
    # seams (called by DocBackend)

    def submit_remote(self, doc, changes: List[Change]) -> bool:
        """Admit + queue remote changes for the next tick. False when
        the doc cannot be live-managed (caller takes the host path).
        Adoption (if needed) builds outside every ordered lock."""
        while True:
            if self._ensure_doc(doc) is None:
                return False
            with doc.emission:
                with self._lock:
                    if self._docs.get(doc.id) is None:
                        continue  # demoted in the gap: re-adopt
                    ld = self._docs[doc.id]
                    ld.last_use = self._bump_use()
                if self._admit(ld, changes):
                    self._sync_doc_meta(ld)
                    self._ticker.mark(doc.id)
                break
        doc._check_ready()
        return True

    def apply_local(
        self, doc, req: ChangeRequest, emit=None
    ) -> Optional[Tuple[Change, Patch]]:
        """Resolve + apply a local change against the live state
        (OpSet.apply_local_request twin). None when the doc cannot be
        live-managed; raises ValueError on an out-of-order seq.

        `emit(change, patch)` runs while the doc's EMISSION DOMAIN is
        still held: the patch's diffs are relative to the state just
        before this change, so its push (feed append included) must
        reach the frontend queue before any tick emits a delta on the
        post-change state. Only THIS doc's domain is held — disjoint
        docs' local changes run concurrently."""
        while True:
            if self._ensure_doc(doc) is None:
                return None
            with doc.emission:
                with self._lock:
                    ld = self._docs.get(doc.id)
                    if ld is None:
                        continue  # demoted in the gap: re-adopt
                    ld.last_use = self._bump_use()
                # pending admitted remotes apply (and notify) first, so
                # the local resolution sees the same state the host
                # path would. The catch-up may evict the doc to the
                # host path (range overflow) — the caller retries
                # host-side.
                if not self._catch_up_locked(ld):
                    return None
                expected = ld.clock.get(req.actor, 0) + 1
                if req.seq != expected:
                    raise ValueError(
                        f"out-of-order local change: seq {req.seq} != "
                        f"{expected}"
                    )
                change, patch = self._apply_local_locked(ld, req)
                self._sync_doc_meta(ld)
                self._m["local_changes"].add(1)
                if emit is not None:
                    emit(change, patch)
            return change, patch

    def snapshot_patch(self, doc) -> Optional[Patch]:
        """From-scratch patch of the live state (OpSet.snapshot_patch
        twin — served for Ready / reopen on adopted docs). Holding the
        doc's emission domain across {snapshot -> push} is the Ready
        atomicity contract: no tick can slip a newer delta ahead of
        the Ready in the frontend queue, because every tick emission
        of this doc needs this same domain."""
        with doc.emission:
            ld = self._docs.get(doc.id)
            if ld is None:
                return None
            if not self._catch_up_locked(ld):
                return None  # evicted to the host path mid-flush
            # diff against an empty doc WITHOUT touching the tracked
            # reachability (this is a read, not an emission to the
            # incremental patch stream)
            saved = ld.state.reachable
            diffs = _diff_states(_DocState(), ld.state)
            ld.state.reachable = saved
            return Patch(
                clock=dict(ld.clock),
                deps=dict(ld.clock),
                max_op=ld.max_op,
                diffs=tuple(diffs),
            )

    def drop(self, doc_id: str) -> None:
        """Forget a doc's live state (close/destroy)."""
        with self._lock:
            self._docs.pop(doc_id, None)
            self._refused.discard(doc_id)
            self._demoted_ids.discard(doc_id)

    def flush_now(self, timeout: float = 5.0) -> bool:
        return self._ticker.flush_now(timeout)

    def close(self) -> None:
        self._ticker.close()
        # fold this engine's labeled series into the closed aggregate:
        # repos open/close freely without growing the registry a label
        # set per lifecycle (stats stays readable — it is handle-based)
        telemetry.REGISTRY.retire(*self._m.values())

    # ------------------------------------------------------------------
    # adoption (lock-free build + install-and-recheck)

    def _bump_use(self) -> int:
        """Next LRU use-clock value. REQUIRES live.engine
        — callers hold the engine lock."""
        self._use_clock += 1
        return self._use_clock

    def _ensure_doc(self, doc) -> Optional[_LiveDoc]:
        """The doc's live state, adopting it if needed. MUST be called
        WITHOUT the engine lock held: the adoption build (pack + kernel
        + decode, O(doc)) runs lock-FREE so other hot docs keep ticking
        through the window, then installs under the lock with a recheck
        (opset still None, serving clock unmoved, doc still open). The
        emission-ordering invariant holds because the build never
        computes or pushes a patch — only the install takes the
        engine lock, and every emission takes the doc's domain.
        Returns None for the host path (refused, recursive adoption
        window, engine-lock re-entry, or doc closed)."""
        # a thread that already HOLDS the engine lock must neither
        # build here (an O(doc) build under the coordination lock
        # stalls every tick) nor wait on another thread's gate (that
        # adopting thread needs this lock to install/finish — waiting with it
        # held deadlocks the engine). Host path instead, the same
        # answer as the recursive-window case below. Holding this
        # doc's own EMISSION DOMAIN is fine: the adopting thread never takes
        # another doc's domain.
        held = getattr(self._lock, "_is_owned", lambda: False)()
        while True:
            with self._lock:
                ld = self._docs.get(doc.id)
                if ld is not None:
                    return ld
                if doc.id in self._refused:
                    return None
                if held:
                    return None
                gate = self._adopting.get(doc.id)
                if gate is None:
                    gate = self._adopting[doc.id] = _AdoptGate()
                elif gate.thread is threading.current_thread():
                    # recursive window during our own build (opening a
                    # cursor actor can replay into this doc): host path
                    return None
            if gate.thread is threading.current_thread():
                break  # we are the adopting thread
            gate.event.wait()
            if gate.outcome == "dropped":
                return None  # doc closed mid-build
            # else loop: reads installed/refused state (or re-adopts
            # if a demotion raced the install)

        outcome = "refused"
        ld = None
        now = time.perf_counter
        t0 = now()
        held0 = self._m["t_adopt_lock_held"].value()
        sp = telemetry.begin("live.adopt", cat="live")
        try:
            for _attempt in range(3):
                built = self._adopt_build(doc)
                if built is None:
                    break
                status, ld = self._install_adoption(doc, *built)
                if status == "retry":
                    # serving clock moved during the build (a host-path
                    # emission raced in): discard and rebuild
                    self._m["adopt_retries"].add(1)
                    continue
                outcome = status
                break
        finally:
            sp.end(outcome=outcome)
            with self._lock:
                self._adopting.pop(doc.id, None)
                gate.outcome = outcome
                if outcome == "refused":
                    self._refused.add(doc.id)
                    self._m["refused"].add(1)
                    # doc._live stays SET (harmless): the host path is
                    # still taken — the opset the fallback installs
                    # short-circuits the live branch, and _refused
                    # rejects re-adoption. Emission ordering is the
                    # doc's own domain either way.
                # the install window is lock-HELD: keep the two stats
                # disjoint so lock_free + lock_held = build wall
                self._m["t_adopt_lock_free"].add(
                    (now() - t0)
                    - (self._m["t_adopt_lock_held"].value() - held0)
                )
            gate.event.set()
        return ld if outcome == "ok" else None

    def _adopt_build(self, doc) -> Optional[Tuple[_LiveDoc, Dict]]:
        """Build a doc's cached columns + decoded state from its feed
        sidecars at its SERVING clock — no host OpSet replay, and NO
        engine lock. Returns (_LiveDoc, clock) ready for the install
        recheck, or None to refuse (missing/short/non-contiguous feed,
        kernel range overflow, or a host OpSet already appeared)."""
        from ..ops.columnar import pack_docs_columns

        back = self._back
        now = time.perf_counter
        with doc._lock:
            if doc.opset is not None or doc._lazy_loader is None:
                return None
            clock = dict(doc._lazy_clock or {})
            history_len = doc._lazy_len
        t0 = now()
        # the shared serveability rule (non-creating: a refused
        # adoption must not materialize an empty actor feed on disk)
        spec = back._serveable_spec(clock)
        if spec is None:
            return None
        with _gc_paused():
            # a host pack (the reference's default pack route): the
            # prefix pack's plain version on CPU tensors
            batch = pack_docs_columns(
                [spec] if spec else [[]], device="cpu"
            )
            lv = LiveColumns.from_batch(batch, 0)
            t1 = now()
            if not self._ranges_ok(lv):
                return None  # refuse BEFORE paying the kernel run
            # kernel over the UNPADDED rows (the tick path's per-doc
            # host kernel): adoption sizes sit just under a pow2
            # bucket, so the padded batch kernel does ~2x the work
            lanes = self._host_lanes(lv)
            t2 = now()
            state = _decode_state(lv, lanes)
            t3 = now()
            # the frontend's baseline is the Ready snapshot of this
            # exact state: record what that snapshot walk can reach
            # (winner-link closure from the kernel lanes — no Diff
            # emission needed)
            state.reachable = _reachable_from_lanes(lv, lanes)
            t4 = now()  # inside the pause: the deferred gen0 sweep at
            # re-enable charges the build total, not the reach stage
        # sharded counters: no engine lock needed for stats anymore
        m = self._m
        m["t_adopt_pack"].add(t1 - t0)
        m["t_adopt_kernel"].add(t2 - t1)
        m["t_adopt_decode"].add(t3 - t2)
        m["t_adopt_reach"].add(t4 - t3)
        ld = _LiveDoc(
            doc, lv, state, clock,
            int(batch.cols["ctr"][0].max(initial=0)), history_len,
        )
        return ld, clock

    def _install_adoption(self, doc, ld, clock):
        """Install a built _LiveDoc under the engine lock, rechecking
        the state the build was derived from. Returns (status, ld):
        'ok' (installed), 'retry' (serving clock moved — rebuild),
        'refused' (a host OpSet won the race), or 'dropped' (the doc
        was closed/destroyed mid-build)."""
        now = time.perf_counter
        t0 = now()
        with self._lock:
            with doc._lock:
                if doc.opset is not None:
                    return "refused", None  # host-side init won
                if self._back.docs.get(doc.id) is not doc:
                    return "dropped", None
                if dict(doc._lazy_clock or {}) != clock:
                    return "retry", None
                doc._live_adopted = True
            ld.last_use = self._bump_use()
            self._docs[doc.id] = ld
            self._m["adopted"].add(1)
            if doc.id in self._demoted_ids:
                self._demoted_ids.discard(doc.id)
                self._m["readopted"].add(1)
            self._m["t_adopt_lock_held"].add(now() - t0)
        # budget enforcement OUTSIDE the engine lock: a demotion takes
        # {domain -> engine}, so running it with the engine held would
        # invert the declared order
        self._enforce_budget()
        return "ok", ld

    # ------------------------------------------------------------------
    # byte-bounded LRU demotion (HM_LIVE_MAX_BYTES)

    def _enforce_budget(self) -> None:
        """Demote least-recently-used idle docs until resident bytes
        fit HM_LIVE_MAX_BYTES (0 = unbounded — the pass costs O(1)
        then; `live_bytes` only refreshes while a cap is set). The
        most recently used doc is never demoted by this pass — a
        single hot doc larger than the cap must not thrash an O(doc)
        adopt/demote cycle on every tick — so the effective floor is
        one doc's bytes. Dirty docs (queued/pending/undecoded) wait
        for their tick."""
        cap = _live_max_bytes()
        if cap <= 0:
            with self._lock:
                self._m["live_docs"].set(len(self._docs))
            return
        self._demote_over(cap, protect_mru=True)

    def demote_idle(self, max_bytes: Optional[int] = None) -> int:
        """Demote idle adopted docs (LRU-first) until resident bytes
        fit `max_bytes` (default: the HM_LIVE_MAX_BYTES cap — a no-op
        when unset; pass 0 to demote every idle doc). Unlike the
        automatic budget pass this may demote the most recently used
        doc too. Returns the number demoted — docs with un-ticked
        changes, or whose state cannot be rebuilt from the sidecars,
        stay resident."""
        if max_bytes is not None:
            cap = max_bytes
        else:
            cap = _live_max_bytes()
            if cap <= 0:
                return 0  # unbounded cap: nothing to enforce
        return self._demote_over(cap, protect_mru=False)

    def _demote_over(self, cap: int, protect_mru: bool) -> int:
        """ONE LRU demotion sweep shared by the per-tick budget pass
        (protect_mru=True) and the explicit demote_idle hook; returns
        the number demoted. Candidates snapshot under the engine
        lock; each demotion re-locks {domain -> engine} and rechecks
        — the domain-before-engine order means the sweep can never
        hold the engine lock while waiting on a busy writer."""
        with self._lock:
            candidates, sizes, total, mru = (
                self._demote_candidates_locked(protect_mru)
            )
        n0 = self._m["demoted"].value()
        if total > cap:
            for ld in candidates:
                if total <= cap:
                    break
                if ld is mru:
                    continue
                if self._demote_one(ld):
                    total -= sizes[ld.doc.id]
        self._m["live_bytes"].set(total)
        with self._lock:
            self._m["live_docs"].set(len(self._docs))
        return int(self._m["demoted"].value() - n0)

    def _demote_candidates_locked(self, protect_mru: bool):
        """LRU-ordered demotion candidates + byte accounting.
        REQUIRES live.engine."""
        docs = self._docs
        sizes = {i: ld.resident_bytes() for i, ld in docs.items()}
        total = sum(sizes.values())
        mru = (
            max(docs.values(), key=lambda l: l.last_use)
            if (docs and protect_mru)
            else None
        )
        order = sorted(docs.values(), key=lambda l: l.last_use)
        return order, sizes, total, mru

    def _demote_one(self, ld: _LiveDoc) -> bool:
        """Demote one candidate if it is still present, idle, and
        rebuildable — under its domain (no emission can be mid-flight)
        plus the engine lock (table mutation)."""
        doc = ld.doc
        with doc.emission:
            with self._lock:
                if self._docs.get(doc.id) is not ld:
                    return False
                if ld.queued or ld.pending or ld.undecoded:
                    return False
                if not self._demotable(ld):
                    return False
                self._demote_locked(ld)
                return True

    def _demotable(self, ld: _LiveDoc) -> bool:
        """Re-adoption must be able to rebuild this exact state from
        the feed sidecars (the shared _serveable_spec rule — the same
        check adoption and the demoted snapshot closure run). Changes
        injected straight into the engine with no backing feed
        (synthetic peers, tests) pin the doc resident — demoting would
        silently lose them. The verdict memoizes per serving clock
        (either way), so over-budget ticks do not re-pay the sidecar
        scans — the scan runs under the doc's emission domain. If a
        sidecar regresses OUT-OF-BAND after a positive memo,
        re-adoption still re-checks serveability and falls back to
        the host path, so a stale verdict degrades, not corrupts."""
        doc = ld.doc
        with doc._lock:
            if doc._lazy_loader is None:
                return False
        memo = ld.demotable_at
        if memo is not None and memo[0] == ld.clock:
            return memo[1]
        verdict = self._back._serveable_spec(ld.clock) is not None
        ld.demotable_at = (dict(ld.clock), verdict)
        return verdict

    def _demote_locked(self, ld: _LiveDoc) -> None:
        """Hand an idle adopted doc back to the lazy path: the serving
        clock/length sync to the doc (they already do, per admission),
        the engine forgets its LiveColumns + decoded state, and the
        doc's next live change re-adopts from the sidecars (cheap: the
        vectorized decode). Reads keep working — a fresh lazy snapshot
        closure replaces the engine's state for Ready/reopen. Caller
        holds the doc's emission domain AND the engine lock
        (REQUIRES live.engine)."""
        doc = ld.doc
        log("live", f"demoting {doc.id[:6]} to lazy (LRU)")
        telemetry.instant("live.demote", cat="live")
        snap = self._back._demoted_snapshot_fn(doc.id, dict(ld.clock))
        doc.demote_from_live(dict(ld.clock), ld.history_len, snap)
        self._docs.pop(doc.id, None)
        self._demoted_ids.add(doc.id)
        self._m["demoted"].add(1)

    @staticmethod
    def _ranges_ok(lv: LiveColumns) -> bool:
        A = max(1, len(lv.actors.items))
        K = max(1, len(lv.keys.items))
        n = lv.n
        max_ctr = int(lv.cols["ctr"][:n].max(initial=0)) if n else 0
        return (
            max_ctr * A + A < 2**30 and (n + 1) * (K + 1) + K < 2**31
        )

    # ------------------------------------------------------------------
    # causal admission (OpSet _enqueue/_drain_pending twin)

    def _admit(self, ld: _LiveDoc, changes: List[Change]) -> bool:
        for c in changes:
            if c.seq <= ld.clock.get(c.actor, 0):
                continue  # duplicate / already applied
            ld.pending.setdefault((c.actor, c.seq), c)
        progressed = True
        admitted = False
        while progressed and ld.pending:
            progressed = False
            for key in list(ld.pending):
                c = ld.pending[key]
                if c.seq != ld.clock.get(c.actor, 0) + 1:
                    continue
                if any(
                    ld.clock.get(a, 0) < s for a, s in c.deps.items()
                ):
                    continue
                del ld.pending[key]
                ld.clock[c.actor] = c.seq
                ld.max_op = max(ld.max_op, c.max_op)
                ld.history_len += 1
                ld.queued.append(c)
                progressed = True
                admitted = True
        return admitted

    def _sync_doc_meta(self, ld: _LiveDoc) -> None:
        doc = ld.doc
        with doc._lock:
            doc._lazy_clock = dict(ld.clock)
            doc._lazy_len = ld.history_len

    # ------------------------------------------------------------------
    # the tick

    def _on_tick(self, marked: Dict) -> None:
        with telemetry.span("live.tick", cat="live"):
            m = self._m
            kernel_docs: List[_LiveDoc] = []
            ticked = 0
            for doc_id in list(marked):
                # GIL-atomic table snapshot: the tick NEVER holds the
                # engine lock while acquiring a doc's domain (and
                # never two domains at once — the no-cross-doc
                # invariant of the write plane)
                ld = self._docs.get(doc_id)
                if ld is None:
                    continue
                with ld.doc.emission:
                    with self._lock:
                        if self._docs.get(doc_id) is not ld:
                            continue  # demoted/evicted before we got in
                        ld.last_use = self._bump_use()
                    res = self._tick_doc_locked(ld)
                    if res:
                        ticked += 1
                    if res == 2:
                        kernel_docs.append(ld)
            if ticked:
                m["ticks"].add(1)
                m["tick_docs"].add(ticked)
            if kernel_docs:
                # shape buckets: docs whose row counts share a pow2
                # bucket ride one padded dispatch (and successive
                # ticks reuse its program)
                from ..ops.crdt_kernels import LIVE_MIN_ROWS, live_bucket

                groups: Dict[int, List[_LiveDoc]] = {}
                for ld in kernel_docs:
                    groups.setdefault(
                        live_bucket(ld.tick_rows, LIVE_MIN_ROWS), []
                    ).append(ld)
                for bucket_n, lds in sorted(groups.items()):
                    self._run_group(bucket_n, lds)
            self._enforce_budget()

    def _tick_doc_locked(self, ld: _LiveDoc) -> int:
        """Tick phase 1 for ONE doc, under its emission domain: append
        its queued changes and either apply them incrementally (small
        ticks — O(tick ops) through the OpSet-twin _apply_op_state —
        complete here, patch emitted) or mark the doc `undecoded` for
        the shared batched kernel: phase 2 dispatches across docs with
        NO locks held, phase 3 installs per doc back under this
        domain. Returns 0 = no work, 1 = done inline, 2 = joined the
        kernel group. REQUIRES doc.emit."""
        now = time.perf_counter
        m = self._m
        changes = ld.queued
        if not changes and not ld.undecoded:
            return 0
        if changes:
            ld.queued = []
            m["tick_changes"].add(len(changes))
            t0 = now()
            ld.cols.append_changes(changes)
            m["t_live_append"].add(now() - t0)
            if not self._ranges_ok(ld.cols):
                self._evict_to_host(ld)
                return 1
        n_ops = sum(len(c.ops) for c in changes)
        if not ld.undecoded and (
            n_ops <= 8 or n_ops * max(ld.cols.n, 1) <= _inc_budget_cells()
        ):
            t1 = now()
            diffs: List[Diff] = []
            for c in changes:
                for i, op in enumerate(c.ops):
                    self._apply_op_state(ld.state, c.op_id(i), op, diffs)
            m["inc_changes"].add(len(changes))
            m["t_live_apply"].add(now() - t1)
            self._emit_tick(ld, diffs)
            return 1
        ld.undecoded = True
        ld.tick_rows = ld.cols.n
        return 2

    def _catch_up_locked(self, ld: _LiveDoc) -> bool:
        """Bring ld.state current under its emission domain: apply the
        queued changes and decode any appended-but-undecoded rows,
        emitting the coalesced delta patch — the per-doc successor of
        the old engine-locked _flush_ids. Returns False when the doc
        was evicted to the host path (the caller retries host-side).
        REQUIRES doc.emit."""
        state = self._tick_doc_locked(ld)
        if state == 1 and self._docs.get(ld.doc.id) is not ld:
            return False  # _evict_to_host handed it to the host path
        if not ld.undecoded:
            return True
        # single-doc catch-up: the same bucketed kernel the tick group
        # uses (device when the padded shape clears the min-cells bar)
        from ..ops.crdt_kernels import LIVE_MIN_ROWS, live_bucket

        now = time.perf_counter
        t0 = now()
        lanes = self._kernel(
            live_bucket(ld.cols.n, LIVE_MIN_ROWS), [ld]
        )[0]
        self._m["t_live_kernel"].add(now() - t0)
        self._decode_install_locked(ld, lanes)
        return True

    def _decode_install_locked(self, ld: _LiveDoc, lanes) -> None:
        """Decode kernel lanes into a fresh state, diff, install, and
        emit — the shared tail of the catch-up paths. Caller holds the
        doc's emission domain."""
        now = time.perf_counter
        m = self._m
        t1 = now()
        with _gc_paused():
            new_state = _decode_state(ld.cols, lanes)
        t2 = now()
        diffs = _diff_states(ld.state, new_state)
        ld.state = new_state
        ld.undecoded = False
        m["t_live_decode"].add(t2 - t1)
        m["t_live_diff"].add(now() - t2)
        self._emit_tick(ld, diffs)

    def _emit_tick(self, ld: _LiveDoc, diffs: List[Diff]) -> None:
        self._sync_doc_meta(ld)
        doc = ld.doc
        if diffs and doc._announced:
            patch = Patch(
                clock=dict(ld.clock),
                deps=dict(ld.clock),
                max_op=ld.max_op,
                diffs=tuple(diffs),
            )
            doc._notify(
                {"type": "RemotePatch", "doc": doc, "patch": patch}
            )
        doc._check_ready()

    def _run_group(self, bucket_n: int, lds: List[_LiveDoc]) -> None:
        """Tick phases 2+3 for one shape bucket: ONE batched kernel
        dispatch across the group's docs with NO locks held (rows
        under each doc's phase-1 snapshot are immutable — LiveColumns
        appends publish `n` last), then a per-doc install back under
        its emission domain with a recheck: a doc a writer caught up
        (or evicted/closed) mid-kernel discards its stale lanes."""
        now = time.perf_counter
        m = self._m
        t0 = now()
        lanes_by_doc = self._kernel(bucket_n, lds)
        m["t_live_kernel"].add(now() - t0)
        for ld, lanes in zip(lds, lanes_by_doc):
            with ld.doc.emission:
                if not ld.undecoded:
                    continue  # a writer's catch-up beat us to it
                with self._lock:
                    if self._docs.get(ld.doc.id) is not ld:
                        continue  # dropped/demoted mid-kernel
                if ld.cols.n != ld.tick_rows:
                    # rows landed after the snapshot: redo at the
                    # current shape instead of installing stale lanes
                    self._catch_up_locked(ld)
                    continue
                self._decode_install_locked(ld, lanes)

    def _kernel(self, bucket_n: int, lds: List[_LiveDoc]):
        """Run the materialize kernel over the group; returns one lane
        view per doc. Device when the padded batch clears the min-cells
        bar, numpy twin otherwise (both bit-identical — the twin is the
        fuzz reference)."""
        D = len(lds)
        if D * bucket_n < _device_min_cells():
            self._m["kernel_runs"].add(1)
            return [self._host_lanes(ld.cols) for ld in lds]
        return self._kernel_device(bucket_n, lds)

    @staticmethod
    def _host_lanes(lv: LiveColumns):
        """One doc's numpy kernel lanes over its UNPADDED live columns
        — shared by the tick path's small-group kernel and adoption
        (which runs at exact n instead of the padded batch shape)."""
        from ..ops.host_kernel import _host_doc_kernel

        n = lv.n
        A = max(1, len(lv.actors.items))
        K = max(1, len(lv.keys.items))
        c = lv.cols
        return _host_doc_kernel(
            c["action"][:n], lv.slots(), c["ctr"][:n],
            np.zeros(n, np.int32), c["obj"][:n],
            c["key"][:n], c["ref"][:n], c["insert"][:n],
            c["value"][:n], lv.psrc[: lv.n_preds],
            lv.ptgt[: lv.n_preds],
            np.arange(A, dtype=np.int32), A, K,
        )

    def _kernel_device(self, bucket_n: int, lds: List[_LiveDoc]):
        """The group's padded [D, N] batch through materialize_live_device
        on the backend's device (the CUDA kernel on a GPU; the plain
        version on a CPU backend); the four lanes the decode reads come
        back in one synchronizing copy."""
        from ..ops.crdt_kernels import materialize_live_device

        self._m["kernel_runs"].add(1)
        self._m["device_dispatches"].add(1)
        planes, A, K = tick_batch([ld.cols for ld in lds], bucket_n)
        dev = self._back.device
        out = materialize_live_device(
            *(torch.from_numpy(a).to(dev) for a in planes), A=A, K=K
        )
        i32 = torch.int32
        lanes = torch.stack((
            out.visible.to(i32), out.elem_live.to(i32), out.rank,
            out.inc_total,
        )).cpu().numpy()
        host = {
            "visible": lanes[0].astype(bool),
            "elem_live": lanes[1].astype(bool),
            "rank": lanes[2],
            "inc_total": lanes[3],
        }
        return [_LaneDict(host, d) for d in range(len(lds))]

    def _evict_to_host(self, ld: _LiveDoc) -> None:
        """A doc outgrew the kernel's composite ranges: hand it back to
        the host OpSet path. Everything admitted is already in the
        feeds, so the explicit replay (at the serving clock) rebuilds
        the exact state; un-admitted pending changes re-queue so none
        is lost. Caller holds the doc's emission domain; the table
        mutation takes the engine lock inside it."""
        doc = ld.doc
        log("live", f"evicting {doc.id[:6]} to host path (range)")
        with self._lock:
            self._docs.pop(doc.id, None)
            self._refused.add(doc.id)
        with doc._lock:
            # doc._live stays set (see _ensure_doc): emissions keep the
            # engine lock so the Ready ordering contract holds
            doc._live_adopted = False
            doc._lazy_clock = dict(ld.clock)
            doc._lazy_len = ld.history_len
        doc._ensure_opset()  # the documented fallback: full host replay
        if ld.pending:
            doc.apply_remote_changes(list(ld.pending.values()))

    # ------------------------------------------------------------------
    # local change resolution (OpSet.apply_local_request twin)

    def _apply_local_locked(
        self, ld: _LiveDoc, req: ChangeRequest
    ) -> Tuple[Change, Patch]:
        state = ld.state
        start_op = ld.max_op + 1
        deps = {a: s for a, s in ld.clock.items() if a != req.actor}
        temp_map: Dict[str, OpId] = {}
        ops: List[Op] = []
        diffs: List[Diff] = []
        ctr = start_op
        for intent in req.intents:
            op = self._resolve_intent(
                state, intent, OpId(ctr, req.actor), temp_map
            )
            if op is None:
                continue
            self._apply_op_state(state, OpId(ctr, req.actor), op, diffs)
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
        ld.cols.append_changes([change])
        ld.clock[req.actor] = req.seq
        ld.max_op = max(ld.max_op, change.max_op)
        ld.history_len += 1
        patch = Patch(
            clock=dict(ld.clock),
            deps=dict(ld.clock),
            max_op=ld.max_op,
            diffs=tuple(diffs),
            actor=req.actor,
            seq=req.seq,
        )
        return change, patch

    @staticmethod
    def _resolve_intent(
        state: _DocState, intent, opid: OpId, temp_map
    ) -> Optional[Op]:
        # the SHARED resolver (crdt/opset.py) — one implementation for
        # both HM_LIVE twins, parameterized over this engine's decoded
        # state (_Obj has the same .is_sequence/.fields shape)
        from ..crdt.opset import resolve_intent

        return resolve_intent(
            intent, opid, temp_map, state.objs.get, _Obj.live
        )

    def _apply_op_state(
        self, state: _DocState, opid: OpId, op: Op, diffs: List[Diff]
    ) -> None:
        """OpSet._apply_op twin over the decoded state — ONE
        implementation serves both local resolution and the incremental
        remote tick path, so the two engines cannot drift."""
        obj = state.objs.get(op.obj)
        if obj is None:
            return  # tolerate ops against unknown objects (OpSet does)
        if op.action.makes_object and opid not in state.objs:
            child_type = OBJ_TYPE_BY_MAKE[op.action]
            state.objs[opid] = _Obj(child_type)
            state.reachable.add(opid)
            diffs.append(
                Diff(action="create", obj=str(opid), obj_type=child_type)
            )
        val = _Val(
            None if op.action.makes_object else op.value,
            op.action.makes_object,
            None if op.action.makes_object else op.datatype,
        )
        if obj.is_sequence:
            self._apply_seq_state(state, obj, opid, op, val, diffs)
        else:
            self._apply_map_state(state, obj, opid, op, val, diffs)

    @staticmethod
    def _obj_str(op: Op) -> str:
        return ROOT_ID if op.obj == ROOT else str(op.obj)

    @staticmethod
    def _live_index(obj: _Obj, elem: OpId) -> int:
        """Index among LIVE elems (OpSet._live_index twin)."""
        idx = 0
        for e in obj.order:
            if e == elem:
                return idx
            if obj.fields.get(e):
                idx += 1
        return idx

    def _apply_map_state(self, state, obj, opid, op, val, diffs) -> None:
        key = op.key
        if key is None:
            return
        visible = obj.fields.setdefault(key, {})
        had = bool(visible)
        if op.action == Action.INC:
            for p in op.pred:
                if p in visible:
                    state.inc[p] = state.inc.get(p, 0) + (op.value or 0)
        else:
            for p in op.pred:
                if visible.pop(p, None) is not None:
                    state.inc.pop(p, None)
            if op.action == Action.SET or op.action.makes_object:
                visible[opid] = val
        oid = self._obj_str(op)
        if not visible:
            if had:
                diffs.append(
                    Diff(
                        action="remove",
                        obj=oid,
                        obj_type=obj.type,
                        key=key,
                    )
                )
            else:
                obj.fields.pop(key, None)
            return
        winner, value, link, datatype, conflicts = _display(state, visible)
        diffs.append(
            Diff(
                action="set",
                obj=oid,
                obj_type=obj.type,
                key=key,
                value=value,
                link=link,
                datatype=datatype,
                conflicts=conflicts,
            )
        )

    def _apply_seq_state(self, state, obj, opid, op, val, diffs) -> None:
        oid = self._obj_str(op)
        if op.insert:
            # RGA insert-after with descending-OpId skip scan (OpSet's
            # algorithm verbatim; `order` includes tombstones)
            if op.ref == HEAD:
                pos = 0
            else:
                try:
                    pos = obj.order.index(op.ref) + 1
                except ValueError:
                    return  # unknown predecessor
            while pos < len(obj.order) and obj.order[pos] > opid:
                pos += 1
            obj.order.insert(pos, opid)
            obj.fields[opid] = {opid: val}
            value, link, datatype = _op_value(state, opid, val)
            diffs.append(
                Diff(
                    action="insert",
                    obj=oid,
                    obj_type=obj.type,
                    index=self._live_index(obj, opid),
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
                    state.inc[p] = state.inc.get(p, 0) + (op.value or 0)
        else:
            for p in op.pred:
                if visible.pop(p, None) is not None:
                    state.inc.pop(p, None)
            if op.action == Action.SET or op.action.makes_object:
                visible[opid] = val
        if visible:
            winner, value, link, datatype, conflicts = _display(
                state, visible
            )
            diffs.append(
                Diff(
                    # a tombstoned elem coming back to life (concurrent
                    # set vs delete) is an *insert* to the frontend
                    action="set" if had else "insert",
                    obj=oid,
                    obj_type=obj.type,
                    index=self._live_index(obj, elem),
                    elem_id=str(elem),
                    value=value,
                    link=link,
                    datatype=datatype,
                    conflicts=conflicts,
                )
            )
        elif had:
            # tombstone RETAINED in order/fields (OpSet keeps it: later
            # remote inserts may reference this elem)
            diffs.append(
                Diff(
                    action="remove",
                    obj=oid,
                    obj_type=obj.type,
                    index=self._live_index(obj, elem),
                    elem_id=str(elem),
                )
            )


# ---------------------------------------------------------------------------
# the tick's padded batch


def tick_batch(lvs: List[LiveColumns], bucket_n: int):
    """One kernel group's padded batch: (flags, slot, ctr, obj, key, ref,
    value, psrc, ptgt) numpy planes — [D, N] rows (flags uint8 =
    action|insert<<3, the rest int32), [D, P] pred edges — with D, N, A,
    K and P in `live_bucket` pow2 buckets, and (A, K). Pad rows are PAD
    actions with no container, key or reference; pad docs are all pad."""
    from ..ops.columnar import PAD
    from ..ops.crdt_kernels import LIVE_MIN_DOCS, live_bucket

    D = live_bucket(len(lvs), LIVE_MIN_DOCS)
    N = bucket_n
    A = live_bucket(max(len(lv.actors.items) for lv in lvs), 4)
    K = live_bucket(max(len(lv.keys.items) for lv in lvs), 16)
    P = live_bucket(max(lv.n_preds for lv in lvs), 16)
    flags = np.zeros((D, N), np.uint8)
    flags[:, :] = PAD
    slot = np.zeros((D, N), np.int32)
    ctr = np.zeros((D, N), np.int32)
    obj = np.full((D, N), -1, np.int32)
    key = np.full((D, N), -1, np.int32)
    ref = np.full((D, N), -3, np.int32)
    value = np.zeros((D, N), np.int32)
    psrc = np.full((D, P), -1, np.int32)
    ptgt = np.full((D, P), -1, np.int32)
    for d, lv in enumerate(lvs):
        n, npred = lv.n, lv.n_preds
        c = lv.cols
        flags[d, :n] = (
            c["action"][:n].astype(np.uint8)
            | (c["insert"][:n].astype(np.uint8) << 3)
        )
        slot[d, :n] = lv.slots()
        ctr[d, :n] = c["ctr"][:n]
        obj[d, :n] = c["obj"][:n]
        key[d, :n] = c["key"][:n]
        ref[d, :n] = c["ref"][:n]
        value[d, :n] = c["value"][:n]
        psrc[d, :npred] = lv.psrc[:npred]
        ptgt[d, :npred] = lv.ptgt[:npred]
    return (flags, slot, ctr, obj, key, ref, value, psrc, ptgt), A, K


# ---------------------------------------------------------------------------
# lane adapters


class _LaneDict:
    __slots__ = ("visible", "elem_live", "rank", "inc_total")

    def __init__(self, host: Dict[str, np.ndarray], d: int) -> None:
        self.visible = host["visible"][d]
        self.elem_live = host["elem_live"][d]
        self.rank = host["rank"][d]
        self.inc_total = host["inc_total"][d]
