"""Bulk materialization: kernel outputs -> patches / documents.

The port of hypermerge_tpu/ops/materialize.py. Thousands of docs replay
in one GPU dispatch via ops/crdt_kernels.py and this module turns the
winner/order/liveness lanes back into:

- `decode_patch`: a snapshot Patch identical in meaning to
  OpSet.snapshot_patch() — feeds DocReady messages to frontends.
- `materialize_docs`: plain Python document trees (equivalence-tested
  against the host OpSet path).
- `decode_columnar`: stays in numpy — the representation bulk consumers
  (bench, ClockStore-scale queries) should prefer; no per-entry Python
  objects.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..crdt.change import Action
from ..crdt.frontend_state import FrontendDoc
from ..crdt.patch import Conflict, Diff, Patch
from ..device import DeviceLike
from .columnar import ColumnarBatch, decode_value, pack_docs
from .crdt_kernels import (
    MaterializeOut,
    bucket_doc_actors,
    ensure_doc_actors,
    parse_summary_wire,
    run_batch,
    run_batch_summary,
)

_OBJ_TYPES = {
    int(Action.MAKE_MAP): "map",
    int(Action.MAKE_LIST): "list",
    int(Action.MAKE_TEXT): "text",
    int(Action.MAKE_TABLE): "table",
}

ROOT_ROW = -1
ROOT_ID = "0@_root"


class DecodedBatch:
    """Numpy views of device outputs, shared by the decoders.

    Lanes transfer device->host lazily, on first attribute access, so a
    consumer that only needs clocks does not pay for ranks. So do the
    batch's host columns (`cols`): a dispatch builds this before the
    prefix pack's planes have reached the host, and a read waits for
    them.
    """

    _LANES = (
        "visible", "map_winner", "elem_winner", "elem_live",
        "rank", "inc_total", "clock",
    )

    def __init__(
        self,
        batch: ColumnarBatch,
        out: MaterializeOut,
        host_clocks: Optional[List[Dict[str, int]]] = None,
    ) -> None:
        self.batch = batch
        self._out = out
        # authoritative per-doc clocks from the caller (lean kernel runs
        # don't transfer the seq wire, so the device clock lane is zeros)
        self.host_clocks = host_clocks

    @property
    def cols(self):
        """The batch's host columns, {name: [D, N]}."""
        return self.batch.cols

    def __getattr__(self, name: str):
        if name in DecodedBatch._LANES and "_out" in self.__dict__:
            arr = _host(getattr(self._out, name))
            setattr(self, name, arr)
            if all(l in self.__dict__ for l in DecodedBatch._LANES):
                del self._out  # release the device buffers
            return arr
        raise AttributeError(name)

    def clock_dict(self, d: int) -> Dict[str, int]:
        if self.host_clocks is not None:
            return dict(self.host_clocks[d])
        return _local_clock_dict(
            self.batch, _doc_actors_row(self.batch, d), self.clock[d]
        )

    def doc_view(self, d: int) -> "DocView":
        """A one-doc view whose lanes transfer individually — opening a
        single doc out of a bulk batch must not pay for the whole [D, N]
        lane set (decode_patch accepts this in place of the batch)."""
        lanes = {}
        for name in DecodedBatch._LANES:
            if name in self.__dict__:
                lanes[name] = self.__dict__[name][d : d + 1]
            else:
                lanes[name] = _host(getattr(self._out, name)[d])[None]
        cols = {k: v[d : d + 1] for k, v in self.cols.items()}
        return DocView(
            self.batch,
            cols,
            lanes,
            _doc_actors_row(self.batch, d),
            host_clock=(
                dict(self.host_clocks[d])
                if self.host_clocks is not None
                else None
            ),
        )


def _host(t) -> np.ndarray:
    """A lane as a host numpy array: one transfer for a tensor, the
    array itself for the numpy kernel twin's lanes."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _doc_actors_row(batch: ColumnarBatch, d: int) -> np.ndarray:
    return ensure_doc_actors(batch)[d]


class DocView:
    """One document's rows/lanes, shaped [1, N] — decode_patch(view, 0)."""

    def __init__(
        self, batch, cols, lanes, doc_actors, host_clock=None
    ) -> None:
        self.batch = batch
        self.cols = cols
        self.doc_actors = doc_actors
        self.host_clock = host_clock
        for name, arr in lanes.items():
            setattr(self, name, arr)

    def clock_dict(self, _d: int) -> Dict[str, int]:
        if self.host_clock is not None:
            return dict(self.host_clock)
        return _local_clock_dict(self.batch, self.doc_actors, self.clock[0])


def _local_clock_dict(
    batch: ColumnarBatch, doc_actors: np.ndarray, clock_row: np.ndarray
) -> Dict[str, int]:
    """Decode a [A_loc] local-slot clock through the doc's actor map."""
    out: Dict[str, int] = {}
    for slot, gid in enumerate(np.asarray(doc_actors).ravel()):
        if gid < 0 or slot >= len(clock_row):
            continue
        s = int(clock_row[slot])
        if s > 0:
            out[batch.actors[int(gid)]] = s
    return out


def materialize_batch(
    docs_changes, n_rows: Optional[int] = None, device: DeviceLike = None
) -> DecodedBatch:
    """Pack -> device kernel -> decoded views, in one call."""
    batch = pack_docs(docs_changes, n_rows=n_rows)
    out = run_batch(batch, device=device)
    return DecodedBatch(batch, out)


# ---------------------------------------------------------------------------
# per-doc patch decode (runtime use: DocReady snapshots)


def decode_patch(dec: DecodedBatch, d: int) -> Patch:
    b, c = dec.batch, dec.cols
    action = c["action"][d]
    actor = c["actor"][d]
    ctr = c["ctr"][d]
    obj = c["obj"][d]
    key = c["key"][d]
    ref = c["ref"][d]
    insert = c["insert"][d]
    vkind = c["vkind"][d]
    value = c["value"][d]
    dt = c["dt"][d]
    visible = dec.visible[d]
    map_winner = dec.map_winner[d]
    elem_winner = dec.elem_winner[d]
    elem_live = dec.elem_live[d]
    rank = dec.rank[d]
    inc_total = dec.inc_total[d]

    def opid_str(row: int) -> str:
        return f"{int(ctr[row])}@{b.actors[int(actor[row])]}"

    def obj_id_str(row: int) -> str:
        return ROOT_ID if row == ROOT_ROW else opid_str(row)

    def row_value(row: int) -> Tuple[Any, bool, Optional[str]]:
        a = int(action[row])
        if a in _OBJ_TYPES:
            return opid_str(row), True, None
        v = decode_value(int(vkind[row]), int(value[row]), int(dt[row]), b)
        datatype = (
            "counter" if dt[row] == 1
            else "timestamp" if dt[row] == 2 else None
        )
        if datatype == "counter":
            v = (v or 0) + int(inc_total[row])
        return v, False, datatype

    # group winners/conflicts by container
    map_rows_by_obj: Dict[int, List[int]] = {}
    map_conf: Dict[Tuple[int, int], List[int]] = {}
    for r in np.nonzero(visible & (key >= 0))[0]:
        r = int(r)
        if map_winner[r]:
            map_rows_by_obj.setdefault(int(obj[r]), []).append(r)
        else:
            map_conf.setdefault((int(obj[r]), int(key[r])), []).append(r)

    # elements: live INS rows per container, ordered by descending rank
    elems_by_obj: Dict[int, List[int]] = {}
    for r in np.nonzero(elem_live)[0]:
        elems_by_obj.setdefault(int(obj[int(r)]), []).append(int(r))
    for rows in elems_by_obj.values():
        rows.sort(key=lambda r: -int(rank[r]))

    # winner value op per element + conflicts
    elem_val: Dict[int, int] = {}
    elem_conf: Dict[int, List[int]] = {}
    for r in np.nonzero(visible & (insert == 0) & (key < 0) & (ref >= 0))[0]:
        r = int(r)
        e = int(ref[r])
        if elem_winner[r]:
            elem_val[e] = r
        else:
            elem_conf.setdefault(e, []).append(r)
    for r in np.nonzero(elem_live & elem_winner)[0]:
        elem_val.setdefault(int(r), int(r))
    for r in np.nonzero(visible & (insert == 1))[0]:
        r = int(r)
        if elem_live[r] and not elem_winner[r]:
            elem_conf.setdefault(r, []).append(r)

    diffs: List[Diff] = []
    visited = set()

    def conflicts_for(rows: List[int]) -> tuple:
        # descending OpId = (ctr, actor-string) order, matching OpSet
        ordered = sorted(
            rows,
            key=lambda r: (int(ctr[r]), b.actors[int(actor[r])]),
            reverse=True,
        )
        out = []
        for r in ordered:
            v, link, datatype = row_value(r)
            out.append(Conflict(opid_str(r), v, link, datatype))
        return tuple(out)

    def emit_obj(row: int) -> None:
        if row in visited:
            return
        visited.add(row)
        oid = obj_id_str(row)
        otype = "map" if row == ROOT_ROW else _OBJ_TYPES[int(action[row])]
        if row != ROOT_ROW:
            diffs.append(Diff(action="create", obj=oid, obj_type=otype))
        if otype in ("list", "text"):
            for index, e in enumerate(elems_by_obj.get(row, [])):
                w = elem_val[e]
                v, link, datatype = row_value(w)
                if link:
                    emit_obj(w)
                diffs.append(
                    Diff(
                        action="insert",
                        obj=oid,
                        obj_type=otype,
                        index=index,
                        elem_id=opid_str(e),
                        value=v,
                        link=link,
                        datatype=datatype,
                        conflicts=conflicts_for(
                            [r for r in elem_conf.get(e, []) if r != w]
                        ),
                    )
                )
        else:
            rows = map_rows_by_obj.get(row, [])
            rows.sort(key=lambda r: b.keys[int(key[r])])
            for w in rows:
                v, link, datatype = row_value(w)
                if link:
                    emit_obj(w)
                diffs.append(
                    Diff(
                        action="set",
                        obj=oid,
                        obj_type=otype,
                        key=b.keys[int(key[w])],
                        value=v,
                        link=link,
                        datatype=datatype,
                        conflicts=conflicts_for(
                            map_conf.get((row, int(key[w])), [])
                        ),
                    )
                )

    emit_obj(ROOT_ROW)
    clock = dec.clock_dict(d)
    max_op = int(ctr.max(initial=0))
    return Patch(clock=clock, deps=clock, max_op=max_op, diffs=tuple(diffs))


def materialize_docs(dec: DecodedBatch) -> List[Any]:
    """Plain Python trees for every doc in the batch (test/equivalence
    path; bulk consumers should stay columnar via decode_columnar)."""
    out = []
    for d in range(dec.batch.n_docs):
        front = FrontendDoc()
        front.apply_patch(decode_patch(dec, d))
        out.append(front.materialize())
    return out


# ---------------------------------------------------------------------------
# columnar decode (bench / bulk path — no per-entry Python objects)


def decode_columnar(dec: DecodedBatch) -> Dict[str, np.ndarray]:
    """Vectorized summary of materialized state: winner masks, element
    order keys, clocks. This is the 'materialized' form bulk pipelines
    consume. Host reference path — bulk consumers should prefer
    `summarize_columnar`, which computes the same thing on device and
    transfers ~5x fewer bytes."""
    live_elems = dec.elem_live
    order_key = np.where(live_elems, -dec.rank, np.iinfo(np.int32).max)
    elem_order = np.argsort(order_key, axis=1, kind="stable")
    return {
        "map_winner": dec.map_winner,
        "elem_live": live_elems,
        "elem_order": elem_order,
        "n_live_elems": live_elems.sum(axis=1),
        "n_map_entries": dec.map_winner.sum(axis=1),
        "clock": dec.clock,
    }


def fetch_summary(wire, batch: ColumnarBatch, lean: bool = False):
    """Transfer + decode one slab's fused summary wire buffer (see
    ops/crdt_kernels.py summary_wire_spec for the byte layout)."""
    _da, A, _K = bucket_doc_actors(batch)
    return parse_summary_wire(_host(wire), batch.n_rows, A, lean)


def summarize_columnar(
    batch: ColumnarBatch, device: DeviceLike = None
) -> Dict[str, np.ndarray]:
    """Bulk path: fused kernel+summary on device, ONE compact transfer,
    decode on host. Same keys/values as decode_columnar(run_batch(...))."""
    return fetch_summary(run_batch_summary(batch, device=device), batch)


class BulkSummaries:
    """Host-side summaries of a bulk load's slabs — the product of the
    materialization barrier (RepoBackend.fetch_bulk_summaries). Slab
    arrays stay columnar (zero-copy for bulk consumers); `doc(id)` decodes
    one doc's counts + clock on demand.

    `memo_slabs` carries docs served from the backend's summary memo
    (clean docs whose clocks did not move since their last fetch — no
    pack, no dispatch, no transfer): (doc_ids, arrays, clock_dicts)
    groups whose arrays follow the same columnar contract, with the
    per-doc clock already decoded."""

    def __init__(self, pending, memo_slabs=None) -> None:
        # pending: (doc_ids, batch, dec, wire, lean) where wire is the
        # slab's summary wire (a tensor) or the parsed arrays dict itself
        # (the backend's barrier fetched it)
        self.slabs: List[Tuple[List[str], Optional[ColumnarBatch], Dict]] = []
        self._where: Dict[str, Tuple[int, int]] = {}
        for doc_ids, batch, dec, wire, lean in pending:
            if isinstance(wire, dict):  # parsed by the barrier
                arrays = wire
            else:
                arrays = fetch_summary(wire, batch, lean)
            if dec.host_clocks is not None:
                # lean slabs never uploaded the seq lane (nor fetched the
                # wire's clock section), so the clock lane is zeros:
                # rebuild it from the authoritative host clocks so the
                # columnar contract (arrays()['clock']) stays consistent
                # with doc()
                da = ensure_doc_actors(batch)
                clock = np.array(arrays["clock"])  # mutate a copy
                for j, hc in enumerate(dec.host_clocks):
                    if not hc:
                        continue
                    for slot, gid in enumerate(da[j]):
                        if gid >= 0:
                            clock[j, slot] = hc.get(
                                batch.actors[int(gid)], 0
                            )
                arrays["clock"] = clock
            self._add_slab(doc_ids, batch, arrays)
        for doc_ids, arrays, clock_dicts in memo_slabs or ():
            arrays = dict(arrays)
            arrays["clock_dicts"] = list(clock_dicts)
            self._add_slab(doc_ids, None, arrays)

    def _add_slab(self, doc_ids, batch, arrays) -> None:
        # only small per-doc dicts are retained — the DecodedBatch
        # (device lanes + column copies) must be releasable once docs
        # drop their lazy snapshot closures
        self.slabs.append((doc_ids, batch, arrays))
        for j, d in enumerate(doc_ids):
            self._where[d] = (len(self.slabs) - 1, j)

    @property
    def doc_ids(self) -> List[str]:
        return list(self._where.keys())

    def arrays(self, doc_id: str) -> Tuple[Dict, int]:
        """(slab arrays, row index) holding this doc."""
        si, j = self._where[doc_id]
        return self.slabs[si][2], j

    def doc(self, doc_id: str) -> Dict[str, Any]:
        si, j = self._where[doc_id]
        _doc_ids, batch, arrays = self.slabs[si]
        if batch is None:  # memo-served group: clock pre-decoded
            clock = dict(arrays["clock_dicts"][j])
        else:
            clock = _local_clock_dict(
                batch, _doc_actors_row(batch, j), arrays["clock"][j]
            )
        return {
            "elems": int(arrays["n_live_elems"][j]),
            "map_entries": int(arrays["n_map_entries"][j]),
            "clock": clock,
        }


def text_join(dec: DecodedBatch, d: int, text_obj_row: int) -> str:
    """Fast text materialization: join the winner chars of one text object
    in RGA order (numpy sort, no per-char Python)."""
    c = dec.cols
    mask = (
        dec.elem_live[d]
        & (c["obj"][d] == text_obj_row)
        & (c["insert"][d] == 1)
    )
    rows = np.nonzero(mask)[0]
    rows = rows[np.argsort(-dec.rank[d][rows], kind="stable")]
    strings = dec.batch.strings
    # pull the selected columns to host ONCE, then index in numpy
    vals = np.asarray(c["value"][d])[rows].tolist()
    kinds = np.asarray(c["vkind"][d])[rows].tolist()
    return "".join(
        strings[v] if k == 3 else "" for v, k in zip(vals, kinds)
    )
