"""Carrying state across between the reference and the port.

The system has no model weights: its state is the change histories and
the packed batch. Histories cross as the JSON form both packages share
(`Change.to_json` / `Change.from_json`), through
`changes_from_reference`. A `ColumnarBatch` of the reference
(hypermerge_tpu.ops.columnar) goes into the port as plain numpy arrays
and lists, through `batch_from_numpy`, and comes back out through
`batch_to_numpy`; kernel outputs come out through `out_to_numpy`. Feed
column sidecars need no converter: both packages read and write the same
bytes (storage/colcache.py), and neither do the sqlite clock and cursor
tables (storage/sql.py keeps the schema). A reference DeviceClockMirror
crosses through `clock_mirror_from_reference`, a resident read-serving
entry (serve/resident.py ResidentDoc) through
`resident_entry_from_reference`, and one live doc's appendable columns
(ops/columnar.py LiveColumns, the live engine's cache) through
`live_columns_from_reference`. Nothing here imports the reference
package: the reference's objects are read by their fields.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .crdt.change import Change, OpId
from .device import DeviceLike, resolve
from .ops.clock_mirror import DeviceClockMirror
from .ops.columnar import COLUMNS, ColumnarBatch, LiveColumns
from .ops.crdt_kernels import MaterializeOut

BATCH_FIELDS = (
    "cols", "psrc", "ptgt", "n_ops", "doc_actors", "slot",
    "actors", "keys", "strings", "floats", "bigints",
)


def changes_from_reference(json_list: List[Dict[str, Any]]) -> List[Change]:
    """Port Changes from a history in JSON form (a list of the reference's
    `Change.to_json()` dicts): values keep their Python types (floats,
    bools, ints of any size)."""
    return [Change.from_json(d) for d in json_list]


def batch_from_numpy(
    cols: Dict[str, np.ndarray],
    psrc: np.ndarray,
    ptgt: np.ndarray,
    n_ops: np.ndarray,
    actors: List[str],
    keys: List[str],
    strings: List[str],
    floats: List[float],
    bigints: List[int],
    doc_actors: Optional[np.ndarray] = None,
    slot: Optional[np.ndarray] = None,
) -> ColumnarBatch:
    """A port ColumnarBatch from the fields of a reference batch. Arrays
    are copied (int32 columns and pred edges), so the two batches never
    share memory."""
    missing = [c for c in COLUMNS if c not in cols]
    if missing:
        raise ValueError(f"batch columns missing: {missing}")
    D, N = np.shape(cols["action"])
    out_cols = {}
    for name in COLUMNS:
        a = np.array(cols[name], dtype=np.int32)
        if a.shape != (D, N):
            raise ValueError(f"column {name}: shape {a.shape} != {(D, N)}")
        out_cols[name] = a
    psrc = np.array(psrc, dtype=np.int32)
    ptgt = np.array(ptgt, dtype=np.int32)
    if psrc.shape != ptgt.shape or psrc.shape[0] != D:
        raise ValueError(f"pred edges: {psrc.shape} / {ptgt.shape}, D={D}")
    return ColumnarBatch(
        cols=out_cols,
        psrc=psrc,
        ptgt=ptgt,
        n_ops=np.array(n_ops, dtype=np.int32),
        actors=list(actors),
        keys=list(keys),
        strings=list(strings),
        floats=list(floats),
        bigints=list(bigints),
        doc_actors=(
            None if doc_actors is None
            else np.array(doc_actors, dtype=np.int32)
        ),
        slot=None if slot is None else np.array(slot, dtype=np.int16),
    )


def batch_to_numpy(batch: Any) -> Dict[str, Any]:
    """The `batch_from_numpy` keyword arguments of a batch (port or
    reference: only the shared field names are read)."""
    return {name: getattr(batch, name) for name in BATCH_FIELDS}


def out_to_numpy(out: MaterializeOut) -> Dict[str, np.ndarray]:
    """Every MaterializeOut lane as a host numpy array."""
    return {name: t.cpu().numpy() for name, t in out._asdict().items()}


def clock_mirror_from_reference(
    mirror: Any, device: DeviceLike = None
) -> DeviceClockMirror:
    """A port DeviceClockMirror on `device` with a reference mirror's state:
    its pending writes are flushed (on the reference), then its matrix
    crosses as numpy with the doc list (the None holes of deleted rows
    kept), the actor list, both indexes and both capacities, so every row
    and column index stays the same (top_k_dominated answers by row)."""
    mirror.flush()
    out = DeviceClockMirror(mirror._cap_d, mirror._cap_a, device=device)
    out._docs = list(mirror._docs)
    out._actors = list(mirror._actors)
    out.doc_index = dict(mirror.doc_index)
    out.actor_index = dict(mirror.actor_index)
    if mirror._matrix is not None:
        m = np.array(mirror._matrix, dtype=np.int32)
        if m.shape != (out._cap_d, out._cap_a):
            raise ValueError(f"mirror matrix {m.shape} != its capacity")
        out._matrix = out._upload(m)
    return out


def resident_entry_from_reference(entry: Any, device: DeviceLike = None):
    """A port ResidentDoc with a reference entry's state: its device lanes
    ([6, bucket] int32) cross as numpy onto `device`, its host half (the
    per-row value columns, the element -> value map, the side tables,
    the key index) is copied."""
    import torch

    from .serve.resident import ResidentDoc, _Tables

    dev = torch.from_numpy(np.array(entry.dev, dtype=np.int32)).to(
        resolve(device)
    )
    host_cols = {
        k: np.array(getattr(entry, k), dtype=np.int32)
        for k in ("action", "vkind", "value", "dt", "inc_total")
    }
    return ResidentDoc(
        entry.doc_id, dict(entry.clock), entry.n, entry.bucket, dev,
        host_cols, np.array(entry.elem_val, dtype=np.int32),
        _Tables(entry.tables), dict(entry.key_index),
    )


def live_columns_from_reference(lv: Any) -> LiveColumns:
    """A port LiveColumns with a reference LiveColumns' state: its column
    arrays and pred edges are copied at their capacity (so later appends
    grow them the same way), the interners keep their items and index (so
    every table index stays the same), and `row_of` and `opids` cross as
    the port's OpIds."""
    out = LiveColumns()
    out.n = int(lv.n)
    out.n_preds = int(lv.n_preds)
    out.cols = {
        name: np.array(lv.cols[name], dtype=np.int32) for name in COLUMNS
    }
    out.psrc = np.array(lv.psrc, dtype=np.int32)
    out.ptgt = np.array(lv.ptgt, dtype=np.int32)
    for name in ("actors", "keys", "strings", "floats", "bigints"):
        ref, interner = getattr(lv, name), getattr(out, name)
        interner.items = list(ref.items)
        interner._index = dict(ref._index)
    out.opids = [OpId(int(c), str(a)) for c, a in lv.opids]
    out.row_of = {
        OpId(int(c), str(a)): int(r) for (c, a), r in lv.row_of.items()
    }
    return out
