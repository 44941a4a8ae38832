"""Carrying state across between the reference and the port.

The system has no model weights: its state is the change histories and
the packed batch. Histories cross as the JSON form both packages share
(`Change.to_json` / `Change.from_json`), through
`changes_from_reference`. A `ColumnarBatch` of the reference
(hypermerge_tpu.ops.columnar) goes into the port as plain numpy arrays
and lists, through `batch_from_numpy`, and comes back out through
`batch_to_numpy`; kernel outputs come out through `out_to_numpy`. Feed
column sidecars need no converter: both packages read and write the same
bytes (storage/colcache.py). Nothing here imports the reference package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .crdt.change import Change
from .ops.columnar import COLUMNS, ColumnarBatch
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
