"""Columnar op-log encoding — changes as padded int32 arrays.

The port's copy of the reference pack (hypermerge_tpu/ops/columnar.py):
a document's change history becomes fixed-shape int32 columns that the
CUDA kernels (ops/crdt_kernels.py) consume, one document per row of a
[D, N] batch.

Row = one op, in a causal linear order (sorted by (start_op ctr, actor) —
valid because a change depending on another always has a larger start_op).

Columns (all int32, shape [N] per doc, padded with PAD rows):
  action  Action code (change.Action; PAD=7)
  actor   index into the batch actor table
  ctr     lamport counter (op id = (ctr, actor))
  seq     change seq the op belongs to (for device clock derivation)
  obj     row index of the container's MAKE op; -1 = root map
  key     index into the batch key-string table; -1 = none (list ops)
  ref     row index: INS -> predecessor elem row (-2 = HEAD);
          SET/DEL on elem -> elem row; INC -> target value-op row; else -3
  insert  1 if the op creates a new list/text element
  vkind   value encoding kind (VK_*)
  value   inline small int / bool / index into a side table
  dt      datatype code: 0 none, 1 counter, 2 timestamp

Supersession (pred) edges are their own arrays [P]: psrc (superseding row),
ptgt (superseded row), padded with (-1, -1). INC ops contribute NO pred
edges — their target rides the ref column (an INC must not kill its
counter).

Side tables (batch-global, host-side): actors, key strings, value strings,
floats (float64 — no precision loss through the device path), bigints.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..crdt.change import HEAD, ROOT, Action, Change, OpId

PAD = int(Action.PAD)

# value kinds
VK_NONE = 0
VK_INT = 1  # inline int32
VK_FLOAT = 2  # index into floats table
VK_STR = 3  # index into strings table
VK_BOOL = 4  # inline 0/1
VK_BIGINT = 5  # index into bigints table
# MAKE_* rows carry no value (the op id is the object id)

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1

COLUMNS = (
    "action",
    "actor",
    "ctr",
    "seq",
    "obj",
    "key",
    "ref",
    "insert",
    "vkind",
    "value",
    "dt",
)


class _Interner:
    def __init__(self) -> None:
        self.items: List[Any] = []
        self._index: Dict[Any, int] = {}

    def __call__(self, item: Any) -> int:
        idx = self._index.get(item)
        if idx is None:
            idx = len(self.items)
            self.items.append(item)
            self._index[item] = idx
        return idx

    def __len__(self) -> int:
        return len(self.items)


@dataclass
class ColumnarBatch:
    """[D, N] padded op columns + [D, P] pred edges + side tables.

    `doc_actors` is the per-doc local actor map: [D, A_loc] int32
    indices into `actors`, ascending (== actor-string sort order, the
    device tie-break), padded with -1. The device kernels only ever see
    A_loc (max actors per doc, a small constant) — never the batch-wide
    actor count — so the jit bucket and the [D, A_loc] clock output stay
    independent of how many documents share a slab."""

    cols: Dict[str, np.ndarray]
    psrc: np.ndarray
    ptgt: np.ndarray
    n_ops: np.ndarray  # [D] real (unpadded) op counts
    actors: List[str]
    keys: List[str]
    strings: List[str]
    floats: List[float]
    bigints: List[int]
    op_actor_ids: List[List[str]] = field(default_factory=list)
    doc_actors: Optional[np.ndarray] = None  # [D, A_loc] int32, -1 pad
    slot: Optional[np.ndarray] = None  # [D, N] int16 local actor slots

    @property
    def shape(self) -> Tuple[int, int]:
        return self.cols["action"].shape  # (D, N)

    @property
    def n_docs(self) -> int:
        return self.shape[0]

    @property
    def n_rows(self) -> int:
        return self.shape[1]


def causal_sort(changes: Sequence[Change]) -> List[Change]:
    """Deduplicate by (actor, seq) and sort into a causal linear order.

    (start_op, actor) is a valid linear extension: if X depends on Y then
    X.start_op > Y.max_op >= Y.start_op (lamport assignment in
    OpSet.apply_local_request)."""
    seen = {}
    for c in changes:
        seen.setdefault((c.actor, c.seq), c)
    return sorted(seen.values(), key=lambda c: (c.start_op, c.actor))


def pack_docs(
    docs_changes: Sequence[Sequence[Change]],
    n_rows: Optional[int] = None,
    n_pred: Optional[int] = None,
) -> ColumnarBatch:
    """Pack many documents' histories into one padded batch."""
    actor_ids = _Interner()
    key_ids = _Interner()
    str_ids = _Interner()
    float_ids = _Interner()
    big_ids = _Interner()

    per_doc: List[Tuple[Dict[str, List[int]], List[Tuple[int, int]]]] = []
    for changes in docs_changes:
        per_doc.append(
            _pack_one(
                causal_sort(changes), actor_ids, key_ids, str_ids, float_ids,
                big_ids,
            )
        )

    # Device kernels tie-break concurrent ops by actor *index* (the
    # composite ctr*A + actor); the host OpSet tie-breaks by actor *string*
    # (OpId ordering). Remap indices so index order == string sort order.
    sorted_actors = sorted(actor_ids.items)
    lut = np.zeros(max(len(actor_ids.items), 1), dtype=np.int32)
    for old, name in enumerate(actor_ids.items):
        lut[old] = sorted_actors.index(name)
    for doc_cols, _ in per_doc:
        doc_cols["actor"] = [int(lut[a]) for a in doc_cols["actor"]]
    actor_ids.items = sorted_actors

    max_ops = max((len(d[0]["action"]) for d in per_doc), default=0)
    max_preds = max((len(d[1]) for d in per_doc), default=0)
    N = n_rows if n_rows is not None else _round_up(max(max_ops, 1))
    P = n_pred if n_pred is not None else _round_up(max(max_preds, 1))
    if max_ops > N or max_preds > P:
        raise ValueError(
            f"doc exceeds bucket: ops {max_ops}>{N} or preds {max_preds}>{P}"
        )

    D = len(per_doc)
    cols = {name: np.full((D, N), 0, dtype=np.int32) for name in COLUMNS}
    cols["action"][:] = PAD
    cols["obj"][:] = -1
    cols["key"][:] = -1
    cols["ref"][:] = -3
    psrc = np.full((D, P), -1, dtype=np.int32)
    ptgt = np.full((D, P), -1, dtype=np.int32)
    n_ops = np.zeros((D,), dtype=np.int32)

    doc_actor_sets: List[List[int]] = []
    for d, (doc_cols, preds) in enumerate(per_doc):
        n = len(doc_cols["action"])
        n_ops[d] = n
        for name in COLUMNS:
            cols[name][d, :n] = doc_cols[name]
        for k, (s, t) in enumerate(preds):
            psrc[d, k] = s
            ptgt[d, k] = t
        doc_actor_sets.append(sorted(set(doc_cols["actor"])))

    return ColumnarBatch(
        cols=cols,
        psrc=psrc,
        ptgt=ptgt,
        n_ops=n_ops,
        actors=list(actor_ids.items),
        keys=list(key_ids.items),
        strings=list(str_ids.items),
        floats=list(float_ids.items),
        bigints=list(big_ids.items),
        doc_actors=pack_doc_actor_map(doc_actor_sets),
    )


def pack_doc_actor_map(doc_actor_sets: Sequence[Sequence[int]]) -> np.ndarray:
    """[D, A_loc] int32 local actor map from per-doc ascending actor-index
    lists; -1 pads. A_loc = max actors in any one doc (min 1)."""
    D = len(doc_actor_sets)
    a_loc = max((len(s) for s in doc_actor_sets), default=1)
    out = np.full((D, max(a_loc, 1)), -1, np.int32)
    for d, s in enumerate(doc_actor_sets):
        out[d, : len(s)] = s
    return out


def round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


_round_up = round_up_pow2


def doc_actor_map_from_pairs(
    pairs: np.ndarray, A: int, Dp: int
) -> np.ndarray:
    """[Dp, A_loc] local actor map from sorted unique (doc*A + actor)
    composites; ascending within a doc (== actor-string sort order when
    actor indices index a sorted actor table), -1 pads."""
    pair_doc = pairs // A
    pair_counts = np.bincount(pair_doc, minlength=Dp).astype(np.int64)
    A_loc = int(pair_counts.max(initial=1))
    pair_starts = np.zeros(Dp + 1, np.int64)
    np.cumsum(pair_counts, out=pair_starts[1:])
    out = np.full(Dp * max(A_loc, 1), -1, np.int32)
    slot = np.arange(len(pairs), dtype=np.int64) - pair_starts[pair_doc]
    out[pair_doc * A_loc + slot] = (pairs % A).astype(np.int32)
    return out.reshape(Dp, max(A_loc, 1))


def _encode_op_row(
    op,
    opid: OpId,
    change: Change,
    row_of: Dict[OpId, int],
    actor_ids: _Interner,
    key_ids: _Interner,
    str_ids: _Interner,
    float_ids: _Interner,
    big_ids: _Interner,
) -> Optional[Tuple[Dict[str, int], List[int]]]:
    """Resolve + encode ONE op as ({column: value}, pred target rows).
    None when the op drops (unknown container/element/INC target — the
    OpSet tolerance)."""
    if op.obj == ROOT:
        obj_row = -1
    else:
        obj_row = row_of.get(op.obj, -4)
        if obj_row == -4:
            return None  # container unknown (tolerate, like OpSet)
    if op.action == Action.INC:
        target = op.pred[0] if op.pred else None
        ref_row = row_of.get(target, -3) if target else -3
        if ref_row == -3:
            return None
    elif op.ref is None:
        ref_row = -3
    elif op.ref == HEAD:
        ref_row = -2
    else:
        ref_row = row_of.get(op.ref, -4)
        if ref_row == -4:
            return None  # unknown element
    vkind, value = _encode_value(op, str_ids, float_ids, big_ids)
    vals = {
        "action": int(op.action),
        "actor": actor_ids(change.actor),
        "ctr": opid.ctr,
        "seq": change.seq,
        "obj": obj_row,
        "key": key_ids(op.key) if op.key is not None else -1,
        "ref": ref_row,
        "insert": 1 if op.insert else 0,
        "vkind": vkind,
        "value": value,
        "dt": (
            1 if op.datatype == "counter"
            else 2 if op.datatype == "timestamp" else 0
        ),
    }
    pred_tgts: List[int] = []
    if op.action != Action.INC:
        for p in op.pred:
            tgt = row_of.get(p)
            if tgt is not None:
                pred_tgts.append(tgt)
    return vals, pred_tgts


def _pack_one(
    changes: List[Change],
    actor_ids: _Interner,
    key_ids: _Interner,
    str_ids: _Interner,
    float_ids: _Interner,
    big_ids: _Interner,
) -> Tuple[Dict[str, List[int]], List[Tuple[int, int]]]:
    cols: Dict[str, List[int]] = {name: [] for name in COLUMNS}
    preds: List[Tuple[int, int]] = []
    row_of: Dict[OpId, int] = {}
    row = 0
    for change in changes:
        for i, op in enumerate(change.ops):
            opid = change.op_id(i)
            enc = _encode_op_row(
                op, opid, change, row_of,
                actor_ids, key_ids, str_ids, float_ids, big_ids,
            )
            if enc is None:
                continue
            vals, pred_tgts = enc
            for name in COLUMNS:
                cols[name].append(vals[name])
            for tgt in pred_tgts:
                preds.append((row, tgt))
            row_of[opid] = row
            row += 1
    return cols, preds


def _encode_value(op, str_ids, float_ids, big_ids) -> Tuple[int, int]:
    v = op.value
    if op.action.makes_object or v is None:
        return VK_NONE, 0
    if isinstance(v, bool):
        return VK_BOOL, 1 if v else 0
    if isinstance(v, int):
        if _INT32_MIN <= v <= _INT32_MAX:
            return VK_INT, v
        return VK_BIGINT, big_ids(v)
    if isinstance(v, float):
        return VK_FLOAT, float_ids(v)
    if isinstance(v, str):
        return VK_STR, str_ids(v)
    # fallthrough: non-scalar payloads shouldn't occur (containers are MAKE
    # ops); encode their repr so nothing crashes
    return VK_STR, str_ids(repr(v))


def decode_value(
    vkind: int, value: int, dt: int, batch: ColumnarBatch
) -> Any:
    if vkind == VK_NONE:
        return None
    if vkind == VK_INT:
        return int(value)
    if vkind == VK_BOOL:
        return bool(value)
    if vkind == VK_FLOAT:
        return batch.floats[value]
    if vkind == VK_STR:
        return batch.strings[value]
    if vkind == VK_BIGINT:
        return batch.bigints[value]
    raise ValueError(f"bad vkind {vkind}")
