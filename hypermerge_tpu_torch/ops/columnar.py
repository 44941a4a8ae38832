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
from typing import (
    Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple,
)

import numpy as np

from ..crdt.change import HEAD, ROOT, Action, Change, OpId
from ..device import DeviceLike, resolve
from ..storage.colcache import OBJ_ROOT, PLANE_NAMES, REF_HEAD, REF_NONE

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

# pad-cell values of the padded [D, N] columns (0 for the others)
COL_DEFAULTS = {"action": PAD, "obj": -1, "key": -1, "ref": REF_NONE}


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


class SlabLanes(NamedTuple):
    """The slab launch's lanes where the prefix pack left them, on its
    device: flags = action | insert << 3 (uint8), slot (int8 zeros: one
    writer a doc), ctr / seq / obj / ref in the row type, key in the key
    type and value int32, each [Dp, N]. The dispatch reads them in place
    (ops/crdt_kernels.py `handoff_args`)."""

    flags: Any
    slot: Any
    ctr: Any
    seq: Any
    obj: Any
    key: Any
    ref: Any
    value: Any


@dataclass
class ColumnarBatch:
    """[D, N] padded op columns + [D, P] pred edges + side tables.

    `doc_actors` is the per-doc local actor map: [D, A_loc] int32
    indices into `actors`, ascending (== actor-string sort order, the
    device tie-break), padded with -1. The device kernels only ever see
    A_loc (max actors per doc, a small constant) — never the batch-wide
    actor count — so the jit bucket and the [D, A_loc] clock output stay
    independent of how many documents share a slab.

    `cols` is a mapping of host [D, N] columns: a dict, or the prefix
    pack's `pack_kernels.HostPlanes`, whose reads wait for the planes'
    copy to the host. That pack also gives the batch its shape (`dims`),
    its launch lanes on the device (`lanes`) and the ranges it folded
    there (`ranges`: vmin, vmax, ctr_max, seq_max, n_inc), so that the
    dispatch reads no host column."""

    cols: Mapping[str, np.ndarray]
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
    dims: Optional[Tuple[int, int]] = None  # (D, N), when given outright
    lanes: Optional[SlabLanes] = None
    ranges: Optional[Dict[str, int]] = None

    @property
    def shape(self) -> Tuple[int, int]:
        if self.dims is not None:
            return self.dims
        return self.cols["action"].shape  # (D, N)

    def has_inc(self) -> bool:
        """Whether any row is an INC op: from the pack's ranges where it
        folded them, else from the action column."""
        if self.ranges is not None:
            return self.ranges["n_inc"] > 0
        return bool(np.any(self.cols["action"] == int(Action.INC)))

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
    cols = {
        name: np.full((D, N), COL_DEFAULTS.get(name, 0), dtype=np.int32)
        for name in COLUMNS
    }
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


# ---------------------------------------------------------------------------
# vectorized bulk packing from columnar feed caches (storage/colcache.py)
#
# The per-op Python loop above (`pack_docs`) is the correctness reference;
# this path packs the same batch from FeedColumns sidecars with numpy only:
# window slicing by searchsorted, one flat causal argsort across all docs,
# and OpId -> row resolution via a sorted composite-key lookup. The
# dominant cold-open shape (one single-writer feed per doc, whole-prefix
# windows) takes a no-sort fast path whose padded-plane emit is the CUDA
# kernel of ops/pack_kernels.py.


def _prefix_single_ok(fc) -> bool:
    """True if a feed qualifies for the no-sort prefix pack: every op's
    container/element/pred references stay inside the feed (single-writer
    history), and ctr is strictly increasing (commit order == causal
    order). Cached on the FeedColumns object (an idempotent latch: racing
    callers compute the same bool from immutable planes)."""
    ok = getattr(fc, "_prefix_single_ok", None)
    if ok is None:
        n = fc.n_rows
        ctr = fc.plane("ctr")
        ok = bool(
            np.all(fc.plane("obj_a") <= 0)  # obj actor: ROOT or writer
            and np.all(fc.plane("ref_a") <= 0)  # writer or sentinel
            # dense lamport counters: row i is op ctr i+1, so references
            # resolve as ctr-1 with no search
            and np.array_equal(
                ctr, np.arange(1, n + 1, dtype=ctr.dtype)
            )
            and (len(fc.preds) == 0 or np.all(fc.preds[:, 2] == 0))
        )
        fc._prefix_single_ok = ok
    return ok


# source planes of the prefix pack, in the order the pack kernel takes them
_PACK_SRC_PLANES = (
    "action", "ctr", "seq", "obj_ctr", "obj_a", "key",
    "ref_ctr", "ref_a", "insert", "vkind", "value", "dt",
)

_pack_src_idx_cache: Optional[np.ndarray] = None


def _pack_src_idx() -> np.ndarray:
    """Indices of the pack's source planes within the sidecar's
    PLANE_NAMES order (the columns of a feed's [n, ROW_FIELDS] rows).
    Compute-local, then one GIL-atomic assignment publishes."""
    global _pack_src_idx_cache
    got = _pack_src_idx_cache
    if got is None:
        got = np.asarray(
            [PLANE_NAMES.index(n) for n in _PACK_SRC_PLANES], np.int64
        )
        _pack_src_idx_cache = got
    return got


def _pack_wire_dtypes(i16ok, row_dt, kdt, vmin, vmax):
    return {
        "action": np.uint8,
        "insert": np.uint8,
        "vkind": np.uint8,
        "dt": np.uint8,
        "actor": np.int32,  # batch-global ids (host/decode only)
        "ctr": row_dt,
        "seq": row_dt,
        "obj": row_dt,
        "key": kdt,
        "ref": row_dt,
        "value": (
            np.int16
            if i16ok and -(2**15) <= vmin and vmax < 2**15
            else np.int32
        ),
    }


def _try_pack_prefix_single(
    doc_specs, n_rows, n_pred, n_docs, device
) -> Optional[ColumnarBatch]:
    """Fast pack for the dominant cold-open shape: one single-writer feed
    per doc, whole-prefix windows. Rows are already in causal order (ctr
    ascending) and every reference resolves within the prefix (causal
    lamport property: a referenced op always has a smaller ctr), so this
    path needs ZERO sorts and no drop fixpoint — the general path's two
    M-sized argsorts and composite-key resolution collapse into one
    searchsorted over an already-sorted key.

    The padded-plane emit is `pack_kernels.device_pack_prefix`: the CUDA
    kernel on `device` "cuda", its plain PyTorch version on "cpu". The
    batch carries its shape, the slab launch's lanes where the kernel
    left them and the ranges it folded; its host planes come down behind
    the call (`HostPlanes`). None when the specs do not have this
    shape."""
    for spec in doc_specs:
        if len(spec) != 1:
            return None
        fc, s, _e = spec[0]
        if s != 0 or not _prefix_single_ok(fc):
            return None

    D = len(doc_specs)
    Dp = max(n_docs, D) if n_docs is not None else D

    fcs: List[Any] = []
    fc_idx: List[int] = []
    fc_of: Dict[int, int] = {}
    ends = np.zeros(D, np.int64)  # prefix row counts
    for d, spec in enumerate(doc_specs):
        fc, _s, e = spec[0]
        i = fc_of.get(id(fc))
        if i is None:
            i = fc_of[id(fc)] = len(fcs)
            fcs.append(fc)
        fc_idx.append(i)
        ends[d] = fc.window(0, e)[1]

    # -- global tables (same interning as the general path). Feeds
    # instantiated from shared templates carry IDENTICAL local tables,
    # so the per-item interning loop memoizes on the table tuple — the
    # global id sequence is unchanged (a memo hit means every item was
    # already interned, in the same order).
    actor_int = _Interner()
    key_int = _Interner()
    str_int = _Interner()
    float_int = _Interner()
    big_int = _Interner()
    luts = {"k": [], "s": [], "f": [], "b": []}
    writers: List[int] = []
    lut_memo: Dict[Any, np.ndarray] = {}

    def lut_of(kind, interner, items):
        key = (kind, tuple(items))
        got = lut_memo.get(key)
        if got is None:
            got = np.asarray([interner(x) for x in items], np.int64)
            lut_memo[key] = got
        return got

    writer_memo: Dict[Any, int] = {}
    for fc in fcs:
        akey = tuple(fc.actors)
        w = writer_memo.get(akey)
        if w is None:
            for x in fc.actors:
                actor_int(x)
            w = actor_int(fc.actors[0]) if fc.actors else 0
            writer_memo[akey] = w
        writers.append(w)
        luts["k"].append(lut_of("k", key_int, fc.keys))
        luts["s"].append(lut_of("s", str_int, fc.strings))
        luts["f"].append(lut_of("f", float_int, fc.floats))
        luts["b"].append(lut_of("b", big_int, fc.bigints))
    sorted_actors = sorted(actor_int.items)
    rank_of = {name: i for i, name in enumerate(sorted_actors)}
    arank = np.asarray(
        [rank_of[a] for a in actor_int.items], np.int64
    )
    writer_g = (
        arank[np.asarray(writers, np.int64)]
        if writers
        else np.zeros(0, np.int64)
    )

    M = int(ends.sum())
    if M == 0:
        N = n_rows if n_rows is not None else 1
        P = n_pred if n_pred is not None else 1
        return _empty_batch(
            Dp, N, P, sorted_actors, key_int, str_int, float_int, big_int
        )

    fc_idx_a = np.asarray(fc_idx, np.int64)

    # -- preds ----------------------------------------------------------
    pr_docs_l: List[int] = []
    pr_cnt_l: List[int] = []
    pr_rows: List[np.ndarray] = []
    for d in range(D):
        fc = fcs[fc_idx[d]]
        n_pr = len(fc.preds)
        if not n_pr:
            continue
        e = int(ends[d])
        phi = (
            n_pr  # whole-prefix window: every pred src is inside it
            if e >= fc.n_rows
            else int(np.searchsorted(fc.preds[:, 0], e, side="left"))
        )
        if phi:
            pr_rows.append(fc.preds[:phi])
            pr_docs_l.append(d)
            pr_cnt_l.append(phi)
    if pr_rows:
        pred_rows = np.concatenate(pr_rows, axis=0)
        pr_doc = np.repeat(
            np.asarray(pr_docs_l, np.int64), np.asarray(pr_cnt_l, np.int64)
        )
        p_src_row = pred_rows[:, 0].astype(np.int64)  # feed row == doc row
        p_tgt_row = pred_rows[:, 1].astype(np.int64) - 1  # dense ctr -> row
        pred_counts = np.bincount(pr_doc, minlength=Dp).astype(np.int64)
        pred_starts = np.zeros(Dp + 1, np.int64)
        np.cumsum(pred_counts, out=pred_starts[1:])
        p_pos = np.arange(len(pr_doc), dtype=np.int64) - pred_starts[pr_doc]
    else:
        pred_counts = np.zeros(Dp, np.int64)
        p_src_row = p_tgt_row = p_pos = pr_doc = np.zeros(0, np.int64)

    # -- bucket shapes ---------------------------------------------------
    max_ops = int(ends.max(initial=0))
    max_preds = int(pred_counts.max(initial=0))
    N = n_rows if n_rows is not None else _round_up(max(max_ops, 1))
    P = n_pred if n_pred is not None else _round_up(max(max_preds, 1))
    if max_ops > N or max_preds > P:
        raise ValueError(
            f"doc exceeds bucket: ops {max_ops}>{N} or preds {max_preds}>{P}"
        )

    # wire dtypes are a function of the bucket + value ranges, so every
    # slab of a bulk load has the same ones: everything row-indexed fits
    # int16 when N < 32k — the common case — and flags planes fit uint8
    i16ok = N < 2**15
    row_dt = np.int16 if i16ok else np.int32
    kdt = np.int16 if len(key_int.items) < 2**15 else np.int32

    def flat_lut(kind):
        offs = np.zeros(len(fcs) + 1, np.int64)
        for i, l in enumerate(luts[kind]):
            offs[i + 1] = offs[i] + len(l)
        flat = (
            np.concatenate(luts[kind])
            if any(len(l) for l in luts[kind])
            else np.zeros(1, np.int64)
        )
        return flat, offs

    from .pack_kernels import device_pack_prefix

    cols, lanes, ranges = device_pack_prefix(
        fcs, fc_idx, fc_idx_a, ends, writer_g, flat_lut,
        Dp, N, i16ok, row_dt, kdt, device,
    )
    pdt = np.int16 if i16ok else np.int32
    psrc = np.full(Dp * P, -1, pdt)
    ptgt = np.full(Dp * P, -1, pdt)
    if len(p_src_row):
        pidx = pr_doc * P + p_pos
        psrc[pidx] = p_src_row
        ptgt[pidx] = p_tgt_row

    doc_actors = np.full((Dp, 1), -1, np.int32)
    doc_actors[:D, 0] = writer_g.astype(np.int32)[fc_idx_a]
    n_ops = np.zeros(Dp, np.int32)
    n_ops[:D] = ends
    batch = ColumnarBatch(
        cols=cols,
        psrc=psrc.reshape(Dp, P),
        ptgt=ptgt.reshape(Dp, P),
        n_ops=n_ops,
        actors=list(sorted_actors),
        keys=list(key_int.items),
        strings=list(str_int.items),
        floats=list(float_int.items),
        bigints=list(big_int.items),
        doc_actors=doc_actors,
        slot=np.zeros((Dp, N), np.int8),  # single writer: slot 0
        dims=(Dp, N),
        lanes=lanes,
        ranges=ranges,
    )
    return batch


def pack_docs_columns(
    doc_specs: Sequence[Sequence[Tuple[Any, int, float]]],
    n_rows: Optional[int] = None,
    n_pred: Optional[int] = None,
    n_docs: Optional[int] = None,
    device: DeviceLike = None,
) -> ColumnarBatch:
    """Pack documents from columnar feed windows.

    doc_specs[d] = [(FeedColumns, start_seq, end_seq), ...] — one entry
    per actor feed in the doc's cursor; the window is (start_seq,
    end_seq], as a feed's change window. Produces a ColumnarBatch
    equivalent (same device-kernel results and decoded patches) to
    `pack_docs` over the same histories.

    `n_docs` pads the doc axis with empty (all-PAD) documents — slab
    loaders bucket the batch shape so every slab of a load has one shape.

    Single-writer whole-prefix loads (the dominant cold-open shape)
    dispatch to a no-sort fast path whose padded planes come from the
    pack kernel on `device` (None means "cuda"; "cpu" runs its plain
    PyTorch version). Anything else takes the general sorted-composite
    path below, which stays host numpy. The device resolves before the
    route, so without a GPU both paths raise unless device="cpu".
    """
    dev = resolve(device)
    fast = _try_pack_prefix_single(doc_specs, n_rows, n_pred, n_docs, dev)
    if fast is not None:
        return fast

    D = len(doc_specs)
    Dp = max(n_docs, D) if n_docs is not None else D

    # -- global tables + per-feed LUTs ---------------------------------
    fcs: List[Any] = []
    fc_of: Dict[int, int] = {}
    for spec in doc_specs:
        for fc, _s, _e in spec:
            if id(fc) not in fc_of:
                fc_of[id(fc)] = len(fcs)
                fcs.append(fc)

    actor_int = _Interner()
    key_int = _Interner()
    str_int = _Interner()
    float_int = _Interner()
    big_int = _Interner()
    luts = {"a": [], "k": [], "s": [], "f": [], "b": []}
    for fc in fcs:
        luts["a"].append(
            np.asarray([actor_int(x) for x in fc.actors], np.int64)
        )
        luts["k"].append(
            np.asarray([key_int(x) for x in fc.keys], np.int64)
        )
        luts["s"].append(
            np.asarray([str_int(x) for x in fc.strings], np.int64)
        )
        luts["f"].append(
            np.asarray([float_int(x) for x in fc.floats], np.int64)
        )
        luts["b"].append(
            np.asarray([big_int(x) for x in fc.bigints], np.int64)
        )

    # actor index order must equal actor string sort order (device
    # tie-break parity — same remap as pack_docs)
    sorted_actors = sorted(actor_int.items)
    rank_of = {name: i for i, name in enumerate(sorted_actors)}
    arank = np.asarray(
        [rank_of[a] for a in actor_int.items], np.int64
    )
    luts["a"] = [
        arank[l] if len(l) else l for l in luts["a"]
    ]

    def _flat_lut(kind: str) -> Tuple[np.ndarray, np.ndarray]:
        offs = np.zeros(len(fcs) + 1, np.int64)
        for i, l in enumerate(luts[kind]):
            offs[i + 1] = offs[i] + len(l)
        flat = (
            np.concatenate(luts[kind])
            if any(len(l) for l in luts[kind])
            else np.zeros(1, np.int64)
        )
        return flat, offs

    alut, aoffs = _flat_lut("a")
    klut, koffs = _flat_lut("k")
    slut, soffs = _flat_lut("s")
    flut, foffs = _flat_lut("f")
    blut, boffs = _flat_lut("b")

    # -- gather window slices ------------------------------------------
    row_slices: List[np.ndarray] = []
    w_doc: List[int] = []
    w_fc: List[int] = []
    w_cnt: List[int] = []
    pred_slices: List[np.ndarray] = []
    p_doc: List[int] = []
    p_fc: List[int] = []
    p_cnt: List[int] = []
    p_base: List[int] = []
    flat_base = 0
    for d, spec in enumerate(doc_specs):
        seen = set()
        for fc, s, e in spec:
            fci = fc_of[id(fc)]
            if fci in seen:
                continue  # same feed listed twice: one window only
            seen.add(fci)
            lo, hi = fc.window(int(s), e)
            if hi <= lo:
                continue
            row_slices.append(fc.ensure_rows()[lo:hi])
            w_doc.append(d)
            w_fc.append(fci)
            w_cnt.append(hi - lo)
            psrc_col = fc.preds[:, 0]
            plo = int(np.searchsorted(psrc_col, lo, side="left"))
            phi = int(np.searchsorted(psrc_col, hi, side="left"))
            if phi > plo:
                pred_slices.append(fc.preds[plo:phi])
                p_doc.append(d)
                p_fc.append(fci)
                p_cnt.append(phi - plo)
                p_base.append(flat_base - lo)
            flat_base += hi - lo

    M = flat_base
    A = max(1, len(sorted_actors))
    if M == 0:
        N = n_rows if n_rows is not None else 1
        P = n_pred if n_pred is not None else 1
        return _empty_batch(
            Dp, N, P, sorted_actors, key_int, str_int, float_int, big_int
        )

    w_cnt_a = np.asarray(w_cnt, np.int64)
    w_doc_a = np.asarray(w_doc, np.int64)
    w_fc_a = np.asarray(w_fc, np.int64)
    R = np.concatenate(row_slices, axis=0)
    doc_col = np.repeat(w_doc_a, w_cnt_a)
    aoff_col = np.repeat(aoffs[w_fc_a], w_cnt_a)

    action = R[:, 0].astype(np.int64)
    ctr = R[:, 1].astype(np.int64)
    seqc = R[:, 2].astype(np.int64)
    start_op = R[:, 3].astype(np.int64)
    obj_ctr = R[:, 4].astype(np.int64)
    obj_a_l = R[:, 5].astype(np.int64)
    key_l = R[:, 6].astype(np.int64)
    ref_ctr = R[:, 7].astype(np.int64)
    ref_a_l = R[:, 8].astype(np.int64)
    insert = R[:, 9].astype(np.int64)
    vkind = R[:, 10].astype(np.int64)
    value_l = R[:, 11].astype(np.int64)
    dt = R[:, 12].astype(np.int64)

    # writer (op actor) = feed-local actor 0
    writer_g = np.asarray(
        [int(luts["a"][fci][0]) for fci in range(len(fcs))], np.int64
    )
    actor_g = np.repeat(writer_g[w_fc_a], w_cnt_a)

    def _lut_where(cond, lut, idx, alt):
        # np.where evaluates both branches: rows where cond is False
        # carry a sentinel local index (e.g. -1), and a feed whose table
        # is empty but sits at the end of the flat LUT would index one
        # past the end — clamp before gathering, select after.
        safe = np.minimum(np.maximum(idx, 0), len(lut) - 1)
        return np.where(cond, lut[safe], alt)

    obj_a_g = _lut_where(obj_a_l >= 0, alut, aoff_col + obj_a_l, obj_a_l)
    ref_a_g = _lut_where(ref_a_l >= 0, alut, aoff_col + ref_a_l, ref_a_l)
    key_g = _lut_where(
        key_l >= 0, klut, np.repeat(koffs[w_fc_a], w_cnt_a) + key_l, -1
    )
    value_g = value_l.copy()
    for code, lut, offs in (
        (VK_STR, slut, soffs),
        (VK_FLOAT, flut, foffs),
        (VK_BIGINT, blut, boffs),
    ):
        m = vkind == code
        if m.any():
            off_col = np.repeat(offs[w_fc_a], w_cnt_a)
            value_g[m] = lut[off_col[m] + value_l[m]]

    # preds (flat, pre-sort indices for src)
    if pred_slices:
        p_cnt_a = np.asarray(p_cnt, np.int64)
        p_fc_a = np.asarray(p_fc, np.int64)
        pred_rows = np.concatenate(pred_slices, axis=0)
        pr_src = pred_rows[:, 0].astype(np.int64) + np.repeat(
            np.asarray(p_base, np.int64), p_cnt_a
        )
        pr_tgt_ctr = pred_rows[:, 1].astype(np.int64)
        pr_aoff = np.repeat(aoffs[p_fc_a], p_cnt_a)
        pr_tgt_a = alut[pr_aoff + pred_rows[:, 2].astype(np.int64)]
        pr_doc = np.repeat(np.asarray(p_doc, np.int64), p_cnt_a)
    else:
        pr_src = pr_tgt_ctr = pr_tgt_a = pr_doc = np.zeros(0, np.int64)

    # -- composite key bit budget --------------------------------------
    ab = max(1, int(A - 1).bit_length())
    max_ctr = int(
        max(ctr.max(initial=0), obj_ctr.max(initial=0),
            ref_ctr.max(initial=0),
            int(pr_tgt_ctr.max(initial=0)))
    )
    cb = max(1, max_ctr.bit_length())
    db = max(1, int(Dp - 1).bit_length())
    if db + cb + ab > 62:
        raise ValueError(
            f"composite key overflow: docs={Dp} ctr={max_ctr} actors={A}"
        )

    def _rowkey(doc, c, a):
        return (doc << (cb + ab)) | (c << ab) | a

    need_obj = obj_a_l >= 0
    need_ref = ref_a_l >= 0

    def _resolve(rk_sorted, order_rk, q_doc, q_ctr, q_a):
        q = _rowkey(q_doc, q_ctr, np.maximum(q_a, 0))
        pos = np.searchsorted(rk_sorted, q)
        pos_c = np.minimum(pos, len(rk_sorted) - 1)
        hit = rk_sorted[pos_c] == q
        return order_rk[pos_c], hit

    # validity fixpoint: an op drops if its container or referenced
    # element is absent from the packed window (matches _pack_one's
    # incremental row_of misses, including the cascade)
    rk = _rowkey(doc_col, ctr, actor_g)
    order_rk = np.argsort(rk)
    rk_sorted = rk[order_rk]
    obj_tgt, obj_hit = _resolve(rk_sorted, order_rk, doc_col, obj_ctr, obj_a_g)
    ref_tgt, ref_hit = _resolve(rk_sorted, order_rk, doc_col, ref_ctr, ref_a_g)
    valid = np.ones(M, bool)
    while True:
        bad = (
            (need_obj & (~obj_hit | ~valid[obj_tgt]))
            | (need_ref & (~ref_hit | ~valid[ref_tgt]))
        ) & valid
        if not bad.any():
            break
        valid[bad] = False

    if not valid.all():
        keep = valid
        (
            action, ctr, seqc, start_op, obj_ctr, obj_a_g, key_g,
            ref_ctr, ref_a_g, insert, vkind, value_g, dt, actor_g,
            doc_col, need_obj, need_ref,
        ) = (
            x[keep]
            for x in (
                action, ctr, seqc, start_op, obj_ctr, obj_a_g, key_g,
                ref_ctr, ref_a_g, insert, vkind, value_g, dt, actor_g,
                doc_col, need_obj, need_ref,
            )
        )
        # remap pred srcs through the compaction
        new_idx = np.cumsum(valid) - 1
        if len(pr_src):
            pk = valid[pr_src]
            pr_src = new_idx[pr_src[pk]]
            pr_tgt_ctr = pr_tgt_ctr[pk]
            pr_tgt_a = pr_tgt_a[pk]
            pr_doc = pr_doc[pk]
        M = len(action)
        if M == 0:
            N = n_rows if n_rows is not None else 1
            P = n_pred if n_pred is not None else 1
            return _empty_batch(
                Dp, N, P, sorted_actors, key_int, str_int, float_int,
                big_int,
            )
        rk = _rowkey(doc_col, ctr, actor_g)
        order_rk = np.argsort(rk)
        rk_sorted = rk[order_rk]
        obj_tgt, obj_hit = _resolve(
            rk_sorted, order_rk, doc_col, obj_ctr, obj_a_g
        )
        ref_tgt, ref_hit = _resolve(
            rk_sorted, order_rk, doc_col, ref_ctr, ref_a_g
        )

    # -- causal order + within-doc positions ---------------------------
    sort_key = _rowkey(doc_col, start_op, actor_g)
    perm = np.argsort(sort_key, kind="stable")
    inv = np.empty(M, np.int64)
    inv[perm] = np.arange(M, dtype=np.int64)
    doc_counts = np.bincount(doc_col, minlength=Dp).astype(np.int64)
    doc_starts = np.zeros(Dp + 1, np.int64)
    np.cumsum(doc_counts, out=doc_starts[1:])
    pos = inv - doc_starts[doc_col]

    obj_row = np.where(need_obj, pos[obj_tgt], OBJ_ROOT)
    ref_row = np.where(
        need_ref,
        pos[ref_tgt],
        np.where(ref_a_l_compact(ref_a_g) == REF_HEAD, REF_HEAD, REF_NONE),
    )

    # -- pred edges -> per-doc rows ------------------------------------
    if len(pr_src):
        tgt_row, tgt_hit = _resolve(
            rk_sorted, order_rk, pr_doc, pr_tgt_ctr, pr_tgt_a
        )
        pk = tgt_hit
        pr_doc = pr_doc[pk]
        p_src_row = pos[pr_src[pk]]
        p_tgt_row = pos[tgt_row[pk]]
        pred_counts = np.bincount(pr_doc, minlength=Dp).astype(np.int64)
        pred_starts = np.zeros(Dp + 1, np.int64)
        np.cumsum(pred_counts, out=pred_starts[1:])
        # pr_doc is nondecreasing (windows gathered doc-by-doc; the
        # validity compaction preserves order)
        p_pos = np.arange(len(pr_doc), dtype=np.int64) - pred_starts[pr_doc]
    else:
        pred_counts = np.zeros(Dp, np.int64)
        p_src_row = p_tgt_row = p_pos = pr_doc = np.zeros(0, np.int64)

    # -- scatter into padded [D, N] ------------------------------------
    max_ops = int(doc_counts.max(initial=0))
    max_preds = int(pred_counts.max(initial=0))
    N = n_rows if n_rows is not None else _round_up(max(max_ops, 1))
    P = n_pred if n_pred is not None else _round_up(max(max_preds, 1))
    if max_ops > N or max_preds > P:
        raise ValueError(
            f"doc exceeds bucket: ops {max_ops}>{N} or preds {max_preds}>{P}"
        )

    flat_idx = doc_col * N + pos
    cols: Dict[str, np.ndarray] = {}
    sources = {
        "action": action, "actor": actor_g, "ctr": ctr, "seq": seqc,
        "obj": obj_row, "key": key_g, "ref": ref_row, "insert": insert,
        "vkind": vkind, "value": value_g, "dt": dt,
    }
    for name in COLUMNS:
        flat = np.full(Dp * N, COL_DEFAULTS.get(name, 0), np.int32)
        flat[flat_idx] = sources[name].astype(np.int32)
        cols[name] = flat.reshape(Dp, N)
    psrc = np.full(Dp * P, -1, np.int32)
    ptgt = np.full(Dp * P, -1, np.int32)
    if len(p_src_row):
        pidx = pr_doc * P + p_pos
        psrc[pidx] = p_src_row.astype(np.int32)
        ptgt[pidx] = p_tgt_row.astype(np.int32)

    # per-doc local actor map (ascending == string sort order: actor_g
    # indexes sorted_actors)
    doc_actors = doc_actor_map_from_pairs(
        np.unique(doc_col * np.int64(A) + actor_g), A, Dp
    )

    return ColumnarBatch(
        cols=cols,
        psrc=psrc.reshape(Dp, P),
        ptgt=ptgt.reshape(Dp, P),
        n_ops=doc_counts.astype(np.int32),
        actors=list(sorted_actors),
        keys=list(key_int.items),
        strings=list(str_int.items),
        floats=list(float_int.items),
        bigints=list(big_int.items),
        doc_actors=doc_actors,
    )


def ref_a_l_compact(ref_a_g: np.ndarray) -> np.ndarray:
    """Sentinels (-2 HEAD / -3 none) pass through the global remap
    unchanged; this just names that fact at the use site."""
    return ref_a_g



def _empty_batch(
    D: int, N: int, P: int, actors, key_int, str_int, float_int, big_int
) -> ColumnarBatch:
    cols = {
        name: np.full((D, N), COL_DEFAULTS.get(name, 0), np.int32)
        for name in COLUMNS
    }
    return ColumnarBatch(
        cols=cols,
        psrc=np.full((D, P), -1, np.int32),
        ptgt=np.full((D, P), -1, np.int32),
        n_ops=np.zeros(D, np.int32),
        actors=list(actors),
        keys=list(key_int.items),
        strings=list(str_int.items),
        floats=list(float_int.items),
        bigints=list(big_int.items),
        doc_actors=np.full((D, 1), -1, np.int32),
    )


# ---------------------------------------------------------------------------
# appendable per-doc packed columns (the live apply engine's cache)


class LiveColumns:
    """ONE document's packed op history, appendable in place.

    The live apply engine (backend/live.py) keeps each hot doc's packed
    columns host-pinned: incoming changes append rows at the tail (no
    feed IO, no repack of the prefix), and each tick stacks dirty docs'
    columns into a padded [D, N] batch for the materialize kernel.

    Row encoding is `_pack_one`'s, with persistent state: `row_of`
    resolves obj/ref/pred references across appends, the interners are
    per-DOC (the kernels never read table *contents*, only group by
    index — so no batch-global remap is ever needed), and unresolvable
    ops drop exactly as `_pack_one` drops them (the OpSet tolerance).

    Row order is arrival order, NOT the causal linear order `pack_docs`
    emits. The kernels are row-order-independent (winners come from
    lexsorts over (group, lamport) keys, RGA order from explicit parent
    pointers), so appending at the tail is always sound; only consumers
    that assume causally-sorted rows (none on the live path) may not
    read these columns.

    Actor column values are intern indices; `slots()` maps them through
    the string-sort rank LUT the kernels tie-break by (recomputed only
    when a new actor joins).
    """

    _INIT_CAP = 64

    def __init__(self) -> None:
        self.n = 0
        self.n_preds = 0
        self.cols: Dict[str, np.ndarray] = {
            name: np.full(self._INIT_CAP, COL_DEFAULTS.get(name, 0), np.int32)
            for name in COLUMNS
        }
        self.psrc = np.full(self._INIT_CAP, -1, np.int32)
        self.ptgt = np.full(self._INIT_CAP, -1, np.int32)
        self.actors = _Interner()
        self.keys = _Interner()
        self.strings = _Interner()
        self.floats = _Interner()
        self.bigints = _Interner()
        self.row_of: Dict[OpId, int] = {}
        self.opids: List[OpId] = []  # row -> OpId (append-only, so the
        # per-tick decoders reuse it instead of rebuilding O(n) objects)
        self._rank_lut: Optional[np.ndarray] = None

    @classmethod
    def from_batch(cls, batch: ColumnarBatch, d: int = 0) -> "LiveColumns":
        """Adopt one doc's rows out of a packed batch (bulk-loaded docs
        enter the live engine through this — their history is already
        packed, so adoption is a column copy plus the row_of index)."""
        lv = cls()
        n = int(batch.n_ops[d])
        lv._reserve_rows(n)
        for name in COLUMNS:
            lv.cols[name][:n] = batch.cols[name][d, :n]
        lv.n = n
        keep = np.asarray(batch.psrc[d]) >= 0
        srcs = np.asarray(batch.psrc[d])[keep].astype(np.int32)
        tgts = np.asarray(batch.ptgt[d])[keep].astype(np.int32)
        lv._reserve_preds(len(srcs))
        lv.psrc[: len(srcs)] = srcs
        lv.ptgt[: len(tgts)] = tgts
        lv.n_preds = len(srcs)
        for a in batch.actors:
            lv.actors(a)
        for k in batch.keys:
            lv.keys(k)
        for s in batch.strings:
            lv.strings(s)
        for f in batch.floats:
            lv.floats(f)
        for b in batch.bigints:
            lv.bigints(b)
        ctr = batch.cols["ctr"][d, :n].tolist()
        acts = batch.cols["actor"][d, :n]
        actors = batch.actors
        if n and int(acts.min()) == int(acts.max()):
            # single-writer doc (the dominant bulk shape): one actor
            # lookup for the whole column
            writer = actors[int(acts[0])]
            lv.opids = [OpId(c, writer) for c in ctr]
        else:
            names = [actors[a] for a in acts.tolist()]
            lv.opids = list(map(OpId, ctr, names))
        lv.row_of = dict(zip(lv.opids, range(n)))
        return lv

    # -- appends --------------------------------------------------------

    def append_changes(self, changes: Sequence[Change]) -> None:
        """Append already-admitted changes (caller enforces causal
        order + dedup — the live engine's admission mirror of OpSet)."""
        for change in changes:
            self._append_one(change)

    def _append_one(self, change: Change) -> None:
        row_of = self.row_of
        for i, op in enumerate(change.ops):
            opid = change.op_id(i)
            n_actors = len(self.actors.items)
            enc = _encode_op_row(
                op, opid, change, row_of,
                self.actors, self.keys, self.strings, self.floats,
                self.bigints,
            )
            if enc is None:
                continue
            if len(self.actors.items) != n_actors:
                self._rank_lut = None  # new actor: ranks shift
            vals, pred_tgts = enc
            row = self.n
            self._reserve_rows(row + 1)
            c = self.cols
            for name in COLUMNS:
                c[name][row] = vals[name]
            for tgt in pred_tgts:
                k = self.n_preds
                self._reserve_preds(k + 1)
                self.psrc[k] = row
                self.ptgt[k] = tgt
                self.n_preds = k + 1
            row_of[opid] = row
            self.opids.append(opid)
            self.n = row + 1

    def _reserve_rows(self, n: int) -> None:
        cap = len(self.cols["action"])
        if n <= cap:
            return
        new_cap = round_up_pow2(n)
        for name in COLUMNS:
            grown = np.full(new_cap, COL_DEFAULTS.get(name, 0), np.int32)
            grown[: self.n] = self.cols[name][: self.n]
            self.cols[name] = grown

    def _reserve_preds(self, n: int) -> None:
        cap = len(self.psrc)
        if n <= cap:
            return
        new_cap = round_up_pow2(n)
        for attr in ("psrc", "ptgt"):
            grown = np.full(new_cap, -1, np.int32)
            grown[: self.n_preds] = getattr(self, attr)[: self.n_preds]
            setattr(self, attr, grown)

    # -- kernel views ---------------------------------------------------

    @property
    def actor_rank(self) -> np.ndarray:
        """LUT: actor intern index -> string-sort rank (the kernel's
        tie-break order)."""
        if self._rank_lut is None or len(self._rank_lut) != max(
            1, len(self.actors.items)
        ):
            order = sorted(
                range(len(self.actors.items)),
                key=lambda i: self.actors.items[i],
            )
            lut = np.zeros(max(1, len(self.actors.items)), np.int32)
            for rank, idx in enumerate(order):
                lut[idx] = rank
            self._rank_lut = lut
        return self._rank_lut

    def slots(self) -> np.ndarray:
        """[n] int32 actor slots in string-sort rank order."""
        return self.actor_rank[self.cols["actor"][: self.n]]

    def opid(self, row: int) -> OpId:
        return OpId(
            int(self.cols["ctr"][row]),
            self.actors.items[int(self.cols["actor"][row])],
        )

    def decode_row_value(self, row: int) -> Any:
        return decode_live_value(
            int(self.cols["vkind"][row]),
            int(self.cols["value"][row]),
            self,
        )

    def decode_values(self, rows: np.ndarray) -> List[Any]:
        """Decoded Python values for the given row indices — the batch
        twin of `decode_row_value`, vectorized by value kind (one
        nonzero + one tight fixup pass per kind present instead of a
        per-row Python call). The live decode's value hot path."""
        vk = self.cols["vkind"][rows]
        out: List[Any] = self.cols["value"][rows].tolist()
        if not out:
            return out
        # VK_INT rows are already right (tolist yields Python ints);
        # patch the other kinds in place
        m = vk == VK_NONE
        if m.any():
            for i in np.nonzero(m)[0].tolist():
                out[i] = None
        m = vk == VK_BOOL
        if m.any():
            for i in np.nonzero(m)[0].tolist():
                out[i] = bool(out[i])
        for code, table in (
            (VK_FLOAT, self.floats.items),
            (VK_STR, self.strings.items),
            (VK_BIGINT, self.bigints.items),
        ):
            m = vk == code
            if m.any():
                for i in np.nonzero(m)[0].tolist():
                    out[i] = table[out[i]]
        return out

    @property
    def nbytes(self) -> int:
        """Resident host bytes of this doc's live cache: the packed
        numpy planes plus an estimate of the opids/row_of index
        structures (~one OpId tuple + two dict/list slots per row).
        What the live engine's byte-bounded LRU charges a hot doc."""
        b = self.psrc.nbytes + self.ptgt.nbytes
        for a in self.cols.values():
            b += a.nbytes
        return b + len(self.opids) * 144


def decode_live_value(vkind: int, value: int, lv: "LiveColumns") -> Any:
    if vkind == VK_NONE:
        return None
    if vkind == VK_INT:
        return int(value)
    if vkind == VK_BOOL:
        return bool(value)
    if vkind == VK_FLOAT:
        return lv.floats.items[value]
    if vkind == VK_STR:
        return lv.strings.items[value]
    if vkind == VK_BIGINT:
        return lv.bigints.items[value]
    raise ValueError(f"bad vkind {vkind}")


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
