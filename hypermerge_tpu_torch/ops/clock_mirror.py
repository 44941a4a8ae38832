"""DeviceClockMirror — the ClockStore's device-resident query twin; the
port of hypermerge_tpu/ops/clock_mirror.py.

The reference answers bulk clock queries by scanning sqlite rows per
call (reference src/ClockStore.ts:63-72 getMultiple + Clock.ts folds).
The mirror keeps the whole [docs, actors] clock matrix RESIDENT in device
memory and applies writes as small batched scatter-max updates, so the
hot bulk queries — union across all docs, domination against a cursor,
top-k covered docs — read nothing from the host beyond the query vector:

- writes buffer host-side (dict of (row, col) -> seq, monotonic max)
  and flush lazily as ONE scatter-max (clock_scatter.cu) right before the
  next query — interactive writes never pay a device round trip;
- union() with writes pending runs the scatter and the column max
  (clock_union.cu) back to back on one stream, with no host sync between
  them, and reads back [actors];
- dominated() is one pairwise gte (clock_pair.cu) of the query row,
  broadcast in place, against the matrix; top_k_dominated() is
  clock_topk.cu;
- capacity grows by pow2 doubling on either axis (device-side pad);
- seqs clamp to INT32_INF like the rest of the clock kernels.

The matrix is a torch int32 tensor on the device resolved at
construction (cuda unless `device="cpu"`, where the plain versions run);
it is allocated at first use, so attaching a mirror costs no device work
until the first query. The port owns its matrix and updates it in place.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..analysis.lockdep import make_rlock
from ..device import DeviceLike, resolve
from . import clock_kernels as K
from .columnar import round_up_pow2 as _pow2

INT32_INF = 2**31 - 1


class DeviceClockMirror:
    def __init__(
        self, capacity_docs: int = 1024, capacity_actors: int = 64,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve(device)
        self._lock = make_rlock("ops.clock_mirror")
        self.doc_index: Dict[str, int] = {}
        self.actor_index: Dict[str, int] = {}
        self._actors: List[str] = []
        self._docs: List[str] = []
        self._cap_d = _pow2(max(1, capacity_docs))
        self._cap_a = _pow2(max(1, capacity_actors))
        # device state is LAZY: writes only buffer host-side, so a repo
        # can attach a mirror unconditionally without paying device init
        # (or any launch) until the first bulk query
        self._matrix = None
        self._pending: Dict[Tuple[int, int], int] = {}

    def _mat(self) -> torch.Tensor:
        if self._matrix is None:
            self._matrix = torch.zeros(
                (self._cap_d, self._cap_a), dtype=torch.int32,
                device=self.device,
            )
        return self._matrix

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # -- host-side indexing --------------------------------------------

    def _doc_row(self, doc_id: str) -> int:
        row = self.doc_index.get(doc_id)
        if row is None:
            row = len(self._docs)
            self.doc_index[doc_id] = row
            self._docs.append(doc_id)
            if row >= self._cap_d:
                self._grow(docs=True)
        return row

    def _actor_col(self, actor_id: str) -> int:
        col = self.actor_index.get(actor_id)
        if col is None:
            col = len(self._actors)
            self.actor_index[actor_id] = col
            self._actors.append(actor_id)
            if col >= self._cap_a:
                self._grow(docs=False)
        return col

    def _grow(self, docs: bool) -> None:
        if docs:
            self._cap_d *= 2
        else:
            self._cap_a *= 2
        if self._matrix is not None:
            old = self._matrix
            self._matrix = torch.zeros(
                (self._cap_d, self._cap_a), dtype=torch.int32,
                device=self.device,
            )
            self._matrix[: old.shape[0], : old.shape[1]] = old

    # -- writes ---------------------------------------------------------

    def seed_bulk(self, doc_ids, actor_ids, matrix) -> None:
        """Bulk initialization from a dense [docs, actors] array: one
        device upload, capacity-padded. Only valid on an empty mirror
        (attach-time seeding, benchmarks)."""
        with self._lock:
            if self.doc_index or self.actor_index or self._pending:
                raise RuntimeError("seed_bulk on a non-empty mirror")
            self._docs = list(doc_ids)
            self._actors = list(actor_ids)
            self.doc_index = {d: i for i, d in enumerate(self._docs)}
            self.actor_index = {a: i for i, a in enumerate(self._actors)}
            self._cap_d = max(self._cap_d, _pow2(max(1, len(self._docs))))
            self._cap_a = max(
                self._cap_a, _pow2(max(1, len(self._actors)))
            )
            arr = np.asarray(matrix)
            if arr.shape != (len(self._docs), len(self._actors)):
                raise ValueError(f"seed_bulk: a {arr.shape} matrix for "
                                 f"{len(self._docs)} docs x "
                                 f"{len(self._actors)} actors")
            padded = np.zeros((self._cap_d, self._cap_a), np.int32)
            padded[: arr.shape[0], : arr.shape[1]] = np.minimum(
                arr, INT32_INF
            )
            self._matrix = self._upload(padded)

    def update(self, doc_id: str, clock: Dict[str, int]) -> None:
        """Monotonic merge (max) — buffered; flushed at next query."""
        with self._lock:
            row = self._doc_row(doc_id)
            for actor, seq in clock.items():
                key = (row, self._actor_col(actor))
                s = min(int(seq), INT32_INF)
                if s > self._pending.get(key, 0):
                    self._pending[key] = s

    def update_many(self, clocks: Dict[str, Dict[str, int]]) -> None:
        for doc_id, clock in clocks.items():
            self.update(doc_id, clock)

    def set(self, doc_id: str, clock: Dict[str, int]) -> None:
        """Hard overwrite of one doc's row (ClockStore.set)."""
        with self._lock:
            self._flush_locked()
            row = self._doc_row(doc_id)
            # resolve columns first: _actor_col may grow the matrix
            pairs = [
                (self._actor_col(a), min(int(s), INT32_INF))
                for a, s in clock.items()
            ]
            vec = np.zeros(self._cap_a, np.int32)
            for col, s in pairs:
                vec[col] = s
            self._mat()[row] = self._upload(vec)

    def delete_doc(self, doc_id: str) -> None:
        with self._lock:
            row = self.doc_index.get(doc_id)
            if row is None:
                return
            self._flush_locked()
            self._mat()[row] = 0
            # row index stays allocated (zeros = neutral for max/union;
            # dominated() masks unallocated/deleted rows by doc list)
            del self.doc_index[doc_id]
            self._docs[row] = None

    # -- flush ----------------------------------------------------------

    def _pending_arrays(self):
        """Pending writes as (rows, cols, vals) padded to a pow2 bucket,
        as in the reference; the pad is a scatter-max of 0 at (0, 0) —
        a no-op against the non-negative matrix."""
        items = self._pending
        self._pending = {}
        n = len(items)
        cap = _pow2(max(1, n))
        rows = np.zeros(cap, np.int32)
        cols = np.zeros(cap, np.int32)
        vals = np.zeros(cap, np.int32)
        rows[:n] = np.fromiter((k[0] for k in items), np.int32, count=n)
        cols[:n] = np.fromiter((k[1] for k in items), np.int32, count=n)
        vals[:n] = np.fromiter(items.values(), np.int32, count=n)
        return rows, cols, vals

    def _scatter_pending(self) -> torch.Tensor:
        """The pending writes scatter-maxed into the matrix (one upload
        of the triples, one launch); returns the matrix."""
        triples = self._upload(np.stack(self._pending_arrays()))
        return K.scatter_max_(self._mat(), triples[0], triples[1], triples[2])

    def _flush_locked(self) -> None:
        if self._pending:
            self._scatter_pending()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    # -- queries (single launches over the resident matrix) ------------

    def union(self) -> Dict[str, int]:
        """Union clock across ALL docs: with writes pending, the scatter
        and the column max run back to back on one stream, and the
        [actors] result is the one read back."""
        with self._lock:
            m = self._scatter_pending() if self._pending else self._mat()
            merged = K.union_reduce(m).cpu().numpy()
            return {
                a: int(merged[c])
                for a, c in self.actor_index.items()
                if merged[c] > 0
            }

    def dominated(self, query: Dict[str, int]) -> List[str]:
        """Doc ids whose clock the query dominates (is >= everywhere)."""
        with self._lock:
            self._flush_locked()
            q = self._query_vec(query)
            ok = K.gte(q, self._mat()).cpu().numpy()
            return [
                d for d, r in self.doc_index.items() if ok[r]
            ]

    def top_k_dominated(
        self, query: Dict[str, int], k: int
    ) -> List[str]:
        with self._lock:
            self._flush_locked()
            q = self._query_vec(query)
            scores, idx = K.top_k_dominated(self._mat(), q, k)
            scores = scores.cpu().numpy()
            idx = idx.cpu().numpy()
            out = []
            for s, i in zip(scores, idx):
                if s < 0:
                    break
                d = self._docs[int(i)] if int(i) < len(self._docs) else None
                if d is not None:
                    out.append(d)
            return out

    def _query_vec(self, query: Dict[str, int]) -> torch.Tensor:
        q = np.zeros(self._cap_a, np.int32)
        for actor, seq in query.items():
            col = self.actor_index.get(actor)
            if col is not None:
                q[col] = min(int(seq), INT32_INF)
        return self._upload(q)

    # -- introspection ---------------------------------------------------

    def rows(self) -> Dict[str, Dict[str, int]]:
        """Full host decode (consistency tests; not a hot path)."""
        with self._lock:
            self._flush_locked()
            m = self._mat().cpu().numpy()
            return {
                d: {
                    a: int(m[r, c])
                    for a, c in self.actor_index.items()
                    if m[r, c] > 0
                }
                for d, r in self.doc_index.items()
            }
