"""The device residency cache: per-doc summary columns pinned on the
backend's device (the port of hypermerge_tpu/serve/resident.py).

A resident doc is the device half of a read: six structural lanes
(serve/kernels.py layout) stacked into ONE [LANES, N] int32 array — a
single upload per install — keyed by the serving clock the columns
were built at. The host half stays host: the value/str/float side
tables, the per-row value columns, and the element->winner-value map,
all of which only ever decode a handful of rows per read.

Install follows the live engine's adoption idiom: the build (sidecar pack +
summary kernel + upload) runs with NO lock held; the install takes the
cache lock for dict bookkeeping only and re-checks the serving clock.
A doc whose clock moved mid-build still serves THIS batch from the
built arrays (they are correct as of read admission) but is not
cached — and a stale entry can never serve a later read, because every
read re-compares the entry clock against the doc's current serving
clock (clock-driven invalidation). Docs whose state the sidecars
cannot rebuild (_serveable_spec None — dirty/unbacked feeds) are never
installed at all: they stay on the host path rather than risk a stale
resurrection.

Eviction is a byte-bounded LRU under HM_SERVE_MAX_BYTES; device OOM
during an install sheds LRU entries and retries once before degrading
to the host path (serve/tier.py owns those counters).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..analysis.lockdep import make_rlock
from ..crdt.change import Action
from .kernels import (
    N_LANES, L_INSERT, L_KEY, L_LIVE, L_MAPWIN, L_OBJ, L_RANK,
    ServeDeviceError,
)

# below this row bucket, shape buckets would proliferate programs for
# no win; every tiny doc shares the 64-row executable
SERVE_MIN_ROWS = 64


def looks_like_oom(e: Exception) -> bool:
    """Device allocation failures worth an evict-and-retry (PyTorch
    raises torch.cuda.OutOfMemoryError; other layers surface exhaustion
    through several exception types, so match on the message too)."""
    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(e).lower()
    return "resource_exhausted" in msg or "out of memory" in msg


def serve_max_bytes() -> int:
    """HM_SERVE_MAX_BYTES — read per enforcement pass so tests and
    operators can adjust the budget live."""
    return int(os.environ.get("HM_SERVE_MAX_BYTES", "268435456"))


class _Tables:
    """The batch side tables decode_value needs, without pinning the
    whole ColumnarBatch (its [D, N] column dict) in the entry."""

    __slots__ = ("strings", "floats", "bigints")

    def __init__(self, batch) -> None:
        self.strings = batch.strings
        self.floats = batch.floats
        self.bigints = batch.bigints


class ResidentDoc:
    """One doc's device lanes + host decode half, valid at `clock`."""

    __slots__ = (
        "doc_id", "clock", "n", "bucket", "dev", "action", "vkind",
        "value", "dt", "inc_total", "elem_val", "tables", "key_index",
        "nbytes", "last_use", "stale",
    )

    def __init__(
        self, doc_id: str, clock: Dict[str, int], n: int, bucket: int,
        dev: Any, host_cols: Dict[str, np.ndarray],
        elem_val: np.ndarray, tables: _Tables,
        key_index: Dict[str, int],
    ) -> None:
        self.doc_id = doc_id
        self.clock = clock
        self.n = n
        self.bucket = bucket
        self.dev = dev  # torch [N_LANES, bucket] int32, on the device
        self.action = host_cols["action"]
        self.vkind = host_cols["vkind"]
        self.value = host_cols["value"]
        self.dt = host_cols["dt"]
        self.inc_total = host_cols["inc_total"]
        self.elem_val = elem_val  # [n] element row -> winner value row
        self.tables = tables
        self.key_index = key_index
        self.nbytes = int(getattr(dev, "nbytes", 0)) + sum(
            int(host_cols[k].nbytes)
            for k in ("action", "vkind", "value", "dt", "inc_total")
        ) + int(elem_val.nbytes) + 512
        self.last_use = 0
        self.stale = False

    def obj_type(self, row: int) -> Optional[str]:
        """'map'/'list'/'text'/'table' for a MAKE row, 'map' for the
        root (-1), None for value rows."""
        from ..ops.materialize import _OBJ_TYPES

        if row < 0:
            return "map"
        return _OBJ_TYPES.get(int(self.action[row]))


def _to_device(stacked: np.ndarray, device: torch.device) -> torch.Tensor:
    """The install's one host->device transfer — a module seam so the
    OOM tests can make the device refuse without faking a whole
    backend."""
    return torch.from_numpy(stacked).to(device)


def build_entry(backend, doc_id: str, clock: Dict[str, int]):
    """Build one doc's resident entry at `clock` — pack from the
    columnar sidecars, run the host summary kernel (or reuse the
    backend's per-doc summary memo when it already holds this clock's
    lanes), derive the host decode half, and upload the stacked device
    lanes. Runs with NO lock held. Returns (entry, memo_hit) or
    (None, False) when the sidecars cannot serve this clock.

    Raises whatever the device upload raises (the tier's OOM
    evict-and-retry wraps this call).
    """
    from ..ops.columnar import pack_docs_columns, round_up_pow2

    spec = backend._serveable_spec(clock)
    if spec is None:
        return None, False
    # the numpy kernel twin below runs on the host: pack there too
    batch = pack_docs_columns([spec], device="cpu")
    c = {k: np.asarray(v[0], np.int32) for k, v in batch.cols.items()}
    n = batch.n_rows
    memo_lanes = _memo_lanes(backend, doc_id, clock, c, n)
    if memo_lanes is not None:
        live, rank, mapwin = memo_lanes
        elem_val = np.arange(n, dtype=np.int32)
        inc_total = np.zeros(n, np.int32)
    else:
        from ..ops.host_kernel import run_batch_host

        out = run_batch_host(batch)
        live = np.asarray(out.elem_live[0])
        rank = np.asarray(out.rank[0], np.int32)
        mapwin = np.asarray(out.map_winner[0])
        inc_total = np.asarray(out.inc_total[0], np.int32)
        elem_val = _elem_val_map(c, np.asarray(out.visible[0]),
                                 np.asarray(out.elem_winner[0]))
    bucket = round_up_pow2(max(n, SERVE_MIN_ROWS))
    stacked = np.zeros((N_LANES, bucket), np.int32)
    stacked[L_LIVE, :n] = live.astype(np.int32)
    stacked[L_RANK, :n] = rank
    stacked[L_OBJ, :n] = c["obj"]
    stacked[L_OBJ, n:] = -3  # pad rows match no container (root is -1)
    stacked[L_INSERT, :n] = c["insert"]
    stacked[L_KEY, :n] = c["key"]
    stacked[L_KEY, n:] = -1
    stacked[L_MAPWIN, :n] = mapwin.astype(np.int32)
    try:
        dev = _to_device(stacked, backend.device)  # ONE upload per install
    except Exception as e:
        if looks_like_oom(e):
            raise  # memory pressure: the tier's evict-and-retry ladder
        raise ServeDeviceError(
            f"install upload of {doc_id[:6]} failed: {e!r}"
        ) from e
    host_cols = {
        "action": c["action"], "vkind": c["vkind"],
        "value": c["value"], "dt": c["dt"], "inc_total": inc_total,
    }
    entry = ResidentDoc(
        doc_id, dict(clock), n, bucket, dev, host_cols, elem_val,
        _Tables(batch), {k: i for i, k in enumerate(batch.keys)},
    )
    return entry, memo_lanes is not None


def _elem_val_map(
    c: Dict[str, np.ndarray], visible: np.ndarray, elem_winner: np.ndarray
) -> np.ndarray:
    """[n] element row -> its winning value row (the decode_patch
    elem_val rule, vectorized): a visible winning SET on the element
    overrides; otherwise the INS row's own value stands."""
    n = len(visible)
    ev = np.arange(n, dtype=np.int32)
    rows = np.nonzero(
        visible
        & (c["insert"] == 0)
        & (c["key"] < 0)
        & (c["ref"] >= 0)
        & elem_winner
    )[0]
    ev[c["ref"][rows]] = rows
    return ev


def _memo_lanes(backend, doc_id, clock, c, n):
    """Reuse the backend's per-doc summary memo (the bulk loader's host
    half) when it already holds this exact clock's summary: the install
    then skips the host kernel run entirely — the serving tier and the
    bulk path share ONE freshness rule (clock equality). Only sound
    when no row needs the lanes the memo does not carry: INC totals and
    element-override SETs fall back to the kernel run."""
    memo = getattr(backend, "_summary_memo", None)
    m = memo.get(doc_id) if memo else None
    if m is None or m["clock"] != clock or m["N"] < n:
        return None
    if np.any(c["action"] == int(Action.INC)):
        return None
    if np.any(
        (c["insert"] == 0)
        & (c["key"] < 0)
        & (c["ref"] >= 0)
        & (c["action"] == int(Action.SET))
    ):
        return None
    from ..ops.crdt_kernels import unpack_bits_le

    N = m["N"]
    mapwin = unpack_bits_le(m["mw_bits"][None], N)[0][:n]
    live = unpack_bits_le(m["el_bits"][None], N)[0][:n]
    # pseudo-rank from the memo'd element order: rank[order[i]] = N - i
    # reproduces the order under the seq_order kernel's argsort
    pos = np.empty(N, np.int64)
    pos[np.asarray(m["order"], np.int64)] = np.arange(N)
    rank = (N - pos[:n]).astype(np.int32)
    return live, rank, mapwin


class ResidencyCache:
    """doc_id -> ResidentDoc under a byte-bounded LRU. The lock guards
    table bookkeeping only — builds and uploads always run outside it
    (see module docstring)."""

    # ids remembered as "evicted" for the residency report — bounded
    # (FIFO) so a long-lived daemon cycling a huge corpus does not
    # grow the Telemetry payload with the whole doc universe
    EVICTED_REMEMBERED = 1024

    def __init__(self) -> None:
        self._lock = make_rlock("serve.cache")
        self._entries: "OrderedDict[str, ResidentDoc]" = OrderedDict()
        self._evicted: "OrderedDict[str, None]" = OrderedDict()
        self._bytes = 0
        self._use = 0

    def get_fresh(
        self, doc_id: str, clock: Dict[str, int]
    ) -> Optional[ResidentDoc]:
        """The serving invalidation check: an entry serves only when
        its build clock EQUALS the doc's current serving clock and no
        write marked it stale since."""
        with self._lock:
            e = self._entries.get(doc_id)
            if e is None or e.stale or e.clock != clock:
                return None
            self._use += 1
            e.last_use = self._use
            self._entries.move_to_end(doc_id)
            return e

    def install(self, entry: ResidentDoc) -> List[ResidentDoc]:
        """Install a built entry (replacing any older clock's entry)
        and evict LRU down to the byte budget. Returns the evicted
        entries (the tier counts them)."""
        cap = serve_max_bytes()
        with self._lock:
            evicted = []
            old = self._entries.pop(entry.doc_id, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._use += 1
            entry.last_use = self._use
            self._entries[entry.doc_id] = entry
            self._bytes += entry.nbytes
            self._evicted.pop(entry.doc_id, None)
            while self._bytes > cap and len(self._entries) > 1:
                did, lru = next(iter(self._entries.items()))
                del self._entries[did]
                self._bytes -= lru.nbytes
                self._note_evicted(did)
                evicted.append(lru)
            return evicted

    def _note_evicted(self, doc_id: str) -> None:
        """Remember (bounded) that this id was resident once.
        REQUIRES serve.cache (analysis/guards.py)."""
        self._evicted[doc_id] = None
        self._evicted.move_to_end(doc_id)
        while len(self._evicted) > self.EVICTED_REMEMBERED:
            self._evicted.popitem(last=False)

    def evict_lru(self, want_bytes: int) -> List[ResidentDoc]:
        """Shed LRU entries until `want_bytes` are freed (memory
        pressure during an install: the OOM retry path)."""
        with self._lock:
            evicted: List[ResidentDoc] = []
            freed = 0
            while self._entries and freed < want_bytes:
                did, lru = next(iter(self._entries.items()))
                del self._entries[did]
                self._bytes -= lru.nbytes
                self._note_evicted(did)
                freed += lru.nbytes
                evicted.append(lru)
            return evicted

    def mark_stale(self, doc_id: str) -> bool:
        """A write moved the doc's clock: the entry (if any) can never
        serve again (clocks never revert to the build clock), so its
        device arrays are RELEASED immediately instead of pinning the
        byte budget as dead weight until LRU pressure finds them.
        In-flight batches that already resolved the entry keep their
        reference and finish serving — those reads were admitted
        before the write's patch was delivered. True when a resident
        entry was actually invalidated."""
        with self._lock:
            e = self._entries.pop(doc_id, None)
            if e is None:
                return False
            e.stale = True
            self._bytes -= e.nbytes
            return True

    def drop(self, doc_id: str) -> None:
        with self._lock:
            e = self._entries.pop(doc_id, None)
            if e is not None:
                self._bytes -= e.nbytes
            self._evicted.pop(doc_id, None)

    @property
    def resident_bytes(self) -> int:
        # atomic_read_ok (analysis/guards.py): monitoring snapshot
        return self._bytes

    @property
    def resident_docs(self) -> int:
        with self._lock:
            return len(self._entries)

    def report(self) -> Dict[str, Any]:
        """Per-doc residency for tools/ls.py (via the Telemetry
        query): resident entries with their device bytes, plus the ids
        eviction pushed out since they were last resident."""
        with self._lock:
            return {
                "resident": {
                    did: {
                        "bytes": e.nbytes,
                        "stale": e.stale,
                        "rows": e.n,
                    }
                    for did, e in self._entries.items()
                },
                "evicted": sorted(self._evicted),
                "bytes": self._bytes,
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._evicted.clear()
            self._bytes = 0
