"""Columnar feed cache — the port's copy of
hypermerge_tpu/storage/colcache.py (sidecar files byte-identical to the
reference's: a sidecar one package wrote, the other reads).

The reference cold start replays every change through the CRDT backend
one block at a time (reference src/RepoBackend.ts:238-257 loadDocument →
Backend.applyChanges). The TPU-first equivalent wants feeds to arrive on
device as int32 columns with zero per-op Python. This module maintains,
next to each feed's block log, a derived columnar encoding of the same
ops that can be loaded with a single `np.fromfile` and sliced/remapped
with numpy only (ops/columnar.py `pack_docs_columns`).

The cache is *derived data*: the JSON change blocks in the feed remain
the source of truth (and the replication wire format). A missing or
stale cache is rebuilt from blocks; a torn tail (crash mid-append) is
truncated to the last committed change, mirroring the torn-tail healing
of FileFeedStorage (storage/feed.py).

Row layout (int32 x ROW_FIELDS per op):
  0 action   Action code
  1 ctr      lamport counter (op id = (ctr, writer))
  2 seq      change seq (nondecreasing -> np.searchsorted windows)
  3 start_op ctr of the change's first op (causal sort key)
  4 obj_ctr  container op id ctr        (0 if root)
  5 obj_a    feed-local actor idx of container (-1 = ROOT map)
  6 key      feed-local key-string idx (-1 = none / list op)
  7 ref_ctr  referenced element / INC target ctr
  8 ref_a    feed-local actor idx (-2 = HEAD, -3 = none)
  9 insert   1 if the op creates a list/text element
 10 vkind    value kind (ops/columnar.py VK_*)
 11 value    inline int / feed-local table idx
 12 dt       datatype: 0 none, 1 counter, 2 timestamp
 13 flags    reserved

Pred (supersession) edges are separate records (int32 x 3):
  src op index (absolute, within this feed), tgt_ctr, tgt_a.
INC ops contribute no pred edges — their target rides ref_* (matching
ops/columnar.py _pack_one).

Tables are append-only JSON lines: {"t": "a"|"k"|"s"|"f"|"b", "v": ...}
("a" actors — index 0 is always the feed writer; "k" key strings;
"s" value strings; "f" floats; "b" bigints as decimal strings).

A commit record (int32 x 4: n_rows, n_preds, n_table_lines, flag) is
appended **after** each change's data; load() honors only the last
complete commit, so a torn append never corrupts the cache. flag=1
marks a corrupt feed block (occupies a seq slot, contributes no ops) —
needed because the host OpSet stalls an actor's changes at the first
corrupt block (seq continuity), so `ok_prefix_len` clamps windows.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..analysis.lockdep import make_rlock
from ..crdt.change import HEAD, ROOT, Action, Change
from .faults import io_fsync, io_open, io_remove, io_replace

ROW_FIELDS = 14
PRED_FIELDS = 3
COMMIT_FIELDS = 4

# value kinds — must match ops/columnar.py
VK_NONE = 0
VK_INT = 1
VK_FLOAT = 2
VK_STR = 3
VK_BOOL = 4
VK_BIGINT = 5

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1

OBJ_ROOT = -1
REF_HEAD = -2
REF_NONE = -3


# plane order == row column order (module docstring row layout)
PLANE_NAMES = (
    "action", "ctr", "seq", "start_op", "obj_ctr", "obj_a", "key",
    "ref_ctr", "ref_a", "insert", "vkind", "value", "dt", "flags",
)


@dataclass
class FeedColumns:
    """One feed's ops as numpy columns + feed-local tables.

    Two storage shapes, one interface: `rows` is [n_ops, ROW_FIELDS]
    int32 (v2 record streams materialize it directly); a v3 checkpoint
    instead carries `planes` — one contiguous array per column in the
    minimal dtype that holds it — and leaves `rows` None until a
    consumer calls `ensure_rows()`. The bulk pack fast path
    (ops/columnar.py) reads planes without ever widening to the row
    matrix; everything else upgrades transparently.

    `preds` is [n_preds, 3] int32. `seq` is nondecreasing, so change
    windows slice via np.searchsorted. `ok_prefix_len` is the number of
    leading non-corrupt changes — the host OpSet can never apply past
    the first corrupt block of an actor, so bulk windows clamp to it.
    """

    rows: Optional[np.ndarray]
    preds: np.ndarray
    actors: List[str]
    keys: List[str]
    strings: List[str]
    floats: List[float]
    bigints: List[int]
    n_changes: int
    ok_prefix_len: int
    # per-change cumulative row counts, len n_changes+1: change i (seq
    # i+1) owns rows [row_ends[i], row_ends[i+1])
    row_ends: np.ndarray
    planes: Optional[Dict[str, np.ndarray]] = None
    # (base_addr, offsets[len(PLANE_NAMES)] int64, dtype_codes uint8,
    # keep_alive) when every plane is a slice of ONE raw checkpoint
    # buffer: the native bulk pack derives all plane pointers from the
    # base address instead of a per-plane __array_interface__ walk
    # (which costs ~5us x 12 planes x 10k feeds on a cold open)
    plane_meta: Optional[Tuple] = None

    @property
    def n_rows(self) -> int:
        if self.rows is not None:
            return len(self.rows)
        return len(self.planes["action"]) if self.planes else 0

    def plane(self, name: str) -> np.ndarray:
        """One column, narrow dtype when plane-backed."""
        if self.planes is not None:
            return self.planes[name]
        return self.rows[:, PLANE_NAMES.index(name)]

    def ensure_rows(self) -> np.ndarray:
        """Materialize (and cache) the [n, ROW_FIELDS] int32 matrix —
        the general pack path and per-op consumers want row slices."""
        if self.rows is None:
            self.rows = rows_from_planes(self.planes)
        return self.rows

    @property
    def seq(self) -> np.ndarray:
        if self.rows is not None:
            return self.rows[:, 2]
        return self.plane("seq")

    def window(self, start_seq: int, end_seq: float) -> Tuple[int, int]:
        """Row range [lo, hi) for changes with seq in (start_seq, end_seq],
        clamped to the applicable (ok) prefix."""
        e = min(float(end_seq), float(self.ok_prefix_len))
        e = int(e)
        s = min(start_seq, self.n_changes)
        lo = int(self.row_ends[s])
        hi = int(self.row_ends[min(e, self.n_changes)]) if e > 0 else 0
        return lo, max(hi, lo)

    def changes_in_window(self, start_seq: int, end_seq: float) -> int:
        """Number of applicable changes with seq in (start_seq, end_seq]."""
        e = int(min(float(end_seq), float(self.ok_prefix_len)))
        return max(0, e - min(start_seq, e))

    def seqs_contiguous(self) -> bool:
        """True iff the rows' seq column matches the contiguous 1..n
        assignment (change i owns seq i+1). The bulk clock shortcut
        (clock[actor] = applied-change count) is only sound under this
        invariant; a feed with a seq gap — e.g. partially replicated or
        corrupt-then-healed out-of-band — must fail loudly, not produce a
        silently wrong clock."""
        n = int(self.row_ends[-1]) if len(self.row_ends) else 0
        if n != self.n_rows:
            return False
        expected = np.repeat(
            np.arange(1, self.n_changes + 1, dtype=np.int64),
            np.diff(self.row_ends),
        )
        return bool(
            np.array_equal(self.seq[:n].astype(np.int64), expected)
        )


# ---------------------------------------------------------------------------
# storage backends


class MemoryColumnStorage:
    def __init__(self) -> None:
        self.rows: List[np.ndarray] = []
        self.preds: List[np.ndarray] = []
        self.tables: List[str] = []
        self.commits: List[Tuple[int, int, int, int]] = []
        # running totals: a commit records the row and pred counts so
        # far without summing every earlier chunk again
        self._n_rows = 0
        self._n_preds = 0

    def commit_change(
        self,
        rows: np.ndarray,
        preds: np.ndarray,
        table_lines: List[str],
        flag: int,
    ) -> None:
        if len(rows):
            self.rows.append(rows)
            self._n_rows += len(rows)
        if len(preds):
            self.preds.append(preds)
            self._n_preds += len(preds)
        self.tables.extend(table_lines)
        self.commits.append(
            (self._n_rows, self._n_preds, len(self.tables), flag)
        )

    def load(self):
        rows = (
            np.concatenate(self.rows, axis=0)
            if self.rows
            else np.zeros((0, ROW_FIELDS), np.int32)
        )
        preds = (
            np.concatenate(self.preds, axis=0)
            if self.preds
            else np.zeros((0, PRED_FIELDS), np.int32)
        )
        commits = np.asarray(self.commits, np.int32).reshape(
            -1, COMMIT_FIELDS
        )
        return rows, preds, list(self.tables), commits

    def reset(self) -> None:
        self.rows.clear()
        self.preds.clear()
        self.tables.clear()
        self.commits.clear()
        self._n_rows = 0
        self._n_preds = 0

    def destroy(self) -> None:
        self.reset()

    def close(self) -> None:
        pass


class FileColumnStorage:
    """rows.bin / preds.bin / tables.jsonl / commits.bin in a directory.

    Only the prefix covered by the last complete commit record is ever
    read back — a crash mid-append loses at most the uncommitted change,
    which the rebuild path re-derives from the feed's blocks."""

    _COMMIT = struct.Struct("<4i")

    def __init__(self, path: str) -> None:
        self.path = path
        self._dir_ready = os.path.isdir(path)
        self._fhs = None  # (rows, preds, tables, commits) — lazy: a
        # read-only bulk load over many feeds must not hold 4 FDs each
        self._n_rows: Optional[int] = None
        self._n_preds: Optional[int] = None
        self._n_tables_written: Optional[int] = None

    def _ensure_writable(self):
        if self._fhs is not None:
            return self._fhs
        if not self._dir_ready:
            os.makedirs(self.path, exist_ok=True)
            self._dir_ready = True
        self._truncate_to_committed()
        self._fhs = (
            open(os.path.join(self.path, "rows.bin"), "ab"),
            open(os.path.join(self.path, "preds.bin"), "ab"),
            open(os.path.join(self.path, "tables.jsonl"), "ab"),
            open(os.path.join(self.path, "commits.bin"), "ab"),
        )
        self._n_rows = os.path.getsize(
            os.path.join(self.path, "rows.bin")
        ) // (4 * ROW_FIELDS)
        self._n_preds = os.path.getsize(
            os.path.join(self.path, "preds.bin")
        ) // (4 * PRED_FIELDS)
        self._n_tables_written = self._count_table_lines()
        return self._fhs

    def _truncate_to_committed(self) -> None:
        """Drop any torn tail from a crash mid-append: the data files are
        rolled back to the sizes the last complete commit record names
        (the lost change re-derives from its feed block on catch-up)."""
        cpath = os.path.join(self.path, "commits.bin")
        csize = (
            os.path.getsize(cpath) if os.path.exists(cpath) else 0
        )
        n_commits = csize // self._COMMIT.size
        if csize != n_commits * self._COMMIT.size:
            with open(cpath, "r+b") as fh:
                fh.truncate(n_commits * self._COMMIT.size)
        if n_commits:
            with open(cpath, "rb") as fh:
                fh.seek((n_commits - 1) * self._COMMIT.size)
                n_rows, n_preds, n_tables, _ = self._COMMIT.unpack(
                    fh.read(self._COMMIT.size)
                )
        else:
            n_rows = n_preds = n_tables = 0
        for name, want in (
            ("rows.bin", n_rows * 4 * ROW_FIELDS),
            ("preds.bin", n_preds * 4 * PRED_FIELDS),
        ):
            p = os.path.join(self.path, name)
            if os.path.exists(p) and os.path.getsize(p) > want:
                with open(p, "r+b") as fh:
                    fh.truncate(want)
        tp = os.path.join(self.path, "tables.jsonl")
        if os.path.exists(tp):
            keep = 0
            count = 0
            with open(tp, "rb") as fh:
                for line in fh:
                    if count >= n_tables or not line.endswith(b"\n"):
                        break
                    count += 1
                    keep += len(line)
            if os.path.getsize(tp) > keep:
                with open(tp, "r+b") as fh:
                    fh.truncate(keep)

    def commit_change(
        self,
        rows: np.ndarray,
        preds: np.ndarray,
        table_lines: List[str],
        flag: int,
    ) -> None:
        rows_fh, preds_fh, tables_fh, commits_fh = self._ensure_writable()
        if len(rows):
            rows_fh.write(np.ascontiguousarray(rows, np.int32).tobytes())
            rows_fh.flush()
            self._n_rows += len(rows)
        if len(preds):
            preds_fh.write(np.ascontiguousarray(preds, np.int32).tobytes())
            preds_fh.flush()
            self._n_preds += len(preds)
        for line in table_lines:
            tables_fh.write(line.encode("utf-8") + b"\n")
        if table_lines:
            tables_fh.flush()
            self._n_tables_written += len(table_lines)
        commits_fh.write(
            self._COMMIT.pack(
                self._n_rows, self._n_preds, self._n_tables_written, flag
            )
        )
        commits_fh.flush()

    def _count_table_lines(self) -> int:
        p = os.path.join(self.path, "tables.jsonl")
        if not os.path.exists(p):
            return 0
        with open(p, "rb") as fh:
            return sum(1 for _ in fh)

    def load(self):
        commits_raw = self._read(os.path.join(self.path, "commits.bin"))
        n_complete = len(commits_raw) // self._COMMIT.size
        commits = np.frombuffer(
            commits_raw[: n_complete * self._COMMIT.size], np.int32
        ).reshape(-1, COMMIT_FIELDS)
        n_rows = int(commits[-1, 0]) if n_complete else 0
        n_preds = int(commits[-1, 1]) if n_complete else 0
        n_tables = int(commits[-1, 2]) if n_complete else 0
        rows_raw = self._read(os.path.join(self.path, "rows.bin"))
        rows = np.frombuffer(
            rows_raw[: n_rows * 4 * ROW_FIELDS], np.int32
        ).reshape(-1, ROW_FIELDS)
        preds_raw = self._read(os.path.join(self.path, "preds.bin"))
        preds = np.frombuffer(
            preds_raw[: n_preds * 4 * PRED_FIELDS], np.int32
        ).reshape(-1, PRED_FIELDS)
        tables: List[str] = []
        tp = os.path.join(self.path, "tables.jsonl")
        if os.path.exists(tp) and n_tables:
            with open(tp, "rb") as fh:
                for line in fh:
                    tables.append(line.decode("utf-8").rstrip("\n"))
                    if len(tables) >= n_tables:
                        break
        return rows, preds, tables, commits

    @staticmethod
    def _read(path: str) -> bytes:
        if not os.path.exists(path):
            return b""
        with open(path, "rb") as fh:
            return fh.read()

    def reset(self) -> None:
        """Discard all cache contents (used when the sidecar disagrees
        with its feed — e.g. a restored/replaced feed file left the
        sidecar ahead of the block log)."""
        self.close()
        for name in ("rows.bin", "preds.bin", "tables.jsonl", "commits.bin"):
            p = os.path.join(self.path, name)
            if os.path.exists(p):
                os.remove(p)
        self._n_rows = self._n_preds = self._n_tables_written = None

    def destroy(self) -> None:
        """reset + remove the sidecar directory itself (doc destroy)."""
        self.reset()
        try:
            os.rmdir(self.path)
        except OSError:
            pass
        self._dir_ready = False

    def close(self) -> None:
        if self._fhs is not None:
            for fh in self._fhs:
                fh.close()
            self._fhs = None


_V2_HDR = struct.Struct("<IIIB")


_V3_MAGIC = b"HMc3"
_V3_HDR = struct.Struct("<IIII")  # n_rows, n_changes, n_preds, tables_len
_V3_DTYPES = (np.int8, np.int16, np.int32, np.uint8)


def _narrow_plane(col: np.ndarray) -> np.ndarray:
    """Minimal-dtype copy of one int32 column."""
    if len(col) == 0:
        return col.astype(np.int8)
    lo, hi = int(col.min()), int(col.max())
    if 0 <= lo and hi <= 255:
        return col.astype(np.uint8)
    if -128 <= lo and hi <= 127:
        return col.astype(np.int8)
    if -(2**15) <= lo and hi <= 2**15 - 1:
        return col.astype(np.int16)
    return np.ascontiguousarray(col, np.int32)


def planes_from_rows(rows: np.ndarray) -> Dict[str, np.ndarray]:
    return {
        name: _narrow_plane(rows[:, i])
        for i, name in enumerate(PLANE_NAMES)
    }


def rows_from_planes(planes: Dict[str, np.ndarray]) -> np.ndarray:
    n = len(planes["action"])
    rows = np.empty((n, ROW_FIELDS), np.int32)
    for i, name in enumerate(PLANE_NAMES):
        rows[:, i] = planes[name]
    return rows


def v3_body_bytes(
    planes: Dict[str, np.ndarray],
    preds: np.ndarray,
    row_ends: np.ndarray,
    flags: np.ndarray,
) -> bytes:
    """Everything between the v3 header and the tables blob — the
    doc-invariant middle the corpus writer renders once per template."""
    n_changes = len(row_ends)
    n_rows = int(row_ends[-1]) if n_changes else 0
    parts = []
    for name in PLANE_NAMES:
        p = planes[name]
        assert len(p) == n_rows, (name, len(p), n_rows)
        parts.append(bytes([_V3_DTYPES.index(p.dtype.type)]))
        parts.append(np.ascontiguousarray(p).tobytes())
    parts.append(np.ascontiguousarray(row_ends, np.int64).tobytes())
    parts.append(np.ascontiguousarray(flags, np.uint8).tobytes())
    parts.append(np.ascontiguousarray(preds, np.int32).tobytes())
    return b"".join(parts)


def v3_frame(
    body: bytes,
    n_rows: int,
    n_changes: int,
    n_preds: int,
    tables_bytes: bytes,
) -> bytes:
    return b"".join(
        (
            _V3_MAGIC,
            _V3_HDR.pack(n_rows, n_changes, n_preds, len(tables_bytes)),
            body,
            tables_bytes,
        )
    )


def pack_v3_checkpoint(
    planes: Dict[str, np.ndarray],
    preds: np.ndarray,
    row_ends: np.ndarray,
    flags: np.ndarray,
    tables_bytes: bytes,
) -> bytes:
    """The v3 checkpoint block: the whole committed prefix as contiguous
    column planes (minimal dtypes) + preds + per-change row ends/corrupt
    flags + the interner tables as one JSONL blob. Loading is a handful
    of np.frombuffer slices — no per-change parsing (the v2 record loop
    cost a 10k-feed cold open seconds of pure Python). v2 records append
    AFTER the checkpoint; `FileColumnStorageV2.load` replays that tail."""
    n_changes = len(row_ends)
    n_rows = int(row_ends[-1]) if n_changes else 0
    return v3_frame(
        v3_body_bytes(planes, preds, row_ends, flags),
        n_rows, n_changes, len(preds), tables_bytes,
    )


def parse_v3_checkpoint(raw: bytes):
    """(planes, preds, row_ends, flags, tables_lines, end_offset,
    plane_meta) or None when `raw` does not start with a complete v3
    block. plane_meta is the FeedColumns.plane_meta tuple (pointer table
    for the native bulk pack)."""
    if not raw.startswith(_V3_MAGIC):
        return None
    pos = len(_V3_MAGIC)
    if pos + _V3_HDR.size > len(raw):
        return None
    n_rows, n_changes, n_preds, t_len = _V3_HDR.unpack_from(raw, pos)
    pos += _V3_HDR.size
    planes: Dict[str, np.ndarray] = {}
    base = np.frombuffer(raw, np.uint8)
    base_addr = base.__array_interface__["data"][0]
    plane_offs = np.empty(len(PLANE_NAMES), np.int64)
    plane_dts = np.empty(len(PLANE_NAMES), np.uint8)
    for pi, name in enumerate(PLANE_NAMES):
        if pos + 1 > len(raw):
            return None
        code = raw[pos]
        pos += 1
        if code >= len(_V3_DTYPES):
            return None
        dt = np.dtype(_V3_DTYPES[code])
        nbytes = n_rows * dt.itemsize
        if pos + nbytes > len(raw):
            return None
        planes[name] = np.frombuffer(raw, dt, count=n_rows, offset=pos)
        plane_offs[pi] = pos
        plane_dts[pi] = code
        pos += nbytes
    plane_meta = (base_addr, plane_offs, plane_dts, base)
    need = n_changes * 8 + n_changes + n_preds * 4 * PRED_FIELDS + t_len
    if pos + need > len(raw):
        return None
    row_ends = np.frombuffer(raw, np.int64, count=n_changes, offset=pos)
    pos += n_changes * 8
    flags = np.frombuffer(raw, np.uint8, count=n_changes, offset=pos)
    pos += n_changes
    preds = np.frombuffer(
        raw, np.int32, count=n_preds * PRED_FIELDS, offset=pos
    ).reshape(-1, PRED_FIELDS)
    pos += n_preds * 4 * PRED_FIELDS
    tables = (
        raw[pos : pos + t_len].decode("utf-8").splitlines()
        if t_len
        else []
    )
    pos += t_len
    return planes, preds, row_ends, flags, tables, pos, plane_meta


def pack_v2_record(
    rows: np.ndarray, preds: np.ndarray, table_lines: List[str], flag: int
) -> bytes:
    """One framed v2 sidecar record (shared by the live writer and the
    corpus writer so both produce byte-identical files)."""
    tables_bytes = (
        ("\n".join(table_lines) + "\n").encode("utf-8")
        if table_lines
        else b""
    )
    return b"".join(
        (
            _V2_HDR.pack(len(rows), len(preds), len(tables_bytes), flag),
            np.ascontiguousarray(rows, np.int32).tobytes(),
            np.ascontiguousarray(preds, np.int32).tobytes(),
            tables_bytes,
        )
    )


class FileColumnStorageV2:
    """Single-file sidecar: optional v3 checkpoint + framed records.

    Record = <u32 n_rows, u32 n_preds, u32 tables_len, u8 flag>
             rows_bytes || preds_bytes || tables_bytes(jsonl)
    A record is valid iff the file holds all the bytes its header names;
    a torn tail (crash mid-append) simply fails that check and is
    overwritten by the next append. One open+read per cold load and one
    append write per change — the 4-file layout (FileColumnStorage,
    retained read-compatible for old repos) cost a bulk cold start four
    opens + seven stats PER FEED.

    A file may START with a v3 checkpoint block (pack_v3_checkpoint):
    the committed prefix as contiguous narrow column planes, loaded by
    `load_v3` with a handful of frombuffer slices instead of a per-
    change Python loop. Records after the checkpoint are the live tail;
    `write_checkpoint` (FeedColumnCache.compact) folds them in by
    atomically rewriting the file."""

    _HDR = struct.Struct("<IIIB")

    def __init__(self, path: str) -> None:
        self.path = path
        self._end: Optional[int] = None  # valid end offset
        self._counts = None  # (n_rows, n_preds, n_tables) totals

    def _parse_from(self, raw: bytes, start: int):
        """(records, valid_end): records are (n_rows, n_preds, tables
        slice, flag, rows slice, preds slice), parsed from `start`."""
        out = []
        pos = start
        end = len(raw)
        h = self._HDR
        while pos + h.size <= end:
            n_rows, n_preds, t_len, flag = h.unpack_from(raw, pos)
            body = n_rows * 4 * ROW_FIELDS + n_preds * 4 * PRED_FIELDS + t_len
            if pos + h.size + body > end:
                break  # torn tail
            p = pos + h.size
            out.append((n_rows, n_preds, t_len, flag, p))
            pos += h.size + body
        return out, pos

    def load_v3(self):
        """(base_planes|None, tail_rows, preds, tables, commits,
        n_tail_records, plane_meta|None): the checkpoint (when present)
        plus the v2 tail after it. Base commits synthesize
        [row_end, 0, 0, flag] rows — only columns 0 and 3 feed
        FeedColumns."""
        try:
            with open(self.path, "rb") as fh:
                raw = fh.read()
        except OSError:
            raw = b""
        return self._load_v3_bytes(raw)  # _load_v2 records the valid end

    def _load_v3_bytes(self, raw: bytes):
        ck = parse_v3_checkpoint(raw)
        if ck is None:
            rows, preds, tables, commits = self._load_v2(raw, 0)
            return None, rows, preds, tables, commits, len(commits), None
        planes, preds_ck, row_ends, flags, tables_ck, off, meta = ck
        t_rows, t_preds, t_tables, t_commits = self._load_v2(raw, off)
        n_base_rows = int(row_ends[-1]) if len(row_ends) else 0
        commits = np.zeros(
            (len(row_ends) + len(t_commits), COMMIT_FIELDS), np.int32
        )
        commits[: len(row_ends), 0] = row_ends
        commits[: len(row_ends), 3] = flags
        if len(t_commits):
            commits[len(row_ends) :] = t_commits
            commits[len(row_ends) :, 0] += n_base_rows
            commits[len(row_ends) :, 1] += len(preds_ck)
        preds = (
            np.concatenate([preds_ck, t_preds], axis=0)
            if len(t_preds)
            else preds_ck
        )
        self._counts = (
            n_base_rows + len(t_rows),
            len(preds),
            len(tables_ck) + len(t_tables),
        )
        return (
            planes, t_rows, preds, tables_ck + t_tables, commits,
            len(t_commits), meta,
        )

    def load(self):
        """Legacy whole-rows entry: delegates to load_v3 and widens any
        checkpoint planes into the dense row matrix."""
        planes, t_rows, preds, tables, commits, _, _meta = self.load_v3()
        if planes is None:
            return t_rows, preds, tables, commits
        base = rows_from_planes(planes)
        rows = (
            np.concatenate([base, t_rows], axis=0)
            if len(t_rows)
            else base
        )
        return rows, preds, tables, commits

    def _load_v2(self, raw: bytes, start: int):
        recs, valid_end = self._parse_from(raw, start)
        self._end = valid_end
        rows_parts = []
        pred_parts = []
        tables: List[str] = []
        commits = np.zeros((len(recs), COMMIT_FIELDS), np.int32)
        tr = tp = tt = 0
        for i, (n_rows, n_preds, t_len, flag, p) in enumerate(recs):
            rp = p + n_rows * 4 * ROW_FIELDS
            pp = rp + n_preds * 4 * PRED_FIELDS
            if n_rows:
                rows_parts.append(raw[p:rp])
            if n_preds:
                pred_parts.append(raw[rp:pp])
            if t_len:
                tables.extend(
                    raw[pp : pp + t_len].decode("utf-8").splitlines()
                )
            tr += n_rows
            tp += n_preds
            tt = len(tables)
            commits[i] = (tr, tp, tt, flag)
        rows = np.frombuffer(b"".join(rows_parts), np.int32).reshape(
            -1, ROW_FIELDS
        )
        preds = np.frombuffer(b"".join(pred_parts), np.int32).reshape(
            -1, PRED_FIELDS
        )
        self._counts = (tr, tp, tt)
        return rows, preds, tables, commits

    def _ensure_end(self) -> int:
        if self._end is None:
            self.load()
        return self._end

    def commit_change(
        self,
        rows: np.ndarray,
        preds: np.ndarray,
        table_lines: List[str],
        flag: int,
    ) -> None:
        end = self._ensure_end()
        rec = pack_v2_record(rows, preds, table_lines, flag)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        mode = "r+b" if os.path.exists(self.path) else "w+b"
        # a mid-write ENOSPC/EIO leaves a torn record past `end`;
        # self._end only advances on success, so the next commit seeks
        # back and overwrites it — and load() honors only records whose
        # bytes are all present either way
        with io_open(self.path, mode) as fh:
            fh.seek(end)  # overwrite any torn tail
            fh.write(rec)
            fh.truncate()
            fh.flush()
        self._end = end + len(rec)

    def write_checkpoint(
        self,
        planes: Dict[str, np.ndarray],
        preds: np.ndarray,
        row_ends: np.ndarray,
        flags: np.ndarray,
        tables_bytes: bytes,
    ) -> None:
        """Atomically replace the file with a checkpoint covering the
        whole committed state (tmp + rename: a crash leaves either the
        old file or the new one, never a hybrid)."""
        blob = pack_v3_checkpoint(
            planes, preds, row_ends, flags, tables_bytes
        )
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with io_open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            io_fsync(fh)
        io_replace(tmp, self.path)
        self._end = len(blob)

    def reset(self) -> None:
        if os.path.exists(self.path):
            io_remove(self.path)
        self._end = 0
        self._counts = None

    def destroy(self) -> None:
        self.reset()
        self._end = None

    def close(self) -> None:
        pass


class SlabColumnStorage(FileColumnStorageV2):
    """One feed's sidecar served from the corpus slab (storage/slab.py).

    Byte format per feed is identical to the `.cols2` single file —
    the slab just frames many of them in one file — so this subclass
    only redirects the byte source: loads slice the slab's mmap,
    commits append record segments, checkpoints append a fresh image.
    A legacy `.cols2` file migrates lazily on first read: its bytes
    become the feed's image segment and the file is deleted (sidecars
    are derived data — a crash between the two at worst rebuilds from
    blocks, the cache's normal recovery)."""

    def __init__(
        self, slab, name: str, legacy_v2: Optional[str] = None
    ) -> None:
        super().__init__(slab.path + "#" + name)  # diagnostic only
        self._slab = slab
        self._name = name
        self._legacy_v2 = legacy_v2

    def load_v3(self):
        from .slab import KIND_IMAGE

        raw = self._slab.image_bytes(self._name)
        if not raw and not self._slab.has(self._name):
            lp = self._legacy_v2
            if lp is not None and os.path.exists(lp):
                with open(lp, "rb") as fh:
                    raw = fh.read()
                self._slab.append(KIND_IMAGE, self._name, raw)
                try:
                    io_remove(lp)
                except OSError:
                    pass
        return self._load_v3_bytes(raw)

    def commit_change(self, rows, preds, table_lines, flag) -> None:
        from .slab import KIND_RECORD

        self._slab.append(
            KIND_RECORD,
            self._name,
            pack_v2_record(rows, preds, table_lines, flag),
        )

    def write_checkpoint(
        self, planes, preds, row_ends, flags, tables_bytes
    ) -> None:
        from .slab import KIND_IMAGE

        self._slab.append(
            KIND_IMAGE,
            self._name,
            pack_v3_checkpoint(planes, preds, row_ends, flags, tables_bytes),
        )

    def reset(self) -> None:
        from .slab import KIND_TOMBSTONE

        if self._slab.feed_live(self._name):
            self._slab.append(KIND_TOMBSTONE, self._name, b"")
        lp = self._legacy_v2
        if lp is not None and os.path.exists(lp):
            io_remove(lp)
        self._counts = None

    def destroy(self) -> None:
        self.reset()

    def close(self) -> None:  # the slab is owned/closed by the repo
        pass


def memory_column_storage_fn(_name: str) -> MemoryColumnStorage:
    return MemoryColumnStorage()


def file_column_storage_fn(root: str):
    """Sidecars live in the corpus slab (storage/slab.py): one file, one
    open, sequential reads for a whole cold start. Per-feed `.cols2`
    files written by older versions migrate into the slab lazily on
    first read; directories written by the oldest 4-file layout keep
    loading through their reader. HM_SLAB=0 restores the per-feed
    single-file layout. The returned fn carries the slab handle as
    `fn.slab` (the backend compacts + closes it on shutdown)."""
    use_slab = os.environ.get("HM_SLAB", "1") != "0"
    slab = None
    if use_slab:
        from .slab import CorpusSlab

        slab = CorpusSlab(os.path.join(root, "cols.slab"))

    def fn(name: str):
        legacy = os.path.join(root, name[:2], name + ".cols")
        v2 = os.path.join(root, name[:2], name + ".cols2")
        if slab is not None and slab.has(name):
            return SlabColumnStorage(slab, name, legacy_v2=v2)
        if os.path.isdir(legacy) and not os.path.exists(v2):
            return FileColumnStorage(legacy)
        if slab is None:
            return FileColumnStorageV2(v2)
        return SlabColumnStorage(slab, name, legacy_v2=v2)

    fn.slab = slab
    return fn


# ---------------------------------------------------------------------------
# the cache


class _Interner:
    def __init__(self) -> None:
        self.items: List[Any] = []
        self._index: Dict[Any, int] = {}

    def add(self, item: Any) -> int:
        idx = self._index.get(item)
        if idx is None:
            idx = len(self.items)
            self.items.append(item)
            self._index[item] = idx
        return idx

    def __contains__(self, item: Any) -> bool:
        return item in self._index


class FeedColumnCache:
    """Maintains the columnar encoding of one feed.

    Writers call `append_change` after every block append (Actor does
    this for both local writes and decoded remote blocks); bulk loaders
    call `columns()` — a cheap incremental concatenation after the first
    load. The encode mirrors ops/columnar.py `_pack_one` semantics:
    INC rides ref_* with no pred edges; ops are dropped at *pack* time
    (not here) when their obj/ref targets are absent from the packed
    window."""

    def __init__(self, storage, writer: str) -> None:
        self._storage = storage
        self._lock = make_rlock("store.colcache")
        self.writer = writer
        self._loaded = False  # storage read is deferred: a bulk cold
        # start creates thousands of caches serially but loads them in
        # parallel (RepoBackend._prefetch_columns)

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        self._actors = _Interner()
        self._keys = _Interner()
        self._strings = _Interner()
        self._floats = _Interner()
        self._bigints = _Interner()
        self._pending_tables = []
        self._base_planes: Optional[Dict[str, np.ndarray]] = None
        self._base_meta = None
        n_tail = 0
        lv3 = getattr(self._storage, "load_v3", None)
        if lv3 is not None:
            (
                self._base_planes, rows, preds, tables, commits, n_tail,
                self._base_meta,
            ) = lv3()
        else:
            rows, preds, tables, commits = self._storage.load()
        self._apply_tables(tables)
        if self.writer not in self._actors:
            # fresh cache: actor 0 is the writer (the table line flushes
            # with the first commit)
            self._intern("a", self._actors, self.writer)
        self._base_rows = (
            len(self._base_planes["action"])
            if self._base_planes is not None
            else 0
        )
        self._row_chunks: List[np.ndarray] = [rows] if len(rows) else []
        self._pred_chunks: List[np.ndarray] = [preds] if len(preds) else []
        self._n_rows_total = self._base_rows + len(rows)
        self._n_preds_total = len(preds)
        self._commits_arr: np.ndarray = np.asarray(
            commits, np.int32
        ).reshape(-1, COMMIT_FIELDS)
        self._commits_new: List[Tuple[int, int, int, int]] = []
        self._cached: Optional[FeedColumns] = None
        # long v2 tails re-pay the per-record parse on every cold load:
        # fold them into the checkpoint now (atomic rewrite)
        if n_tail >= int(os.environ.get("HM_CKPT_TAIL", "64")):
            try:
                self.compact()
            except OSError:  # read-only media: served from memory fine
                pass

    # -- table interning ----------------------------------------------

    def _apply_tables(self, lines: List[str]) -> None:
        if not lines:
            return
        kinds = {
            "a": self._actors,
            "k": self._keys,
            "s": self._strings,
            "f": self._floats,
            "b": self._bigints,
        }
        # one C-level parse for the whole file beats a json.loads per line
        # (bulk cold opens read tens of thousands of these)
        for rec in json.loads("[" + ",".join(lines) + "]"):
            t = rec["t"]
            v = rec["v"]
            kinds[t].add(int(v) if t == "b" else v)

    def _intern(self, kind: str, interner: _Interner, v: Any) -> int:
        if v in interner:
            return interner.add(v)
        idx = interner.add(v)
        jv = str(v) if kind == "b" else v
        self._pending_tables.append(
            json.dumps({"t": kind, "v": jv}, separators=(",", ":"))
        )
        return idx

    # -- encode --------------------------------------------------------

    @property
    def n_changes(self) -> int:
        with self._lock:
            self._ensure_loaded()
            return len(self._commits_arr) + len(self._commits_new)

    def append_change(self, change: Optional[Change]) -> None:
        """Encode one change (None = corrupt block placeholder)."""
        with self._lock:
            self._ensure_loaded()
            if change is None:
                lines = self._take_pending()
                try:
                    self._storage.commit_change(
                        np.zeros((0, ROW_FIELDS), np.int32),
                        np.zeros((0, PRED_FIELDS), np.int32),
                        lines,
                        1,
                    )
                except BaseException:
                    self._pending_tables = lines + self._pending_tables
                    raise
                self._commits_new.append(
                    (self._total_rows(), self._total_preds(), 0, 1)
                )
                self._cached = None
                return
            rows, preds = self._encode(change)
            lines = self._take_pending()
            try:
                self._storage.commit_change(rows, preds, lines, 0)
            except BaseException:
                # ENOSPC/EIO mid-commit: the interners already hold the
                # new table entries, so the un-persisted lines MUST go
                # back on the pending queue — dropping them would make
                # every later commit reference table indices the file
                # never defines (silently wrong values after reload)
                self._pending_tables = lines + self._pending_tables
                raise
            if len(rows):
                self._row_chunks.append(rows)
                self._n_rows_total += len(rows)
            if len(preds):
                self._pred_chunks.append(preds)
                self._n_preds_total += len(preds)
            self._commits_new.append(
                (self._total_rows(), self._total_preds(), 0, 0)
            )
            self._cached = None

    def _take_pending(self) -> List[str]:
        lines = self._pending_tables
        self._pending_tables = []
        return lines

    def _total_rows(self) -> int:
        return self._n_rows_total

    def _total_preds(self) -> int:
        return self._n_preds_total

    def _encode(self, change: Change) -> Tuple[np.ndarray, np.ndarray]:
        base = self._total_rows()
        out_rows: List[List[int]] = []
        out_preds: List[Tuple[int, int, int]] = []
        # hoisted out of the closure: the guarded-attr rule checks the
        # _actors read at THIS (REQUIRES-covered) function depth
        actors = self._actors
        aid = lambda actor: self._intern("a", actors, actor)  # noqa: E731
        for i, op in enumerate(change.ops):
            ctr = change.start_op + i
            if op.obj == ROOT:
                obj_ctr, obj_a = 0, OBJ_ROOT
            else:
                obj_ctr, obj_a = op.obj.ctr, aid(op.obj.actor)
            if op.action == Action.INC:
                if not op.pred:
                    continue  # no target: dropped (matches _pack_one)
                tgt = op.pred[0]
                ref_ctr, ref_a = tgt.ctr, aid(tgt.actor)
            elif op.ref is None:
                ref_ctr, ref_a = 0, REF_NONE
            elif op.ref == HEAD:
                ref_ctr, ref_a = 0, REF_HEAD
            else:
                ref_ctr, ref_a = op.ref.ctr, aid(op.ref.actor)
            vkind, value = self._encode_value(op)
            key = (
                self._intern("k", self._keys, op.key)
                if op.key is not None
                else -1
            )
            dt = (
                1 if op.datatype == "counter"
                else 2 if op.datatype == "timestamp" else 0
            )
            row_idx = base + len(out_rows)
            if op.action != Action.INC:
                for p in op.pred:
                    out_preds.append((row_idx, p.ctr, aid(p.actor)))
            out_rows.append(
                [
                    int(op.action), ctr, change.seq, change.start_op,
                    obj_ctr, obj_a, key, ref_ctr, ref_a,
                    1 if op.insert else 0, vkind, value, dt, 0,
                ]
            )
        rows = np.asarray(out_rows, np.int32).reshape(-1, ROW_FIELDS)
        preds = np.asarray(out_preds, np.int32).reshape(-1, PRED_FIELDS)
        return rows, preds

    def _encode_value(self, op) -> Tuple[int, int]:
        # mirrors ops/columnar.py _encode_value
        v = op.value
        if op.action.makes_object or v is None:
            return VK_NONE, 0
        if isinstance(v, bool):
            return VK_BOOL, 1 if v else 0
        if isinstance(v, int):
            if _INT32_MIN <= v <= _INT32_MAX:
                return VK_INT, v
            return VK_BIGINT, self._intern("b", self._bigints, v)
        if isinstance(v, float):
            return VK_FLOAT, self._intern("f", self._floats, v)
        if isinstance(v, str):
            return VK_STR, self._intern("s", self._strings, v)
        return VK_STR, self._intern("s", self._strings, repr(v))

    # -- decode --------------------------------------------------------

    def reset(self) -> None:
        """Discard the cache and start over (storage included). Invoked
        by Actor when the sidecar claims more changes than the feed holds
        — blocks are the source of truth, so a cache that ran ahead (e.g.
        feed file replaced/truncated out-of-band) must rebuild."""
        with self._lock:
            self._loaded = True  # reset state IS the loaded-fresh state
            self._storage.reset()
            self._base_planes = None
            self._base_meta = None
            self._base_rows = 0
            self._actors = _Interner()
            self._keys = _Interner()
            self._strings = _Interner()
            self._floats = _Interner()
            self._bigints = _Interner()
            self._pending_tables = []
            self._intern("a", self._actors, self.writer)
            self._row_chunks = []
            self._pred_chunks = []
            self._n_rows_total = 0
            self._n_preds_total = 0
            self._commits_arr = np.zeros((0, COMMIT_FIELDS), np.int32)
            self._commits_new = []
            self._cached = None

    def columns(self) -> FeedColumns:
        with self._lock:
            self._ensure_loaded()
            if self._cached is not None:
                return self._cached
            planes = None
            meta = None
            if self._base_planes is not None:
                if not self._row_chunks:
                    planes = self._base_planes  # pure checkpoint load
                    meta = self._base_meta
                else:
                    # live appends landed after the checkpoint: fold the
                    # planes into dense rows once and continue row-wise
                    self._row_chunks.insert(
                        0, rows_from_planes(self._base_planes)
                    )
                    self._base_planes = None
                    self._base_meta = None
                    self._base_rows = 0
            rows = (
                self._row_chunks[0]
                if len(self._row_chunks) == 1  # no-copy: fresh load
                else np.concatenate(self._row_chunks, axis=0)
                if self._row_chunks
                else (
                    None
                    if planes is not None
                    else np.zeros((0, ROW_FIELDS), np.int32)
                )
            )
            preds = (
                self._pred_chunks[0]
                if len(self._pred_chunks) == 1
                else np.concatenate(self._pred_chunks, axis=0)
                if self._pred_chunks
                else np.zeros((0, PRED_FIELDS), np.int32)
            )
            self._row_chunks = (
                [rows] if rows is not None and len(rows) else []
            )
            self._pred_chunks = [preds] if len(preds) else []
            if self._commits_new:
                self._commits_arr = np.concatenate(
                    [
                        self._commits_arr,
                        np.asarray(self._commits_new, np.int32).reshape(
                            -1, COMMIT_FIELDS
                        ),
                    ],
                    axis=0,
                )
                self._commits_new = []
            commits = self._commits_arr
            n = len(commits)
            bad = np.nonzero(commits[:, 3] != 0)[0]
            ok_prefix = int(bad[0]) if len(bad) else n
            row_ends = np.zeros(n + 1, np.int64)
            if n:
                row_ends[1:] = commits[:, 0]
            self._cached = FeedColumns(
                rows=rows,
                preds=preds,
                actors=list(self._actors.items),
                keys=list(self._keys.items),
                strings=list(self._strings.items),
                floats=list(self._floats.items),
                bigints=list(self._bigints.items),
                n_changes=n,
                ok_prefix_len=ok_prefix,
                row_ends=row_ends,
                planes=planes,
                plane_meta=meta,
            )
            return self._cached

    def compact(self) -> None:
        """Fold the storage's whole committed state into one v3
        checkpoint (atomic rewrite). Cold loads of a compacted feed are
        a handful of frombuffer slices; v2 tails re-accumulate with
        live appends until the next compaction (auto at load when the
        tail exceeds HM_CKPT_TAIL records)."""
        with self._lock:
            self._ensure_loaded()
            wc = getattr(self._storage, "write_checkpoint", None)
            if wc is None:
                return
            fc = self.columns()
            if fc.planes is not None:
                planes = fc.planes
            else:
                planes = planes_from_rows(fc.ensure_rows())
            commits = self._commits_arr
            wc(
                planes,
                fc.preds,
                commits[:, 0].astype(np.int64),
                commits[:, 3].astype(np.uint8),
                self._tables_blob(),
            )

    def _tables_blob(self) -> bytes:
        lines = []
        for kind, interner in (
            ("a", self._actors), ("k", self._keys),
            ("s", self._strings), ("f", self._floats),
            ("b", self._bigints),
        ):
            for v in interner.items:
                jv = str(v) if kind == "b" else v
                lines.append(
                    json.dumps({"t": kind, "v": jv}, separators=(",", ":"))
                )
        return ("\n".join(lines) + "\n").encode("utf-8") if lines else b""

    def destroy(self) -> None:
        """Delete the cache's persisted state entirely (doc destroy)."""
        with self._lock:
            self.reset()
            if hasattr(self._storage, "destroy"):
                self._storage.destroy()

    def close(self) -> None:
        self._storage.close()
