"""Deterministic disk-fault injection and crash-schedule recording — the
port's copy of hypermerge_tpu/storage/faults.py, whole.

The harness sits at the storage backends' seam: the file-handle layer
that FileFeedStorage, CorpusSlab, FileColumnStorageV2, FileSigStorage,
the write-ahead journal (storage/wal.py) and SqlDatabase all write
through. It provides:

  DiskFaultPlan   seeded per-path RNG fault schedules: short/torn
                  writes, ENOSPC/EIO on write and fsync, and fsync
                  LIES (the syscall succeeds, the bytes are dropped at
                  the next simulated power cut). Per-path streams are
                  keyed by (seed, path), so which op of a given file
                  faults is reproducible regardless of how threads
                  interleave ops across files — and the same seed
                  draws the same fates in both packages.

  CrashRecorder   records the write/fsync/rename/commit schedule of a
                  workload as an ordered event log; `materialize()`
                  replays any prefix of it into a fresh directory — a
                  simulated crash at that boundary. Two crash models:
                    - kill -9 (default): every syscall issued before
                      the cut survives (the page cache outlives the
                      process);
                    - power cut (`powercut=True`): per file, only
                      bytes covered by an honest fsync survive; writes
                      after the last fsync — and everything a LYING
                      fsync claimed — are gone. SQLite commits are
                      modeled durable at commit (sqlite fsyncs its
                      journal itself).
                  `partial_last` tears the write at the cut, and
                  `base` seeds the replay for workloads that did not
                  start from an empty directory.

  activate        installs a plan and/or a recorder on the seam for
                  the length of a `with` block (one at a time);
                  `harness_gen()` counts installs and uninstalls, so
                  cached write handles (storage/feed.py) reopen
                  through the seam when it moves, and
                  `active_recorder()` is what storage/sql.py journals
                  its statements into (one batch per commit).

  io_open/io_fsync/io_replace/io_remove
                  the seam: drop-in wrappers the storage backends use
                  for every WRITE-side file op. With no harness active
                  they are the builtins (one global read per call);
                  with one active they consult the plan and/or feed
                  the recorder (writes through FaultFile). Read-side
                  opens never route here.

The crash tests (tests/test_torch_faults.py, test_torch_wal.py,
test_torch_crash.py) run workloads under a CrashRecorder, replay sampled
prefixes, reopen the repo, and assert the recovery invariants: reopen
never raises; recovered state is a gapless prefix of acknowledged state;
anything acknowledged under the durable tier (storage/durability.py
HM_FSYNC) survives a power cut.
"""

from __future__ import annotations

import contextlib
import errno
import os
import random
import sqlite3
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import lockdep
from ..analysis.lockdep import make_lock

WRITE = "write"
APPEND = "append"
TRUNCATE = "truncate"
FSYNC = "fsync"
REPLACE = "replace"
UNLINK = "unlink"
DB_COMMIT = "db_commit"

_W_OK = "ok"
_W_ERROR = "error"
_W_TORN = "torn"

_F_OK = "ok"
_F_ERROR = "error"
_F_LIE = "lie"


class DiskFaultPlan:
    """Seeded per-path fault schedule for writes and fsyncs.

    Each path gets its own RNG stream seeded by (seed, relpath), and
    each write/fsync on that path consumes the stream in op order — so
    the fate of "write #7 of feeds/ab/abcd" is a pure function of the
    seed, however the workload interleaves files. `after` ops per path
    are always fault-free (lets a unit test build a healthy prefix and
    then fault the tail deterministically); `path_filter` restricts
    faults to matching relpaths (substring)."""

    def __init__(
        self,
        seed: int = 0,
        write_error_p: float = 0.0,
        torn_write_p: float = 0.0,
        fsync_error_p: float = 0.0,
        fsync_lie_p: float = 0.0,
        errnos: Tuple[int, ...] = (errno.ENOSPC, errno.EIO),
        after: int = 0,
        path_filter: Optional[str] = None,
    ) -> None:
        self.seed = seed
        self.write_error_p = write_error_p
        self.torn_write_p = torn_write_p
        self.fsync_error_p = fsync_error_p
        self.fsync_lie_p = fsync_lie_p
        self.errnos = errnos
        self.after = after
        self.path_filter = path_filter
        self._lock = make_lock("store.fault.plan")
        self._rngs: Dict[str, random.Random] = {}
        self._ops: Dict[str, int] = {}
        self.stats: Dict[str, int] = {
            "write_errors": 0,
            "torn_writes": 0,
            "fsync_errors": 0,
            "fsync_lies": 0,
        }

    def _draw(self, path: str) -> Tuple[random.Random, int]:
        rng = self._rngs.get(path)
        if rng is None:
            rng = random.Random(f"{self.seed}|{path}")
            self._rngs[path] = rng
            self._ops[path] = 0
        n = self._ops[path]
        self._ops[path] = n + 1
        return rng, n

    def _applies(self, path: str) -> bool:
        return self.path_filter is None or self.path_filter in path

    def write_fate(self, path: str, nbytes: int):
        """(fate, errno, n_written_before_error) for the next write on
        `path`. The RNG stream advances even for filtered paths so the
        schedule of every OTHER path stays fixed."""
        with self._lock:
            rng, n = self._draw(path)
            r = rng.random()
            e = self.errnos[rng.randrange(len(self.errnos))]
            torn_at = rng.randrange(nbytes) if nbytes > 1 else 0
            if n < self.after or not self._applies(path):
                return _W_OK, 0, nbytes
            if r < self.write_error_p:
                self.stats["write_errors"] += 1
                return _W_ERROR, e, 0
            if r < self.write_error_p + self.torn_write_p:
                self.stats["torn_writes"] += 1
                return _W_TORN, e, torn_at
            return _W_OK, 0, nbytes

    def fsync_fate(self, path: str):
        """(fate, errno) for the next fsync on `path`."""
        with self._lock:
            rng, n = self._draw(path)
            r = rng.random()
            e = self.errnos[rng.randrange(len(self.errnos))]
            if n < self.after or not self._applies(path):
                return _F_OK, 0
            if r < self.fsync_error_p:
                self.stats["fsync_errors"] += 1
                return _F_ERROR, e
            if r < self.fsync_error_p + self.fsync_lie_p:
                self.stats["fsync_lies"] += 1
                return _F_LIE, 0
            return _F_OK, 0


class CrashRecorder:
    """Ordered write/fsync/rename/commit schedule of a workload under
    `root`, replayable prefix-by-prefix into fresh directories.

    The workload must start from an EMPTY root (materialize replays
    from nothing). SQLite statements journal per-connection and land in
    the event log as one DB_COMMIT batch per commit, so a crash between
    statements of a transaction drops the whole transaction — the same
    atomicity sqlite's rollback journal provides."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self._lock = make_lock("store.fault.recorder")
        self.events: List[Tuple] = []
        self._db_pending: Dict[str, List[Tuple]] = {}

    def rel(self, path: str) -> Optional[str]:
        """Path relative to root, or None for paths outside it (those
        are not recorded — e.g. an unrelated tmp dir)."""
        p = os.path.abspath(path)
        if p == self.root:
            return ""
        prefix = self.root + os.sep
        if not p.startswith(prefix):
            return None
        return p[len(prefix):]

    @property
    def n_points(self) -> int:
        """Number of crash boundaries: before event 0 .. after the
        last event."""
        with self._lock:
            return len(self.events) + 1

    def _emit(self, *event: Any) -> None:
        with self._lock:
            self.events.append(event)

    # -- file ops (called from the io_* seam) --------------------------

    def on_write(self, path: str, offset: Optional[int], data: bytes):
        rel = self.rel(path)
        if rel is None:
            return
        if offset is None:
            self._emit(APPEND, rel, bytes(data))
        else:
            self._emit(WRITE, rel, offset, bytes(data))

    def on_truncate(self, path: str, size: int) -> None:
        rel = self.rel(path)
        if rel is not None:
            self._emit(TRUNCATE, rel, size)

    def on_fsync(self, path: str, lied: bool) -> None:
        rel = self.rel(path)
        if rel is not None:
            self._emit(FSYNC, rel, lied)

    def on_replace(self, src: str, dst: str) -> None:
        rs, rd = self.rel(src), self.rel(dst)
        if rs is not None and rd is not None:
            self._emit(REPLACE, rs, rd)

    def on_unlink(self, path: str) -> None:
        rel = self.rel(path)
        if rel is not None:
            self._emit(UNLINK, rel)

    # -- sqlite ops (called from storage/sql.py) -----------------------

    def db_stmt(self, path: str, kind: str, sql: str, params) -> None:
        rel = self.rel(path)
        if rel is None:
            return
        with self._lock:
            self._db_pending.setdefault(rel, []).append(
                (kind, sql, params)
            )

    def db_commit(self, path: str) -> None:
        rel = self.rel(path)
        if rel is None:
            return
        with self._lock:
            stmts = self._db_pending.pop(rel, [])
            if stmts:
                self.events.append((DB_COMMIT, rel, stmts))

    # -- replay --------------------------------------------------------

    def materialize(
        self,
        dst_root: str,
        upto: int,
        powercut: bool = False,
        partial_last: Optional[int] = None,
        base: Optional[str] = None,
    ) -> None:
        """Build `dst_root` as the on-disk state of a crash after
        `upto` events. kill -9 model: every applied syscall survives.
        Power-cut model: per file, only the image captured by its last
        HONEST fsync before the cut (lying fsyncs capture nothing);
        sqlite commits are durable either way. `partial_last` applies
        only the first N bytes of event `upto` itself (an intra-write
        tear at the crash boundary).

        `base` is the pre-workload snapshot of the root for workloads
        that did NOT start from an empty directory (e.g. crash/recover
        cycles): its files seed the replay, and untouched files carry
        over verbatim. Without it the replay starts from nothing —
        recording over pre-existing state then drops that state."""
        with self._lock:
            events = list(self.events[:upto])
            if partial_last is not None and upto < len(self.events):
                ev = self.events[upto]
                if ev[0] == WRITE:
                    events.append(
                        (WRITE, ev[1], ev[2], ev[3][:partial_last])
                    )
                elif ev[0] == APPEND:
                    events.append((APPEND, ev[1], ev[2][:partial_last]))
        os.makedirs(dst_root, exist_ok=True)
        if base is not None:
            import shutil

            shutil.copytree(base, dst_root, dirs_exist_ok=True)
        volatile: Dict[str, bytearray] = {}
        durable: Dict[str, bytearray] = {}
        removed: set = set()
        dbs: Dict[str, List[List[Tuple]]] = {}

        def seed(rel: str) -> bytearray:
            """The file's working image, seeded from the base snapshot
            on first touch (a write at offset N lands on the base
            bytes, not on zeros)."""
            buf = volatile.get(rel)
            if buf is None:
                buf = bytearray()
                p = os.path.join(dst_root, rel)
                if (
                    base is not None
                    and rel not in removed
                    and os.path.exists(p)
                ):
                    with open(p, "rb") as fh:
                        buf = bytearray(fh.read())
                    # base content was at rest on disk: durable too
                    durable.setdefault(rel, bytearray(buf))
                volatile[rel] = buf
            return buf

        for ev in events:
            kind = ev[0]
            if kind == WRITE:
                _, rel, off, data = ev
                buf = seed(rel)
                removed.discard(rel)
                if len(buf) < off:
                    buf.extend(b"\x00" * (off - len(buf)))
                buf[off:off + len(data)] = data
            elif kind == APPEND:
                _, rel, data = ev
                seed(rel).extend(data)
                removed.discard(rel)
            elif kind == TRUNCATE:
                _, rel, size = ev
                buf = seed(rel)
                removed.discard(rel)
                if len(buf) > size:
                    del buf[size:]
                elif len(buf) < size:
                    buf.extend(b"\x00" * (size - len(buf)))
            elif kind == FSYNC:
                _, rel, lied = ev
                if not lied and rel in volatile:
                    durable[rel] = bytearray(volatile[rel])
            elif kind == REPLACE:
                _, rs, rd = ev
                seed(rs)
                volatile[rd] = volatile.pop(rs)
                removed.add(rs)
                removed.discard(rd)
                # rename is a metadata op: the DURABLE image of the
                # destination is whatever of the source was durable
                # (checkpoint writers fsync before replacing)
                if rs in durable:
                    durable[rd] = durable.pop(rs)
                else:
                    durable.pop(rd, None)
            elif kind == UNLINK:
                _, rel = ev
                volatile.pop(rel, None)
                durable.pop(rel, None)
                removed.add(rel)
            elif kind == DB_COMMIT:
                _, rel, stmts = ev
                dbs.setdefault(rel, []).append(stmts)
        files = durable if powercut else volatile
        for rel, buf in files.items():
            p = os.path.join(dst_root, rel)
            os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
            with open(p, "wb") as fh:
                fh.write(bytes(buf))
        if powercut:
            # a file touched but never fsynced keeps its base image
            # (already on disk from the copy); one CREATED in-session
            # and never fsynced must not exist at all
            for rel in volatile:
                if rel not in durable:
                    p = os.path.join(dst_root, rel)
                    if os.path.exists(p):
                        os.remove(p)
        for rel in removed:
            if rel in files:
                continue
            p = os.path.join(dst_root, rel)
            if os.path.exists(p):
                os.remove(p)
        for rel, batches in dbs.items():
            p = os.path.join(dst_root, rel)
            os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
            conn = sqlite3.connect(p)
            try:
                for stmts in batches:
                    for kind, sql, params in stmts:
                        if kind == "script":
                            conn.executescript(sql)
                        elif kind == "many":
                            conn.executemany(sql, params)
                        else:
                            conn.execute(sql, params)
                    conn.commit()
            finally:
                conn.close()


# ---------------------------------------------------------------------------
# activation + the io_* seam


class _Active:
    def __init__(
        self,
        plan: Optional[DiskFaultPlan],
        recorder: Optional[CrashRecorder],
    ) -> None:
        self.plan = plan
        self.recorder = recorder


_active: Optional[_Active] = None
_active_lock = make_lock("store.fault.active")
# bumped on every install AND uninstall: long-lived cached write
# handles (FileFeedStorage's hot-append fds) compare this to decide
# whether to re-open through the seam — a handle opened before a
# harness activated would otherwise bypass injection/recording
_gen = 0


def harness_gen() -> int:
    return _gen


@contextlib.contextmanager
def activate(
    plan: Optional[DiskFaultPlan] = None,
    recorder: Optional[CrashRecorder] = None,
):
    """Install a fault plan and/or crash recorder on the io_* seam for
    the duration of the block. One harness at a time (tests)."""
    global _active, _gen
    with _active_lock:
        if _active is not None:
            raise RuntimeError("a disk-fault harness is already active")
        _active = _Active(plan, recorder)
        _gen += 1
    try:
        yield _active
    finally:
        with _active_lock:
            _active = None
            _gen += 1


def active_recorder() -> Optional[CrashRecorder]:
    a = _active
    return a.recorder if a is not None else None


def _plan_rel(path: str) -> str:
    """The per-path fault-stream key: recorder-relative when one is
    active (stable across tmp dirs), absolute otherwise."""
    a = _active
    if a is not None and a.recorder is not None:
        rel = a.recorder.rel(path)
        if rel is not None:
            return rel
    return path


class FaultFile:
    """A writable file handle behind the harness: every write consults
    the plan (short/torn writes, ENOSPC/EIO) and feeds the recorder;
    truncate/close pass through with recording. Read-side methods
    delegate untouched."""

    def __init__(self, fh, path: str, append_mode: bool) -> None:
        self._fh = fh
        self.path = path
        self._append = append_mode

    # -- pass-through ---------------------------------------------------

    def read(self, *a):
        return self._fh.read(*a)

    def seek(self, *a):
        return self._fh.seek(*a)

    def tell(self):
        return self._fh.tell()

    def flush(self):
        return self._fh.flush()

    def fileno(self):
        return self._fh.fileno()

    @property
    def closed(self):
        return self._fh.closed

    def close(self):
        return self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._fh.close()
        return False

    # -- faulted ops ----------------------------------------------------

    def write(self, data) -> int:
        a = _active
        data = bytes(data)
        plan = a.plan if a is not None else None
        if plan is not None:
            fate, err, n_ok = plan.write_fate(
                _plan_rel(self.path), len(data)
            )
            if fate == _W_ERROR:
                raise OSError(err, os.strerror(err), self.path)
            if fate == _W_TORN:
                self._write_through(data[:n_ok], a)
                raise OSError(err, os.strerror(err), self.path)
        self._write_through(data, a)
        return len(data)

    def _write_through(self, data: bytes, a: Optional[_Active]) -> None:
        if not data:
            return
        offset = None if self._append else self._fh.tell()
        self._fh.write(data)
        if a is not None and a.recorder is not None:
            a.recorder.on_write(self.path, offset, data)

    def truncate(self, size: Optional[int] = None) -> int:
        if size is None:
            size = self._fh.tell()
        out = self._fh.truncate(size)
        a = _active
        if a is not None and a.recorder is not None:
            a.recorder.on_truncate(self.path, size)
        return out


_WRITE_MODES = ("w", "a", "+", "x")


def io_open(path: str, mode: str = "rb"):
    """The storage backends' open(). Write-capable opens route through
    the harness when one is active; everything else (and the common
    inactive case) is the builtin."""
    a = _active
    if a is None or not any(m in mode for m in _WRITE_MODES):
        return open(path, mode)
    existed = os.path.exists(path)
    fh = open(path, mode)
    if a.recorder is not None:
        if "w" in mode or (not existed and ("a" in mode or "x" in mode)):
            # w/w+ truncate at open; a fresh a/x creates empty
            a.recorder.on_truncate(path, 0)
    return FaultFile(fh, path, append_mode="a" in mode)


def io_fsync(fh) -> None:
    """fsync through the harness: may raise EIO, may LIE (succeed
    without durability — visible only to the power-cut replay)."""
    with lockdep.blocking("fsync", getattr(fh, "path", "") or ""):
        a = _active
        if a is None:
            os.fsync(fh.fileno())
            return
        path = getattr(fh, "path", None)
        lied = False
        if a.plan is not None and path is not None:
            fate, err = a.plan.fsync_fate(_plan_rel(path))
            if fate == _F_ERROR:
                raise OSError(err, os.strerror(err), path)
            lied = fate == _F_LIE
        if not lied:
            os.fsync(fh.fileno())
        if a.recorder is not None and path is not None:
            a.recorder.on_fsync(path, lied)


def io_replace(src: str, dst: str) -> None:
    os.replace(src, dst)
    a = _active
    if a is not None and a.recorder is not None:
        a.recorder.on_replace(src, dst)


def io_remove(path: str) -> None:
    os.remove(path)
    a = _active
    if a is not None and a.recorder is not None:
        a.recorder.on_unlink(path)
