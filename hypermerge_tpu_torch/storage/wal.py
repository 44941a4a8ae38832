"""Group-commit write-ahead journal — O(1) fsyncs per commit window (the
port's copy of hypermerge_tpu/storage/wal.py; the journal format is
identical, so either package reads and replays the other's journal).

Without the journal (HM_WAL=0), durable tiers pay per-FEED fsyncs: tier
1's group flusher fsyncs every dirty block log each window (O(dirty
feeds)), and tier 2 fsyncs the log inline on every append. The WAL makes
a durable commit window ONE sequential journal append + ONE fsync
regardless of how many feeds (or writer threads) are dirty:

  - every feed append at HM_FSYNC>=1 also writes an APPEND record
    (feed name, block index, block bytes) to the shared per-repo
    journal (<repo>/wal.log), a pure sequential write;
  - durability = fsync of the JOURNAL only. Tier 2 acks through
    `commit()` — a leader/follower group commit where concurrent
    committers (different docs, different threads, since the per-doc
    emission split) share one fsync. Tier 1 marks the WAL dirty with
    the DurabilityManager, whose debounced flusher calls `sync()`:
    one journal fsync per window, however many feeds changed;
  - the per-feed block logs are written (page cache) at append time
    but fsynced only at CHECKPOINT, off the ack path: when the
    journal exceeds HM_WAL_MAX_BYTES (or at close), every journaled
    storage gets its one `sync()`, then the journal resets to its
    session dirty-name ledger via an atomic tmp+rename rotation — a
    crash at any point mid-checkpoint leaves either the old journal
    (replay is idempotent) or the new one (the logs are already
    durable);
  - recovery (storage/scrub.py) replays the journal prefix into the
    block logs before the per-feed scrub: a power cut that dropped
    unfsynced log pages loses nothing acked, because the acked bytes
    are in the fsynced journal. A torn journal tail (crash mid-record)
    parses as end-of-journal — torn records were never acked.

The journal doubles as the **generation stamp** bounding recovery: its
header carries a per-session id (also written into the `repo.dirty`
marker), and a DIRTY record names every feed touched this session —
checkpoint rotation preserves the name ledger. Recovery after a crash
whose marker matches the journal header therefore scrubs ONLY the
session-dirty feeds instead of scanning every sidecar in the repo
(100k-feed repos recover in O(dirty)). A mismatched or unreadable
journal (older layout, HM_WAL=0 session, tier-0 header) falls back to
the full scan — bounding is an optimization that must never skip real
damage.

Every byte goes through the storage/faults.py io seam, so the crash
tests (tests/test_torch_wal.py) replay journal writes, fsyncs, fsync
LIES, and the checkpoint rename with the same kill -9 / power-cut
fidelity as the block logs.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Set, Tuple

from ..analysis.lockdep import make_condition, make_lock
from ..utils.debug import log
from .faults import io_fsync, io_open, io_remove, io_replace
from .. import telemetry

JOURNAL_NAME = "wal.log"
_MAGIC = b"HMWAL1 "

_REC = struct.Struct("<IIBH")  # payload_len, crc32, kind, name_len
_IDX = struct.Struct("<Q")  # block index (APPEND payload prefix)
K_DIRTY = 1
K_APPEND = 2

# journal telemetry (process registry): the storage.wal.* group —
# append/fsync/checkpoint rates and journal byte flow
_M_APPENDS = telemetry.counter("storage.wal.appends")
_M_BYTES = telemetry.counter("storage.wal.bytes")
_M_FSYNCS = telemetry.counter("storage.wal.fsyncs")
_M_CKPTS = telemetry.counter("storage.wal.checkpoints")
_M_PACED = telemetry.counter("storage.wal.paced_commits")
_M_REPLAYED = telemetry.counter("storage.wal.replayed")


def wal_enabled() -> bool:
    return os.environ.get("HM_WAL", "1") != "0"


def _max_bytes() -> int:
    try:
        return int(os.environ.get("HM_WAL_MAX_BYTES", "67108864"))
    except ValueError:
        return 67108864


def _commit_window_s() -> float:
    try:
        return float(os.environ.get("HM_WAL_MS", "0")) / 1e3
    except ValueError:
        return 0.0


def _encode(kind: int, name: str, payload: bytes) -> bytes:
    nb = name.encode("utf-8")
    crc = zlib.crc32(bytes([kind]) + nb + payload) & 0xFFFFFFFF
    return _REC.pack(len(payload), crc, kind, len(nb)) + nb + payload


class WriteAheadLog:
    """The shared per-repo journal. One instance per file-backed
    RepoBackend session, created AFTER recovery consumed the previous
    session's journal; `session` is the generation stamp the repo
    writes into its crash marker."""

    def __init__(self, path: str, tier: int) -> None:
        self.path = path
        self.session = os.urandom(8).hex()
        self.tier = tier
        self._max_bytes = _max_bytes()
        self._window_s = _commit_window_s()
        self._lock = make_lock("store.wal")
        self._cv = make_condition("store.wal", self._lock)
        header = _MAGIC + json.dumps(
            {"session": self.session, "tier": tier}
        ).encode("utf-8") + b"\n"
        self._fh = io_open(path, "wb")
        self._fh.write(header)
        self._fh.flush()
        # the header (the stamp recovery matches against the crash
        # marker) must be durable at every tier — one fsync per
        # session open, the same cost class as the marker itself
        io_fsync(self._fh)
        self._fh.close()
        self._fh = io_open(path, "ab")
        self._file_bytes = len(header)
        # virtual append offset: MONOTONE across checkpoint rotations
        # (commit tokens survive the file shrinking), in bytes
        self._end = 0
        self._synced = 0
        self._syncing = False
        self._ckpt_running = False
        self._dirty_names: Set[str] = set()
        self._ckpt_pending: Dict[str, object] = {}
        self._closed = False
        # service-plane backpressure hook (set once at wiring, before
        # writers exist): zero-arg callable returning extra seconds to
        # add to the group-commit gather window while the overload
        # controller is in SHED — acks pace down, writes are never
        # dropped once acked. The port runs no service plane yet, so
        # nothing sets it.
        self.ack_pacer = None

    # ------------------------------------------------------------------
    # append + group commit

    def _write_locked(self, rec: bytes) -> bool:
        """Append one encoded record to the journal; heals its own
        torn tail on a failed write (truncate back to the last good
        end) so later records stay parseable. False = journal broken
        (caller falls back to legacy per-feed durability)."""
        try:
            self._fh.write(rec)
            self._fh.flush()
        except OSError as e:
            log("storage:wal", f"journal write failed: {e}")
            try:
                self._fh.truncate(self._file_bytes)
            except OSError:
                # cannot even truncate: stop journaling, the fsynced
                # prefix stays replayable
                self._closed = True
            return False
        self._file_bytes += len(rec)
        self._end += len(rec)
        return True

    def _append_dirty_locked(self, name: str, storage) -> bool:
        if name not in self._dirty_names:
            if not self._write_locked(_encode(K_DIRTY, name, b"")):
                return False
            self._dirty_names.add(name)
        if storage is not None:
            self._ckpt_pending[name] = storage
        return True

    def note_dirty(self, name: str, storage=None) -> None:
        """Ledger-only entry (tier 0): records that `name` was touched
        this session so recovery can bound its scan, without
        journaling payload bytes."""
        with self._cv:
            if self._closed:
                return
            self._append_dirty_locked(name, storage)

    def append(
        self, name: str, index: int, data: bytes, storage=None
    ) -> Optional[int]:
        """Journal one feed block; returns the commit token to pass to
        `commit()` (tier 2) or None when the journal cannot accept it
        (caller falls back to the legacy per-feed path)."""
        rec = _encode(K_APPEND, name, _IDX.pack(index) + bytes(data))
        ckpt = False
        with self._cv:
            if self._closed:
                return None
            if not self._append_dirty_locked(name, storage):
                return None
            if not self._write_locked(rec):
                return None
            end = self._end
            if (
                self._file_bytes > self._max_bytes
                and not self._ckpt_running
            ):
                self._ckpt_running = True
                ckpt = True
        _M_APPENDS.add(1)
        _M_BYTES.add(len(rec))
        if ckpt:
            threading.Thread(
                target=self._checkpoint_bg, daemon=True, name="hm-wal-ckpt"
            ).start()
        return end

    def fsync_debt(self) -> int:
        """Bytes appended but not yet covered by a journal fsync —
        the service plane's WAL pressure signal (normalized against
        HM_WAL_MAX_BYTES)."""
        with self._cv:
            return max(0, self._end - self._synced)

    def commit(self, end: int) -> None:
        """Block until the journal is durable through `end` — the
        group-commit handshake: the first committer in becomes the
        leader and fsyncs for everyone queued behind it."""
        while True:
            with self._cv:
                if self._synced >= end:
                    return
                if self._closed:
                    # woken by closure WITHOUT a covering fsync (a
                    # failed close/broken journal): the append is NOT
                    # durable — raising makes the caller's ack fail
                    # instead of granting a durable ack for bytes
                    # that never reached the platter
                    raise OSError(
                        "journal closed before commit was durable"
                    )
                if not self._syncing:
                    self._syncing = True
                    leader = True
                else:
                    leader = False
                    self._cv.wait(1.0)
            if not leader:
                continue
            pacer = self.ack_pacer
            extra = float(pacer()) if pacer is not None else 0.0
            if extra > 0:
                _M_PACED.add(1)
            gather = self._window_s + extra
            if gather > 0:
                time.sleep(gather)  # gather followers (+ backpressure)
            with self._cv:
                fh = self._fh
                target = self._end
            err: Optional[OSError] = None
            rotated = False
            try:
                io_fsync(fh)
                _M_FSYNCS.add(1)
            except OSError as e:
                err = e
            except ValueError:
                # a checkpoint rotation closed this handle mid-fsync;
                # the rotation itself marked everything durable — loop
                # and re-read _synced instead of failing the commit
                rotated = True
            with self._cv:
                self._syncing = False
                if err is None and not rotated:
                    self._synced = max(self._synced, target)
                self._cv.notify_all()
            if err is not None:
                raise err

    def sync(self) -> None:
        """Make everything journaled so far durable (the tier-1 group
        flusher target and the pre-sqlite barrier): ONE fsync per
        window however many feeds are dirty."""
        with self._cv:
            end = self._end
        self.commit(end)

    # ------------------------------------------------------------------
    # checkpoint (off the ack path)

    def _checkpoint_bg(self) -> None:
        try:
            self.checkpoint()
        except Exception as e:  # pragma: no cover - defensive
            log("storage:wal", f"background checkpoint failed: {e}")
        finally:
            with self._cv:
                self._ckpt_running = False

    def checkpoint(self) -> Dict[str, int]:
        """Drain the journal into the per-feed files: fsync every
        journaled storage (their bytes are already written — this is
        the deferred durability), then reset the journal to its
        session dirty-name ledger with an atomic tmp+rename. Records
        appended DURING the checkpoint are carried over verbatim.
        Crash-safe at every prefix: the old journal replays
        idempotently; the new one only lands after the logs are
        durable."""
        out = {"synced_feeds": 0, "carried_bytes": 0}
        with self._cv:
            if self._closed:
                return out
            pending = self._ckpt_pending
            self._ckpt_pending = {}
            file_mark = self._file_bytes
        items = sorted(pending.items())
        for i, (name, storage) in enumerate(items):
            try:
                storage.sync()
                out["synced_feeds"] += 1
            except (OSError, ValueError) as e:
                log("storage:wal", f"checkpoint sync {name[:8]}: {e}")
                # abort: the journal stays authoritative for this feed
                # AND every not-yet-synced one behind it — dropping
                # them would let a later rotation discard K_APPEND
                # records whose logs never reached the platter
                with self._cv:
                    for n, s in items[i:]:
                        self._ckpt_pending.setdefault(n, s)
                return out
        with self._cv:
            if self._closed:
                return out
            # rotate: header + dirty ledger + any records appended
            # while the syncs ran (their logs are NOT yet durable)
            tail = b""
            if self._file_bytes > file_mark:
                try:
                    with open(self.path, "rb") as rfh:
                        rfh.seek(file_mark)
                        tail = rfh.read()
                except OSError as e:
                    log("storage:wal", f"checkpoint tail read: {e}")
                    return out
            header = _MAGIC + json.dumps(
                {"session": self.session, "tier": self.tier}
            ).encode("utf-8") + b"\n"
            body = b"".join(
                _encode(K_DIRTY, n, b"")
                for n in sorted(self._dirty_names)
            )
            tmp = self.path + ".tmp"
            try:
                with io_open(tmp, "wb") as tfh:
                    tfh.write(header + body + tail)
                    tfh.flush()
                    io_fsync(tfh)
                self._fh.close()
                io_replace(tmp, self.path)
                self._fh = io_open(self.path, "ab")
            except OSError as e:
                log("storage:wal", f"checkpoint rotate failed: {e}")
                try:  # keep appending to the (intact) old journal
                    self._fh = io_open(self.path, "ab")
                except OSError:
                    self._closed = True
                return out
            self._file_bytes = len(header) + len(body) + len(tail)
            out["carried_bytes"] = len(tail)
            # everything journaled before the rotation is durable now:
            # checkpointed records live in fsynced logs, and the
            # carried tail rode the fsynced tmp image
            self._synced = max(self._synced, self._end)
        _M_CKPTS.add(1)
        return out

    # ------------------------------------------------------------------

    def file_bytes(self) -> int:
        with self._cv:
            return self._file_bytes

    def dirty_names(self) -> Set[str]:
        with self._cv:
            return set(self._dirty_names)

    def close(self) -> bool:
        """Final checkpoint + journal reset. True when everything
        reached the platter (the repo only marks itself clean then)."""
        try:
            self.sync()
        except OSError:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            return False
        ok = True
        with self._cv:
            pending = dict(self._ckpt_pending)
            self._ckpt_pending = {}
        for _name, storage in sorted(pending.items()):
            try:
                storage.sync()
            except OSError as e:
                log("storage:wal", f"close sync failed: {e}")
                ok = False
        with self._cv:
            self._closed = True
            fh = self._fh
            self._cv.notify_all()
        try:
            fh.close()
        except OSError:
            pass
        if ok:
            # logs are durable: the journal has served its purpose.
            # Truncate to the bare header so a later crash's recovery
            # (marker left by a FAILED close elsewhere) sees an empty
            # ledger consistent with reality.
            try:
                header = _MAGIC + json.dumps(
                    {"session": self.session, "tier": self.tier}
                ).encode("utf-8") + b"\n"
                with io_open(self.path, "wb") as nfh:
                    nfh.write(header)
                    nfh.flush()
                    io_fsync(nfh)
            except OSError as e:
                log("storage:wal", f"close reset failed: {e}")
                ok = False
        return ok


# ---------------------------------------------------------------------------
# recovery-side reading + replay


def read_journal(path: str):
    """Parse a journal file. Returns (header | None, dirty_names,
    records, torn_bytes) where records is [(name, index, bytes), ...]
    in append order. A torn tail (crash mid-record) terminates the
    parse cleanly — torn records were never acknowledged."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError:
        return None, set(), [], 0
    if not raw.startswith(_MAGIC):
        return None, set(), [], len(raw)
    nl = raw.find(b"\n")
    if nl < 0:
        return None, set(), [], len(raw)
    try:
        header = json.loads(raw[len(_MAGIC):nl].decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None, set(), [], len(raw)
    pos = nl + 1
    dirty: Set[str] = set()
    records: List[Tuple[str, int, bytes]] = []
    end = len(raw)
    while pos + _REC.size <= end:
        plen, crc, kind, nlen = _REC.unpack_from(raw, pos)
        body_end = pos + _REC.size + nlen + plen
        if body_end > end:
            break  # torn tail
        nb = raw[pos + _REC.size: pos + _REC.size + nlen]
        payload = raw[pos + _REC.size + nlen: body_end]
        if zlib.crc32(bytes([kind]) + nb + payload) & 0xFFFFFFFF != crc:
            break  # torn/corrupt record: stop here
        try:
            name = nb.decode("utf-8")
        except UnicodeDecodeError:
            break
        dirty.add(name)
        if kind == K_APPEND and plen >= _IDX.size:
            (index,) = _IDX.unpack_from(payload, 0)
            records.append((name, index, payload[_IDX.size:]))
        pos = body_end
    return header, dirty, records, len(raw) - pos


def recover(back, repair: bool = True) -> Dict:
    """Replay the crashed session's journal into the block logs —
    called by storage/scrub.py BEFORE the per-feed scrub, so torn-tail
    repair and sig-chain reconciliation see the replayed blocks.
    Returns the `wal` section of the scrub report; `bounded`+`dirty`
    tell the scrub which feeds the session could have damaged (the
    generation stamp honored)."""
    path = os.path.join(back.path, JOURNAL_NAME)
    report: Dict = {
        "present": 0, "session_match": 0, "tier": None, "records": 0,
        "dirty_feeds": 0, "replayed": 0, "skipped": 0, "torn_bytes": 0,
        "bounded": 0,
    }
    if not os.path.exists(path):
        return report
    header, dirty, records, torn = read_journal(path)
    report["present"] = 1
    report["torn_bytes"] = torn
    if header is None:
        return report
    report["tier"] = header.get("tier")
    report["records"] = len(records)
    report["dirty_feeds"] = len(dirty)
    report["dirty"] = sorted(dirty)
    marker = b""
    try:
        with open(os.path.join(back.path, "repo.dirty"), "rb") as fh:
            marker = fh.read()
    except OSError:
        pass
    session = str(header.get("session") or "")
    match = bool(session) and marker.decode("utf-8", "replace") == session
    report["session_match"] = 1 if match else 0
    # bounding is only sound when the journal provably belongs to the
    # crashed session AND that session ran a durable tier (tier 0
    # never fsyncs the ledger, so a power cut may have eaten it)
    report["bounded"] = 1 if (match and (header.get("tier") or 0) >= 1) else 0
    if not repair:
        # mirror the real replay's sequential `index == have` walk per
        # feed (a journal with a GAP must preview exactly what repair
        # will append — `index >= have` would overcount past the gap)
        would = 0
        have_sim: Dict[str, int] = {}
        for name, index, _data in records:
            if name not in have_sim:
                storage = back.feeds._storage_fn(name)
                try:
                    have_sim[name] = len(storage)
                finally:
                    storage.close()
            if index == have_sim[name]:
                would += 1
                have_sim[name] += 1
        report["replay_would"] = would
        return report
    # -- replay: append every journaled block the log lost -------------
    by_feed: Dict[str, List[Tuple[int, bytes]]] = {}
    for name, index, data in records:
        by_feed.setdefault(name, []).append((index, data))
    replayed_feeds: Set[str] = set()
    replay_durable = True
    suspend = getattr(back.durability, "suspended", None)
    import contextlib

    ctx = suspend() if suspend is not None else contextlib.nullcontext()
    with ctx:
        for name in sorted(by_feed):
            storage = back.feeds._storage_fn(name)
            try:
                touched = False
                for index, data in sorted(by_feed[name]):
                    have = len(storage)
                    if index == have:
                        storage.append(data)
                        touched = True
                        report["replayed"] += 1
                        replayed_feeds.add(name)
                    else:
                        report["skipped"] += 1
                if touched:
                    # replayed bytes must be durable BEFORE the journal
                    # is reset below (this IS the recovery checkpoint)
                    try:
                        storage.sync()
                    except OSError as e:
                        log("storage:wal", f"replay sync {name[:8]}: {e}")
                        replay_durable = False
            finally:
                storage.close()
    _M_REPLAYED.add(report["replayed"])
    report["replayed_feeds"] = sorted(replayed_feeds)
    if replay_durable:
        try:
            io_remove(path)  # consumed: a fresh session writes its own
        except OSError:
            pass
    else:
        # a replayed block reached only the page cache: the journal
        # stays — another power cut can still replay it. The session
        # must then run journal-less (RepoBackend checks this flag;
        # creating a fresh WriteAheadLog here would truncate the one
        # copy of the un-durable records).
        report["replay_sync_failed"] = 1
    return report
