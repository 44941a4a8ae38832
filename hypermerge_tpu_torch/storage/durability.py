"""Durability tiers for the feed write path (HM_FSYNC).

The hot append path was historically flush()-only: an acknowledged
local edit reached the OS page cache but never the platter, so a power
cut could drop acked writes (a kill -9 could not — the page cache
outlives the process). HM_FSYNC picks the trade:

  HM_FSYNC=0  (default) no fsync on the append path. Crash-SAFE but
              not crash-DURABLE: every format heals torn tails and
              recovery-on-open (storage/scrub.py) reconciles sqlite
              against feed reality, so a crash never corrupts — it can
              only lose the unfsynced tail.
  HM_FSYNC=1  batched group fsync: appends mark their storage dirty
              and a debounced flusher (HM_FSYNC_MS, default 25ms)
              fsyncs every dirty feed log — one fsync per log per
              window, not per append. An acked write is durable within
              one window (or at the next sqlite store flush, whose
              barrier syncs feeds FIRST — see below).
  HM_FSYNC=2  the append is durable when the call returns.

With the shared journal attached (HM_WAL=1, storage/wal.py — the
file-backed default), BOTH durable tiers commit through it instead of
fsyncing per-feed logs: tier 1's window fsyncs the JOURNAL once
(O(1), not O(dirty feeds)); tier 2 rides the journal's leader/
follower group commit, so concurrent writers on different docs share
one fsync. The per-feed logs are fsynced only at checkpoint, off the
ack path; recovery replays the journal prefix. HM_WAL=0 restores the
legacy per-feed behavior below verbatim.

Ordering invariants (the recoverable direction):
  - feed log fsync happens BEFORE the .len/index sidecar describes it
    (a sidecar ahead of the log is detected by the size check and
    rescanned; the log is never behind what the sidecar promises).
  - sqlite clock/cursor commits never land ahead of durable feed
    bytes: the store flusher calls `barrier()` before committing, so
    under tiers 1/2 a clock row can only describe blocks that are
    already on the platter. (Tier 0 relies on recovery-on-open
    clamping clock rows back to feed reality instead.)

Sidecars (columnar slab, signature records) stay flush-only at every
tier: they are derived data — blocks are the source of truth and every
sidecar format detects-and-rebuilds on mismatch.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional, Set

from ..analysis.lockdep import make_lock
from ..utils.debug import log
from .. import telemetry

# storage durability counters (process registry): fsync passes, the
# storages they synced, failures, and pre-sqlite barriers — the
# "is durability keeping up" view for HM_FSYNC=1 daemons
_M_SYNCS = telemetry.counter("storage.fsyncs")
_M_SYNC_ERRS = telemetry.counter("storage.fsync_errors")
_M_BARRIERS = telemetry.counter("storage.barriers")


def fsync_tier() -> int:
    try:
        return int(os.environ.get("HM_FSYNC", "0"))
    except ValueError:
        return 0


def _flush_window_s() -> float:
    return float(os.environ.get("HM_FSYNC_MS", "25")) / 1e3


class DurabilityManager:
    """Owns the dirty-set + group-fsync flusher for tier 1 and the
    pre-sqlite barrier for every tier. Storages call `mark_dirty(self)`
    after an unfsynced append; anything with a `.sync()` method works.
    The flusher thread starts lazily on the first dirty mark (tier 0
    and tier 2 never pay for it)."""

    def __init__(self) -> None:
        self._lock = make_lock("store.durability")
        self._dirty: Set = set()
        self._flusher = None
        self._closed = False
        # the shared group-commit journal (storage/wal.py), attached
        # by the RepoBackend after recovery consumed the previous
        # session's journal; None = legacy per-feed durability
        self.wal = None
        # recovery replay suspends journaling: replayed blocks COME
        # from the journal (single-threaded, scrub-only window)
        self._wal_suspended = 0
        # fired ONCE on the first journal-less feed write, when set
        # (RepoBackend, HM_RECOVER=0 sessions): a preserved crash
        # stamp must stop bounding recovery once writes land outside
        # the preserved journal's ledger
        self.journalless_write_cb = None

    @property
    def tier(self) -> int:
        return fsync_tier()

    @property
    def ack_durable(self) -> bool:
        """HM_ACK_DURABLE=1: a local edit's ack (the LocalPatch echo)
        waits for the WAL group commit at tier 1 — durable acks at
        group-fsync cost. Tier 2 acks are already durable; tier 0 has
        no durability to wait for."""
        return os.environ.get("HM_ACK_DURABLE", "0") == "1"

    def attach_wal(self, wal) -> None:
        with self._lock:
            self.wal = wal

    @contextmanager
    def suspended(self):
        """Journaling off for the caller's block (recovery replay)."""
        self._wal_suspended += 1
        try:
            yield
        finally:
            self._wal_suspended -= 1

    def journal_append(self, path: str, index: int, data: bytes,
                       storage) -> bool:
        """Route one feed-block append through the shared journal.
        True = the journal owns durability for this block (the caller
        skips its per-feed fsync/mark); False = legacy path (no WAL,
        tier 0 ledger-only, or a broken journal)."""
        wal = self.wal
        if wal is None or self._wal_suspended:
            if wal is None and not self._wal_suspended:
                cb = self.journalless_write_cb
                if cb is not None:
                    self.journalless_write_cb = None
                    cb()
            return False
        name = os.path.basename(path)
        tier = self.tier
        if tier < 1:
            # tier 0 never fsyncs — but the dirty-name ledger still
            # bounds a kill -9 recovery's scan
            wal.note_dirty(name, storage)
            return False
        end = wal.append(name, index, data, storage)
        if end is None:
            return False
        if tier >= 2:
            wal.commit(end)  # the leader/follower group fsync
        else:
            self.mark_dirty(wal)  # ONE journal fsync per window
        return True

    def commit_ack(self) -> None:
        """The durable-ack barrier (HM_ACK_DURABLE=1, tier 1): block
        until everything journaled so far — including the caller's
        just-appended block — is on the platter. Riders share the
        leader's ONE fsync (storage/wal.py group commit, HM_WAL_MS
        gather window), so N concurrent writers' durable acks cost one
        journal fsync per window, not N. Without a journal (HM_WAL=0)
        this degrades to the legacy O(dirty feeds) barrier — and the
        journal fsync only vouches for blocks it JOURNALED: an append
        that fell back to the legacy path (transient journal write
        error, broken journal) was mark_dirty'd instead, so any
        non-journal dirty storage forces the legacy barrier too."""
        wal = self.wal
        if wal is not None and not self._wal_suspended:
            try:
                wal.sync()
            except OSError:
                # journal closed/broken without covering the append:
                # the bytes live in the feed logs — fsync those
                self.barrier()
                return
            with self._lock:
                legacy = any(s is not wal for s in self._dirty)
            if legacy:
                self.barrier()
        else:
            self.barrier()

    def mark_dirty(self, storage) -> None:
        if self.tier < 1:
            return
        with self._lock:
            if self._closed:
                return
            self._dirty.add(storage)
            if self._flusher is None:
                from ..utils.debounce import Debouncer

                self._flusher = Debouncer(
                    lambda _batch: self.sync_now(),
                    window_s=_flush_window_s(),
                    name="fsync",
                )
            self._flusher.mark("sync")

    def sync_now(self) -> int:
        """Group-fsync every dirty storage now. Returns the number
        synced. A storage whose sync fails stays dirty — and the
        flusher is re-marked so the retry does not wait for an
        unrelated append (ENOSPC/EIO on fsync must not silently drop
        durability). The FIRST failure re-raises after the pass so
        callers that gate on durability (barrier) see it."""
        with self._lock:
            dirty = list(self._dirty)
            self._dirty.clear()
        n = 0
        first_err: Optional[OSError] = None
        sp = (
            telemetry.begin("storage.fsync_group", "storage",
                            n=len(dirty))
            if dirty
            else telemetry.NOOP
        )
        try:
            for s in dirty:
                try:
                    s.sync()
                    n += 1
                except OSError as e:
                    log("storage:durability", f"sync failed: {e}")
                    _M_SYNC_ERRS.add(1)
                    if first_err is None:
                        first_err = e
                    with self._lock:
                        if not self._closed:
                            self._dirty.add(s)
                            if self._flusher is not None:
                                self._flusher.mark("sync")
        finally:
            # a non-OSError escaping a sync (ValueError from a closed
            # file) must not drop the span or the already-synced count
            sp.end()
            _M_SYNCS.add(n)
        if first_err is not None:
            raise first_err
        return n

    def barrier(self) -> None:
        """Make every dirty feed durable BEFORE the caller commits
        sqlite rows describing it (clocks-ahead-of-feeds is the
        direction recovery cannot undo without truncating history).
        RAISES on a failed fsync: the caller must NOT commit rows for
        bytes that never reached the platter — the store debouncer
        re-queues the batch and retries with backoff."""
        _M_BARRIERS.add(1)
        if self.tier >= 1:
            self.sync_now()

    def flush_now(self, timeout: float = 5.0) -> bool:
        """Settle the tier-1 flusher (tests/bench ack barrier)."""
        f = self._flusher
        if f is not None and not f.flush_now(timeout):
            return False
        self.sync_now()
        return True

    def close(self) -> bool:
        """Final drain. Returns True when everything dirty reached the
        platter — the backend only marks the repo CLEAN (removes the
        crash marker) on a True close; a failed final sync leaves the
        marker so the next open runs recovery."""
        with self._lock:
            self._closed = True
            f = self._flusher
            self._flusher = None
        if f is not None:
            f.close()
        # final drain: anything still dirty gets one last sync
        with self._lock:
            dirty = list(self._dirty)
            self._dirty.clear()
            wal = self.wal
        clean = True
        for s in dirty:
            try:
                s.sync()
            except OSError as e:
                log("storage:durability", f"close sync failed: {e}")
                clean = False
        if wal is not None:
            # final checkpoint: per-feed logs durable, journal reset —
            # a clean close leaves nothing to replay
            clean = wal.close() and clean
        return clean
