"""Actor — binds one feed to an in-memory Change list.

Parity: reference src/Actor.ts:44-142 — writes local changes as packed
blocks (seq continuity asserted against feed length), parses downloaded
blocks back into changes, and emits lifecycle events
(ActorInitialized / ActorSync / Download) to the RepoBackend hub.

Accelerator-first deltas from the reference:
- Block decode is **lazy**: opening an actor does not JSON-decode its
  feed (the reference parses every block on feed ready,
  src/Actor.ts:105-117). The interactive path decodes on first access;
  the bulk cold-start path never decodes at all — it reads the columnar
  sidecar via `columns()`.
- The actor maintains the feed's columnar cache (storage/colcache.py)
  on every append, local or replicated, so cold starts stay vectorized.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..analysis.lockdep import make_rlock
from ..crdt.change import Change
from ..storage import block as blockmod
from ..storage.colcache import (
    FeedColumnCache,
    FeedColumns,
    MemoryColumnStorage,
)
from ..storage.feed import Feed
from ..utils.debug import log

_UNSET = object()  # block present but not yet decoded


class Actor:
    def __init__(
        self,
        feed: Feed,
        notify: Callable[[Dict[str, Any]], None],
        defer_cache: Optional[Callable[["Actor"], None]] = None,
    ) -> None:
        self.id = feed.public_key
        self.feed = feed
        self._notify = notify
        # when set, per-append sidecar encoding moves OFF the write's
        # critical path: defer_cache(self) schedules a debounced
        # sync_cache() instead (the sidecar is derived data — columns()
        # catches up on demand, and blocks rebuild it after a crash)
        self._defer_cache = defer_cache
        self._lock = make_rlock("actor")
        # slot per feed block: _UNSET until decoded; None = corrupt.
        # Lazily sized — feed.length forces the block-log scan, which a
        # bulk cold open wants in its parallel prefetch, not in the
        # serial actor-creation loop.
        self._changes: Optional[List[Any]] = None
        self._colcache: FeedColumnCache = feed.colcache or FeedColumnCache(
            MemoryColumnStorage(), writer=self.id
        )
        feed.on_append(self._on_append)
        feed.on_extended(self._on_extended)
        self._pending_dl = [0, 0.0]  # bytes, ms since last Download event
        self._notify({"type": "ActorInitialized", "actor": self})
        self._notify({"type": "ActorSync", "actor": self, "origin": "init"})

    @property
    def writable(self) -> bool:
        return self.feed.writable

    @property
    def changes(self) -> List[Any]:
        """Slot list sized to the feed's block log, re-checked on EVERY
        read, not just first touch: append_verified fires its listener
        callbacks outside the feed lock, so two concurrent backfill
        batches (multi-source repair after churn) can deliver
        _on_append out of order or drop a callback mid-fan-out. A slot
        list that only grew one-per-callback would stay short forever,
        and every reader that trusts len(changes) — seq_head,
        changes_in_window, the sidecar sync — would clamp to the stale
        head and never serve the tail blocks the feed already holds.
        The block log is authoritative; slots decode lazily from it."""
        n = self.feed.length
        if self._changes is None:
            self._changes = [_UNSET] * n
        elif len(self._changes) < n:
            self._changes.extend([_UNSET] * (n - len(self._changes)))
        return self._changes

    @property
    def seq_head(self) -> int:
        with self._lock:
            return len(self.changes)

    def _get_change(self, index: int) -> Optional[Change]:
        c = self.changes[index]
        if c is _UNSET:
            c = self._parse_block(self.feed.get(index), index)
            self.changes[index] = c
        return c

    def _parse_block(self, data: bytes, index: int) -> Optional[Change]:
        try:
            return Change.from_json(blockmod.unpack(data))
        except (ValueError, KeyError, TypeError) as e:
            log("repo:actor", f"corrupt block {index} in {self.id[:6]}: {e}")
            return None

    def write_change(self, change: Change) -> None:
        """Append a locally-generated change; seq must equal feed length+1
        (per-actor total order invariant, reference src/Actor.ts:73-80)."""
        with self._lock:
            head = len(self.changes)
            if change.seq != head + 1:
                log(
                    "repo:actor",
                    f"seq mismatch on {self.id[:6]}: "
                    f"{change.seq} != {head + 1}",
                )
                return
            self.changes.append(change)
            try:
                self.feed.append(blockmod.pack_change(change.to_json()))
            except BaseException:
                # ENOSPC/EIO mid-append: if the block never landed on
                # the feed (storage only advances on success), the
                # in-memory change list must not run ahead either — a
                # phantom entry would break seq continuity for every
                # later write and push the sidecar ahead of the block
                # log. (If the failure struck AFTER the block landed —
                # e.g. a listener — memory and disk already agree.)
                if self.feed.length < len(self.changes):
                    self.changes.pop()
                raise
            if self._defer_cache is None:
                self._sync_cache_locked()
        if self._defer_cache is not None:
            self._defer_cache(self)
        # local writes don't re-notify sync: the doc already applied it

    def _on_append(self, index: int, data: bytes) -> None:
        t0 = time.perf_counter()
        with self._lock:
            # the property sizes to the feed head, which already counts
            # this block; a callback racing ahead of a batch that
            # appended earlier indices (listeners fire outside the feed
            # lock) still lands in bounds
            cs = self.changes
            if len(cs) <= index:
                cs.extend([_UNSET] * (index + 1 - len(cs)))
            if cs[index] is not _UNSET:
                return  # our own write_change already recorded it
            cs[index] = self._parse_block(data, index)
            if self._defer_cache is None:
                self._sync_cache_locked()
            self._pending_dl[0] += len(data)
            self._pending_dl[1] += (time.perf_counter() - t0) * 1e3
        if self._defer_cache is not None:
            self._defer_cache(self)
        self._notify(
            {"type": "ActorSync", "actor": self, "origin": "append"}
        )

    def _on_extended(self, start: int, end: int) -> None:
        """Every non-local extension is a replicated download: one
        progress event per network chunk (reference hypercore 'download'
        -> ActorBlockDownloadedMsg, src/Actor.ts:120-126 — but chunk-
        granular, so a 100k-block backfill is not 100k doc lookups)."""
        with self._lock:
            size, ms = self._pending_dl
            self._pending_dl = [0, 0.0]
        if size == 0:
            return  # our own write_change (no parse happened)
        self._notify(
            {
                "type": "Download",
                "actor": self,
                "index": end - 1,
                "size": size,
                "time": ms,
            }
        )

    def _sync_cache_locked(self) -> None:
        """Bring the columnar sidecar up to the feed head (decodes only
        the blocks the cache is missing — a fresh cache over an existing
        feed rebuilds here). A sidecar AHEAD of the feed (feed file
        replaced or torn-tail-truncated after the sidecar committed) is
        never trusted: blocks are the source of truth, so the cache is
        discarded and rebuilt from them."""
        cc = self._colcache
        n = cc.n_changes
        head = len(self.changes)
        if n > head:
            log(
                "repo:actor",
                f"colcache ahead of feed {self.id[:6]} "
                f"({n} > {head}): rebuilding from blocks",
            )
            cc.reset()
            n = 0
        for i in range(n, head):
            cc.append_change(self._get_change(i))

    def sync_cache(self) -> None:
        """Catch the columnar sidecar up to the feed head (the deferred
        flush target; idempotent)."""
        with self._lock:
            self._sync_cache_locked()

    def columns(self) -> FeedColumns:
        """The feed as columnar arrays (the bulk cold-start input); the
        sidecar is caught up first if stale."""
        with self._lock:
            self._sync_cache_locked()
            return self._colcache.columns()

    def changes_in_window(
        self, start_seq: int, end_seq: float
    ) -> List[Change]:
        """Changes with seq in (start_seq, end_seq] — the syncChanges
        window (reference src/RepoBackend.ts:513-522). seqs are 1-based;
        change at list index i has seq i+1."""
        with self._lock:
            end = min(len(self.changes), int(min(end_seq, len(self.changes))))
            return [
                c
                for c in (
                    self._get_change(i) for i in range(start_seq, end)
                )
                if c is not None
            ]

    def close(self) -> None:
        pass
