"""Append-only per-actor feeds + FeedStore.

Parity: the hypercore feed + FeedStore surface the reference relies on
(SURVEY.md §2.1 FeedStore; src/types/hypercore.d.ts append/get/getBatch/
stream/on('download'/'sync')). Design differences, accelerator-first:

- A feed is a block log with a signed merkle root per append (signing in
  storage/integrity.py; writable feeds hold the secret key — feed identity
  IS the ed25519 public key, like the reference).
- Storage backends are pluggable like random-access-* (reference
  src/RepoBackend.ts:84): MemoryFeedStorage and FileFeedStorage.
- Readers can subscribe to appends (replication + Actor block parsing).

The columnar bulk loader (ops/columnar.py) reads whole feeds at once for
the batched cold-start path — `read_all` is the API it uses.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Callable, Dict, List, Optional

from ..analysis.lockdep import make_rlock
from ..utils import keys as keymod
from ..utils.debug import log
from ..utils.ids import DiscoveryId, get_or_create
from ..utils.queue import Queue
from .durability import fsync_tier
from .faults import harness_gen, io_fsync, io_open, io_remove


class MemoryFeedStorage:
    def __init__(self) -> None:
        self.blocks: List[bytes] = []

    def append(self, data: bytes) -> None:
        self.blocks.append(data)

    def get(self, index: int) -> bytes:
        return self.blocks[index]

    def __len__(self) -> int:
        return len(self.blocks)

    def destroy(self) -> None:
        self.blocks.clear()

    def close(self) -> None:  # pragma: no cover - nothing to do
        pass


class FileFeedStorage:
    """Length-prefixed block log + block-count index sidecar.

    Crash-safety model matches the reference's append-only philosophy
    (SURVEY.md §5 failure detection): a torn tail write is detected by the
    length prefix running past EOF and the tail is ignored — the same
    self-healing the reference applies to holey feeds
    (reference src/hypercore.ts:39-47).

    The `.len` sidecar holds (block_count, end_offset); when its end
    offset matches the log's stat size, `len(storage)` is a stat call —
    a bulk cold start with fresh columnar sidecars needs only the block
    COUNT of ten thousand feeds (the sidecar-trust check), not their
    bytes. Any mismatch (torn append, out-of-band edit) falls back to a
    full scan. The per-block offset index is built lazily on first
    `get`.

    Durability (storage/durability.py HM_FSYNC): tier 2 fsyncs the log
    inside `append` BEFORE the `.len` sidecar describes it; tier 1
    marks this storage dirty with the repo's DurabilityManager, whose
    group flusher calls `sync()`. Tier 0 (default) never fsyncs —
    crash-safe (torn tails heal), not crash-durable."""

    _HDR = struct.Struct("<I")
    _LEN = struct.Struct("<QQ")  # block count, end offset

    def __init__(self, path: str, durability=None) -> None:
        self.path = path
        self._durability = durability
        self._offsets: List[int] = []
        self._sizes: List[int] = []
        self._end = 0
        self._count: Optional[int] = None  # known count, offsets may lag
        self._scanned = False
        # the does-the-log-exist stat is deferred to first use: a bulk
        # cold open constructs thousands of these and metadata syscalls
        # are a measurable slice of its serial host time
        self._init_checked = False
        # cached write handles (log + .len sidecar): an acked edit's
        # append is the repo's hottest path, and re-opening both files
        # per append was ~0.5ms of serialized syscall+setup cost under
        # the per-doc emission domain (bench config_writers). Handles
        # open lazily on the first append — read-only consumers (the
        # bulk cold open's thousands of storages) never pay an fd —
        # and drop on close/destroy/repair/truncate. The appender
        # (under its doc's emission domain + feed lock) and the WAL
        # checkpoint thread's sync() share these fds: _io serializes
        # every use/drop (analysis/guards.py FileFeedStorage).
        self._io = make_rlock("store.feed_io")
        self._wfh = None
        self._len_fh = None
        self._fh_gen = -1  # faults.harness_gen() the handles saw

    def _check_gen(self) -> None:
        # a fault harness came or went since the handles were opened:
        # they must re-open through the io_* seam, or injected faults
        # and crash recording would bypass the hot path entirely.
        # REQUIRES store.feed_io (analysis/guards.py).
        gen = harness_gen()
        if gen != self._fh_gen:
            self._drop_write_handles()
            self._fh_gen = gen

    def _write_handle(self):
        # REQUIRES store.feed_io (analysis/guards.py)
        self._check_gen()
        if self._wfh is None or self._wfh.closed:
            mode = "r+b" if os.path.exists(self.path) else "w+b"
            self._wfh = io_open(self.path, mode)
        return self._wfh

    def _drop_write_handles(self) -> None:
        # REQUIRES store.feed_io (analysis/guards.py)
        for fh in (self._wfh, self._len_fh):
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass
        self._wfh = None
        self._len_fh = None

    def _check_init(self) -> None:
        if self._init_checked:
            return
        self._init_checked = True
        if not os.path.exists(self.path):
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._scanned = True
            self._count = 0

    def _len_path(self) -> str:
        return self.path + ".len"

    def _write_len(self) -> None:
        # REQUIRES store.feed_io (analysis/guards.py)
        self._check_gen()
        fh = self._len_fh
        if fh is None or fh.closed:
            # w+b then in-place rewrites: the record is fixed-size, so
            # no truncate is ever needed after the first open
            self._len_fh = fh = io_open(self._len_path(), "w+b")
        fh.seek(0)
        fh.write(self._LEN.pack(self._count, self._end))
        fh.flush()

    def _try_count_shortcut(self) -> bool:
        """Trust the .len sidecar iff its end offset equals the log's
        actual size."""
        try:
            with open(self._len_path(), "rb") as fh:
                raw = fh.read(self._LEN.size)
            if len(raw) != self._LEN.size:
                return False
            count, end = self._LEN.unpack(raw)
            if os.path.getsize(self.path) != end:
                return False  # torn append or external edit: rescan
            self._count = count
            self._end = end
            return True
        except OSError:
            return False

    def _ensure_count(self) -> None:
        if self._count is not None:
            return
        if self._try_count_shortcut():
            # a matching .len proves the log exists: the healthy-feed
            # fast path costs one open + one stat, nothing else
            self._init_checked = True
            return
        self._check_init()
        self._ensure_scan()

    def _ensure_scan(self) -> None:
        self._check_init()
        if self._scanned:
            return
        self._scanned = True
        with open(self.path, "rb") as fh:
            raw = fh.read()
        end = len(raw)
        pos = 0
        self._offsets = []
        self._sizes = []
        while pos + self._HDR.size <= end:
            (size,) = self._HDR.unpack_from(raw, pos)
            if pos + self._HDR.size + size > end:
                break  # torn tail: ignore
            self._offsets.append(pos + self._HDR.size)
            self._sizes.append(size)
            pos += self._HDR.size + size
        self._end = pos
        self._count = len(self._offsets)

    def append(self, data: bytes) -> None:
        with self._io:
            self._append_io_locked(data)

    def _append_io_locked(self, data: bytes) -> None:
        # REQUIRES store.feed_io (analysis/guards.py)
        self._ensure_scan()
        tier = fsync_tier()
        # exception safety under mid-write ENOSPC/EIO: the in-memory
        # _offsets/_end/_count only advance AFTER every log byte landed
        # (and, at tier 2, fsynced) — a raise leaves memory pointing at
        # the pre-append end, so the next append seeks there, overwrites
        # the torn tail, and truncates the stale bytes. The (possibly
        # torn) on-disk tail is exactly what the scan already heals.
        # A raise also drops the cached handle: its buffered state is
        # no longer trustworthy.
        try:
            fh = self._write_handle()
            fh.seek(self._end)  # overwrite any torn tail...
            fh.write(self._HDR.pack(len(data)))
            fh.write(data)
            fh.truncate()  # ...and drop stale bytes beyond it, so a later
            # scan can't misparse leftovers as a phantom block
            fh.flush()
            # shared journal (storage/wal.py): at HM_FSYNC>=1 the
            # block's durability is ONE sequential journal append +
            # the group-commit fsync — the log itself stays page-cache
            # only until checkpoint. A raise here (journal fsync
            # error) unwinds exactly like a torn write: memory never
            # advances, the on-disk tail heals on the next append.
            journaled = False
            if self._durability is not None:
                journaled = self._durability.journal_append(
                    self.path, len(self._offsets), data, self
                )
            if tier >= 2 and not journaled:
                # legacy: log durable BEFORE the .len sidecar
                # describes it
                io_fsync(fh)
        except BaseException:
            self._drop_write_handles()
            raise
        self._offsets.append(self._end + self._HDR.size)
        self._sizes.append(len(data))
        self._end += self._HDR.size + len(data)
        self._count = len(self._offsets)
        try:
            self._write_len()
        except OSError as e:
            # the block is durable; the sidecar is advisory (a mismatch
            # just costs the next open a rescan) — never fail the
            # acked append over it
            log("storage:feed", f".len write failed {self.path}: {e}")
        if tier == 1 and not journaled and self._durability is not None:
            self._durability.mark_dirty(self)

    def sync(self) -> None:
        """Make the log (and its .len sidecar) durable: the tier-1
        group-fsync target and the pre-sqlite barrier. Log first, .len
        second — the sidecar must never describe unfsynced bytes.
        Serializes against the appender under _io: the WAL checkpoint
        thread calls this on a storage whose cached handles a writer
        may be mid-append on."""
        if not os.path.exists(self.path):
            return
        with self._io:
            self._check_gen()
            fh = self._wfh
            if fh is not None and not fh.closed:
                # the cached append handle: every append flushed
                # before _io released, so an fd-level fsync is safe
                io_fsync(fh)
            else:
                with io_open(self.path, "r+b") as fh:
                    io_fsync(fh)
            if self._count is not None:
                try:
                    self._write_len()
                    with io_open(self._len_path(), "r+b") as fh:
                        io_fsync(fh)
                except OSError as e:
                    log(
                        "storage:feed",
                        f".len sync failed {self.path}: {e}",
                    )

    def repair(self, write: bool = True) -> Dict[str, int]:
        """Crash recovery: scan the log, physically truncate any torn
        tail, rewrite the .len sidecar. Returns counters for the scrub
        report; write=False only reports (tools/scrub.py --dry-run).
        (Lazy healing would do all of this on the next append; repair
        makes the on-disk state clean NOW so audits, byte accounting,
        and read-only consumers see no leftovers.)"""
        out = {"blocks": 0, "bytes_truncated": 0}
        with self._io:
            self._drop_write_handles()  # repair rewrites out-of-band
            if not os.path.exists(self.path):
                return out
            # force a fresh scan (ignore any .len shortcut state)
            self._scanned = False
            self._count = None
            self._init_checked = True
            self._ensure_scan()
            out["blocks"] = self._count or 0
            size = os.path.getsize(self.path)
            if size > self._end:
                out["bytes_truncated"] = size - self._end
                if write:
                    with io_open(self.path, "r+b") as fh:
                        fh.truncate(self._end)
            if write:
                try:
                    self._write_len()
                except OSError:
                    pass
        return out

    def truncate_to(self, count: int) -> int:
        """Drop blocks beyond `count` (scrub's recovery for a READ-ONLY
        feed whose unsigned tail cannot be trusted — the blocks
        re-replicate from peers). Returns the number dropped."""
        with self._io:
            self._ensure_scan()
            if count >= len(self._offsets):
                return 0
            dropped = len(self._offsets) - count
            self._end = (
                self._offsets[count] - self._HDR.size if count else 0
            )
            del self._offsets[count:]
            del self._sizes[count:]
            self._count = count
            self._drop_write_handles()
            with io_open(self.path, "r+b") as fh:
                fh.truncate(self._end)
            try:
                self._write_len()
            except OSError:
                pass
        return dropped

    def get(self, index: int) -> bytes:
        self._ensure_scan()
        if index >= len(self._offsets):
            # the .len sidecar can promise more blocks than the scan
            # could parse (tampered/torn size header): the log truly
            # ends here — IndexError, not a silent empty read
            raise IndexError(
                f"block {index} beyond scanned log end "
                f"({len(self._offsets)} block(s))"
            )
        with open(self.path, "rb") as fh:
            fh.seek(self._offsets[index])
            return fh.read(self._sizes[index])

    def __len__(self) -> int:
        self._ensure_count()
        return self._count

    def destroy(self) -> None:
        """Remove the block log (and its .len index) from disk."""
        with self._io:
            self._drop_write_handles()
            for p in (self.path, self._len_path()):
                if os.path.exists(p):
                    io_remove(p)
            self._offsets = []
            self._sizes = []
            self._end = 0
            self._count = 0
            self._scanned = True

    def close(self) -> None:
        with self._io:
            self._drop_write_handles()


StorageFn = Callable[[str], object]  # name -> storage backend


def memory_storage_fn(_name: str) -> MemoryFeedStorage:
    return MemoryFeedStorage()


def file_storage_fn(root: str, durability=None) -> StorageFn:
    def fn(name: str) -> FileFeedStorage:
        return FileFeedStorage(
            os.path.join(root, name[:2], name), durability=durability
        )

    return fn


class Feed:
    """One append-only log, identified by its ed25519 public key."""

    def __init__(
        self,
        public_key: str,
        storage,
        secret_key: Optional[str] = None,
    ) -> None:
        self.public_key = public_key
        self.secret_key = secret_key
        self._discovery_id: Optional[str] = None  # lazy: ~40us of
        # base58+blake2b per feed adds up over a 10k-feed cold open
        self._storage = storage
        self._lock = make_rlock("store.feed")
        self._append_listeners: List[Callable[[int, bytes], None]] = []
        # chunk-granularity listeners: cb(start, end) once per extension
        # (a verified multi-block chunk fires ONE of these but one
        # on_append per block) — replication tails and progress events
        # subscribe here to avoid per-block amplification
        self._extend_listeners: List[Callable[[int, int], None]] = []
        # columnar sidecar (storage/colcache.py), attached by FeedStore
        # when a cache_fn is configured; maintained by Actor
        self.colcache = None
        # signed-merkle state (storage/integrity.py), attached by
        # FeedStore; loaded lazily (bulk cold opens never read it)
        self.integrity = None
        # sparse side-buffer: inclusion-proof-verified blocks fetched
        # OUT OF ORDER (net/replication.py range fetch — hypercore's
        # sparse download). The contiguous log stays authoritative;
        # entries are dropped as the head passes them.
        self._sparse: Dict[int, bytes] = {}
        self._sparse_listeners: List[Callable[[int, bytes], None]] = []

    @property
    def writable(self) -> bool:
        return self.secret_key is not None

    @property
    def discovery_id(self) -> str:
        if self._discovery_id is None:
            self._discovery_id = keymod.discovery_id(self.public_key)
        return self._discovery_id

    @property
    def length(self) -> int:
        with self._lock:
            return len(self._storage)

    def append(self, data: bytes) -> int:
        """Writer append: store the block AND extend the signed merkle
        log (storage/integrity.py) before listeners fire, so replication
        tails always have a signature covering what they push."""
        if not self.writable:
            raise PermissionError(f"feed {self.public_key[:8]} not writable")
        with self._lock:
            self._storage.append(data)
            index = len(self._storage) - 1
            if self.integrity is not None:
                self.integrity.sign_append(self, index, data)
            self._prune_sparse_locked()
            listeners = list(self._append_listeners)
            extended = list(self._extend_listeners)
        for cb in listeners:
            cb(index, data)
        for cb in extended:
            cb(index, index + 1)
        return index

    def append_verified(
        self, start: int, blocks: List[bytes], length: int, sig: bytes
    ) -> bool:
        """Replication append: verify the sender's signed merkle root
        over [0, length) BEFORE storing anything (the trust boundary —
        reference: hypercore verifies every replicated block against the
        feed key). Duplicate prefixes are tolerated; a gap or a bad
        signature stores nothing and returns False."""
        if self.integrity is None:
            return False
        with self._lock:
            have = len(self._storage)
            if length <= have:
                return True  # nothing new (stale retransmit)
            if start > have:
                return False  # gap: caller re-requests from our head
            eff = blocks[have - start :]
            if have + len(eff) != length:
                return False
            res = self.integrity.verify_extension(
                self, have, eff, length, sig
            )
            if res is None:
                return False
            root, new_leaves = res
            indices = []
            for b in eff:
                self._storage.append(b)
                indices.append(len(self._storage) - 1)
            self.integrity.record_verified(length, root, sig, new_leaves)
            self._prune_sparse_locked()
            listeners = list(self._append_listeners)
            extended = list(self._extend_listeners)
        for i, b in zip(indices, eff):
            for cb in listeners:
                cb(i, b)
        for cb in extended:
            cb(indices[0], length)
        return True

    def seal(self) -> None:
        """Persist a signed record at the current head. Live appends
        sign lazily (storage/integrity.py sign_interval); seal closes
        the gap so the on-disk chain covers every block — called on
        close and before audit."""
        if self.integrity is not None and self.writable and self.length:
            self.integrity.record_for(self, self.length)

    def audit(self) -> bool:
        """Re-hash the whole block log against the signed record chain
        (on-disk tamper detection). True for an empty unsigned feed.

        Sealing first happens ONLY for a tail this process itself
        appended (unsigned_tail — inside the local trust boundary). A
        tail found on disk beyond the last record — crash leftovers or
        an attacker's append — must FAIL the audit, never be signed
        into validity."""
        from .integrity import AUDIT_OK

        return self.audit_status() == AUDIT_OK

    def audit_status(self) -> str:
        """Three-way audit (storage/integrity.py AUDIT_*): "ok",
        "unsigned_tail" (a writable feed's crash-orphaned lazy-signing
        tail — recoverable: seal() signs a fresh head record), or
        "tampered". In-process unsigned tails are sealed before
        auditing, exactly as audit() always did."""
        from .integrity import AUDIT_TAMPERED

        if self.integrity is None:
            return AUDIT_TAMPERED  # unverifiable: no sig chain storage
        if self.writable and self.integrity.unsigned_tail:
            self.seal()
        return self.integrity.audit_status(self)

    def _append_raw(self, data: bytes) -> int:
        """Append without writability or signature checks. Only for
        callers inside the local trust boundary (tests, migration tools);
        replication MUST use append_verified."""
        with self._lock:
            self._storage.append(data)
            index = len(self._storage) - 1
            self._prune_sparse_locked()
            listeners = list(self._append_listeners)
            extended = list(self._extend_listeners)
        for cb in listeners:
            cb(index, data)
        for cb in extended:
            cb(index, index + 1)
        return index

    def put_sparse(self, index: int, data: bytes) -> bool:
        """Store an out-of-order block the caller has ALREADY verified
        (inclusion proof against a signed root — net/replication.py).

        The buffer is bounded (HM_SPARSE_CAP entries): when full, the
        entry FURTHEST beyond the contiguous head is evicted — blocks
        near the head are about to be absorbed by backfill, while far
        ones can be re-fetched; an incoming block beyond everything
        buffered is simply dropped. A hostile or runaway peer can
        therefore never grow this map without bound.

        Returns True when the block is retrievable afterwards (stored,
        or already covered by the contiguous log) and False when the cap
        dropped it — the replication layer keeps a dropped index in its
        outstanding-request set so a re-served copy is not mistaken for
        an unsolicited push."""
        with self._lock:
            if index < len(self._storage):
                return True  # contiguous log already holds it
            if index not in self._sparse:
                cap = int(os.environ.get("HM_SPARSE_CAP", "1024"))
                if len(self._sparse) >= cap:
                    if not self._sparse:
                        # cap <= 0: the buffer admits nothing — drop the
                        # block instead of max() on an empty dict
                        return False
                    worst = max(self._sparse)
                    if index >= worst:
                        return False  # incoming is the furthest: drop
                    del self._sparse[worst]
            self._sparse[index] = data
            listeners = list(self._sparse_listeners)
        for cb in listeners:
            cb(index, data)
        return True

    def _prune_sparse_locked(self) -> None:
        # caller holds the lock; entries the contiguous head passed are
        # redundant (storage is authoritative for them)
        if self._sparse:
            head = len(self._storage)
            for i in [i for i in self._sparse if i < head]:
                del self._sparse[i]

    def get_sparse(self, index: int) -> Optional[bytes]:
        """Block at `index` from the contiguous log or the sparse
        buffer; None when neither holds it."""
        with self._lock:
            if index < len(self._storage):
                return self._storage.get(index)
            data = self._sparse.get(index)
            if data is None:
                return None
            return data

    def has_block(self, index: int) -> bool:
        with self._lock:
            return index < len(self._storage) or index in self._sparse

    def on_sparse(self, cb: Callable[[int, bytes], None]) -> None:
        with self._lock:
            self._sparse_listeners.append(cb)

    def get(self, index: int) -> bytes:
        with self._lock:
            return self._storage.get(index)

    def get_batch(self, start: int, end: int) -> List[bytes]:
        with self._lock:
            end = min(end, len(self._storage))
            out = []
            for i in range(start, end):
                try:
                    out.append(self._storage.get(i))
                except IndexError:
                    # count index ran ahead of what the block log can
                    # actually parse (tampered/torn header): hand the
                    # caller the true short log — the integrity audit
                    # turns the shortfall into AUDIT_TAMPERED
                    break
            return out

    def read_all(self) -> List[bytes]:
        return self.get_batch(0, self.length)

    def on_append(self, cb: Callable[[int, bytes], None]) -> None:
        with self._lock:
            self._append_listeners.append(cb)

    def off_append(self, cb: Callable[[int, bytes], None]) -> None:
        with self._lock:
            if cb in self._append_listeners:
                self._append_listeners.remove(cb)

    def on_extended(self, cb: Callable[[int, int], None]) -> None:
        with self._lock:
            self._extend_listeners.append(cb)

    def off_extended(self, cb: Callable[[int, int], None]) -> None:
        with self._lock:
            if cb in self._extend_listeners:
                self._extend_listeners.remove(cb)

    def destroy(self) -> None:
        """Delete everything this feed persisted: block log, columnar
        sidecar, signature records."""
        with self._lock:
            if self.colcache is not None:
                self.colcache.destroy()
                self.colcache.close()
            if self.integrity is not None:
                self.integrity.destroy()
            if hasattr(self._storage, "destroy"):
                self._storage.destroy()
            self._storage.close()

    def close(self) -> None:
        if self.integrity is not None and self.integrity.unsigned_tail:
            self.seal()
        if self.colcache is not None:
            self.colcache.close()
        self._storage.close()


class FeedStore:
    """Feeds keyed by public key, with discovery-id lookup.

    Mirrors the reference FeedStore surface (create/append/read/head/
    stream, reference src/FeedStore.ts:26-142) minus streams — readers
    subscribe to appends instead."""

    def __init__(
        self,
        storage_fn: StorageFn,
        cache_fn: Optional[StorageFn] = None,
        sig_fn: Optional[StorageFn] = None,
    ) -> None:
        from .integrity import memory_sig_storage_fn

        self._storage_fn = storage_fn
        self._cache_fn = cache_fn
        self._sig_fn = sig_fn or memory_sig_storage_fn
        self._feeds: Dict[str, Feed] = {}
        self._by_discovery: Dict[str, str] = {}
        self._discovery_pending: List[Feed] = []  # ids computed lazily
        self._lock = make_rlock("store.feed_store")
        self.feed_q: Queue = Queue("feedstore")

    def create(self, pair: keymod.KeyPair) -> Feed:
        return self._open(pair.public_key, pair.secret_key)

    def open_feed(self, public_key: str) -> Feed:
        return self._open(public_key, None)

    def _open(self, public_key: str, secret_key: Optional[str]) -> Feed:
        with self._lock:
            feed = self._feeds.get(public_key)
            if feed is None:
                feed = Feed(
                    public_key, self._storage_fn(public_key), secret_key
                )
                if self._cache_fn is not None:
                    from .colcache import FeedColumnCache

                    feed.colcache = FeedColumnCache(
                        self._cache_fn(public_key), writer=public_key
                    )
                from .integrity import FeedIntegrity

                feed.integrity = FeedIntegrity(
                    self._sig_fn(public_key), public_key
                )
                self._feeds[public_key] = feed
                self._discovery_pending.append(feed)
                self.feed_q.push(feed)
            elif secret_key is not None and feed.secret_key is None:
                feed.secret_key = secret_key
            return feed

    def get_feed(self, public_key: str) -> Optional[Feed]:
        with self._lock:
            return self._feeds.get(public_key)

    def open_if_present(self, public_key: str) -> Optional[Feed]:
        """Open a feed only if its storage already holds blocks (e.g.
        persisted from a previous run). Unlike open_feed this never
        registers/announces an empty feed for an unknown key — lookups
        for bogus ids must not pollute the store."""
        with self._lock:
            feed = self._feeds.get(public_key)
            if feed is not None:
                return feed
            storage = self._storage_fn(public_key)
            has_blocks = len(storage) > 0
            storage.close()  # _open builds its own storage instance
            if not has_blocks:
                return None
        return self._open(public_key, None)

    def _drain_discovery_pending(self) -> None:
        # caller holds the lock
        for feed in self._discovery_pending:
            self._by_discovery[feed.discovery_id] = feed.public_key
        self._discovery_pending.clear()

    def by_discovery_id(self, discovery_id: str) -> Optional[Feed]:
        with self._lock:
            self._drain_discovery_pending()
            pk = self._by_discovery.get(discovery_id)
            return self._feeds.get(pk) if pk else None

    def known_discovery_ids(self) -> List[str]:
        with self._lock:
            self._drain_discovery_pending()
            return list(self._by_discovery.keys())

    def append(self, public_key: str, data: bytes) -> int:
        feed = self._feeds.get(public_key)
        if feed is None:
            raise KeyError(public_key)
        return feed.append(data)

    def read(self, public_key: str, index: int) -> bytes:
        feed = self._feeds.get(public_key)
        if feed is None:
            raise KeyError(public_key)
        return feed.get(index)

    def head(self, public_key: str) -> bytes:
        feed = self._feeds[public_key]
        return feed.get(feed.length - 1)

    def remove(self, public_key: str) -> None:
        """Forget a feed and delete its persisted state (doc destroy) —
        including state persisted by PREVIOUS sessions for feeds never
        opened in this one."""
        with self._lock:
            feed = self._feeds.pop(public_key, None)
            if feed is not None:
                self._discovery_pending = [
                    f for f in self._discovery_pending if f is not feed
                ]
                self._by_discovery = {
                    d: pk
                    for d, pk in self._by_discovery.items()
                    if pk != public_key
                }
        if feed is not None:
            feed.destroy()
            return
        # not open this session: destroy the on-disk state directly,
        # without registering/announcing a transient feed
        storage = self._storage_fn(public_key)
        if hasattr(storage, "destroy"):
            storage.destroy()
        storage.close()
        if self._cache_fn is not None:
            from .colcache import FeedColumnCache

            cc = FeedColumnCache(self._cache_fn(public_key), public_key)
            cc.destroy()
            cc.close()
        from .integrity import FeedIntegrity

        FeedIntegrity(self._sig_fn(public_key), public_key).destroy()

    def close(self) -> None:
        with self._lock:
            for feed in self._feeds.values():
                feed.close()
            self._feeds.clear()
