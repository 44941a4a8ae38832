"""RepoBackend — the orchestration hub (the port's copy of
hypermerge_tpu/backend/repo_backend.py).

Parity: reference src/RepoBackend.ts:55-651 — owns storage, doc backends,
actors, cursor/clock stores; routes every event. Message protocol to the
frontend is JSON dicts (msgs.py), so the frontend can live on another
thread/process (SURVEY.md §7.1).

Bulk cold-start: `load_documents_bulk` packs many docs' feeds into one
columnar batch and materializes them in slab-sized GPU dispatches
(ops/crdt_kernels.py run_batch_full); `fetch_bulk_summaries` is the
barrier that brings each slab's summary wire to the host. The stages run
as the streaming slab pipeline (backend/pipeline.py: sidecar IO and
specs on an IO thread, packs on a pool of GIL-free pack workers, the
slab's launch on the caller thread, the wire's wait and parse on fetch
workers) where the reference's gate enables it (`pipeline_enabled`: the
native pack loads and drops the GIL, or HM_PIPELINE=1), else serially
(HM_PIPELINE=0, the correctness twin, `_load_slabs_serial`).

The backend runs on its device (`device`, cuda unless "cpu"), which it
hands to the clock mirror, the bulk loader and the read-serving tier.
When two or more ranks of that device type are visible
(parallel/mesh.py `visible_devices`: every CUDA card) and HM_MESH is not
0, the pipelined loader streams whole slabs round-robin over them
(`_slab_rr`: parallel/sharded.py `MeshBulkScheduler`, stat `rr_slabs`;
HM_SLAB_RR=0 turns it off) and the serial loader shards each slab over
a mesh of them (`sharded_full`, stat `sharded_slabs`), as the reference
does.
Incremental changes on bulk-loaded docs go through the live apply
engine (backend/live.py, `self.live`; HM_LIVE=0 keeps the host-OpSet
twin), as in the reference.
A file-backed repo keeps the reference's durability: the shared
write-ahead journal (storage/wal.py, on unless HM_WAL=0) and recovery on
open (storage/scrub.py): a directory left with its `repo.dirty` marker
is recovered before the clock mirror attaches and before any doc opens
(`recovery_report`; HM_RECOVER=0 skips it, keeps the crashed marker and
journal, and runs the session journal-less), and the marker carries the
journal's session stamp that bounds the next recovery's scan.
The network hooks are the reference's: `set_swarm` attaches a Network
(net/network.py: TcpSwarm or LoopbackSwarm transports, replication,
cursor gossip), and every hook stays behind `self.network is not None`,
so a repo with no swarm runs as before. Changes that arrive from a peer
apply through the live engine's tick on the device, as local ones do.
The service plane (serve/overload.py) is the reference's: a brownout
ladder on this backend's own signals, admitting reads at `read_doc` and
pacing the journal's durable acks. It runs under HM_SERVICE=1; unlike the
reference, the port's default is off (HM_SERVICE=0), because its read_mix
cell sheds under the reference's ladder (ROADMAP.md, open items).
Hyperfiles are the reference's: `get_file_store` (files/file_store.py,
swarm-wired for remote fetch, its completed uploads into `meta`) and
`start_file_server` (files/file_server.py, HTTP over a unix socket).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..analysis.lockdep import make_lock, make_rlock, maybe_install_racedep
from ..device import DeviceLike, resolve
from .. import msgs
from ..crdt import clock as clockmod
from ..crdt.change import Change, ChangeRequest
from ..storage.colcache import (
    file_column_storage_fn,
    memory_column_storage_fn,
)
from ..storage.feed import (
    FeedStore,
    file_storage_fn,
    memory_storage_fn,
)
from ..storage.sql import SqlDatabase
from ..storage.stores import (
    ClockStore,
    CursorStore,
    FeedInfoStore,
    KeyStore,
)
from ..utils import keys as keymod
from ..utils.debug import log
from ..utils.ids import root_actor_id
from .. import telemetry
from ..utils.queue import Queue
from ..files.file_store import FileStore
from .actor import Actor
from .doc_backend import DocBackend
from .metadata import Metadata

# device->host summary-wire transfer bytes (handle cached — one
# per-slab bump)
_M_D2H = telemetry.counter("mesh.d2h_bytes")


def _start_host_copy(wire):
    """(host tensor, copy events) for a slab's summary wire: one tensor, or
    a ShardedTensor whose ranks each hold a row slice. On the GPU the copy
    into ONE pinned host buffer starts now, without blocking (each rank's
    rows at their row offset, one event per rank), and the barrier
    (_fetch_slab) waits on those events alone, so the transfer overlaps
    later slabs' pack and compute; a wire on the CPU is its own host
    copy, with nothing to wait on."""
    shards = getattr(wire, "shards", [wire])
    if wire.device.type != "cuda":
        return (wire.cpu() if len(shards) > 1 else wire), []
    host = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
    copied, row = [], 0
    for part in shards:
        with torch.cuda.device(part.device):
            host[row : row + part.shape[0]].copy_(part, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        copied.append(event)
        row += part.shape[0]
    return host, copied


# actor id -> discovery id is a pure hash of an immutable key: memoize
# it for the telemetry payload's per-poll sweep over every doc's actors
_discovery_id_cached = functools.lru_cache(maxsize=65536)(
    keymod.discovery_id
)


def _merge_store_marks(old, new):
    """Within-window merge for the debounced store flusher's marks:
    clock dicts merge per-actor max-wins (two cursor-gossip frames in
    one window must not drop the older frame's actors), cursor seqs
    take the max. The sqlite upserts are monotonic anyway; this keeps
    the in-window view equally monotonic."""
    if isinstance(old, dict) and isinstance(new, dict):
        out = dict(old)
        for k, v in new.items():
            if v > out.get(k, 0):
                out[k] = v
        return out
    if isinstance(old, int) and isinstance(new, int):
        return max(old, new)
    return new


class RepoBackend:
    def __init__(
        self, path: Optional[str] = None, memory: bool = False,
        device: DeviceLike = None,
    ) -> None:
        if not memory and path is None:
            raise ValueError("need a path unless memory=True")
        maybe_install_racedep()  # the reference's HM_RACEDEP hook
        self.path = path
        self.memory = memory
        self.device = resolve(device)
        from ..storage.integrity import (
            file_sig_storage_fn,
            memory_sig_storage_fn,
        )

        from ..storage.durability import DurabilityManager

        # durability tiers (HM_FSYNC, storage/durability.py): feed
        # appends either fsync inline (tier 2), group-fsync on this
        # manager's debounced flusher (tier 1), or not at all (tier 0 —
        # crash-safe via recovery, not crash-durable)
        self.durability = DurabilityManager()
        if memory:
            storage_fn = memory_storage_fn
            cache_fn = memory_column_storage_fn
            sig_fn = memory_sig_storage_fn
            db_path = ":memory:"
            self._dirty_marker = None
            was_dirty = False
        else:
            storage_fn = file_storage_fn(
                os.path.join(path, "feeds"), durability=self.durability
            )
            cache_fn = file_column_storage_fn(os.path.join(path, "feeds"))
            sig_fn = file_sig_storage_fn(os.path.join(path, "feeds"))
            os.makedirs(path, exist_ok=True)
            db_path = os.path.join(path, "repo.db")
            # crash detection: the marker exists for exactly the life
            # of a session that may write; close() removes it after
            # every flusher drained. Present at open = the previous
            # session crashed -> run whole-repo recovery below.
            self._dirty_marker = os.path.join(path, "repo.dirty")
            was_dirty = os.path.exists(self._dirty_marker)
        # corpus slab handle (storage/slab.py) when file-backed: the
        # backend owns its lifecycle (compaction on close)
        self._col_slab = getattr(cache_fn, "slab", None)
        self.db = SqlDatabase(db_path)
        self.clocks = ClockStore(self.db, device=self.device)
        self.cursors = CursorStore(self.db)
        self.key_store = KeyStore(self.db)
        self.feed_info = FeedInfoStore(self.db)
        self.feeds = FeedStore(storage_fn, cache_fn, sig_fn)
        self.id: str = self.key_store.get_or_create("self.repo").public_key
        # every secret key this repo ever persisted, by PUBLIC key —
        # one query, not one per actor. Writable actors stay writable
        # across restarts (the reference persists keys the same way).
        self._actor_keys = {
            p.public_key: p
            for p in self.key_store.all_pairs().values()
            if p.secret_key
        }
        # whole-repo crash recovery (storage/scrub.py): replay the
        # journal, audit/truncate torn tails, repair the sig chains,
        # reset sidecars that ran ahead, clamp the sqlite clock rows to
        # what the feeds hold. Runs BEFORE the clock mirror attaches (it
        # seeds from the clamped rows) and before any doc opens.
        self.recovery_report: Optional[Dict] = None
        recovery_skipped = False
        if was_dirty and os.environ.get("HM_RECOVER", "1") != "0":
            from ..storage.scrub import recover_repo

            self.recovery_report = recover_repo(self)
        elif was_dirty:
            recovery_skipped = True
        # shared group-commit journal (storage/wal.py): created AFTER
        # recovery consumed the crashed session's journal. With
        # recovery explicitly skipped (HM_RECOVER=0) the crashed
        # journal must survive for a manual recovery pass, so this
        # session runs journal-less and durable appends take the legacy
        # per-feed path. Same when recovery RAN but a replayed feed's
        # fsync failed: the old journal is the only durable copy of
        # those records, and a fresh WriteAheadLog at the same path
        # would truncate it.
        wal_rep = (self.recovery_report or {}).get("wal") or {}
        replay_incomplete = bool(wal_rep.get("replay_sync_failed"))
        if not memory and not recovery_skipped and not replay_incomplete:
            from ..storage.wal import WriteAheadLog, wal_enabled

            if wal_enabled():
                try:
                    self.durability.attach_wal(
                        WriteAheadLog(
                            os.path.join(path, "wal.log"),
                            self.durability.tier,
                        )
                    )
                except OSError as e:
                    log("repo:backend", f"no write-ahead journal: {e}")
        if recovery_skipped and self._dirty_marker is not None:
            # the preserved stamp bounds a FUTURE recovery's scan to
            # the crashed session's dirty ledger — sound only while
            # that ledger covers all damage. The first journal-less
            # feed write of THIS session breaks that: invalidate the
            # stamp then (not at open — a read-only session must leave
            # it byte-for-byte intact).
            self.durability.journalless_write_cb = (
                self._invalidate_recovery_stamp
            )
        if self._dirty_marker is not None and not recovery_skipped:
            from ..storage.faults import io_fsync, io_open

            # the marker must be DURABLE: if a power cut erased it,
            # reopen would silently skip recovery — and tier 0 depends
            # on recovery-on-open to reconcile clocks with feeds. Its
            # CONTENT is the journal's session id (the generation
            # stamp): recovery bounds its scan to the journal's dirty
            # ledger only when marker and journal header agree. With
            # recovery explicitly skipped (HM_RECOVER=0) the CRASHED
            # session's marker+stamp must survive untouched.
            with io_open(self._dirty_marker, "wb") as fh:
                if self.durability.wal is not None:
                    fh.write(
                        self.durability.wal.session.encode("utf-8")
                    )
                io_fsync(fh)
            self._fsync_dir(path)
        if os.environ.get("HM_CLOCK_MIRROR", "1") != "0":
            # device-resident ClockStore query twin (ops/clock_mirror.py):
            # writes buffer host-side, so this costs nothing until the
            # first bulk union/dominated query
            from ..ops.clock_mirror import DeviceClockMirror

            self.clocks.attach_mirror(
                self.id, DeviceClockMirror(device=self.device)
            )
        self.docs: Dict[str, DocBackend] = {}
        self.actors: Dict[str, Actor] = {}
        self._lock = make_rlock("repo")
        # many-writer plane (hub mode): Create/Open/NeedsActorId arrive
        # tagged with a per-connection writer token; each writing
        # connection gets its OWN actor per doc so N frontends can write
        # one hot doc without sharing (and corrupting) a seq counter.
        # (doc_id, token) -> actor_id; doc_id -> tokens awaiting Ready.
        self._writer_actors: Dict[Any, str] = {}
        self._pending_ready: Dict[str, set] = {}
        self.to_frontend: Queue = Queue("backend:toFrontend")
        self._query_handlers: Dict[str, Callable] = {}
        self.network = None  # attached by set_swarm (net/network.py)
        self.meta = Metadata(self.feeds, self.key_store)
        self.file_store: Optional[FileStore] = None
        self._file_server = None
        self._closed = False
        # bulk-load state: deferred per-actor work (one executemany / one
        # resync instead of per-feed sqlite + sync queries), and the
        # device summary refs the materialization barrier fetches
        self._bulk_deferred_syncs: Optional[set] = None
        self._bulk_feed_rows: Optional[List] = None
        self._bulk_mutex = make_lock("repo.bulk")  # serializes bulk loads:
        # the deferral accumulators above are per-load state
        self._pending_summaries: List = []
        self._pending_memo: List = []
        self._stats_lock = make_lock("repo.stats")
        self._bulk_t0: Optional[float] = None
        # the pipelined load's fetch workers, joined by the barrier
        self._fetch_ctx = None
        self._rr_cached = False  # round-robin scheduler, built lazily
        self._rr_value = None
        # per-doc summary memo: doc_id -> last fetched summary row + the
        # clock it was fetched at. A later bulk load of a doc whose
        # clock has not moved (the same clock rows the device-resident
        # ClockStore mirror tracks) is CLEAN: it skips pack, dispatch,
        # and the summary transfer entirely — only dirty docs ride the
        # wire. Bounded LRU by BYTES (HM_SUMMARY_MEMO_MB, 0 disables) —
        # entries scale with the doc's row bucket, so an entry-count cap
        # would let large buckets pin gigabytes.
        from collections import OrderedDict

        self._summary_memo: "OrderedDict[str, Dict]" = OrderedDict()
        self._summary_memo_bytes = 0
        self.last_bulk_stats: Dict[str, int] = {}
        from ..utils.debounce import Debouncer

        # cursor/clock gossip is a latest-state broadcast: debounce it
        # so a burst of local changes to one doc costs one frame (10 ms)
        self._gossip = Debouncer(
            self._flush_gossip, window_s=0.010, name="gossip",
        )
        # inbound-sync application is idempotent window-polling: under
        # edit load many small extensions coalesce into one
        # _sync_changes pass per actor
        self._syncs = Debouncer(
            self._flush_syncs,
            window_s=float(os.environ.get("HM_SYNC_FLUSH_MS", "2"))
            / 1e3,
            name="syncs",
        )
        # sidecar encoding rides OFF the interactive write path: the
        # columnar cache is derived data, caught up by this flusher (or
        # on demand by columns())
        self._cache_syncs = Debouncer(
            lambda actors: [a.sync_cache() for a in actors],
            window_s=float(os.environ.get("HM_CACHE_FLUSH_MS", "5"))
            / 1e3,
            name="colcache",
        )
        # clock/cursor rows are monotonic latest-state: a burst of live
        # patches coalesces into one executemany per window instead of
        # a per-change upsert + read-back (the in-memory doc clock is
        # authoritative; rows rebuild from feeds after a crash)
        self._stores = Debouncer(
            self._flush_store_rows,
            window_s=float(os.environ.get("HM_STORE_FLUSH_MS", "5"))
            / 1e3,
            merge=_merge_store_marks,
            name="stores",
        )
        # read once: _mark_clock_row/_mark_cursor_row run per patch
        self._store_debounce = (
            os.environ.get("HM_STORE_DEBOUNCE", "1") != "0"
        )
        # live apply engine (backend/live.py): incremental changes on
        # lazy docs batch through per-tick kernel dispatches. HM_LIVE=0
        # keeps the host-OpSet path as the correctness twin.
        self.live = None
        if os.environ.get("HM_LIVE", "1") != "0":
            from .live import LiveApplyEngine

            self.live = LiveApplyEngine(self)
        # read-serving tier (serve/): reads answer from device-resident
        # summary lanes through batched query kernels. HM_SERVE=0 keeps
        # per-request host materialization as the bit-identical twin.
        self.serve = None
        if os.environ.get("HM_SERVE", "1") != "0":
            from ..serve import ServeTier

            self.serve = ServeTier(self)
        # service plane (serve/overload.py): the brownout ladder
        # watching this backend's own signals — serve read p99,
        # admission-queue occupancy, WAL fsync debt — and enforcing
        # at the read front door (read_doc) and the WAL ack path.
        # Off unless HM_SERVICE=1: the reference's default is on, but
        # the port's read_mix cell sheds under it (see ROADMAP).
        self.overload = None
        if os.environ.get("HM_SERVICE", "0") != "0":
            self._start_service()

    def _start_service(self) -> None:
        """Build the service plane's controller on this backend's
        signals, wire the journal's ack pacer to it, and start it."""
        from ..serve.overload import HistogramWindow, OverloadController

        self._serve_p99 = (
            HistogramWindow(self.serve._hist)
            if self.serve is not None
            else None
        )
        self.overload = OverloadController(signals=self._service_signals)
        wal = self.durability.wal
        if wal is not None:
            # SHED backpressure: the group-commit leader stretches its
            # gather window — acks pace down, nothing acked is ever
            # dropped
            wal.ack_pacer = self.overload.ack_extra_s
        self.overload.start()

    @staticmethod
    def _fsync_dir(path: str) -> None:
        """Durably record a directory entry (marker create). Advisory:
        platforms without O_DIRECTORY fsync just skip it."""
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def _invalidate_recovery_stamp(self) -> None:
        """First feed write of a journal-less HM_RECOVER=0 session
        (storage/durability.py journalless_write_cb): the crashed
        session's marker+journal were preserved for a manual recovery,
        but this session's writes are OUTSIDE that journal's dirty
        ledger — append a suffix so the stamp stops matching the
        journal header. A crash of THIS session then recovers with
        the full sidecar scan (and still replays the old journal,
        which is session-match independent) instead of trusting a
        ledger that never saw the new damage. The marker itself — the
        crash evidence — survives."""
        if self._dirty_marker is None:
            return
        from ..storage.faults import io_fsync, io_open

        try:
            prev = b""
            try:
                with open(self._dirty_marker, "rb") as fh:
                    prev = fh.read()
            except OSError:
                pass
            if prev.endswith(b"+journalless"):
                return
            with io_open(self._dirty_marker, "wb") as fh:
                fh.write(prev + b"+journalless")
                io_fsync(fh)
        except OSError as e:
            log("repo:backend", f"stamp invalidation failed: {e}")

    def hydrate_feeds(self) -> int:
        """Open every feed the repo has on record (the feeds table) so
        a repo ANNOUNCES and SERVES all its docs without waiting for a
        doc open. Persisted secret keys re-bind writability exactly as
        in _get_or_create_actor; opening a feed is storage-light (no
        CRDT materialization). Returns the number of feeds on record."""
        n = 0
        for pk in self.feed_info.all_public_ids():
            pair = self._actor_keys.get(pk)
            if pair is not None:
                self.feeds.create(pair)
            else:
                self.feeds.open_feed(pk)
            n += 1
        return n

    def identity_seed(self) -> Optional[bytes]:
        """The repo's static ed25519 seed for transport authentication
        (net/secure.py auth frames), or None for readonly repos."""
        from ..utils import base58

        pair = self.key_store.get_or_create("self.repo")
        if pair.secret_key is None:
            return None
        return base58.decode(pair.secret_key)

    # ------------------------------------------------------------------
    # wiring

    def subscribe(self, subscriber: Callable[[Dict[str, Any]], None]) -> None:
        self.to_frontend.subscribe(subscriber)

    def receive(self, msg: Dict[str, Any]) -> None:
        if self._closed:
            return
        t = msg["type"]
        if t == "Create":
            self.create(
                msg["publicKey"], msg["secretKey"],
                writer=msg.get("writer"),
            )
        elif t == "Open":
            self.open(msg["id"], writer=msg.get("writer"))
        elif t == "OpenBulk":
            self.load_documents_bulk(msg["ids"])
        elif t == "Request":
            self.handle_request(msg["id"], msg["request"])
        elif t == "Merge":
            self.merge(msg["id"], clockmod.strs_to_clock(msg["actors"]))
        elif t == "Close":
            self.close_doc(msg["id"])
        elif t == "Destroy":
            self.destroy(msg["id"])
        elif t == "DocMessage":
            self.send_doc_message(msg["id"], msg["contents"])
        elif t == "Query":
            self.handle_query(msg["queryId"], msg["query"])
        elif t == "NeedsActorId":
            doc = self.docs.get(msg["id"])
            if doc is not None:
                writer = msg.get("writer")
                if writer is None:
                    self._ensure_writable_actor(doc)
                else:
                    self._grant_writer_actor(doc, writer)
        elif t == "WriterGone":
            self._drop_writer(msg["writer"])
        else:
            log("repo:backend", "unknown msg", t)

    # ------------------------------------------------------------------
    # doc lifecycle

    def create(
        self,
        public_key: str,
        secret_key: str,
        writer: Optional[int] = None,
    ) -> DocBackend:
        doc_id = public_key
        doc = DocBackend(doc_id, self._doc_notify, None, live=self.live)
        with self._lock:
            self.docs[doc_id] = doc
            if writer is not None:
                # the creating connection claims the root actor (its
                # frontend already assumed actor_id == doc_id); later
                # writers mint fresh actors via NeedsActorId
                self._writer_actors[(doc_id, writer)] = root_actor_id(
                    doc_id
                )
                self._pending_ready.setdefault(doc_id, set()).add(writer)
        self.cursors.add_actor(self.id, doc_id, root_actor_id(doc_id))
        self._init_actor(keymod.KeyPair(public_key, secret_key))
        doc.init([], doc_id)  # root actor is writable on create
        return doc

    def open(
        self, doc_id: str, writer: Optional[int] = None
    ) -> DocBackend:
        with self._lock:
            doc = self.docs.get(doc_id)
            if doc is None:
                doc = DocBackend(
                    doc_id, self._doc_notify, None, live=self.live
                )
                self.docs[doc_id] = doc
                existing = None
            else:
                existing = doc
            if writer is not None and (
                existing is None or not existing._announced
            ):
                # doc still loading: park the token; the DocReady-time
                # _send_ready pops it and emits this writer's Ready
                self._pending_ready.setdefault(doc_id, set()).add(writer)
        if existing is not None:
            if existing._announced:
                # a (re)opened frontend needs the Ready snapshot again.
                # OUTSIDE self._lock: the snapshot takes the live-engine
                # lock, and live.engine ranks ABOVE repo in the declared
                # hierarchy (analysis/hierarchy.py; adoption opens
                # actors under self._lock) — holding repo->engine here
                # would deadlock against a tick. The lint rule
                # `lock-order` flags engine entrypoints called under
                # repo/doc/store locks.
                self._send_ready(existing, writer=writer)
            return existing
        try:
            # a doc closed with store rows still in the debouncer must
            # not reload from the stale rows (load reads cursor/clock
            # directly)
            self._settle_store_rows(doc_id)
            self.cursors.add_actor(self.id, doc_id, root_actor_id(doc_id))
            if not self._load_document_fast(doc):
                self._load_document(doc)
        except BaseException:
            # a failed load must not leave the blank doc registered:
            # every later open() would return it as-is (never loaded,
            # never Ready) even after the failure clears
            with self._lock:
                if self.docs.get(doc_id) is doc:
                    del self.docs[doc_id]
            if self.live is not None:
                self.live.drop(doc_id)
            raise
        return doc

    def merge(self, doc_id: str, clock: clockmod.Clock) -> None:
        """Adopt the target clock's actors into this doc's cursor; actual
        op merge falls out of sync_changes (reference src/RepoBackend.ts:
        213-217)."""
        doc = self.open(doc_id)
        self.cursors.update(self.id, doc_id, clock)
        for actor_id in clock:
            actor = self._get_or_create_actor(actor_id)
            self._sync_changes(actor)
        self._gossip_cursor(doc)

    def close_doc(self, doc_id: str) -> None:
        with self._lock:
            self.docs.pop(doc_id, None)
            self._pending_ready.pop(doc_id, None)
            for key in [
                k for k in self._writer_actors if k[0] == doc_id
            ]:
                del self._writer_actors[key]
        if self.live is not None:
            self.live.drop(doc_id)
        if self.serve is not None:
            self.serve.drop(doc_id)

    def destroy(self, doc_id: str) -> None:
        """Remove ALL doc state: store rows AND the on-disk feeds
        (block logs, columnar sidecars, signature records) of every
        actor exclusive to this doc. Actors shared with other docs keep
        their feeds. (The reference stubs destroy out —
        src/RepoBackend.ts:632-635; here it reclaims disk for real.)"""
        self.close_doc(doc_id)
        # pending debounced rows flushed after the delete would
        # resurrect the destroyed doc's rows — land them first
        self._settle_store_rows(doc_id)
        actors = list(self.cursors.get(self.id, doc_id))
        self.clocks.delete_doc(doc_id)  # peers' rows included
        self.cursors.delete_doc(self.id, doc_id)
        for actor_id in actors:
            others = self.cursors.docs_with_actor(self.id, actor_id)
            if others:  # shared with surviving docs: keep the feed
                continue
            with self._lock:
                self.actors.pop(actor_id, None)
            self._actor_keys.pop(actor_id, None)
            self.key_store.clear(actor_id)
            self.feed_info.remove(actor_id)
            self.feeds.remove(actor_id)

    def handle_request(self, doc_id: str, request_json: Dict) -> None:
        doc = self.docs.get(doc_id)
        if doc is None:
            log("repo:backend", "request for unknown doc", doc_id[:6])
            return
        doc.apply_local_request(ChangeRequest.from_json(request_json))

    # ------------------------------------------------------------------
    # loading

    def _load_document(self, doc: DocBackend) -> None:
        cursor = self.cursors.get(self.id, doc.id)
        changes: List[Change] = []
        writable: Optional[str] = None
        for actor_id, max_seq in cursor.items():
            actor = self._get_or_create_actor(actor_id)
            if actor.writable and writable is None:
                writable = actor_id
            changes.extend(actor.changes_in_window(0, max_seq))
        if writable is None:
            writable = self._create_doc_actor(doc.id)
        root = root_actor_id(doc.id)
        root_actor = self.actors.get(root)
        if not changes and (root_actor is None or not root_actor.writable):
            # Unknown doc with no local history: gate readiness until the
            # root actor's first change replicates in (the reference's
            # minimumClock render gate, src/DocBackend.ts:90-113)
            doc.update_minimum_clock({root: 1})
        doc.init(changes, writable)
        # Feed announcements above can deliver blocks re-entrantly while
        # doc.opset is still None (so _sync_changes skipped them); the
        # cursor may also have grown via CursorMessages. Re-sync every
        # cursor actor now that the doc can apply changes.
        for actor_id in self.cursors.get(self.id, doc.id):
            actor = self.actors.get(actor_id)
            if actor is not None:
                self._sync_changes(actor)

    def _doc_feed_spec(
        self,
        doc_id: str,
        contiguous: Dict[str, bool],
        cursor: Optional[Dict[str, int]] = None,
    ):
        """(spec, clock, n_changes, actor_ids, ok) for a doc's cursor:
        sidecar windows per actor feed plus the contiguous-seq clock
        shortcut (clock[actor] = applied count is only sound when the
        feed's seqs are 1..n — gap-y feeds set ok=False and must take
        the safe per-op replay path). `contiguous` memoizes the per-feed
        verification across docs sharing an actor. Bulk callers pass the
        pre-fetched `cursor` (one SELECT for the whole load)."""
        if cursor is None:
            cursor = self.cursors.get(self.id, doc_id)
        spec = []
        clock: Dict[str, int] = {}
        n_changes = 0
        ok = True
        for actor_id, max_seq in cursor.items():
            actor = self._get_or_create_actor(actor_id)
            fc = actor.columns()
            good = contiguous.get(actor_id)
            if good is None:
                good = fc.seqs_contiguous()
                contiguous[actor_id] = good
                if not good:
                    log(
                        "repo:backend",
                        f"feed {actor_id[:6]} has non-contiguous "
                        "seqs; bulk clock shortcut unsafe",
                    )
            ok = ok and good
            spec.append((fc, 0, max_seq))
            applied = fc.changes_in_window(0, max_seq)
            n_changes += applied
            if applied > 0:
                clock[actor_id] = applied  # seqs contiguous 1..n
        return spec, clock, n_changes, list(cursor), ok

    def _gate_unknown_empty(self, doc: DocBackend) -> None:
        """No local history and no writable root: gate readiness until
        the root actor's first change replicates in (the reference's
        minimumClock render gate, src/DocBackend.ts:90-113)."""
        root = root_actor_id(doc.id)
        root_actor = self.actors.get(root)
        if root_actor is None or not root_actor.writable:
            doc.update_minimum_clock({root: 1})

    def _resync_cursor_actors(self, actor_ids, synced: set) -> None:
        """Blocks replicated while a (bulk or fast) load was in flight
        hit _sync_changes before the doc could apply; re-run now (cheap
        no-op when clocks already match), as _load_document does."""
        for actor_id in actor_ids:
            if actor_id in synced:
                continue
            synced.add(actor_id)
            actor = self.actors.get(actor_id)
            if actor is not None:
                self._sync_changes(actor)

    def _load_document_fast(self, doc: DocBackend) -> bool:
        """Sidecar-backed cold open of ONE doc: pack its feed windows and
        decode through the numpy kernel twin (ops/host_kernel.py) — no
        per-op host replay, no device dispatch/compile. Returns False
        (caller falls back to _load_document's replay) when a feed's
        sidecar can't serve the window (non-contiguous seqs).
        Replaces the reference's per-change Automerge replay for stored
        histories (src/RepoBackend.ts:238-257 -> DocBackend.init)."""
        if os.environ.get("HM_FAST_OPEN", "1") == "0":
            return False
        from ..ops.columnar import pack_docs_columns
        from ..ops.host_kernel import run_batch_host
        from ..ops.materialize import DecodedBatch, decode_patch

        spec, clock, n_changes, actor_ids, ok = self._doc_feed_spec(
            doc.id, {}
        )
        if not ok:
            return False
        writable = self._writable_actor_for(doc.id)
        if n_changes == 0:
            self._gate_unknown_empty(doc)
        # the numpy kernel twin runs on the host: pack there too
        batch = pack_docs_columns([spec], device="cpu")
        dec = DecodedBatch(batch, run_batch_host(batch))
        doc.init_deferred(
            loader=self._bulk_history_loader(doc.id),
            clock=clock,
            history_len=n_changes,
            actor_id=writable,
            snapshot_fn=lambda: decode_patch(dec, 0),
            quiet=False,
        )
        self.clocks.update(self.id, doc.id, clock)
        self._resync_cursor_actors(
            self.cursors.get(self.id, doc.id), set()
        )
        return True

    def load_documents_bulk(
        self, doc_ids: List[str], slab: Optional[int] = None,
        pad_docs: Optional[int] = None, pad_rows: Optional[int] = None,
    ) -> None:
        """Cold-start many docs with zero per-op host work (the north
        star, BASELINE config 4): each doc's feed windows come from the
        columnar sidecars (storage/colcache.py), pack vectorized
        (ops/columnar.py pack_docs_columns), and materialize in slab-sized
        device dispatches. Docs come up ready with host-verified clocks
        and lazily-decoded snapshot patches; the host OpSet reconstructs
        only when a doc takes its first incremental change
        (DocBackend.init_deferred). Contrast the reference's per-doc
        loadDocument replay loop (src/RepoBackend.ts:238-257).

        Host-side work is batched, not per-doc: one cursor upsert + one
        SELECT for all docs, one feed-registry executemany, one clock
        executemany, parallel sidecar loads, and per-actor syncs deferred
        to a single pass at the end. Device dispatches are async — the
        materialization barrier is `fetch_bulk_summaries`. The stages
        stream per slab (backend/pipeline.py) or, under HM_PIPELINE=0, run
        one after another for all docs.

        `pad_docs`/`pad_rows` override the slab's bucket shape."""
        with telemetry.span(
            "pipeline.bulk_load", "pipeline", docs=len(doc_ids)
        ):
            if slab is None:
                slab = int(os.environ.get("HM_BULK_SLAB", "4096"))
            with self._bulk_mutex:  # concurrent open_many calls serialize
                self._load_documents_bulk_locked(
                    doc_ids, slab, pad_docs, pad_rows
                )

    def _load_documents_bulk_locked(
        self, doc_ids, slab, pad_docs, pad_rows
    ) -> None:
        from .pipeline import pipeline_enabled

        # summaries are for the latest load: drop refs nobody fetched so
        # repeated open_many calls can't pin old slabs' host+device memory
        self._pending_summaries = []
        self._pending_memo = []
        stale = self._fetch_ctx
        self._fetch_ctx = None
        if stale is not None:
            # nobody ran the barrier for the previous load: settle its
            # fetch workers before dispatching a new pipeline (and don't
            # let a fetch error vanish with the discarded context)
            try:
                stale.join()
            except Exception as e:
                log("repo:backend", f"unfetched bulk load's fetch: {e}")

        now = time.perf_counter
        self._bulk_t0 = now()
        pipelined = pipeline_enabled()

        # -- phase 1: register docs + one bulk cursor upsert/select -----
        t0 = now()
        new_docs: List[DocBackend] = []
        already_ready: List[str] = []  # open docs: frontend may re-read
        with self._lock:
            for doc_id in doc_ids:
                existing = self.docs.get(doc_id)
                if existing is not None:
                    if existing._announced:
                        already_ready.append(doc_id)
                    continue
                doc = DocBackend(
                    doc_id, self._doc_notify, None, live=self.live
                )
                self.docs[doc_id] = doc
                new_docs.append(doc)
        # docs closed with store rows still in the debouncer must not
        # bulk-reload from the stale rows (same guard as open/destroy)
        self._settle_store_rows({d.id for d in new_docs})
        with self.db.bulk():
            self.cursors.add_actors(
                self.id, [(d.id, root_actor_id(d.id)) for d in new_docs]
            )
        cursor_map = self.cursors.get_multiple(
            self.id, [d.id for d in new_docs]
        )
        # stage breakdown (seconds). Serial twin: each stage's wall time
        # (they run back-to-back, so they sum to the wall clock).
        # Pipeline: each stage's BUSY time — the stages overlap, so the
        # wall clock is `wall_critical_path`, ~max(stage). t_fetch lands
        # when the materialization barrier runs.
        with self._stats_lock:
            self.last_bulk_stats = {
                "docs": len(new_docs),
                "fast": 0,
                "memo": 0,
                "fallback": 0,
                "pipeline": 1 if pipelined else 0,
                "pack_workers": 0,  # serial twin: pack inline, no pool
                "t_sql": round(now() - t0, 3),
                "t_io": 0.0,
                "t_spec": 0.0,
                "t_pack": 0.0,
                "t_dispatch": 0.0,
            }

        ready_ids: List[str] = []
        clock_rows: Dict[str, Dict[str, int]] = {}
        self._begin_bulk_actors()
        try:
            load = (
                self._load_slabs_pipelined
                if pipelined
                else self._load_slabs_serial
            )
            memo_hits, fallback_docs = load(
                new_docs, cursor_map, slab, ready_ids, clock_rows,
                pad_docs, pad_rows,
            )
            stats = self.last_bulk_stats
            stats["memo"] = len(memo_hits)
            stats["fallback"] = len(fallback_docs)
            stats["fast"] = len(new_docs) - len(fallback_docs)
            for (doc, spec, clock, n_changes, actor_ids), m in memo_hits:
                self._init_bulk_doc(
                    doc, clock, n_changes, actor_ids,
                    self._doc_snapshot_fn(spec, clock),
                    ready_ids, clock_rows,
                )
                self._pending_memo.append((doc.id, m))
            t0 = now()
            with self.db.bulk():
                self.clocks.update_many(self.id, clock_rows)
            self._stat_add("t_sql", now() - t0)
            for doc in fallback_docs:
                self._load_document(doc)
            if fallback_docs:
                log(
                    "repo:backend",
                    f"bulk load: {len(fallback_docs)}/{len(new_docs)} "
                    "docs fell back to per-op host replay "
                    "(non-contiguous feed seqs)",
                )
        except Exception:
            # a failed load must not pin device refs, leave fetch workers
            # running unjoined, or hand the barrier a half-built pending
            # list (a failure AFTER the pipeline ran — clock write,
            # fallback replay — still has live fetch workers: join them
            # so no hm-pipe thread outlives the load)
            ctx = self._fetch_ctx
            self._pending_summaries = []
            self._pending_memo = []
            self._fetch_ctx = None
            self._bulk_t0 = None  # a later barrier must not stamp
            # wall_critical_path with this dead load's idle time
            if ctx is not None:
                try:
                    ctx.join()
                except Exception:
                    pass  # the load's own error is the one to raise
            raise
        finally:
            self._end_bulk_actors()
        if pipelined:
            # busy aliases: explicit names for readers that want both
            # views without knowing the mode
            with self._stats_lock:
                for k in ("t_io", "t_spec", "t_pack", "t_dispatch"):
                    self.last_bulk_stats[k + "_busy"] = (
                        self.last_bulk_stats.get(k, 0.0)
                    )
        # provisional: the barrier extends this through the fetch
        with self._stats_lock:
            self.last_bulk_stats["wall_critical_path"] = round(
                now() - self._bulk_t0, 3
            )
        ready_ids.extend(already_ready)
        if ready_ids:
            self.to_frontend.push(msgs.bulk_ready_msg(ready_ids))

    def _stat_add(self, key: str, dt: float) -> None:
        """Accumulate a stage timing into last_bulk_stats (pipeline stage
        threads add concurrently). Microsecond precision: rounding each
        addition to ms would floor a stage of many small slivers to 0."""
        with self._stats_lock:
            s = self.last_bulk_stats
            s[key] = round(s.get(key, 0.0) + dt, 6)

    def _collect_cursor_actors(self, docs, cursor_map) -> List[str]:
        needed: List[str] = []
        seen: set = set()
        for d in docs:
            for actor_id in cursor_map[d.id]:
                if actor_id not in seen:
                    seen.add(actor_id)
                    needed.append(actor_id)
        return needed

    def _load_slabs_serial(
        self, new_docs, cursor_map, slab, ready_ids, clock_rows,
        pad_docs, pad_rows,
    ):
        """Every stage finishes for ALL docs before the next begins —
        wall clock = sum(stages). Returns (memo_hits, fallback_docs)."""
        now = time.perf_counter

        # -- phase 2: open every cursor actor, per-feed work deferred ---
        t0 = now()
        needed = self._collect_cursor_actors(new_docs, cursor_map)
        actors = [self._get_or_create_actor(a) for a in needed]
        self._prefetch_columns(actors)
        self._stat_add("t_io", now() - t0)

        # -- phase 3: per-doc feed specs --------------------------------
        t0 = now()
        entries = []  # (doc, spec, clock, n_changes, actor_ids)
        contiguous: Dict[str, bool] = {}
        fallback_docs: List[DocBackend] = []
        for doc in new_docs:
            spec, clock, n_changes, actor_ids, ok = self._doc_feed_spec(
                doc.id, contiguous, cursor_map[doc.id]
            )
            if not ok:
                fallback_docs.append(doc)
                continue
            if n_changes == 0:
                self._gate_unknown_empty(doc)
            entries.append((doc, spec, clock, n_changes, actor_ids))
        self._stat_add("t_spec", now() - t0)

        # -- phase 3.5: clean docs (summary memo holds a row fetched
        # at this exact clock) skip pack/dispatch/transfer --------------
        memo_hits = []
        if self._summary_memo:
            fresh = []
            for e in entries:
                m = self._summary_memo.get(e[0].id)
                if m is not None and m["clock"] == e[2]:
                    memo_hits.append((e, m))
                else:
                    fresh.append(e)
            entries = fresh

        # -- phase 4: slab dispatches -----------------------------------
        self._load_slabs(
            entries, slab, ready_ids, clock_rows, pad_docs, pad_rows,
        )
        return memo_hits, fallback_docs

    def _load_slabs_pipelined(
        self, new_docs, cursor_map, slab, ready_ids, clock_rows,
        pad_docs, pad_rows,
    ):
        """Streamed phases 2-4 (backend/pipeline.py): slab N+1's sidecar
        IO and pack proceed while slab N is on the device and slab N-1's
        summary is on its way to the host. Entry groups are the serial
        twin's (slab-sized chunks of the post-memo entry stream, in doc
        order), so both produce bit-identical summaries. Returns
        (memo_hits, fallback_docs); the fetch workers may still run, and
        `_fetch_ctx` hands them to the barrier."""
        from ..ops.columnar import pack_docs_columns, round_up_pow2
        from .pipeline import FetchContext, SlabPipeline, pack_worker_count

        now = time.perf_counter
        contiguous: Dict[str, bool] = {}

        def prefetch(doc_chunk):
            t0 = now()
            needed = self._collect_cursor_actors(doc_chunk, cursor_map)
            actors = [self._get_or_create_actor(a) for a in needed]
            self._prefetch_columns(actors)
            self._stat_add("t_io", now() - t0)

        def classify(doc):
            t0 = now()
            try:
                spec, clock, n_changes, actor_ids, ok = (
                    self._doc_feed_spec(
                        doc.id, contiguous, cursor_map[doc.id]
                    )
                )
                if not ok:
                    return ("fallback", doc)
                if n_changes == 0:
                    self._gate_unknown_empty(doc)
                e = (doc, spec, clock, n_changes, actor_ids)
                m = self._summary_memo.get(doc.id)
                if m is not None and m["clock"] == clock:
                    return ("memo", (e, m))
                return ("entry", e)
            finally:
                self._stat_add("t_spec", now() - t0)

        # the round-robin scheduler (built before any dispatch, so the
        # fetch stage can size itself) accumulates per-rank times across
        # loads: snapshot now, diff after the run
        rr = self._slab_rr()
        disp0 = list(rr.t_dispatch_chip) if rr is not None else None
        slabs0 = list(rr.slabs_per_chip) if rr is not None else None
        # with strict round-robin the rank of slab `seq` is (cursor at
        # load start + seq), so a pack worker places its pack on the rank
        # that will launch the slab and the lanes never cross cards
        rr_cursor0 = rr.cursor() if rr is not None else 0
        rank_of: Dict[int, int] = {}  # id(entry) -> rank it launched on

        def pack(chunk, seq):
            # runs on a pack-pool worker (HM_PACK_WORKERS)
            t0 = now()
            dev = rr.pack_device_for(seq, rr_cursor0) if rr else None
            batch = pack_docs_columns(
                [e[1] for e in chunk],
                n_docs=pad_docs or round_up_pow2(len(chunk)),
                n_rows=pad_rows,
                device=self.device if dev is None else dev,
            )
            self._stat_add("t_pack", now() - t0)
            return batch

        def dispatch(chunk, batch):
            entry = self._dispatch_slab(chunk, batch, ready_ids, clock_rows)
            if rr is not None:
                rank_of[id(entry)] = rr.last_device
            return entry

        stats = self.last_bulk_stats  # captured: the fetch workers can
        # outlive this load; their timings belong to THIS load's stats

        def fetch(entry):
            t0 = now()
            self._fetch_slab(entry)
            dt = now() - t0
            rank = rank_of.pop(id(entry), None)
            with self._stats_lock:
                stats["t_fetch_busy"] = round(
                    stats.get("t_fetch_busy", 0.0) + dt, 6
                )
                if rank is not None:
                    per = stats.setdefault(
                        "t_fetch_chips", [0.0] * len(rr.devices)
                    )
                    per[rank] = round(per[rank] + dt, 6)

        # one fetch worker per rank (bounded: each is one wait and one
        # host parse at a time)
        workers = 1
        if rr is not None:
            workers = max(1, min(
                len(rr.devices),
                int(os.environ.get("HM_FETCH_WORKERS", "4")),
            ))
        pipe = SlabPipeline(
            new_docs,
            prefetch=prefetch,
            classify=classify,
            pack=pack,
            dispatch=dispatch,
            fetch=fetch,
            slab=slab,
            fetch_workers=workers,
            pack_workers=pack_worker_count(),
        )
        ctx = FetchContext()
        try:
            memo_hits, fallbacks = pipe.run(ctx)
        finally:
            if rr is not None:
                rr.release()  # dispatching done: drop backpressure refs
        with self._stats_lock:
            # pool shape + per-worker busy lanes: sum(busy) can exceed
            # the wall once packs overlap
            stats["pack_workers"] = pipe.pack_workers
            stats["t_pack_busy_per_worker"] = [
                round(b, 6) for b in pipe.pack_busy
            ]
            stats["t_pack_wall"] = round(pipe.pack_wall(), 6)
            if rr is not None:
                stats["t_dispatch_chips"] = [
                    round(b - a, 6)
                    for a, b in zip(disp0, rr.t_dispatch_chip)
                ]
                stats["slabs_per_chip"] = [
                    b - a for a, b in zip(slabs0, rr.slabs_per_chip)
                ]
        self._fetch_ctx = ctx
        return memo_hits, fallbacks

    def _fetch_slab(self, entry) -> None:
        """Wait for one slab's summary wire to reach the host and parse
        it (idempotent: a parsed slab passes). The wire started its copy
        into pinned host memory at dispatch; this waits on that copy's
        event alone, never on the whole device."""
        from ..ops.materialize import fetch_summary

        _ids, batch, _dec, wire, lean = entry
        if isinstance(wire, dict):
            return
        host, copied = wire
        for event in copied:
            event.synchronize()
        # a mesh pads the doc axis to a dp multiple: the pad docs go here
        host = host[: batch.n_docs]
        entry[3] = fetch_summary(host, batch, lean)
        _M_D2H.add(host.nbytes)

    def _begin_bulk_actors(self) -> None:
        """Defer per-feed sqlite writes and actor syncs for the duration
        of a bulk load (each would otherwise be a per-feed round trip)."""
        with self._lock:
            self._bulk_feed_rows = []
            self._bulk_deferred_syncs = set()

    def _end_bulk_actors(self) -> None:
        with self._lock:
            rows = self._bulk_feed_rows or []
            deferred = self._bulk_deferred_syncs or set()
            self._bulk_feed_rows = None
            self._bulk_deferred_syncs = None
        if rows:
            with self.db.bulk():
                self.feed_info.save_many(
                    (f.public_key, f.discovery_id, f.writable)
                    for f in rows
                )
        for actor_id in deferred:
            actor = self.actors.get(actor_id)
            if actor is not None:
                self._sync_changes(actor)

    def _prefetch_columns(self, actors: List[Actor]) -> None:
        """Load every actor's columnar sidecar in parallel — the bulk of
        cold-start IO; file reads drop the GIL so threads overlap it."""
        from concurrent.futures import ThreadPoolExecutor

        if self._col_slab is not None:
            # hint the corpus slab's extents into the page cache first:
            # the decode loop below then slices warm pages
            self._col_slab.prefetch([a.id for a in actors])
        big = [a for a in actors if a.feed.colcache is not None]
        if len(big) < 2:
            for a in actors:
                a.columns()
            return
        workers = min(16, int(os.environ.get("HM_LOAD_THREADS", "8")))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(lambda a: a.columns(), actors))

    def _mesh(self):
        """The mesh the bulk loader shards over: the visible ranks of the
        backend's device type, when there are two or more and HM_MESH is
        not 0 (on a card, every CUDA device; a CPU backend sees none
        unless a test supplies CPU ranks). Cached per backend."""
        if getattr(self, "_mesh_cached", False):
            return self._mesh_value
        self._mesh_cached = True
        self._mesh_value = None
        if os.environ.get("HM_MESH", "1") != "0":
            from ..parallel import mesh as meshmod

            devs = [d for d in meshmod.visible_devices()
                    if d.type == self.device.type]
            if len(devs) > 1:
                self._mesh_value = meshmod.make_mesh(devices=devs)
        return self._mesh_value

    def _load_slabs(
        self, entries, slab, ready_ids, clock_rows, pad_docs=None,
        pad_rows=None,
    ) -> None:
        from ..ops.columnar import pack_docs_columns, round_up_pow2

        for base in range(0, len(entries), slab):
            chunk = entries[base : base + slab]
            # bucket the doc axis (pow2) so every slab of a bulk load —
            # and every later bulk load — has one kernel shape
            t0 = time.perf_counter()
            batch = pack_docs_columns(
                [e[1] for e in chunk],
                n_docs=pad_docs or round_up_pow2(len(chunk)),
                n_rows=pad_rows,
                device=self.device,
            )
            self._stat_add("t_pack", time.perf_counter() - t0)
            self._dispatch_slab(chunk, batch, ready_ids, clock_rows)

    def _dispatch_slab(self, chunk, batch, ready_ids, clock_rows):
        """One packed slab -> async device dispatch + deferred doc init.
        Returns the pending-summary entry (a mutable list: the barrier
        replaces its wire slot with parsed host arrays)."""
        from ..ops.crdt_kernels import run_batch_full
        from ..ops.materialize import DecodedBatch, decode_patch

        # host clocks (authoritative, from sidecar metadata) for
        # every doc in the slab, padded docs empty — lets the device
        # path skip the seq wire entirely
        slab_clocks = [e[2] for e in chunk] + [{}] * (
            batch.n_docs - len(chunk)
        )
        t0 = time.perf_counter()
        # every slab, however small, dispatches on the backend's device
        # (the kernels compile once at build, not per bucket). No INC
        # ops + host clocks in hand -> skip the seq and value lanes AND
        # the summary wire's clock section (the pack's INC count where it
        # folded one: no host column is read before the barrier)
        lean = not batch.has_inc()
        rr = self._slab_rr()
        mesh = self._mesh() if rr is None else None
        if rr is not None:
            # pipelined over several ranks: successive WHOLE slabs land
            # on successive ranks (bounded in-flight queues per rank)
            out, wire = rr.dispatch(batch, lean=lean)
            with self._stats_lock:
                stats = self.last_bulk_stats
                stats["rr_slabs"] = stats.get("rr_slabs", 0) + 1
                stats.setdefault("rr_devices", len(rr.devices))
        elif mesh is not None:
            # multi-device: THE same kernels, doc-sharded over dp
            from ..parallel.sharded import sharded_full

            out, wire = sharded_full(batch, mesh, lean=lean)
            with self._stats_lock:
                self.last_bulk_stats["sharded_slabs"] = (
                    self.last_bulk_stats.get("sharded_slabs", 0) + 1
                )
        else:
            out, wire = run_batch_full(batch, lean=lean, device=self.device)
        # the launch is queued: the pack's device lanes are no longer
        # needed (the host planes' copy holds its own reference)
        batch.lanes = None
        summary = _start_host_copy(wire)
        self._stat_add("t_dispatch", time.perf_counter() - t0)
        dec = DecodedBatch(batch, out, host_clocks=slab_clocks)
        entry = [[e[0].id for e in chunk], batch, dec, summary, lean]
        self._pending_summaries.append(entry)
        for j, (doc, _spec, clock, n_changes, actor_ids) in enumerate(
            chunk
        ):
            self._init_bulk_doc(
                doc, clock, n_changes, actor_ids,
                lambda dec=dec, j=j: decode_patch(dec.doc_view(j), 0),
                ready_ids, clock_rows,
            )
        return entry

    def _slab_rr(self):
        """The round-robin slab scheduler over the visible ranks of the
        backend's device type: a `MeshBulkScheduler` with resident
        tracking off (the barrier fetches per slab on the fetch workers,
        so tracked refs would pin every slab's wire with no reader).
        Pipeline mode only, with two or more ranks, unless HM_SLAB_RR or
        HM_MESH is 0. The mode gates re-evaluate on every call (the
        serial twin must never round-robin, even on a backend that ran
        pipelined); only the scheduler is cached. None otherwise."""
        from .pipeline import pipeline_enabled

        if (
            os.environ.get("HM_SLAB_RR", "1") == "0"
            or os.environ.get("HM_MESH", "1") == "0"
            or not pipeline_enabled()
        ):
            return None
        if self._rr_cached:
            return self._rr_value
        self._rr_cached = True
        from ..parallel import mesh as meshmod

        devs = [d for d in meshmod.visible_devices()
                if d.type == self.device.type]
        if len(devs) > 1:
            from ..parallel.sharded import MeshBulkScheduler

            self._rr_value = MeshBulkScheduler(
                meshmod.make_mesh(devices=devs), track_resident=False
            )
        return self._rr_value

    def fetch_bulk_summaries(self) -> "BulkSummaries":
        """The materialization barrier for the preceding bulk load(s):
        brings every slab's fused summary wire buffer (winner/liveness
        masks bit-packed, element order at ceil(log2 N) bits/entry,
        narrow counts; clock section only on non-lean runs) to host —
        ONE device buffer per slab, whose copy started at dispatch — and
        returns the decoded summaries. Docs the summary memo served
        (clock unchanged since their last fetch) transfer nothing. After
        this, any doc in the load renders host-side with no further
        device work. Clears the pending refs and refreshes the memo with
        the freshly fetched rows. Runs under `repo.bulk`, the guard of
        the pending accumulators.

        After a pipelined load the fetch workers already waited for and
        parsed each slab's wire while later slabs packed and dispatched;
        this joins them (a fetch failure re-raises as PipelineError) and
        assembles host-side only: `t_fetch` is the residual wait,
        `t_fetch_busy` the workers' busy time."""
        from ..ops.materialize import BulkSummaries

        with self._bulk_mutex:
            pending = self._pending_summaries
            memo_pending = self._pending_memo
            fetch_ctx = self._fetch_ctx
            wall_t0 = self._bulk_t0
            self._pending_summaries = []
            self._pending_memo = []
            self._fetch_ctx = None
            # one barrier per load — cleared up front so neither a
            # fetch failure below nor a later (empty) barrier call can
            # restamp the critical path with idle wall time
            self._bulk_t0 = None
            t0 = time.perf_counter()
            if fetch_ctx is not None:
                fetch_ctx.join()  # raises PipelineError on a fetch failure
            for entry in pending:
                self._fetch_slab(entry)
            out = BulkSummaries(
                pending, memo_slabs=self._memo_slabs(memo_pending)
            )
            self._memoize_summaries(out, pending, memo_pending)
        with self._stats_lock:
            self.last_bulk_stats["t_fetch"] = round(
                time.perf_counter() - t0, 3
            )
            if wall_t0 is not None:
                self.last_bulk_stats["wall_critical_path"] = round(
                    time.perf_counter() - wall_t0, 3
                )
        return out

    @staticmethod
    def _memo_cap_bytes() -> int:
        return (
            int(os.environ.get("HM_SUMMARY_MEMO_MB", "256")) * 1024 * 1024
        )

    @staticmethod
    def _memo_entry_bytes(m: Dict) -> int:
        return (
            m["mw_bits"].nbytes
            + m["el_bits"].nbytes
            + m["order"].nbytes
            + m["clock_row"].nbytes
            + 512  # dict/key overhead estimate
        )

    def _memo_slabs(self, memo_pending):
        """Memo-served docs as BulkSummaries memo groups (grouped by N
        so rows stack into one arrays dict per bucket)."""
        if not memo_pending:
            return []
        import numpy as np

        groups: Dict[tuple, List] = {}
        for doc_id, m in memo_pending:
            key = (m["N"], len(m["clock_row"]))
            groups.setdefault(key, []).append((doc_id, m))
        out = []
        from ..ops.crdt_kernels import unpack_bits_le

        for (N, _A), items in groups.items():
            def bits(key):
                return unpack_bits_le(
                    np.stack([m[key] for _d, m in items]), N
                )

            arrays = {
                "map_winner": bits("mw_bits"),
                "elem_live": bits("el_bits"),
                "elem_order": np.stack(
                    [m["order"] for _d, m in items]
                ).astype(np.int64),
                "n_live_elems": np.asarray(
                    [m["n_live"] for _d, m in items], np.int64
                ),
                "n_map_entries": np.asarray(
                    [m["n_map"] for _d, m in items], np.int64
                ),
                # the real [A_loc] local-slot clock rows, same columnar
                # contract as fetched slabs (arrays()['clock'])
                "clock": np.stack([m["clock_row"] for _d, m in items]),
            }
            out.append((
                [d for d, _m in items],
                arrays,
                [m["clock"] for _d, m in items],
            ))
        return out

    def _memoize_summaries(self, summaries, pending, memo_pending) -> None:
        """Refresh the per-doc summary memo from freshly fetched slab
        rows (byte-bounded LRU)."""
        cap = self._memo_cap_bytes()
        if cap <= 0:
            return
        import numpy as np

        memo = self._summary_memo
        for doc_id, m in memo_pending:  # served rows stay warm
            if doc_id in memo:
                memo.move_to_end(doc_id)
        for i, (doc_ids, batch, dec, _wire, _lean) in enumerate(pending):
            if dec.host_clocks is None:
                continue  # no authoritative clock: not memoizable
            arrays = summaries.slabs[i][2]
            N = batch.n_rows
            mwb = np.packbits(
                arrays["map_winner"], axis=1, bitorder="little"
            )
            elb = np.packbits(
                arrays["elem_live"], axis=1, bitorder="little"
            )
            odt = np.int16 if N < 2**15 else np.int32
            order = arrays["elem_order"].astype(odt)
            clock_arr = np.asarray(arrays["clock"], np.int32)
            for j, doc_id in enumerate(doc_ids):
                old = memo.pop(doc_id, None)
                if old is not None:
                    self._summary_memo_bytes -= self._memo_entry_bytes(
                        old
                    )
                entry = {
                    "clock": dict(dec.host_clocks[j]),
                    "N": N,
                    "n_live": int(arrays["n_live_elems"][j]),
                    "n_map": int(arrays["n_map_entries"][j]),
                    "mw_bits": mwb[j].copy(),
                    "el_bits": elb[j].copy(),
                    "order": order[j].copy(),
                    "clock_row": clock_arr[j].copy(),
                }
                memo[doc_id] = entry
                self._summary_memo_bytes += self._memo_entry_bytes(entry)
        while memo and self._summary_memo_bytes > cap:
            _d, old = memo.popitem(last=False)
            self._summary_memo_bytes -= self._memo_entry_bytes(old)

    def _init_bulk_doc(
        self, doc, clock, n_changes, actor_ids, snapshot_fn,
        ready_ids, clock_rows,
    ) -> None:
        """Shared deferred-init tail of the bulk load: resolve the
        writable actor, hand the doc its lazy snapshot, record its clock
        row, and mark it ready (minimum-clock-gated docs wait)."""
        writable = None
        for actor_id in actor_ids:
            a = self.actors.get(actor_id)
            if a is not None and a.writable:
                writable = actor_id
                break
        doc.init_deferred(
            loader=self._bulk_history_loader(doc.id),
            clock=clock,
            history_len=n_changes,
            actor_id=writable,
            snapshot_fn=snapshot_fn,
        )
        clock_rows[doc.id] = clock
        if doc._announced:
            ready_ids.append(doc.id)

    def _doc_snapshot_fn(self, spec, clock):
        """Lazy one-doc snapshot decode through the numpy kernel twin —
        memo-served docs have no slab DecodedBatch to decode from."""

        def snap():
            from ..ops.columnar import pack_docs_columns
            from ..ops.host_kernel import run_batch_host
            from ..ops.materialize import DecodedBatch, decode_patch

            batch = pack_docs_columns([spec], device="cpu")
            dec = DecodedBatch(
                batch, run_batch_host(batch), host_clocks=[dict(clock)]
            )
            return decode_patch(dec, 0)

        return snap

    def _bulk_history_loader(self, doc_id: str):
        """Deferred host replay for a bulk-loaded doc: decode the feed
        windows into Change objects only when the doc's first incremental
        change forces an OpSet to exist."""

        def load() -> List[Change]:
            cursor = self.cursors.get(self.id, doc_id)
            changes: List[Change] = []
            for actor_id, max_seq in cursor.items():
                actor = self._get_or_create_actor(actor_id)
                changes.extend(actor.changes_in_window(0, max_seq))
            return changes

        return load

    def _demoted_snapshot_fn(self, doc_id: str, clock: Dict[str, int]):
        """Ready/reopen snapshot closure for a doc the live engine
        DEMOTED back to lazy: decode the feed windows at the doc's
        serving clock through the numpy kernel twin — no host OpSet,
        no engine state. Falls back to a clamped OpSet replay when a
        sidecar can no longer serve the window (e.g. the feed was
        truncated out-of-band after demotion)."""

        def snap():
            from ..crdt.opset import OpSet
            from ..ops.columnar import pack_docs_columns
            from ..ops.host_kernel import run_batch_host
            from ..ops.materialize import DecodedBatch, decode_patch

            spec = self._serveable_spec(clock)
            if spec is not None:
                batch = pack_docs_columns(
                    [spec] if spec else [[]], device="cpu"
                )
                dec = DecodedBatch(
                    batch,
                    run_batch_host(batch),
                    host_clocks=[dict(clock)],
                )
                return decode_patch(dec, 0)
            sub = OpSet()
            sub.apply_changes(
                [
                    c
                    for c in self._bulk_history_loader(doc_id)()
                    if c.seq <= clock.get(c.actor, 0)
                ]
            )
            return sub.snapshot_patch()

        return snap

    def _writable_actor_for(self, doc_id: str) -> str:
        cursor = self.cursors.get(self.id, doc_id)
        for actor_id in cursor:
            actor = self.actors.get(actor_id)
            if actor is not None and actor.writable:
                return actor_id
        return self._create_doc_actor(doc_id)

    def _create_doc_actor(self, doc_id: str) -> str:
        pair = keymod.create()
        self._init_actor(pair)
        self.cursors.add_actor(self.id, doc_id, pair.public_key)
        return pair.public_key

    def _ensure_writable_actor(self, doc: DocBackend) -> None:
        actor_id = self._writable_actor_for(doc.id)
        doc.set_actor_id(actor_id)

    def _grant_writer_actor(self, doc: DocBackend, writer: int) -> None:
        """Many-writer NeedsActorId: mint ONE fresh actor per writing
        connection (never claim an existing writable actor — after a
        worker respawn a reconnecting frontend may still be appending
        to it) and answer only that connection with a tagged ActorId.
        Does NOT call doc.set_actor_id — that fires an UNTAGGED
        broadcast ActorId event which every connection's frontend
        would adopt."""
        with self._lock:
            actor_id = self._writer_actors.get((doc.id, writer))
        if actor_id is None:
            minted = self._create_doc_actor(doc.id)
            with self._lock:
                # first mint wins a NeedsActorId race for the same
                # token; the loser's fresh actor stays registered but
                # unused (frontends send one NeedsActorId per doc)
                actor_id = self._writer_actors.setdefault(
                    (doc.id, writer), minted
                )
        msg = msgs.actor_id_msg(doc.id, actor_id)
        msg["writer"] = writer
        self.to_frontend.push(msg)

    def _drop_writer(self, writer: int) -> None:
        """A writing connection went away (hub detach): forget its
        per-doc actor grants and any parked Ready tokens. The actors
        themselves stay — their feeds hold acked history."""
        with self._lock:
            for key in [
                k for k in self._writer_actors if k[1] == writer
            ]:
                del self._writer_actors[key]
            for tokens in self._pending_ready.values():
                tokens.discard(writer)

    # ------------------------------------------------------------------
    # actors

    def _save_feed_info(self, feed) -> None:
        with self._lock:
            if self._bulk_feed_rows is not None:
                self._bulk_feed_rows.append(feed)  # row built at end
                return
        self.feed_info.save(
            feed.public_key, feed.discovery_id, feed.writable
        )

    def _save_actor_key(self, pair: keymod.KeyPair) -> None:
        """Persist a writable actor's keypair (keys table, by public
        key) so the feed stays writable across restarts — reopened
        docs keep appending to THEIR actor, and crash recovery can
        re-sign (seal) an orphaned unsigned tail."""
        if self._actor_keys.get(pair.public_key) is not None:
            return
        self.key_store.set(pair.public_key, pair)
        self._actor_keys[pair.public_key] = pair

    def _init_actor(self, pair: keymod.KeyPair) -> Actor:
        if pair.secret_key is not None:
            self._save_actor_key(pair)
        feed = self.feeds.create(pair)
        actor = Actor(
            feed, self._actor_notify, defer_cache=self._cache_syncs.mark
        )
        with self._lock:
            self.actors[actor.id] = actor
        self._save_feed_info(feed)
        if self.network is not None:
            self.network.announce_feed(feed)
        return actor

    def _peek_actor(self, actor_id: str) -> Optional[Actor]:
        """An actor by id WITHOUT materializing storage for unknown
        keys: unlike _get_or_create_actor this never registers or
        announces an EMPTY feed — a refused live adoption (missing /
        short / non-contiguous feed) must not pollute the store with
        phantom actor feeds. Returns None when no feed exists; a feed
        that DOES exist wraps through _get_or_create_actor (same
        construction, same race semantics — open_if_present has
        already registered it in the FeedStore, so no new storage is
        created)."""
        with self._lock:
            actor = self.actors.get(actor_id)
        if actor is not None:
            return actor
        if self.feeds.open_if_present(actor_id) is None:
            return None
        return self._get_or_create_actor(actor_id)

    def _serveable_spec(self, clock: Dict[str, int]):
        """[(FeedColumns, 0, end), ...] feed windows able to serve
        `clock` from the columnar sidecars, or None when any actor
        feed is absent, short, or non-contiguous. Non-creating
        (_peek_actor). The serving tier's install, live adoption and
        demotion all call this, so they can never disagree about what
        the sidecars can rebuild."""
        spec = []
        for actor_id, end in clock.items():
            if end <= 0:
                continue
            actor = self._peek_actor(actor_id)
            fc = actor.columns() if actor is not None else None
            if (
                fc is None
                or not fc.seqs_contiguous()
                or fc.n_changes < end
            ):
                return None
            spec.append((fc, 0, end))
        return spec

    def _get_or_create_actor(self, actor_id: str) -> Actor:
        with self._lock:
            actor = self.actors.get(actor_id)
        if actor is None:
            pair = self._actor_keys.get(actor_id)
            # a persisted secret key re-binds writability on reopen
            feed = (
                self.feeds.create(pair)
                if pair is not None
                else self.feeds.open_feed(actor_id)
            )
            actor = Actor(
                feed, self._actor_notify, defer_cache=self._cache_syncs.mark
            )
            with self._lock:
                self.actors[actor_id] = actor
            self._save_feed_info(feed)
            if self.network is not None:
                self.network.announce_feed(feed)
        return actor

    def _sync_changes(self, actor: Actor) -> None:
        """Feed caught new blocks: push the admissible window into every
        doc whose cursor includes this actor (reference syncChanges,
        src/RepoBackend.ts:506-531)."""
        for doc_id in self.cursors.docs_with_actor(self.id, actor.id):
            doc = self.docs.get(doc_id)
            if doc is None or not doc.can_apply:
                continue
            start = doc.clock.get(actor.id, 0)
            end = self.cursors.entry(self.id, doc_id, actor.id)
            window = actor.changes_in_window(start, end)
            if window:
                doc.apply_remote_changes(window)

    # ------------------------------------------------------------------
    # notifications from docs / actors

    def _settle_store_rows(self, doc_ids) -> None:
        """Block until the named docs' debounced store rows are durable
        (single id or a collection — bulk reopens settle in one pass).
        Cheap no-op unless a doc actually has rows in flight, so
        open/destroy don't stall behind unrelated traffic. A wedged
        flusher raises instead of returning: proceeding would reload
        from stale rows (open) or let a late flush resurrect rows the
        caller is about to delete (destroy)."""
        if isinstance(doc_ids, str):
            doc_ids = {doc_ids}
        deadline = time.monotonic() + 30.0
        while any(k[1] in doc_ids for k in self._stores.pending()):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(
                    "store flusher failed to drain rows for docs "
                    f"{sorted(doc_ids)[:3]} within 30s"
                )
            # a False return only means the GLOBAL queue didn't drain;
            # this doc's rows may have landed — the loop re-checks
            self._stores.flush_now(timeout=min(remaining, 1.0))

    def _overlay_pending_rows(self, doc_id: str, cursor, clock, pend=None):
        """Overlay rows still inside the store debouncer onto values
        read back from the store, so advertisement paths (gossip,
        discovery) are read-your-writes: a gossip flush racing ahead of
        the store flush must NOT advertise a stale cursor — a peer that
        believes the stale seq never requests the newer blocks, and if
        no later change re-gossips, replication stalls permanently.
        Multi-doc callers pass one `pend` snapshot for the whole loop
        (pending() copies the dict under the debouncer cv each call)."""
        if pend is None:
            pend = self._stores.pending()
        if not pend:
            return cursor, clock
        cursor = dict(cursor)
        clock = dict(clock)
        for key, val in pend.items():
            if key[0] == "c" and key[1] == doc_id:
                for actor, seq in val.items():
                    if seq > clock.get(actor, 0):
                        clock[actor] = seq
            elif key[0] == "u" and key[1] == doc_id:
                actor = key[2]
                if val > cursor.get(actor, 0):
                    cursor[actor] = val
        return cursor, clock

    def _mark_clock_row(self, doc: DocBackend) -> None:
        """Queue the doc's (in-memory, authoritative) clock for the
        debounced store flush — a burst of patches costs one upsert."""
        if not self._store_debounce:
            self.clocks.update(self.id, doc.id, doc.clock)
            return
        self._stores.mark(("c", doc.id), doc.clock)

    def _mark_cursor_row(
        self, doc: DocBackend, actor_id: str, seq: int
    ) -> None:
        """Cursor twin of _mark_clock_row: HM_STORE_DEBOUNCE=0 must
        restore the synchronous write here too, or the 'debounce off'
        twin still flushes cursor rows asynchronously."""
        if not self._store_debounce:
            self.cursors.update(self.id, doc.id, {actor_id: seq})
            return
        self._stores.mark(("u", doc.id, actor_id), seq)

    def _flush_store_rows(self, batch: Dict) -> None:
        clocks: Dict[str, Dict[str, int]] = {}
        cursor_rows = []
        # remote peers' clock rows (cursor-gossip ingest), grouped by
        # the SENDER repo id the row is recorded under
        remote: Dict[str, Dict[str, Dict[str, int]]] = {}
        for key, val in batch.items():
            if key[0] == "c":
                clocks[key[1]] = val
            elif key[0] == "r":
                remote.setdefault(key[1], {})[key[2]] = val
            else:
                cursor_rows.append((key[1], key[2], val))
        # durability ordering: a clock row must never COMMIT ahead of
        # the feed bytes it describes (HM_FSYNC>=1 syncs dirty feed
        # logs here; tier 0 relies on recovery-on-open clamping
        # instead — storage/durability.py)
        with telemetry.span(
            "storage.store_flush", "storage", rows=len(batch)
        ):
            self.durability.barrier()
            with self.db.bulk():
                if clocks:
                    self.clocks.update_many(self.id, clocks)
                if cursor_rows:
                    self.cursors.update_many_rows(self.id, cursor_rows)
                for rid, docs in remote.items():
                    self.clocks.update_many(rid, docs)

    def _doc_notify(self, event: Dict[str, Any]) -> None:
        t = event["type"]
        doc: DocBackend = event["doc"]
        if t in ("LocalPatch", "RemotePatch") and self.serve is not None:
            # serving invalidation hook: every patch emission — host
            # paths AND live-engine ticks (_emit_tick notifies through
            # here) — moves the doc's serving clock, so its resident
            # read entry can never serve again. Bookkeeping only
            # (this runs under the emission lock).
            self.serve.note_clock_moved(doc.id)
        if t == "DocReady":
            self._send_ready(doc)
        elif t == "LocalPatch":
            change: Change = event["change"]
            actor = self.actors.get(change.actor)
            if actor is not None and actor.writable:
                actor.write_change(change)
                if self.durability.tier == 1 and (
                    self.durability.ack_durable
                ):
                    # HM_ACK_DURABLE=1: the echo below is a DURABLE
                    # ack — wait for the WAL group commit covering the
                    # append. Runs under THIS doc's emission domain
                    # only (doc.emit may block); concurrent writers'
                    # waits share the leader's one fsync per HM_WAL_MS
                    # window.
                    self.durability.commit_ack()
            else:
                log("repo:backend", "no writable actor for", change.actor[:6])
            self._mark_clock_row(doc)
            self._mark_cursor_row(doc, change.actor, change.seq)
            self.to_frontend.push(
                msgs.patch_msg(
                    doc.id, event["patch"].to_json(), doc.history_len
                )
            )
            self._gossip_cursor(doc)
        elif t == "RemotePatch":
            self._mark_clock_row(doc)
            self.to_frontend.push(
                msgs.patch_msg(
                    doc.id, event["patch"].to_json(), doc.history_len
                )
            )
            # our applied clock advanced: re-gossip so peers BEYOND the
            # source learn it too (relay re-serving — a passive middle
            # repo must propagate actor knowledge, reference
            # src/RepoBackend.ts:394-427). Monotone, so it terminates.
            self._gossip_cursor(doc)
        elif t == "ActorId":
            self.to_frontend.push(
                msgs.actor_id_msg(doc.id, event["actorId"])
            )

    def _send_ready(
        self, doc: DocBackend, writer: Optional[int] = None
    ) -> None:
        def push(patch) -> None:
            self._mark_clock_row(doc)
            patch_json = patch.to_json() if patch else None
            # many-writer plane: serve every parked writer token (plus
            # the direct re-opener) a PER-CONNECTION Ready carrying the
            # actor granted to THAT connection (None -> the frontend
            # opens read-mode and mints via NeedsActorId on first
            # write). Rank-legal under doc.emission: doc.emit ranks
            # below repo in analysis/hierarchy.py.
            with self._lock:
                tokens = self._pending_ready.pop(doc.id, set())
                if writer is not None:
                    tokens.add(writer)
                grants = {
                    t: self._writer_actors.get((doc.id, t))
                    for t in tokens
                }
            for token, actor_id in sorted(grants.items()):
                msg = msgs.ready_msg(
                    doc.id, actor_id, patch_json, doc.history_len
                )
                msg["writer"] = token
                self.to_frontend.push(msg)
            if tokens:
                # tagged mode: an extra UNTAGGED Ready would broadcast
                # doc.actor_id to every connection (actor collision)
                return
            self.to_frontend.push(
                msgs.ready_msg(
                    doc.id,
                    doc.actor_id,
                    patch_json,
                    doc.history_len,
                )
            )

        # Ready atomicity is PER DOC since the write-plane split:
        # holding this doc's emission domain across {snapshot -> push}
        # means no tick, local echo, or remote handler can slip a patch
        # for a NEWER state of THIS doc ahead of the Ready in the
        # frontend queue (a pending frontend drops pre-Ready patches).
        # Both the engine path (live.snapshot_patch re-enters the same
        # re-entrant domain) and the host twin hold only this one
        # domain — disjoint docs' Readys and emissions run in parallel.
        # Cross-doc re-entry (a frontend callback dispatched from doc
        # A's patch push Opens doc B on the same thread) must NOT nest
        # B's domain under A's: park the Ready on the deferred-emission
        # worker. Safe to delay — the frontend stays pending and drops
        # pre-Ready patches, so the deferred Ready still delivers a
        # full snapshot.
        from . import emission

        if emission.entered_other(doc.id):
            emission.defer(lambda: self._send_ready(doc, writer=writer))
            return
        with doc.emission:
            if self.live is not None:
                patch = self.live.snapshot_patch(doc)
                if patch is not None:
                    push(patch)
                    return
            push(doc.snapshot_patch())

    def _actor_notify(self, event: Dict[str, Any]) -> None:
        t = event["type"]
        actor: Actor = event["actor"]
        if t == "ActorSync":
            with self._lock:
                if self._bulk_deferred_syncs is not None:
                    # Bulk load in flight. Doc windows pack AFTER actor
                    # creation, so creation-time syncs have nothing to
                    # deliver — drop them instead of a per-feed query
                    # storm. Appends landing mid-load (replication) are
                    # deferred to one pass at the end.
                    if event.get("origin") == "append":
                        self._bulk_deferred_syncs.add(actor.id)
                    return
            if event.get("origin") == "append":
                # replicated appends arrive in bursts: coalesce the
                # idempotent window-application per actor
                self._syncs.mark(actor.id)
            else:
                self._sync_changes(actor)
        elif t == "Download":
            for doc_id in self.cursors.docs_with_actor(self.id, actor.id):
                self.to_frontend.push(
                    msgs.download_msg(
                        doc_id,
                        actor.id,
                        event["index"],
                        event["size"],
                        event["time"],
                    )
                )

    # ------------------------------------------------------------------
    # queries

    def _service_signals(self) -> Dict[str, float]:
        """The overload controller's pressure feed, all from numbers
        the repo already measures: serve read p99 over the tick
        window, admission-queue occupancy, WAL fsync debt over its
        rotation budget. Runs on the controller ticker (~20 Hz)."""
        sig = {"p99_s": 0.0, "queue_frac": 0.0, "debt_frac": 0.0}
        serve = self.serve
        if serve is not None:
            if self._serve_p99 is not None:
                sig["p99_s"] = self._serve_p99.quantile(0.99)
            b = serve._batcher
            if b._cap > 0:
                sig["queue_frac"] = b.depth / b._cap
        wal = self.durability.wal
        if wal is not None:
            sig["debt_frac"] = wal.fsync_debt() / max(1, wal._max_bytes)
        return sig

    def read_doc(
        self, doc_id: str, query: Dict[str, Any], cb: Callable[[Any], None]
    ) -> None:
        """One read through the serving tier (HM_SERVE=1) or the
        per-request host twin (HM_SERVE=0). `cb(payload)` may fire on
        the tier's batcher thread; payload None = unknown doc / not
        ready. A read NEVER creates state: a doc id with no stored
        cursor answers None instead of materializing a phantom doc.
        The service plane's front door is HERE — every read, IPC or
        in-process, passes the same admission check; a refused read
        answers the typed {"overload": ...} payload, never an error
        and never silence."""
        if self.overload is not None:
            refusal = self.overload.admit_read(query.get("tenant"))
            if refusal is not None:
                cb(refusal)
                return
        doc = self.docs.get(doc_id)
        if doc is None:
            if not self.cursors.get(self.id, doc_id):
                cb(None)
                return
            try:
                doc = self.open(doc_id)
            except Exception as e:
                log("repo:backend", f"read open {doc_id[:6]}: {e}")
                cb(None)
                return
        if self.serve is not None:
            self.serve.read_async(doc, query, cb)
            return
        from ..serve.tier import host_read

        cb(host_read(doc, query))

    def telemetry_payload(self) -> Dict[str, Any]:
        """The Telemetry query's reply — ONE assembly for every seam
        that answers it (handle_query here, tools/serve.py's --ipc
        QueryServer): the process-wide registry snapshot + trace state
        (tools/top.py's rate feed) plus THIS backend's per-doc
        read-serving residency block (tools/ls.py's residency=
        column)."""
        payload = telemetry.query_payload()
        if self.serve is not None:
            payload["serve"] = self.serve.residency_report()
        if self.overload is not None:
            # the service plane's attributable state: ladder rung,
            # pressure, per-tenant quota table (tools/top.py
            # [service], tools/ls.py service=, bench gating)
            payload["service"] = self.overload.report()
        if self.network is not None:
            # DHT introspection (DhtSwarm.discovery_report: node id,
            # bucket occupancy, records, joined posture) for
            # tools/meta.py --dht and the tools/ls.py header
            dht = self.network.discovery_report()
            if dht is not None:
                payload["dht"] = dht
            # per-doc swarm view for the tools/ls.py peers=/announce=
            # columns: connected peers replicating each open doc, and
            # whether the doc's feeds are joined (announced/looked-up).
            # Built entirely from the cursor MIRROR + memoized
            # discovery ids: Telemetry is polled ~1/s by tools/top.py,
            # and a per-doc SQL query + per-actor sha1 would put
            # O(docs x peers) work on every poll of a fleet daemon.
            docs_net: Dict[str, Any] = {}
            joined = self.network.joined
            repl = self.network.replication
            # docs on RECORD, not just open ones: a fleet daemon
            # (hydrate_feeds) serves docs no frontend ever opened
            doc_ids = set(self.docs.keys())
            doc_ids.update(self.clocks.all_doc_ids(self.id))
            for doc_id in doc_ids:
                dids = [
                    _discovery_id_cached(a)
                    for a in self.cursors.get(self.id, doc_id)
                ]
                peers: set = set()
                for d in dids:
                    peers.update(repl.peers_with_feed(d))
                docs_net[doc_id] = {
                    "peers": len(peers),
                    "announced": any(d in joined for d in dids),
                }
            payload["net"] = {"docs": docs_net}
        return payload

    def handle_query(self, query_id: int, query: Dict[str, Any]) -> None:
        t = query["type"]
        if t == "Read":
            # async: the tier's batcher thread pushes the Reply, so a
            # steady-state read never stalls the backend message pump
            # (queue callbacks are serialized) while a batch
            # coalesces. At admission overflow (HM_SERVE_QUEUE full)
            # the refused read IS answered inline on this thread —
            # deliberate backpressure: the overloading reader pays
            # the host-path cost instead of growing an unbounded
            # queue.
            self.read_doc(
                query["id"],
                query.get("query") or {},
                lambda payload: self.to_frontend.push(
                    msgs.reply_msg(query_id, payload)
                ),
            )
            return
        if t == "Materialize":
            doc = self.docs.get(query["id"])
            patch = (
                doc.history_patch(query["history"])
                if doc is not None
                else None
            )
            payload = patch.to_json() if patch is not None else None
            self.to_frontend.push(msgs.reply_msg(query_id, payload))
        elif t == "Metadata":
            doc = self.docs.get(query["id"])
            if doc is None:
                # Not an open doc: maybe a hyperfile in the ledger
                # (reference src/RepoBackend.ts:560-568 consults Metadata).
                payload = self.meta.file_metadata(query["id"])
            else:
                payload = {
                    "type": "Document",
                    "clock": clockmod.clock_to_strs(doc.clock),
                    "actors": self.cursors.actors_for(self.id, doc.id),
                    "history": doc.history_len,
                }
            self.to_frontend.push(msgs.reply_msg(query_id, payload))
        elif t == "Telemetry":
            self.to_frontend.push(
                msgs.reply_msg(query_id, self.telemetry_payload())
            )
        else:
            self.to_frontend.push(msgs.reply_msg(query_id, None))

    # ------------------------------------------------------------------
    # peer messaging + gossip (net/network.py)

    def send_doc_message(self, doc_id: str, contents: Any) -> None:
        if self.network is not None:
            self.network.broadcast_doc_message(doc_id, contents)

    def deliver_doc_message(self, doc_id: str, contents: Any) -> None:
        """Inbound ephemeral message from a peer."""
        self.to_frontend.push(msgs.doc_message_fwd_msg(doc_id, contents))

    def on_cursor_message(
        self,
        peer,
        doc_id: str,
        cursors: clockmod.Clock,
        clocks: clockmod.Clock,
    ) -> None:
        """Peer told us which actors (and how far) a doc includes: expand
        our cursor, gate rendering on their clock, open missing feeds
        (reference src/RepoBackend.ts:394-427). The peer's clock is
        recorded under the SENDER's id — our own clock row only ever
        reflects changes we actually applied (else we'd advertise state we
        can't supply to third parties)."""
        before = self.cursors.get(self.id, doc_id)
        if self._store_debounce:
            # hot ingest path (a fleet doc gossips one actor per
            # peer): merge the write-through MIRROR now, ride the
            # debounced flusher for the sqlite rows — one executemany
            # per window instead of O(actors) per inbound frame
            after = self.cursors.merge_mem(self.id, doc_id, cursors)
            for a, s in cursors.items():
                self._stores.mark(("u", doc_id, a), s)
            self._stores.mark(("r", peer.id, doc_id), dict(clocks))
        else:
            after = self.cursors.update(self.id, doc_id, cursors)
            self.clocks.update(peer.id, doc_id, clocks)
        doc = self.docs.get(doc_id)
        if doc is not None:
            doc.update_minimum_clock(clocks)
        for actor_id in cursors:
            actor = self._get_or_create_actor(actor_id)
            self._sync_changes(actor)
        if after != before:
            # our cursor EXPANDED from remote knowledge: relay it to
            # the other peers (strictly monotone — no gossip loop)
            self._gossip.mark(doc_id)

    def on_discovery(self, public_id: str, peer) -> None:
        """A feed shared with `peer` was discovered: send our cursor +
        clock for every doc that includes that actor (reference
        src/RepoBackend.ts:374-392)."""
        pend = self._stores.pending()  # one snapshot for the loop
        for doc_id in self.cursors.docs_with_actor(self.id, public_id):
            # an open doc's in-memory clock is authoritative (and
            # fresher than its debounced store row); the store read is
            # the cold-doc fallback only — discovery fires once per
            # (feed, peer) and a fleet doc has O(peers) feeds, so a
            # SQL query here lands on the hottest wiring path
            doc = self.docs.get(doc_id)
            clock = (
                dict(doc.clock) if doc is not None
                else self.clocks.get(self.id, doc_id)
            )
            cursor, clock = self._overlay_pending_rows(
                doc_id,
                self.cursors.get(self.id, doc_id),
                clock,
                pend=pend,
            )
            self.network.send_cursor_to(peer, doc_id, cursor, clock)

    def send_sweep_cursors(self, peer, public_ids) -> None:
        """Anti-entropy cursor repair (ReplicationManager.on_sweep):
        re-send our cursor+clock for every doc sharing an actor with
        `peer` — ONE cursor frame per doc per sweep, iterated doc-side
        (O(docs) store reads) rather than feed-side (a fleet doc
        carries one placeholder actor per peer, so per-feed iteration
        is O(peers) SQL per sweep). Idempotent latest-state: this is
        what bounds the staleness of a bounded-fanout cursor gossip
        the peer wasn't sampled into (net/discovery/gossip.py)."""
        if self.network is None or self._closed:
            return
        pks = set(public_ids)
        pend = self._stores.pending()
        doc_ids = set(self.docs.keys())
        doc_ids.update(self.clocks.all_doc_ids(self.id))
        for doc_id in doc_ids:
            cursor = self.cursors.get(self.id, doc_id)
            if not pks.intersection(cursor):
                continue
            doc = self.docs.get(doc_id)
            clock = (
                dict(doc.clock) if doc is not None
                else self.clocks.get(self.id, doc_id)
            )
            cursor, clock = self._overlay_pending_rows(
                doc_id, cursor, clock, pend=pend,
            )
            self.network.send_cursor_to(peer, doc_id, cursor, clock)

    def _gossip_cursor(self, doc: DocBackend) -> None:
        # without a swarm the flush would drop the mark anyway: skip the
        # debouncer on the patch path
        if self.network is not None:
            self._gossip.mark(doc.id)

    def _flush_gossip(self, doc_ids) -> None:
        if self.network is None or self._closed:
            return
        pend = self._stores.pending()  # one snapshot for the loop
        for doc_id in doc_ids:
            # an open doc's in-memory clock is fresher than its store
            # row (clock rows flush debounced — _flush_store_rows)
            doc = self.docs.get(doc_id)
            clock = (
                doc.clock if doc is not None
                else self.clocks.get(self.id, doc_id)
            )
            cursor, clock = self._overlay_pending_rows(
                doc_id, self.cursors.get(self.id, doc_id), clock,
                pend=pend,
            )
            self.network.gossip_cursor(doc_id, cursor, clock)

    def _announce_file_feed(self, feed) -> None:
        """File feeds replicate like any feed (reference
        src/ReplicationManager.ts:71-89): persist + join + announce so
        peers holding (or wanting) the file can sync it."""
        self._save_feed_info(feed)
        if self.network is not None:
            self.network.announce_feed(feed)

    def _forget_file_feed(self, feed) -> None:
        """Undo _announce_file_feed for a speculative remote open that
        fetched nothing (the FeedStore entry is already removed)."""
        self.feed_info.delete(feed.public_key)
        if self.network is not None:
            self.network.leave(feed.discovery_id)

    def get_file_store(self) -> FileStore:
        """The repo's FileStore, swarm-wired for remote fetch; created
        on first use (with or without an HTTP file server)."""
        if self.file_store is None:
            self.file_store = FileStore(
                self.feeds,
                announce=self._announce_file_feed,
                forget=self._forget_file_feed,
                remote_capable=lambda: self.network is not None,
            )
            # Completed uploads flow into the durable metadata ledger
            # (reference src/RepoBackend.ts:105-107 → Metadata.addFile).
            self.file_store.write_log.subscribe(
                lambda header: self.meta.add_file(
                    header.url, header.size, header.mime_type
                )
            )
        return self.file_store

    def start_file_server(self, path: str) -> None:
        from ..files.file_server import FileServer

        if self._file_server is not None:
            raise RuntimeError(
                "file server already listening; one per repo backend"
            )
        self.get_file_store()
        self._file_server = FileServer(self.file_store)
        self._file_server.listen(path)
        self.to_frontend.push(msgs.file_server_ready_msg(path))

    def set_swarm(self, swarm, join_options=None) -> None:
        from ..net.network import Network

        if self.network is None:
            self.network = Network(self)
        self.network.set_swarm(swarm, join_options)

    # ------------------------------------------------------------------

    def _flush_syncs(self, actor_ids) -> None:
        if self._closed:
            return
        for actor_id in actor_ids:
            actor = self.actors.get(actor_id)
            if actor is not None:
                self._sync_changes(actor)

    def close(self) -> None:
        self._closed = True
        # a barrier-less bulk load may still have fetch workers draining
        # device buffers: settle them before the feeds, slab mmap and
        # sqlite they indirectly depend on go away, and log any error
        # nobody ran the barrier to see
        with self._bulk_mutex:
            ctx = self._fetch_ctx
            self._fetch_ctx = None
        if ctx is not None:
            try:
                ctx.join()
            except Exception as e:
                log("repo:backend", f"bulk fetch at close: {e}")
        if self.overload is not None:
            self.overload.close()  # stop the ticker before the tier
        if self.serve is not None:
            self.serve.close()  # drains: in-flight reads answer first
        if self.live is not None:
            self.live.close()  # drains: final tick patches still emit
        self._gossip.close()
        self._syncs.close()
        self._cache_syncs.close()  # drains: sidecars durable on close
        self._stores.close()  # drains AFTER patch sources: last rows land
        if self._file_server is not None:
            self._file_server.close()
            self._file_server = None
        if self.network is not None:
            self.network.close()
        self.feeds.close()
        # final group fsync while files exist; a FAILED final sync
        # leaves the crash marker in place
        durable = self.durability.close()
        if self._col_slab is not None:
            self._col_slab.close()
        self.db.close()
        if (
            durable
            and self._dirty_marker is not None
            and os.path.exists(self._dirty_marker)
        ):
            # clean close: every flusher drained, every store closed
            from ..storage.faults import io_remove

            io_remove(self._dirty_marker)
