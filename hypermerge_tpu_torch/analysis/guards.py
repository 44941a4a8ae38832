"""THE shared-state guard manifest — which lock guards which field.

`hierarchy.py` makes the lock ORDER machine-checked; this module
does the same for the DATA half of the concurrency story: every shared
attribute of the hot concurrent classes is mapped to the lock class
(from `analysis/hierarchy.py`) that guards it, in the tradition of
Clang's `GUARDED_BY` thread-safety annotations. The scattered
"guarded by the engine lock" comments those classes used to carry are
now rows here, consumed by two checkers:

- the static `guarded-attr` lint rule (`analysis/linter.py`, run by
  `python -m hypermerge_tpu_torch.tools.lint` and tier-1): every
  `self.<attr>` read/write of a declared attribute inside its class
  must sit lexically inside a
  `with` of the declared guard (or inside a method listed in
  `REQUIRES` below). Writes are hard errors; reads may be excused by
  the `atomic_read_ok` escape.
- the runtime lockset detector (`analysis/lockdep.py`,
  `HM_RACEDEP=1`): the declared attributes are wrapped in descriptor
  instrumentation that intersects per-(object, attribute) candidate
  locksets Eraser-style against the per-thread held stacks lockdep
  maintains — a guard violation is reported from the access pattern
  alone, without the race ever firing, and regardless of which
  receiver expression reached the field (the static rule only sees
  `self.X`).

Escape classes — every shared field has a DECLARED story, including
the fields that are deliberately not lock-guarded:

- (no escape)      reads AND writes require the guard.
- `atomic_read_ok` writes require the guard; a lone read is a
  GIL-atomic snapshot (dict.get / bool flag / int) taken on a hot
  path on purpose. The runtime detector still tracks writes.
- `init_only`      written only in `__init__` (before the object is
  shared); reads need no lock. A write anywhere else is a violation.
- `unguarded`      deliberately lock-free shared state; the `doc`
  string IS the story (single-writer protocol, monotonic latch,
  snapshot idiom). Not instrumented at runtime.

Granularity matches GUARDED_BY: the FIELD (the reference) is guarded,
not the object graph behind it — mutating a dict obtained from a
guarded read is visible to the checkers only at the `self.X` access.
`__init__` bodies are exempt everywhere (the object is not yet
shared). Accesses through receivers other than `self` are invisible
to the static rule but fully visible to the runtime detector.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

from .hierarchy import BY_NAME as LOCK_BY_NAME

ESCAPES = ("", "atomic_read_ok", "init_only", "unguarded")


class GuardedClass(NamedTuple):
    cls: str      # class name (unique across the package)
    module: str   # dotted import path (runtime instrumentation)
    guard: str    # hierarchy lock class guarding the fields below
    guarded: Tuple[str, ...] = ()         # reads + writes under guard
    atomic_read_ok: Tuple[str, ...] = ()  # writes under guard only
    init_only: Tuple[str, ...] = ()       # written in __init__ only
    unguarded: Tuple[str, ...] = ()       # declared lock-free (doc!)
    doc: str = ""


GUARDS: Tuple[GuardedClass, ...] = (
    GuardedClass(
        "LiveApplyEngine", "hypermerge_tpu_torch.backend.live", "live.engine",
        guarded=(
            "_refused", "_adopting", "_demoted_ids",
            "_use_clock",
        ),
        atomic_read_ok=("_docs",),
        init_only=("_back", "_m", "_ticker"),
        doc="Tick/dirty-set coordination only since the write-plane "
            "split: the doc table and refusal/adoption/demotion sets "
            "mutate under the engine lock, but `_docs` LOOKUPS are "
            "GIL-atomic dict.get snapshots — the tick and the "
            "emission paths resolve a doc with NO engine lock held "
            "and recheck identity under the doc's emission domain. "
            "Adoption BUILDS run lock-free and install under the "
            "engine lock with a recheck (the install-and-recheck idiom). Per-doc "
            "live state lives on `_LiveDoc` under `doc.emit`.",
    ),
    GuardedClass(
        "_LiveDoc", "hypermerge_tpu_torch.backend.live", "doc.emit",
        guarded=(
            "state", "clock", "max_op", "history_len", "pending",
            "queued", "undecoded",
        ),
        atomic_read_ok=("tick_rows",),
        init_only=("doc", "cols"),
        doc="One doc's live write-plane state — decoded state, "
            "admission clock/pending set, queued tick changes, and "
            "the appended-but-undecoded marker — all under ITS OWN "
            "emission domain (backend/emission.py), never the engine "
            "lock: this is the relocated half of the old engine-lock "
            "guard rows. `cols` is rebound only at construction; its "
            "in-place appends happen under the domain. `tick_rows` — "
            "the phase-3 install-and-recheck token — is written under "
            "the domain (_tick_doc_locked); the tick loop's bucket "
            "grouping reads it as a GIL-atomic int snapshot with no "
            "domain held, and phase 3 rechecks it under the domain "
            "before installing.",
    ),
    GuardedClass(
        "_LiveDoc(engine)", "hypermerge_tpu_torch.backend.live",
        "live.engine",
        guarded=("last_use", "demotable_at"),
        doc="The LRU bookkeeping the ENGINE owns about a live doc "
            "(use-clock stamp, demotability memo): read and written "
            "by the coordination passes under the engine lock.",
    ),
    GuardedClass(
        "EmissionDomain", "hypermerge_tpu_torch.backend.emission", "doc.emit",
        init_only=("doc_id",),
        doc="The per-doc emission domain handle itself: one "
            "re-entrant doc.emit lock plus its identity. All real "
            "state it orders lives on the doc/_LiveDoc.",
    ),
    GuardedClass(
        "DocBackend", "hypermerge_tpu_torch.backend.doc_backend", "doc",
        guarded=(
            "_lazy_loader", "_lazy_clock", "_lazy_len", "_snapshot_fn",
            "_snapshot_cache", "_replay_cache", "minimum_clock",
            "_live_adopted",
        ),
        atomic_read_ok=("opset", "_announced", "actor_id"),
        init_only=("id", "_notify", "_live", "ready", "local_q",
                   "remote_q", "emission"),
        doc="Per-doc CRDT/lazy state under the doc lock. `opset` and "
            "`_announced` transition once (None->OpSet, "
            "False->True) and are snapshot-read on the hot dispatch "
            "paths before taking any lock; `actor_id` is snapshot-read "
            "by Ready emissions (engine/emit lock held, doc lock not).",
    ),
    GuardedClass(
        "RepoBackend", "hypermerge_tpu_torch.backend.repo_backend", "repo",
        guarded=("_bulk_deferred_syncs", "_bulk_feed_rows",
                 "_writer_actors", "_pending_ready"),
        atomic_read_ok=("docs", "actors"),
        init_only=(
            "path", "memory", "durability", "db", "clocks", "cursors",
            "key_store", "feed_info", "feeds", "id", "meta",
            "to_frontend", "recovery_report", "_dirty_marker",
            "_col_slab", "_query_handlers", "_gossip",
            "_syncs", "_cache_syncs", "_stores", "_store_debounce",
            "_gossip_fresh", "live", "serve",
        ),
        unguarded=("network", "file_store", "_file_server", "_closed",
                   "_actor_keys"),
        doc="docs/actors mutate under the repo lock; lookups are "
            "GIL-atomic dict.get snapshots on the receive/query hot "
            "paths. `network`/`file_store`/`_file_server` are "
            "set-once wiring installed before traffic flows; "
            "`_closed` is a monotonic shutdown latch; `_actor_keys` "
            "mirrors the sqlite keys table (insert-once per actor, "
            "GIL-atomic dict ops, sqlite is the durable truth).",
    ),
    GuardedClass(
        "RepoBackend(bulk)", "hypermerge_tpu_torch.backend.repo_backend",
        "repo.bulk",
        guarded=("_pending_memo", "_bulk_t0", "_fetch_ctx",
                 "_summary_memo_bytes"),
        atomic_read_ok=("_summary_memo",),
        unguarded=(
            "_pending_summaries", "_rr_cached", "_rr_value",
            "_mesh_cached", "_mesh_value",
        ),
        doc="Bulk-load accumulators: one load at a time under "
            "repo.bulk (the barrier, fetch_bulk_summaries, takes it "
            "too). `_summary_memo` is read lock-free by pipeline "
            "classify and serve installs (GIL-atomic dict.get); "
            "`_pending_summaries` is appended by pipeline stage "
            "threads (GIL-atomic) and swapped whole under repo.bulk "
            "after the stage barrier joined them; the scheduler/mesh "
            "caches build once, idempotently, on first use.",
    ),
    GuardedClass(
        "RepoBackend(stats)", "hypermerge_tpu_torch.backend.repo_backend",
        "repo.stats",
        atomic_read_ok=("last_bulk_stats",),
        doc="Stage timings accumulate from pipeline worker threads "
            "under repo.stats (_stat_add); bench/tools read the dict "
            "lock-free after the load settled.",
    ),
    GuardedClass(
        "ReadBatcher", "hypermerge_tpu_torch.serve.batcher", "serve.batch",
        guarded=("_seq", "_closed"),
        atomic_read_ok=("_depth",),
        init_only=("_flush", "_cap", "_deb"),
        doc="Admission accounting under serve.batch; `depth` is a "
            "monitoring snapshot read.",
    ),
    GuardedClass(
        "OverloadController", "hypermerge_tpu_torch.serve.overload",
        "serve.overload",
        guarded=("_tenants", "_last", "_pressure", "_thread",
                 "_closed"),
        atomic_read_ok=("_state",),
        init_only=("_signals", "_now", "_slo_s", "_tick_s", "_retry_s",
                   "_stretch_s", "_rate", "_burst", "_ladder", "_force",
                   "_m"),
        doc="The service plane's shared state: the tenant "
            "token-bucket table, the last signal sample, and the "
            "ticker lifecycle mutate under serve.overload (tick, "
            "admit_read, report). `_state` — the one question every "
            "hot path asks (am I shedding?) — is written under the "
            "lock by tick() and read as a GIL-atomic int snapshot by "
            "admit_read/defer_install/ack_extra_s. `_ladder` is a "
            "construction-time reference whose internals mutate only "
            "inside tick()'s critical section.",
    ),
    GuardedClass(
        "ResidencyCache", "hypermerge_tpu_torch.serve.resident", "serve.cache",
        guarded=("_entries", "_evicted", "_use"),
        atomic_read_ok=("_bytes",),
        doc="The residency table mutates under serve.cache only "
            "(builds/uploads run outside it); `resident_bytes` is a "
            "monitoring snapshot read.",
    ),
    GuardedClass(
        "SessionSupervisor", "hypermerge_tpu_torch.net.resilience", "net.sup",
        guarded=("_sessions",),
        atomic_read_ok=("_stopped",),
        init_only=("_dial", "_deliver", "_banned", "_m", "_connector"),
        unguarded=("_on_status",),
        doc="The outbound session table mutates under net.sup; "
            "`_stopped` is polled lock-free by every session thread's "
            "redial loop (and checked by the async-mode callback "
            "chain). `_on_status` is a set-once hook registered "
            "before sessions start; `_connector` is construction-time "
            "wiring selecting the async (event-loop) dial mode.",
    ),
    GuardedClass(
        "TcpSwarm", "hypermerge_tpu_torch.net.tcp", "net.tcp.accept",
        guarded=("_accept_q", "_accept_idle", "_accept_workers"),
        init_only=("_async", "_loop"),
        doc="The bounded inbound-handshake pool of the legacy "
            "(thread-per-connection) stack: the accepted-socket queue "
            "and the idle/spawned worker counters mutate under "
            "net.tcp.accept (listener thread enqueues, pool workers "
            "dequeue, destroy() drains). `_async`/`_loop` are the "
            "construction-time transport-twin selection "
            "(HM_NET_ASYNC).",
    ),
    GuardedClass(
        "AioLoop", "hypermerge_tpu_torch.net.aio", "net.aio",
        guarded=("_ready", "_timers"),
        init_only=("_sel", "_timer_seq", "_wake_r", "_wake_w",
                   "_worker_cap", "_thread"),
        doc="The shared event loop's submission state: the ready-"
            "callback deque and the timer heap mutate under net.aio "
            "(any thread submits, the loop thread drains). The "
            "selector itself is mutated ONLY on the loop thread "
            "(callers go through call_soon), so it needs no lock; "
            "the self-pipe write is a lock-free wakeup.",
    ),
    GuardedClass(
        "AioLoop(dispatch)", "hypermerge_tpu_torch.net.aio",
        "net.aio.dispatch",
        guarded=("_dispatch_q", "_dispatch_idle", "_workers"),
        doc="The bounded dispatch pool (user-facing callbacks run "
            "here, never on the loop thread): the work queue and the "
            "idle/spawned counters mutate under net.aio.dispatch "
            "(offload() demand-spawns up to HM_AIO_DISPATCH workers).",
    ),
    GuardedClass(
        "AioDuplex", "hypermerge_tpu_torch.net.aio", "net.aio.conn",
        guarded=("_outbox", "_out_inflight", "_tx_scheduled",
                 "_rx_pending", "_rx_scheduled", "_close_cbs",
                 "_ready_fired"),
        atomic_read_ok=("_out_bytes", "closed"),
        init_only=("_loop", "_sock", "_identity", "_on_ready",
                   "_out_cap", "_stall_s", "_drained", "_inbox",
                   "_session"),
        unguarded=("_shed", "_rx_eof", "_last_rx", "_last_progress",
                   "_rbuf", "_wbuf", "_registered", "_events",
                   "_counted", "_hs_timer", "_ka_timer", "_ka_misses",
                   "_ka_probe", "_hs_phase", "_hs_offer"),
        doc="One multiplexed connection: the plaintext outbox, the tx "
            "kick latch, the ordered inbound-dispatch deque and its "
            "exactly-one-drainer latch, the close-listener list, and "
            "the ready-once latch mutate under net.aio.conn (sender "
            "threads vs the loop thread vs dispatch workers). "
            "`_out_bytes`/`closed` are written under the lock and "
            "snapshot-read on the lock-free fast paths (shed check, "
            "early-outs). The unguarded block is LOOP-CONFINED state "
            "— read/write buffers, selector registration, the "
            "handshake machine, keepalive bookkeeping — touched only "
            "by loop callbacks after construction, plus the monotonic "
            "`_shed`/`_rx_eof` latches and the stall/liveness "
            "clocks, whose racing writers all move them the same "
            "direction.",
    ),
    GuardedClass(
        "NetworkPeer", "hypermerge_tpu_torch.net.peer", "net.peer",
        guarded=("_pending",),
        init_only=("self_id", "id", "_on_active", "_on_inactive"),
        unguarded=("connection",),
        doc="`_pending` mutates under net.peer (accept/supervisor "
            "threads vs close-driven prunes). `connection` is the "
            "DOCUMENTED snapshot idiom: it can flip to None under "
            "churn, so every consumer snapshots it once "
            "(NetworkPeer.try_send) instead of check-then-use.",
    ),
    GuardedClass(
        "RoutingTable", "hypermerge_tpu_torch.net.discovery.dht", "net.dht",
        guarded=("_buckets", "_replacements", "_probing"),
        init_only=("self_id", "k"),
        doc="The k-bucket array and per-bucket replacement caches "
            "mutate under net.dht only (observe/refresh/evict/closest "
            "from the UDP reader thread, lookup walkers, and timeout "
            "timers); liveness probes run outside it.",
    ),
    GuardedClass(
        "RecordStore", "hypermerge_tpu_torch.net.discovery.dht",
        "net.dht.store",
        guarded=("_records",),
        doc="The signed announce-record table (reader thread stores, "
            "lookup walkers and lazy expiry read) mutates under "
            "net.dht.store; signature verification runs before the "
            "lock.",
    ),
    GuardedClass(
        "DhtNode", "hypermerge_tpu_torch.net.discovery.dht", "net.dht.rpc",
        guarded=("_pending",),
        init_only=("table", "records", "_rpc_ids", "bootstrap",
                   "public_key", "id"),
        unguarded=("_closed", "_announce_seed", "_seed",
                   "_sign_cache", "_seed_hook", "_seeded"),
        doc="The pending-RPC correlation table mutates under "
            "net.dht.rpc (reader thread resolves, timers expire, "
            "senders register). `_closed` is a monotonic shutdown "
            "latch polled by the reader; `_announce_seed` is set-once "
            "wiring installed by set_identity before any join "
            "traffic; `_seed` is the construction-time node key. "
            "`_sign_cache` is driven only by the swarm maintenance "
            "thread (announce is its single caller; the boot-time "
            "set_announce_seed reset precedes any join traffic); "
            "`_seed_hook` is set-once wiring installed before "
            "traffic; `_seeded` dedup membership mutates only on the "
            "UDP reader thread.",
    ),
    GuardedClass(
        "DhtSwarm", "hypermerge_tpu_torch.net.discovery.swarm",
        "net.dht.swarm",
        guarded=("_joined", "_targets", "_pass_waiters"),
        init_only=("tcp", "node", "_rng", "_kick", "_stop", "_thread"),
        unguarded=("_need",),
        doc="The joined-id table and the sampled active-view targets "
            "mutate under net.dht.swarm (join/leave callers vs the "
            "maintenance thread); dials and DHT walks run outside "
            "it. `_need` is set-once wiring (Network.set_swarm "
            "installs the demand hook before any join traffic).",
    ),
    GuardedClass(
        "GossipSampler", "hypermerge_tpu_torch.net.discovery.gossip",
        "net.gossip",
        guarded=("_samples",),
        init_only=("fanout", "reshuffle_s", "_rng"),
        unguarded=("overload_ctl",),
        doc="The per-key sample table mutates under net.gossip; the "
            "hot broadcast paths hold it for dict bookkeeping only. "
            "`_rng` is only ever driven under the lock. "
            "`overload_ctl` is a set-once service-plane hook "
            "installed by Network wiring before traffic flows; the "
            "sample path snapshots the reference (GIL-atomic).",
    ),
    GuardedClass(
        "_FrontendHub", "hypermerge_tpu_torch.net.ipc", "net.ipc.hub",
        guarded=("_conns", "_interest", "_next_key"),
        init_only=("_back", "_writers"),
        doc="The multi-frontend daemon's connection + doc-interest "
            "tables (accept/reader threads register and retire "
            "entries, the to_frontend router snapshots its targets) "
            "mutate under net.ipc.hub; socket sends run OUTSIDE it "
            "so a slow frontend cannot stall accepts or routing.",
    ),
    GuardedClass(
        "_ShardRouter", "hypermerge_tpu_torch.net.ipc", "net.ipc.router",
        guarded=("_workers", "_pending", "_respawns", "_gen",
                 "_tele", "_next_tele"),
        init_only=("_repo_path", "_sock_base", "_n"),
        unguarded=("_closed", "_dispatch", "_interest"),
        doc="Worker slots, outage buffers, and in-flight telemetry "
            "fan-outs mutate under net.ipc.router (route threads vs "
            "the respawn supervisor vs worker reader threads); "
            "socket sends run OUTSIDE it. `_closed` is a monotonic "
            "shutdown latch; `_dispatch`/`_interest` are set-once "
            "hub wiring installed by start() before any worker "
            "spawns (traffic cannot precede them).",
    ),
    GuardedClass(
        "SlabPipeline", "hypermerge_tpu_torch.backend.pipeline",
        "pipeline.pack_pool",
        guarded=("_pack_turn", "_pack_eof_claimed"),
        init_only=("docs", "prefetch", "classify", "pack", "dispatch",
                   "fetch", "slab", "fetch_workers", "pack_workers",
                   "pack_q", "disp_q", "fetch_q", "_q_gauges",
                   "abort"),
        unguarded=("total_slabs", "pack_busy", "pack_t0", "pack_t1",
                   "memo_hits", "fallbacks"),
        doc="The pack pool's ordered-emit state: the turn counter and "
            "the EOF claim mutate under pipeline.pack_pool (N workers "
            "race the pack queue, emit in slab order). `total_slabs` "
            "is a write-once latch the io thread publishes BEFORE the "
            "EOF token (the queue put/get is the happens-before edge "
            "to the one reader, the EOF-claiming worker). "
            "`pack_busy`/`pack_t0`/`pack_t1` are per-worker slots — "
            "single-writer by construction (worker w owns index w) — "
            "read only after the workers joined. "
            "`memo_hits`/`fallbacks` are appended by the single io "
            "thread and read after it joined.",
    ),
    GuardedClass(
        "SlabPipeline(err)", "hypermerge_tpu_torch.backend.pipeline",
        "pipeline.err",
        atomic_read_ok=("error", "error_stage"),
        doc="First-error capture: _fail writes the winning (error, "
            "stage) pair under pipeline.err; the driver reads them "
            "lock-free after every stage joined.",
    ),
    GuardedClass(
        "FeedColumnCache", "hypermerge_tpu_torch.storage.colcache",
        "store.colcache",
        guarded=(
            "_loaded", "_actors", "_keys", "_strings", "_floats",
            "_bigints", "_pending_tables", "_base_planes",
            "_base_meta", "_base_rows", "_row_chunks", "_pred_chunks",
            "_n_rows_total", "_n_preds_total", "_commits_arr",
            "_commits_new", "_cached",
        ),
        init_only=("_storage", "writer"),
        doc="The pack path's shared-memo audit row (HM_PACK_WORKERS "
            ">1): every interner table, chunk list, and the cached "
            "FeedColumns snapshot mutate under the feed's rlock only. "
            "Concurrent pack workers never reach these fields — "
            "columns() hands them an immutable snapshot whose table "
            "lists are COPIES taken under the lock.",
    ),
    GuardedClass(
        "FeedColumns", "hypermerge_tpu_torch.storage.colcache",
        "store.colcache",
        unguarded=("rows",),
        doc="The shared snapshot pack workers read CONCURRENTLY. "
            "`rows` is a lazy idempotent latch: ensure_rows() derives "
            "the row matrix from the immutable planes and rebinds "
            "once (GIL-atomic); racing workers at worst duplicate the "
            "compute, never observe a torn value. The "
            "`_prefix_single_ok` bool ops/columnar caches on the "
            "object is the same idiom (set through a foreign "
            "receiver, so only this story covers it — the checkers "
            "cannot see it). Every other field is written by the "
            "cache build under store.colcache before the object "
            "escapes.",
    ),
    GuardedClass(
        "FileFeedStorage", "hypermerge_tpu_torch.storage.feed",
        "store.feed_io",
        guarded=("_wfh", "_len_fh", "_fh_gen"),
        doc="The cached write handles (block log + .len sidecar) and "
            "the fault-harness generation they were opened under: "
            "shared between the appender (under its doc's emission "
            "domain + feed lock) and the WAL checkpoint thread's "
            "storage.sync() — every use, fsync, and drop serializes "
            "under store.feed_io, or interleaved seek/write could "
            "tear the sidecar and a drop could close an fd mid-fsync.",
    ),
    GuardedClass(
        "CursorStore", "hypermerge_tpu_torch.storage.stores", "store.cursors",
        guarded=("_mem", "_by_actor", "_del_gen"),
        atomic_read_ok=("_hydrated",),
        init_only=("db",),
        doc="The write-through cursor mirror mutates under "
            "store.cursors; `_hydrated` membership is the documented "
            "GIL-atomic fast path of _ensure_hydrated (writes merge "
            "under the lock).",
    ),
    GuardedClass(
        "DurabilityManager", "hypermerge_tpu_torch.storage.durability",
        "store.durability",
        guarded=("_dirty", "_closed"),
        atomic_read_ok=("_flusher", "wal"),
        unguarded=("_wal_suspended", "journalless_write_cb"),
        doc="The tier-1 dirty set and shutdown latch mutate under "
            "store.durability; flush_now snapshots the flusher handle "
            "lock-free (it is installed once and cleared at close). "
            "`wal` is attached once at repo open (before traffic) and "
            "snapshot-read on every journal_append. `_wal_suspended` "
            "is toggled only inside the single-threaded recovery "
            "replay window (scrub runs before any doc opens). "
            "`journalless_write_cb` is a fire-once latch set at repo "
            "open; a racing double-clear at worst double-fires the "
            "idempotent stamp invalidation.",
    ),
    GuardedClass(
        "WriteAheadLog", "hypermerge_tpu_torch.storage.wal", "store.wal",
        guarded=(
            "_fh", "_end", "_file_bytes", "_synced", "_syncing",
            "_dirty_names", "_ckpt_pending", "_ckpt_running",
            "_closed",
        ),
        init_only=("path", "session", "tier", "_max_bytes",
                   "_window_s"),
        unguarded=("ack_pacer",),
        doc="The shared journal: file handle (rebound at checkpoint "
            "rotation), append end offset, the group-commit "
            "synced/syncing handshake, the session dirty-name ledger "
            "and the checkpoint-pending storage set all mutate under "
            "store.wal. The commit fsync snapshots the handle under "
            "the lock and syncs OUTSIDE it. `ack_pacer` is a "
            "set-once service-plane hook installed at backend wiring "
            "before any writer exists; the commit leader snapshots "
            "the reference once per window (GIL-atomic).",
    ),
)

# Methods whose WHOLE BODY runs with the named lock held — the Clang
# `REQUIRES` annotation as manifest data. Every caller acquires the
# lock; the static rule treats the body as a held region. (The runtime
# detector needs no such hint: it sees the actual held stack.)
REQUIRES: Dict[Tuple[str, str], str] = {
    ("LiveApplyEngine", "_bump_use"): "live.engine",
    ("LiveApplyEngine", "_tick_doc_locked"): "doc.emit",
    ("LiveApplyEngine", "_catch_up_locked"): "doc.emit",
    ("LiveApplyEngine", "_demote_candidates_locked"): "live.engine",
    ("LiveApplyEngine", "_demote_locked"): "live.engine",
    ("WriteAheadLog", "_append_dirty_locked"): "store.wal",
    ("WriteAheadLog", "_write_locked"): "store.wal",
    ("FileFeedStorage", "_append_io_locked"): "store.feed_io",
    ("FileFeedStorage", "_check_gen"): "store.feed_io",
    ("FileFeedStorage", "_write_handle"): "store.feed_io",
    ("FileFeedStorage", "_drop_write_handles"): "store.feed_io",
    ("FileFeedStorage", "_write_len"): "store.feed_io",
    ("DocBackend", "_minimum_satisfied"): "doc",
    ("RepoBackend", "_load_documents_bulk_locked"): "repo.bulk",
    ("RepoBackend", "_load_slabs_serial"): "repo.bulk",
    ("RepoBackend", "_load_slabs_pipelined"): "repo.bulk",
    ("RepoBackend", "_memoize_summaries"): "repo.bulk",
    ("ResidencyCache", "_note_evicted"): "serve.cache",
    ("FeedColumnCache", "_ensure_loaded"): "store.colcache",
    ("FeedColumnCache", "_apply_tables"): "store.colcache",
    ("FeedColumnCache", "_intern"): "store.colcache",
    ("FeedColumnCache", "_take_pending"): "store.colcache",
    ("FeedColumnCache", "_total_rows"): "store.colcache",
    ("FeedColumnCache", "_total_preds"): "store.colcache",
    ("FeedColumnCache", "_encode"): "store.colcache",
    ("FeedColumnCache", "_encode_value"): "store.colcache",
    ("FeedColumnCache", "_tables_blob"): "store.colcache",
    ("CursorStore", "_repo"): "store.cursors",
    ("CursorStore", "_absorb"): "store.cursors",
    ("OverloadController", "_tenant_row"): "serve.overload",
}


class AttrGuard(NamedTuple):
    cls: str
    module: str
    guard: str
    attr: str
    escape: str  # "", "atomic_read_ok", "init_only", "unguarded"


def _flatten() -> Dict[Tuple[str, str], AttrGuard]:
    out: Dict[Tuple[str, str], AttrGuard] = {}
    for gc in GUARDS:
        # "RepoBackend(bulk)" style rows split ONE class's fields
        # across guards; the real class name precedes the "("
        cls = gc.cls.split("(", 1)[0]
        for escape, attrs in (
            ("", gc.guarded),
            ("atomic_read_ok", gc.atomic_read_ok),
            ("init_only", gc.init_only),
            ("unguarded", gc.unguarded),
        ):
            for attr in attrs:
                key = (cls, attr)
                if key in out:
                    raise ValueError(
                        f"duplicate guard entry for {cls}.{attr}"
                    )
                out[key] = AttrGuard(cls, gc.module, gc.guard, attr,
                                     escape)
    return out


BY_CLS_ATTR: Dict[Tuple[str, str], AttrGuard] = _flatten()
CLASSES: Tuple[str, ...] = tuple(
    sorted({cls for cls, _attr in BY_CLS_ATTR})
)


def guard_for(cls: str, attr: str) -> Optional[AttrGuard]:
    """The declared guard entry for (class, attribute), or None."""
    return BY_CLS_ATTR.get((cls, attr))


def validate() -> None:
    """Manifest self-check (run by tests): guards declared in the
    lock hierarchy, REQUIRES targets sane, no duplicate fields."""
    for gc in GUARDS:
        if gc.guard not in LOCK_BY_NAME:
            raise ValueError(
                f"{gc.cls}: guard {gc.guard!r} is not a lock class "
                f"declared in analysis/hierarchy.py"
            )
        if not gc.module.startswith("hypermerge_tpu_torch."):
            raise ValueError(f"{gc.cls}: module {gc.module!r} outside "
                             f"the package")
        if gc.unguarded and not gc.doc.strip():
            raise ValueError(
                f"{gc.cls}: unguarded fields need the story in doc"
            )
    _flatten()  # raises on duplicates
    for (cls, _method), lock in REQUIRES.items():
        if lock not in LOCK_BY_NAME:
            raise ValueError(
                f"REQUIRES[{cls}]: unknown lock class {lock!r}"
            )
        if not any(c.split("(", 1)[0] == cls for c in
                   (g.cls for g in GUARDS)):
            raise ValueError(
                f"REQUIRES names class {cls!r} absent from GUARDS"
            )


def markdown_table() -> str:
    """The README guard-map table (`--guards-table` of the lint CLI)."""
    lines = [
        "| Class | Guard | Escape | Fields |",
        "| --- | --- | --- | --- |",
    ]
    for gc in GUARDS:
        cls = gc.cls.split("(", 1)[0]
        for escape, attrs in (
            ("—", gc.guarded),
            ("atomic_read_ok", gc.atomic_read_ok),
            ("init_only", gc.init_only),
            ("unguarded", gc.unguarded),
        ):
            if not attrs:
                continue
            fields = ", ".join(f"`{a}`" for a in attrs)
            lines.append(
                f"| `{cls}` | `{gc.guard}` | {escape} | {fields} |"
            )
    return "\n".join(lines)
