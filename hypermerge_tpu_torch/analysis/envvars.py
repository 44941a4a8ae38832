"""The HM_* environment-variable registry.

Every `os.environ` read of an `HM_`-prefixed name anywhere in the
port (the package, bench_torch/ and chip_smoke.py) must be declared
here exactly once — the `env-registry` lint rule
(analysis/linter.py) fails tier-1 on an undeclared read, on a registry
entry nothing reads (stale), and on a registry entry missing from the
README's env-var table. This is the one place a knob's default and
meaning live; the README table is generated from the same data
(`python -m hypermerge_tpu_torch.tools.lint --env-table`), and lives
in the README's "PyTorch/CUDA port" section.

The rows are the reference's (hypermerge_tpu/analysis/envvars.py) with
two defaults that are the port's own (HM_DEVICE_PACK=1: the pack runs
`pack_prefix.cu` by default; HM_SERVICE=0: the service plane is off by
default) and without the four knobs of XLA and Pallas that the port has
nothing to switch: HM_COMPILE_CACHE, HM_COMPILE_CACHE_FORCE,
HM_ASYNC_SUMMARY_COPY and HM_ICI_PALLAS.

`default` is the literal fallback the reading site uses (None for
presence-style flags where unset means off). Registering here is
documentation, not parsing — call sites keep reading os.environ
directly so hot paths stay allocation-free.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple


class EnvVar(NamedTuple):
    name: str
    default: Optional[str]  # None: presence-style flag, unset = off
    doc: str


REGISTRY: Tuple[EnvVar, ...] = (
    # -- live apply engine ---------------------------------------------
    EnvVar("HM_LIVE", "1", "Live apply engine on the incremental path "
           "(0 = host OpSet twin)."),
    EnvVar("HM_LIVE_TICK_MS", "2", "Debounce window of the live tick "
           "(leading-edge pad of a burst)."),
    EnvVar("HM_LIVE_TICK_MAX_MS", "25", "Adaptive ceiling of the live "
           "tick window under sustained load."),
    EnvVar("HM_LIVE_INC_BUDGET", "2000000", "Max cells (rows x lanes) a "
           "small tick applies host-side before a catch-up dispatch."),
    EnvVar("HM_LIVE_MAX_BYTES", "0", "Resident-bytes cap across adopted "
           "docs' live columns; LRU demotes back to lazy (0 = unbounded)."),
    EnvVar("HM_DEVICE_MIN_CELLS", "131072", "Below this many cells a "
           "materialize runs host-side instead of a device dispatch."),
    # -- bulk cold open / pipeline -------------------------------------
    EnvVar("HM_BULK_SLAB", "4096", "Docs per bulk-load slab (the "
           "streaming pipeline's unit of IO/pack/dispatch)."),
    EnvVar("HM_PIPELINE", None, "Force the streaming pipeline on (1) or "
           "off (0); unset = auto (on when the native pack drops the "
           "GIL)."),
    EnvVar("HM_PIPELINE_DEPTH", "2", "Bounded depth of each pipeline "
           "stage queue."),
    EnvVar("HM_FETCH_WORKERS", "4", "Summary-fetch workers (sized to "
           "device count by the bulk loader)."),
    EnvVar("HM_PACK_WORKERS", "0", "Pack-pool threads for the bulk "
           "pipeline (slab-granular, order-preserving); 0 = auto: "
           "min(4, cores) when the native pack is concurrency-safe, "
           "else 1."),
    EnvVar("HM_DEVICE_PACK", "1", "Run the fast-path pack as the "
           "device kernel (kernels/csrc/pack_prefix.cu); 0 = the native "
           "host pack (numpy where it is absent), bit-identical."),
    EnvVar("HM_LOAD_THREADS", "8", "Parallel sidecar prefetch threads "
           "for bulk document loads."),
    EnvVar("HM_FAST_OPEN", "1", "Serve single-doc opens from the "
           "columnar sidecar when possible (0 = full feed replay)."),
    EnvVar("HM_SUMMARY_MEMO_MB", "256", "Byte-bounded LRU of per-doc "
           "summary rows; clean docs skip pack+dispatch+fetch "
           "(0 = disabled)."),
    # -- mesh / multi-chip ---------------------------------------------
    EnvVar("HM_MESH", "1", "Multi-device mesh programs (0 = single "
           "device)."),
    EnvVar("HM_SLAB_RR", "1", "Round-robin whole slabs across devices "
           "(0 = sharded_full lockstep)."),
    EnvVar("HM_RR_DEPTH", "2", "Per-device in-flight slab bound of the "
           "round-robin scheduler."),
    EnvVar("HM_RR_LEAST_LOADED", "0", "Shortest-queue-first slab "
           "placement instead of strict round-robin."),
    # -- storage --------------------------------------------------------
    EnvVar("HM_SLAB", "1", "Columnar sidecars in one mmap'd corpus slab "
           "file (0 = per-feed .cols2 files)."),
    EnvVar("HM_SLAB_SLACK", "0.25", "Dead-byte fraction that triggers "
           "slab compaction."),
    EnvVar("HM_CKPT_TAIL", "64", "Sidecar tail length that triggers a "
           "fresh column image (checkpoint) instead of a delta append."),
    EnvVar("HM_BLOCK_CODEC", None, "Block codec override (zlib); unset "
           "= raw."),
    EnvVar("HM_FSYNC", "0", "Durability tier: 0 none, 1 group-fsync "
           "window, 2 fsync per append."),
    EnvVar("HM_FSYNC_MS", "25", "Group-fsync window for HM_FSYNC=1."),
    EnvVar("HM_WAL", "1", "Shared per-repo write-ahead journal "
           "(storage/wal.py): a durable commit window is ONE "
           "sequential append + ONE fsync regardless of dirty feed "
           "count (0 = legacy per-feed fsyncs)."),
    EnvVar("HM_WAL_MS", "0", "Group-commit gather window of the WAL "
           "leader fsync (tier-2 acks and HM_ACK_DURABLE tier-1 acks; "
           "0 = sync immediately; concurrent committers still share "
           "one fsync)."),
    EnvVar("HM_ACK_DURABLE", "0", "=1 makes a local edit's ack "
           "DURABLE at HM_FSYNC=1: the LocalPatch echo waits for the "
           "WAL group commit covering its append (N writers share "
           "one fsync per HM_WAL_MS window)."),
    EnvVar("HM_WAL_MAX_BYTES", "67108864", "Journal size that "
           "triggers a checkpoint (per-feed logs fsynced off the ack "
           "path, journal reset to its dirty-name ledger)."),
    EnvVar("HM_RECOVER", "1", "Whole-repo recovery-on-open after a "
           "crash marker (0 = skip)."),
    EnvVar("HM_SIGN_INTERVAL", "1024", "Appends between persisted "
           "merkle signature records (lazy signing)."),
    EnvVar("HM_ALLOW_UNSIGNED_FEEDS", None, "=1 serves feeds with no "
           "signature chain (tests/migration only)."),
    EnvVar("HM_SPARSE_CAP", "1024", "Bound of the out-of-order "
           "verified-block side buffer per feed."),
    EnvVar("HM_SPARSE_WANTED_CAP", "8192", "Bound of the outstanding "
           "sparse range-request set per feed (furthest-out shed "
           "first)."),
    EnvVar("HM_STORE_DEBOUNCE", "1", "Debounced clock/cursor sqlite "
           "flusher (0 = write-through)."),
    EnvVar("HM_STORE_FLUSH_MS", "5", "Window of the clock/cursor store "
           "flusher."),
    EnvVar("HM_CACHE_FLUSH_MS", "5", "Window of the deferred columnar "
           "sidecar sync."),
    EnvVar("HM_SYNC_FLUSH_MS", "2", "Window of the inbound-sync "
           "application debouncer."),
    EnvVar("HM_CLOCK_MIRROR", "1", "Device-resident clock mirror for "
           "bulk union/dominated queries."),
    # -- read-serving tier ---------------------------------------------
    EnvVar("HM_SERVE", "1", "HBM-resident read-serving tier: reads "
           "answer from batched device query kernels over resident "
           "summary columns (0 = per-request host materialization "
           "twin)."),
    EnvVar("HM_SERVE_MAX_BYTES", "268435456", "Resident-bytes budget "
           "of the serving tier (LRU eviction), applied to the device "
           "residency cache and the host fallback memo each."),
    EnvVar("HM_SERVE_BATCH_MS", "1", "Debounce window of the read "
           "batcher: concurrent reads inside it coalesce into one "
           "batched kernel dispatch."),
    EnvVar("HM_SERVE_QUEUE", "4096", "Bound of the read admission "
           "queue; overflow is a dedicated service-plane signal "
           "(serve.overload_shed) answered via the host path or a "
           "typed refusal, never an unbounded queue."),
    # -- service plane (overload control) -------------------------------
    EnvVar("HM_SERVICE", "0", "=1 runs the overload controller "
           "(serve/overload.py brownout ladder): signal-driven "
           "admission control at the read front door plus WAL ack "
           "pacing (0 = no controller: the port's default)."),
    EnvVar("HM_SERVICE_TICK_MS", "50", "Period of the controller's "
           "signal-sampling tick."),
    EnvVar("HM_SERVICE_P99_SLO_MS", "50", "Serve-read p99 SLO the "
           "pressure signal normalizes against (pressure 1.0 = p99 "
           "at SLO)."),
    EnvVar("HM_SERVICE_RETRY_AFTER_MS", "100", "Floor of the "
           "retry-after a typed Overload refusal carries."),
    EnvVar("HM_SERVICE_ACK_STRETCH_MS", "25", "Extra group-commit "
           "gather window while SHED — durable-write backpressure "
           "(acks pace down; nothing acked is dropped)."),
    EnvVar("HM_SERVICE_FORCE", None, "Pin the ladder state "
           "(healthy|brownout|shed) — deterministic tests and drills; "
           "unset = signal-driven."),
    EnvVar("HM_BROWNOUT_HI", "1.0", "Pressure watermark at/above "
           "which consecutive ticks escalate the ladder one rung."),
    EnvVar("HM_BROWNOUT_LO", "0.5", "Pressure watermark at/below "
           "which consecutive ticks de-escalate one rung (the dead "
           "band between LO and HI holds the rung: no flapping)."),
    EnvVar("HM_BROWNOUT_UP_TICKS", "3", "Consecutive over-HI ticks "
           "required to escalate."),
    EnvVar("HM_BROWNOUT_DOWN_TICKS", "10", "Consecutive under-LO "
           "ticks required to de-escalate (slower down than up: "
           "recovery must be proven, not hoped)."),
    EnvVar("HM_QUOTA_READS_S", "512", "Per-tenant token-bucket refill "
           "rate enforced at the front door while SHED (reads/s)."),
    EnvVar("HM_QUOTA_BURST", "64", "Per-tenant token-bucket burst "
           "capacity."),
    # -- write plane (hub daemon) ---------------------------------------
    EnvVar("HM_NATIVE_CODEC", "1", "Binary change frames (native "
           "GIL-free encode when built, bit-identical Python twin "
           "otherwise) for small change blocks; 0 = write JSON blocks "
           "(readers always handle both)."),
    EnvVar("HM_HUB_WRITERS", "1", "Hub daemon many-writer plane: tag "
           "Create/Open/NeedsActorId with the connection key so each "
           "writing connection gets its OWN per-doc actor; 0 = legacy "
           "one-writer-per-doc protocol."),
    EnvVar("HM_WORKERS", "0", "Hub daemon worker processes: >0 shards "
           "docs across N per-doc-range net.ipc worker subprocesses "
           "(own repo shard, engine, and WAL each) behind the hub; "
           "0 = single in-process backend."),
    EnvVar("HM_WORKER_RESPAWN_MS", "200", "Supervision backoff before "
           "a dead worker process is reaped and respawned on its "
           "shard (journal-prefix recovery replays acked edits)."),
    # -- network --------------------------------------------------------
    EnvVar("HM_DHT_BOOTSTRAP", None, "Comma-separated host:port DHT "
           "bootstrap nodes (net/discovery/) for DhtSwarm/DhtNode."),
    EnvVar("HM_DHT_K", "16", "Kademlia k: contacts per routing bucket "
           "and width of lookup frontiers/replica sets."),
    EnvVar("HM_DHT_ALPHA", "3", "Concurrent probes per iterative "
           "lookup round."),
    EnvVar("HM_DHT_RPC_TIMEOUT_S", "1", "UDP DHT RPC timeout (an "
           "unanswered liveness ping evicts the bucket LRU)."),
    EnvVar("HM_DHT_TTL_S", "120", "Announce record time-to-live; a "
           "crashed peer's stale address evaporates within one TTL."),
    EnvVar("HM_DHT_ANNOUNCE_S", "30", "Re-announce period for joined "
           "ids with announce posture (keep well under HM_DHT_TTL_S)."),
    EnvVar("HM_DHT_LOOKUP_S", "10", "Lookup refresh period for joined "
           "ids with lookup posture (resamples the active view)."),
    EnvVar("HM_DHT_TARGETS", "4", "Bounded active view: max supervised "
           "dials per joined id out of the announcers a lookup found "
           "(0 = dial every announcer)."),
    EnvVar("HM_GOSSIP_FANOUT", "8", "Per-doc active replication/gossip "
           "fanout cap (random peer subset; 0 = broadcast to every "
           "peer). Anti-entropy sweeps stay unsampled."),
    EnvVar("HM_GOSSIP_RESHUFFLE_S", "5", "How long a gossip sample "
           "stays fixed before reshuffling to a fresh peer subset."),
    EnvVar("HM_GOSSIP_FLUSH_MS", "10", "Window of the cursor/clock "
           "gossip broadcast debouncer."),
    EnvVar("HM_GOSSIP_FRESH", "1", "Overlay pending store rows onto "
           "gossip so it never advertises stale cursors."),
    EnvVar("HM_REPL_CHUNK", "1024", "Blocks per replication data "
           "frame."),
    EnvVar("HM_REPL_CHUNK_BYTES", "8388608", "Byte bound per "
           "replication data frame."),
    EnvVar("HM_REPL_FLUSH_MS", "2", "Window of the replication live-"
           "tail debouncer."),
    EnvVar("HM_REPL_FLUSH_MAX_MS", "25", "Adaptive ceiling of the "
           "replication flush window."),
    EnvVar("HM_ANTIENTROPY_S", "30", "Period of the FeedLength "
           "re-announce sweep (bounds staleness under frame loss; "
           "0 = off)."),
    EnvVar("HM_TCP_OUTBOX_MB", "64", "Per-connection outbound buffer "
           "cap; exceeding it sheds the connection."),
    EnvVar("HM_TCP_STALL_S", "10", "Writer-thread no-progress bound "
           "before a connection is shed."),
    EnvVar("HM_TCP_PLAINTEXT", None, "=1 disables the encrypted "
           "session (tests only)."),
    EnvVar("HM_NET_AUTH", "1", "Require peer identity proof at "
           "accept/dial."),
    EnvVar("HM_NET_PING_S", "15", "Keepalive probe period (0 = off)."),
    EnvVar("HM_NET_PING_MISSES", "3", "Unanswered probes before a "
           "half-open connection is shed."),
    EnvVar("HM_DIAL_TIMEOUT_S", "10", "Bound on one dial+handshake "
           "attempt."),
    EnvVar("HM_REDIAL_BASE_MS", "250", "Base of the supervised-redial "
           "full-jitter backoff."),
    EnvVar("HM_REDIAL_MAX_S", "30", "Cap of the supervised-redial "
           "backoff."),
    EnvVar("HM_REDIAL_RESET_S", "1", "Connection must survive this "
           "long before the backoff resets."),
    EnvVar("HM_INFO_TIMEOUT_S", "20", "Reap connections whose Info "
           "exchange never completes."),
    EnvVar("HM_FAULT", None, "Deterministic network fault spec "
           "(seed:events...) auto-applied to every swarm."),
    EnvVar("HM_NET_ASYNC", "0", "=1 multiplexes every TCP connection "
           "onto the process's selector event loop (net/aio.py): "
           "non-blocking sockets, loop-driven handshakes and dials, "
           "keepalives on one timer wheel — O(1) threads per daemon "
           "instead of ~4 per peer. =0 keeps the wire-compatible "
           "thread-per-connection twin."),
    EnvVar("HM_AIO_DISPATCH", "8", "Bounded worker pool that runs "
           "user-facing callbacks off the event loop thread "
           "(HM_NET_ASYNC=1)."),
    EnvVar("HM_TCP_ACCEPT_POOL", "8", "Bounded inbound-handshake "
           "workers of the thread-per-connection stack; an accept "
           "storm queues instead of spawning unbounded threads."),
    EnvVar("HM_CURSOR_DELTA", "1", "Delta cursor gossip: steady-state "
           "frames carry only actors whose clock advanced since the "
           "last frame on that connection (full frame on "
           "(re)connect; repair paths always full). =0 sends full "
           "maps every frame."),
    EnvVar("HM_DHT_PUSH_SEED", "0", "=1 push-seeds announced docs to "
           "the DHT's k-closest nodes at announce time (they open "
           "the doc and serve the cold-join first wave)."),
    EnvVar("HM_FILE_FETCH_TIMEOUT_S", "15", "Hyperfile range-fetch "
           "timeout."),
    # -- telemetry / analysis ------------------------------------------
    EnvVar("HM_TRACE", None, "Span-trace output path (Chrome trace "
           "JSON, written at exit)."),
    EnvVar("HM_TRACE_RING", "65536", "Span ring capacity."),
    EnvVar("HM_LOCKDEP", "0", "=1 instruments every factory-made lock: "
           "records acquisition order, reports potential deadlock "
           "cycles + held-across-blocking-call violations "
           "(analysis/lockdep.py)."),
    EnvVar("HM_RACEDEP", "0", "=1 wraps the guard manifest's declared "
           "attributes (analysis/guards.py) in Eraser-style lockset "
           "descriptors: a shared field no lock consistently guards "
           "is reported without the race firing (implies "
           "HM_LOCKDEP)."),
    EnvVar("HM_RACEDEP_SAMPLE", "1", "Track every Nth "
           "(object, attribute) under HM_RACEDEP=1 (1 = all; raise "
           "to bound overhead on huge corpora)."),
    # -- native / tools -------------------------------------------------
    EnvVar("HM_NATIVE_PACK", "1", "Native C++ pack kernel (0 = numpy "
           "twin)."),
    EnvVar("HM_NO_NATIVE", None, "Presence disables loading/building "
           "the native library entirely."),
    EnvVar("HM_DRYRUN_DOCS", "2048", "Docs for the graft-entry dryrun "
           "corpus."),
    EnvVar("HM_DRYRUN_OPS", "512", "Ops per doc for the graft-entry "
           "dryrun corpus."),
)

BY_NAME: Dict[str, EnvVar] = {v.name: v for v in REGISTRY}


def validate() -> None:
    """Registry self-check: unique names, every entry documented."""
    if len(BY_NAME) != len(REGISTRY):
        raise ValueError("duplicate HM_* names in the env registry")
    for v in REGISTRY:
        if not v.name.startswith("HM_"):
            raise ValueError(f"{v.name}: registry is for HM_* names")
        if not v.doc.strip():
            raise ValueError(f"{v.name}: missing description")


def markdown_table() -> str:
    """The README env-var table (`--env-table` of the lint CLI)."""
    lines = [
        "| Variable | Default | Meaning |",
        "| --- | --- | --- |",
    ]
    for v in REGISTRY:
        default = "(unset)" if v.default is None else f"`{v.default}`"
        lines.append(f"| `{v.name}` | {default} | {v.doc} |")
    return "\n".join(lines)
