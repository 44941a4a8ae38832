"""THE lock-hierarchy manifest — the machine-checked successor to the
"established lock order" comments that used to live scattered across
`backend/doc_backend.py`, `backend/repo_backend.py` and
`storage/integrity.py`.

Every lock in the package is created through
`analysis.lockdep.make_lock / make_rlock / make_condition` with a
**lock class** name declared here. Two checkers consume the manifest:

- the static linter (`analysis/linter.py`, run by `python -m
  hypermerge_tpu_torch.tools.lint` and `tests/test_torch_analysis.py`):
  flags nested acquisitions that can invert
  the declared ranks, blocking calls inside no-block regions, and raw
  `threading.Lock()` creations that bypass the factory;
- the runtime lockdep (`analysis/lockdep.py`, `HM_LOCKDEP=1`): records
  the actual per-thread acquisition order, builds the global
  class-level lock-order graph, and reports *potential* cycles and
  held-across-blocking-call violations even when no deadlock fires.

Rank semantics: a thread may only acquire a lock whose rank is
STRICTLY GREATER than every ranked lock it already holds (re-entrant
re-acquisition of the same instance is exempt — several classes are
RLocks by design). `rank=None` classes are unranked: they still
participate in cycle detection, but no pairwise order is declared for
them (the net layer's fine-grained locks are ordered empirically by
the cycle detector rather than by decree). `leaf=True` means no other
tracked lock may be acquired while holding it. `no_block=True` marks
the GLOBAL coordination locks: no fsync / socket send / sqlite commit
/ thread join may run while they are held. Since the write-plane
split (backend/emission.py) the only no-block class is `live.engine`
— blocking under it would stall EVERY doc's tick coordination, and
`lock.held_blocking_ms.live_engine` must read zero at every HM_FSYNC
tier (the bench `config_lockdebt` gate). The per-doc emission domain
`doc.emit` is explicitly allowed to block: a durable ack (WAL group
commit, feed append) under it stalls exactly ONE doc.

The established core order (outermost first):

    repo.bulk -> doc.emit -> live.engine -> doc -> repo -> actor
              -> store.* -> util.* -> telemetry / util.debug

(`doc.emit` OUTRANKS the engine lock: an emission path holds its
doc's domain first and dips into the engine for table bookkeeping;
the tick looks docs up with a GIL-atomic snapshot and takes each
doc's domain with NO engine lock held — never two domains at once.)

with `store.integrity`, `telemetry.shard` and `util.debug` as leaves.
The port adds five classes of its own: `kernels.build` (85, held
across nvcc at a kernel's first use), `kernels.launches` (93, a leaf
around the launch counters), `util.ossl` (unranked: libcrypto's
load-once latch), and `tools.top` and `examples.chat` (unranked: the
command-line tools and examples sit inside the package, so their
locks come from the factory too).
Leaf semantics are scoped to the RANKED world: a leaf may still touch
terminal unranked latches (the native-library load-once lock, the
fault recorders) — those are pure sinks and participate in cycle
detection only.
"""

from __future__ import annotations

import re
from typing import Dict, FrozenSet, NamedTuple, Optional, Tuple

# the dotted `subsystem.metric` telemetry naming convention — ONE
# definition shared by the static linter (analysis/linter.py) and the
# runtime creation-time assert (telemetry/registry.py under
# HM_LOCKDEP=1), so the two halves of the rule cannot drift
TELEMETRY_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")


class LockClass(NamedTuple):
    name: str
    rank: Optional[int]  # None = unranked (cycle detection only)
    doc: str
    leaf: bool = False
    no_block: bool = False


# ---------------------------------------------------------------------------
# the manifest

LOCK_CLASSES: Tuple[LockClass, ...] = (
    # -- ranked core (the documented hierarchy) -------------------------
    LockClass(
        "repo.bulk", 5,
        "RepoBackend._bulk_mutex — serializes whole bulk loads; held "
        "across ready-notifies that may take a doc's emission domain, "
        "so it is the outermost lock in the process.",
    ),
    LockClass(
        "doc.emit", 8,
        "DocBackend.emission (backend/emission.py EmissionDomain) — "
        "ONE re-entrant lock per doc, THE emission ordering domain: "
        "every {compute patch -> feed append -> push} pair of that "
        "doc (live ticks, apply_local echoes, Ready snapshots, the "
        "HM_LIVE=0 host path) holds exactly its own doc's domain. "
        "Cross-doc nesting is FORBIDDEN (a same-class edge is a "
        "lockdep order violation); a thread mid-emission that "
        "re-enters the repo for ANOTHER doc defers through "
        "emission.defer(). MAY block: a durable ack (WAL group "
        "commit, tier-2 fsync) under it stalls exactly one doc — "
        "that is the write-plane split.",
    ),
    LockClass(
        "live.engine", 10,
        "LiveApplyEngine._lock — tick/dirty-set COORDINATION only "
        "since the write-plane split: the doc table, "
        "refusal/adoption/demotion bookkeeping, and the LRU "
        "use-clock. Never held across a feed append, fsync, or "
        "frontend push (emissions run under the per-doc doc.emit "
        "domain, which OUTRANKS this lock); "
        "lock.held_blocking_ms.live_engine reading zero at every "
        "HM_FSYNC tier is the machine-checked invariant.",
        no_block=True,
    ),
    LockClass(
        "doc", 16,
        "DocBackend._lock — per-doc CRDT/lazy state. Ranks ABOVE the "
        "repo lock: the lazy replay (_ensure_opset / _replay_opset) "
        "holds it while its loader opens actors through the repo. The "
        "repo NEVER takes a doc lock while holding its own (DocBackend "
        "construction under the repo lock acquires nothing), and "
        "notifies always fire after the doc lock is released.",
    ),
    LockClass(
        "repo", 20,
        "RepoBackend._lock — docs/actors tables. Engine->repo is the "
        "established order (snapshots under the engine lock open "
        "actors under this one); repo->engine is the open()/Ready "
        "deadlock the emission-lock unification removed.",
    ),
    LockClass(
        "actor", 35,
        "Actor._lock — per-feed change list + sidecar sync. Feed "
        "listeners fire outside the feed lock, so actor never nests "
        "inside store.feed.",
    ),
    LockClass(
        "repo.stats", 40,
        "RepoBackend._stats_lock — bulk-load stage timing "
        "accumulators (pipeline worker threads).",
    ),
    LockClass(
        "store.feed_store", 48,
        "FeedStore._lock — the feeds table; held while constructing "
        "Feeds, so it ranks above the per-feed locks' users but "
        "below the feed lock itself.",
    ),
    LockClass(
        "store.feed", 50,
        "Feed._lock — one append-only log. Held across storage "
        "append + merkle sign; listeners fire after release.",
    ),
    LockClass(
        "store.feed_io", 52,
        "FileFeedStorage._io — the cached write handles (log + .len "
        "sidecar) and every operation that uses or drops them: the "
        "appender (under store.feed) and the WAL checkpoint thread's "
        "storage.sync() share the SAME fds, so seek/write/fsync/close "
        "must serialize. Acquired under store.feed, holds across "
        "store.wal (the journal append rides inside a feed append).",
    ),
    LockClass(
        "store.colcache", 54,
        "FeedColumnCache._lock — per-feed columnar sidecar.",
    ),
    LockClass(
        "store.slab", 56,
        "CorpusSlab._lock — the repo's shared sidecar slab file.",
    ),
    LockClass(
        "store.sql", 60,
        "SqlDatabase._lock — statement + commit serialization. The "
        "sqlite commit itself runs under it by design; it is therefore "
        "the one store lock that may block, and nothing below it may "
        "be acquired while it is held except the fault recorder.",
    ),
    LockClass(
        "store.cursors", 62,
        "CursorStore._lock — the write-through cursor memory mirror. "
        "Ranks ABOVE store.sql: the write batches absorb into the "
        "mirror from inside db.bulk() (sql lock held), and hydration "
        "queries SQLite BEFORE taking the mirror lock "
        "(CursorStore._ensure_hydrated — the sql<->cursors AB/BA the "
        "first lockdep run caught).",
    ),
    LockClass(
        "store.durability", 66,
        "DurabilityManager._lock — the tier-1 dirty set. sync_now "
        "drains OUTSIDE it; mark_dirty is called under feed locks.",
    ),
    LockClass(
        "store.wal", 67,
        "WriteAheadLog._lock (storage/wal.py) — the shared per-repo "
        "journal: record appends and the group-commit handshake "
        "serialize under it (acquired under store.feed during a feed "
        "append, hence above it). The commit fsync itself runs "
        "OUTSIDE it — appenders keep writing while the leader "
        "syncs.",
    ),
    LockClass(
        "store.integrity", 70,
        "FeedIntegrity._lock — signed-merkle state. LEAF: proof "
        "serving and signing must not reach back into any other lock "
        "(the integrity lock-order fix, now machine-checked).",
        leaf=True,
    ),
    LockClass(
        "serve.cache", 74,
        "serve.resident.ResidencyCache._lock — the HBM residency "
        "table (entries, LRU order, byte budget) plus the serve "
        "tier's host-side memo. Entry BUILDS (pack + kernel + device "
        "upload) run with NO serve lock held (the "
        "install-and-recheck idiom); the critical sections are dict "
        "bookkeeping only, so nothing but the telemetry/debug leaves "
        "may be acquired under it. Ranks above the store locks: "
        "write-path emission hooks (engine lock held) mark entries "
        "stale under it.",
    ),
    LockClass(
        "serve.batch", 76,
        "serve.batcher.ReadBatcher._lock — admission-queue depth "
        "accounting. Held for counter arithmetic only; the debounced "
        "flush (util.debounce) is always marked OUTSIDE it.",
    ),
    LockClass(
        "serve.overload", 77,
        "serve.overload.OverloadController._lock — the brownout "
        "ladder's shared state: tenant token-bucket table, last "
        "signal sample, ticker lifecycle. Held for dict/arith "
        "bookkeeping only (telemetry shard installs nest inside); "
        "the hot-path state probe is a GIL-atomic read outside it.",
    ),
    LockClass(
        "util.debounce", 78,
        "Debouncer._lock/_cv — mark/flush handshake. flush_fn runs "
        "with NO debouncer lock held, so flushes may take any lock; "
        "mark() is called under store locks.",
    ),
    LockClass(
        "util.queue", 80,
        "utils.queue.Queue._lock — buffered handoff. Subscriber "
        "callbacks run outside it; only the debug lock nests inside "
        "(the subscribe log line).",
    ),
    LockClass(
        "kernels.build", 85,
        "kernels/_build.py's build lock (the port's own) — held while "
        "nvcc builds a CUDA source and its library loads, which runs "
        "at a kernel's first use in the process: a pipeline pack "
        "worker, a live tick, a serve install or a slab dispatch may "
        "be the first caller. Ranked above every store and serve lock "
        "such a caller may hold; it MAY block (the nvcc wait is a "
        "`blocking` seam), so it must never be reached under "
        "live.engine. Only telemetry and the debug leaves nest inside.",
    ),
    LockClass(
        "telemetry.table", 90,
        "MetricsRegistry._lock — the series table. retire() folds a "
        "closed component's counters into an aggregate under it, "
        "installing a shard cell, so it ranks just above the shard "
        "locks and is NOT a leaf.",
    ),
    LockClass(
        "telemetry.shard", 92,
        "Counter/Gauge/Histogram shard-install locks. LEAF: a metric "
        "bump must be acquirable from under any lock in the process.",
        leaf=True,
    ),
    LockClass(
        "kernels.launches", 93,
        "ops/crdt_kernels.py's launch-count lock (the port's own): one "
        "`launches[name] += 1` per kernel launch, taken inside the "
        "CUDA wrappers, which may run under doc.emit, live.engine, "
        "serve.cache or a store lock. LEAF: it guards one dict "
        "increment and nothing is acquired under it.",
        leaf=True,
    ),
    LockClass(
        "util.debug", 95,
        "utils.debug pattern/timing locks. LEAF: log() is called "
        "from under nearly every lock in the package.",
        leaf=True,
    ),
    # -- unranked (cycle detection only) --------------------------------
    LockClass(
        "live.gc", None,
        "backend.live._gc_pause_lock — GC pause refcount across "
        "adoption builds.",
    ),
    LockClass(
        "doc.emit.defer", None,
        "backend.emission deferred-emission worker — the cross-doc "
        "re-entry escape hatch: a thread holding doc A's emission "
        "domain that re-enters the repo for doc B parks the work "
        "here instead of nesting domains.",
    ),
    LockClass(
        "net.ipc.hub", None,
        "net.ipc._FrontendHub._lock — the multi-frontend daemon's "
        "connection/interest table (accept threads vs route).",
    ),
    LockClass(
        "net.ipc.router", None,
        "net.ipc._ShardRouter._lock — the HM_WORKERS write plane's "
        "worker-slot/pending/telemetry tables (route threads vs the "
        "respawn supervisor vs worker reader threads).",
    ),
    LockClass(
        "pipeline.err", None,
        "pipeline FetchContext._err_lock — first-error capture.",
    ),
    LockClass(
        "pipeline.pack_pool", None,
        "SlabPipeline._pack_cv — the pack pool's ordered-emit turn "
        "counter and EOF claim (HM_PACK_WORKERS workers race the pack "
        "queue but emit into the dispatch queue in slab order).",
    ),
    LockClass("front.repo", None, "RepoFrontend._lock."),
    LockClass("front.doc", None, "DocFrontend._lock."),
    LockClass(
        "ops.clock_mirror", None,
        "DeviceClockMirror._lock — host-buffered device clock table.",
    ),
    LockClass("native.load", None, "native library load-once latch."),
    LockClass(
        "util.ossl", None,
        "utils/ossl.py's libcrypto load-once latch (the port's own): "
        "taken by the ed25519 sign/verify route, under store.feed or "
        "store.integrity, and holds nothing else. A pure sink like "
        "native.load, so unranked.",
    ),
    LockClass("net.network", None, "Network._lock — peers table."),
    LockClass("net.swarm", None, "in-memory Swarm._lock."),
    LockClass(
        "net.peer", None,
        "NetworkPeer._plock — pending-connection list (accept/"
        "supervisor threads vs close-driven prunes).",
    ),
    LockClass(
        "net.conn", None,
        "PeerConnection._close_lock — close-listener registration "
        "atomic against the close snapshot.",
    ),
    LockClass("net.duplex", None, "in-memory Duplex._lock."),
    LockClass(
        "net.repl", None,
        "ReplicationManager._lock — per-peer cursor/want state.",
    ),
    LockClass(
        "net.sup", None,
        "SessionSupervisor._lock — outbound session table.",
    ),
    LockClass(
        "net.tcp", None,
        "TcpDuplex._lock — close/session state.",
    ),
    LockClass(
        "net.tcp.outbox", None,
        "TcpDuplex._out_cv — writer-thread outbox handoff.",
    ),
    LockClass(
        "net.tcp.server", None,
        "TcpSwarm._dlock — live duplex tracking.",
    ),
    LockClass(
        "net.tcp.accept", None,
        "TcpSwarm._accept_cv — the bounded inbound-handshake pool's "
        "queue handoff (accept thread vs pool workers). Held for "
        "deque bookkeeping only; handshakes run outside it.",
    ),
    LockClass(
        "net.aio", None,
        "aio.AioLoop._lock — the event loop's ready queue + timer "
        "heap (submitters from any thread vs the loop thread). Held "
        "for queue/heap bookkeeping only; callbacks and selector "
        "polling run outside it.",
    ),
    LockClass(
        "net.aio.conn", None,
        "aio.AioDuplex._lock — one async connection's outbox, close "
        "listeners and inbound-dispatch latch (senders from any "
        "thread vs the loop thread vs dispatch workers).",
    ),
    LockClass(
        "net.aio.dispatch", None,
        "aio.AioLoop._dispatch_cv — the bounded dispatch pool's "
        "queue handoff. User-facing callbacks run OUTSIDE it on the "
        "pool workers, never on the loop thread.",
    ),
    LockClass(
        "net.dht", None,
        "discovery.dht RoutingTable._lock — the k-bucket array + "
        "replacement caches. Pure table bookkeeping; liveness probes "
        "fire OUTSIDE it.",
    ),
    LockClass(
        "net.dht.store", None,
        "discovery.dht RecordStore._lock — the signed announce-record "
        "table (verification runs before the lock).",
    ),
    LockClass(
        "net.dht.rpc", None,
        "discovery.dht DhtNode._plock — the pending-RPC correlation "
        "table (reader thread vs timeout timers vs senders).",
    ),
    LockClass(
        "net.dht.swarm", None,
        "discovery.swarm DhtSwarm._lock — the joined-id and "
        "active-view target tables (join/leave callers vs the "
        "maintenance thread).",
    ),
    LockClass(
        "net.gossip", None,
        "discovery.gossip GossipSampler._lock — the per-key sample "
        "table. Held for dict bookkeeping only (the hot broadcast "
        "paths call sample()).",
    ),
    LockClass("net.fault.plan", None, "FaultPlan._lock — RNG streams."),
    LockClass(
        "net.fault.delay", None,
        "fault _DelayLine._cv — per-direction FIFO delay line.",
    ),
    LockClass("net.fault.swarm", None, "FaultSwarm._lock."),
    LockClass(
        "store.fault.plan", None, "DiskFaultPlan._lock — RNG streams.",
    ),
    LockClass(
        "store.fault.recorder", None,
        "CrashRecorder._lock — write/fsync/commit journal.",
    ),
    LockClass(
        "store.fault.active", None,
        "storage.faults._active_lock — plan activation latch.",
    ),
    # -- the command-line tools and examples (the port's own) -----------
    LockClass(
        "tools.top", None,
        "tools.top.IpcTelemetry._lock — the pending-query table of the "
        "Telemetry client (the poller vs the duplex's reader thread). "
        "Dict bookkeeping only; the wait runs outside it.",
    ),
    LockClass(
        "examples.chat", None,
        "examples.chat run_chat's seen-message count (the watch "
        "callback's threads). Held across a print; nothing else is "
        "taken under it.",
    ),
)

BY_NAME: Dict[str, LockClass] = {c.name: c for c in LOCK_CLASSES}
RANKED: Dict[str, int] = {
    c.name: c.rank for c in LOCK_CLASSES if c.rank is not None
}
LEAVES: FrozenSet[str] = frozenset(c.name for c in LOCK_CLASSES if c.leaf)
NO_BLOCK: FrozenSet[str] = frozenset(
    c.name for c in LOCK_CLASSES if c.no_block
)

# Lock-class pairs the cycle detector must NOT treat as ordered edges,
# each with a justification. Kept deliberately empty-by-default: a new
# entry is a reviewed decision, not a quick fix. (Format:
# ((holder_class, acquired_class), "why this nesting cannot deadlock").)
ALLOWED_EDGES: Dict[Tuple[str, str], str] = {}

# Methods that (transitively) acquire doc.emit / live.engine — the
# linter flags a call to any of these from inside a `with` holding a
# ranked lock whose rank is ABOVE the engine's (repo/doc/actor/store):
# that is exactly the repo->engine inversion the open()/Ready deadlock
# was made of, and since the write-plane split the same rule keeps a
# store/doc lock from being held into an emission domain acquisition.
# (`snapshot_patch` also enters the engine but shares its name with
# OpSet.snapshot_patch — a lexical linter cannot tell them apart, so
# the runtime lockdep detector owns that entrypoint.)
ENGINE_ENTRYPOINTS: FrozenSet[str] = frozenset(
    {"apply_local", "submit_remote", "demote_idle"}
)

# Attribute/function call names the no-blocking-under-lock rule treats
# as blocking primitives when they appear lexically inside a no_block
# `with` region. `.commit` is sqlite, `.sendall` the socket layer,
# `io_fsync`/`fsync` the durability seam, `.join`/`sleep`/`first`/
# `flush_now`/`barrier`/`sync_now` the wait-shaped calls.
BLOCKING_CALLS: FrozenSet[str] = frozenset(
    {
        "fsync", "io_fsync", "sendall", "commit", "join", "sleep",
        "first", "flush_now", "barrier", "sync_now", "wait",
    }
)


def rank_of(name: str) -> Optional[int]:
    """Declared rank for a lock class (None when unranked/unknown)."""
    return RANKED.get(name)


def validate() -> None:
    """Manifest self-check (run by tests): names unique, ranks unique
    among ranked classes, allowed-edge endpoints declared and
    justified."""
    names = [c.name for c in LOCK_CLASSES]
    if len(names) != len(set(names)):
        raise ValueError("duplicate lock class names in manifest")
    ranks = [c.rank for c in LOCK_CLASSES if c.rank is not None]
    if len(ranks) != len(set(ranks)):
        raise ValueError("duplicate ranks in manifest")
    for (a, b), why in ALLOWED_EDGES.items():
        if a not in BY_NAME or b not in BY_NAME:
            raise ValueError(f"allowed edge ({a}, {b}) names unknown class")
        if not why.strip():
            raise ValueError(f"allowed edge ({a}, {b}) lacks justification")
