"""DocBackend — per-document CRDT state holder.

Parity: reference src/DocBackend.ts:46-213 — wraps the CRDT engine
(here: crdt.opset.OpSet), serializes local/remote change application
through single-subscriber queues, tracks the clock and the minimumClock
render gate (don't surface a doc until we've caught up to what peers said
exists, reference src/DocBackend.ts:90-113), and notifies the RepoBackend
hub of Ready/LocalPatch/RemotePatch events.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ..analysis.lockdep import make_rlock
from ..crdt import clock as clockmod
from ..crdt.change import Change, ChangeRequest
from ..crdt.opset import OpSet
from ..utils.debug import bench, log
from ..utils.queue import Queue
from . import emission
from .emission import EmissionDomain


class DocBackend:
    def __init__(
        self,
        doc_id: str,
        notify: Callable[[Dict[str, Any]], None],
        opset: Optional[OpSet] = None,
        live=None,
    ) -> None:
        self.id = doc_id
        self._notify = notify
        # which of this class's fields the doc lock guards — and which
        # reads are declared GIL-atomic snapshots (opset/_announced/
        # actor_id) — is manifest data now: analysis/guards.py, checked
        # statically (guarded-attr) and at runtime (HM_RACEDEP=1)
        self._lock = make_rlock("doc")
        # THE doc's emission ordering domain (`doc.emit`,
        # backend/emission.py): every {compute patch -> feed append ->
        # push} pair of THIS doc — live ticks, local echoes, Ready
        # snapshots, the HM_LIVE=0 host path — holds it, and nothing
        # else's. A Ready snapshot can never be overtaken by a patch
        # for a NEWER state of this doc (a pending frontend drops
        # pre-Ready patches), while DISJOINT docs emit (and commit
        # durably) in parallel. Re-entrant for in-process frontends
        # whose on_patch synchronously sends the next change to the
        # SAME doc; cross-doc re-entry defers (emission.defer).
        self.emission = EmissionDomain(doc_id)
        self.opset: Optional[OpSet] = opset
        # live apply engine (backend/live.py): lazy docs' incremental
        # changes batch through per-tick kernel dispatches instead of
        # reconstructing a host OpSet. None = host path (HM_LIVE=0).
        self._live = live
        self._live_adopted = False
        self.actor_id: Optional[str] = None
        # deferred-init state (bulk cold start, repo_backend
        # load_documents_bulk): readiness/clock/snapshot served without a
        # host OpSet; the OpSet reconstructs lazily on first change
        self._lazy_loader: Optional[Callable[[], List[Change]]] = None
        self._lazy_clock: Optional[clockmod.Clock] = None
        self._lazy_len = 0
        self._snapshot_fn: Optional[Callable[[], Any]] = None
        self._snapshot_cache: Optional[Any] = None
        # (serving clock, OpSet) memo for the time-travel replay of a
        # live-adopted doc — scrubbing a history slider must not pay a
        # full feed replay per step
        self._replay_cache: Optional[tuple] = None
        self.ready = Queue(f"doc:{doc_id[:6]}:ready")
        self._announced = False
        self.minimum_clock: Optional[clockmod.Clock] = None
        self.local_q: Queue = Queue(f"doc:{doc_id[:6]}:local")
        self.remote_q: Queue = Queue(f"doc:{doc_id[:6]}:remote")
        self.local_q.subscribe(self._handle_local)
        self.remote_q.subscribe(self._handle_remote)
        if opset is not None:
            self._check_ready()

    # ------------------------------------------------------------------

    @property
    def can_apply(self) -> bool:
        """True once the doc can absorb changes — either a live OpSet or
        the deferred-init state (which reconstructs one on demand)."""
        with self._lock:
            return self.opset is not None or self._lazy_loader is not None

    @property
    def clock(self) -> clockmod.Clock:
        with self._lock:
            if self.opset is not None:
                return dict(self.opset.clock)
            if self._lazy_clock is not None:
                return dict(self._lazy_clock)
            return {}

    @property
    def history_len(self) -> int:
        with self._lock:
            if self.opset is not None:
                return len(self.opset.history)
            return self._lazy_len

    def init(self, changes: List[Change], actor_id: Optional[str]) -> None:
        """Cold-start materialization (reference DocBackend.init — the
        north-star hot loop's per-doc endpoint)."""
        with self._lock:
            if self.opset is None:
                self.opset = OpSet()
            with bench(f"doc:init"):
                self.opset.apply_changes(changes)
            if actor_id is not None:
                self.actor_id = actor_id
        self._check_ready()

    def init_deferred(
        self,
        loader: Callable[[], List[Change]],
        clock: clockmod.Clock,
        history_len: int,
        actor_id: Optional[str],
        snapshot_fn: Callable[[], Any],
        quiet: bool = True,
    ) -> None:
        """Bulk cold start: the device already materialized this doc, so
        readiness, clock, and the Ready snapshot serve without replaying
        the history through the host OpSet. The OpSet reconstructs
        lazily (via `loader`) the first time an incremental change needs
        it — the dual-path seam of SURVEY.md §7.3 item 4."""
        with self._lock:
            if self.opset is not None:
                return  # raced with a normal init: host state wins
            self._lazy_loader = loader
            self._lazy_clock = dict(clock)
            self._lazy_len = history_len
            self._snapshot_fn = snapshot_fn
            if actor_id is not None:
                self.actor_id = actor_id
        self._check_ready(quiet=quiet)

    def _ensure_opset(self) -> None:
        """Reconstruct the host OpSet from feed history (lazy path) —
        only up to the clock this doc has been SERVING: the loader's
        cursor window may already include newer replicated changes, and
        folding those into the replay would make the caller's incremental
        apply a no-op (empty patch -> the frontend never hears about
        them). The newer changes re-arrive through the caller's window
        and produce a real patch."""
        with self._lock:
            if self.opset is not None:
                return
            if self._live_adopted:
                return  # the live engine owns this doc's state
            self.opset = OpSet()
            loader, self._lazy_loader = self._lazy_loader, None
            base_clock, self._lazy_clock = self._lazy_clock, None
            self._snapshot_fn = None
            self._snapshot_cache = None
            self._replay_cache = None
            if loader is not None:
                with bench("doc:lazyReplay"):
                    changes = loader()
                    if base_clock is not None:
                        changes = [
                            c
                            for c in changes
                            if c.seq <= base_clock.get(c.actor, 0)
                        ]
                    self.opset.apply_changes(changes)

    def demote_from_live(
        self,
        clock: clockmod.Clock,
        history_len: int,
        snapshot_fn: Callable[[], Any],
    ) -> None:
        """The live engine demoted this doc back to the lazy path (the
        byte-bounded LRU, backend/live.py): the engine's clock/length
        become the lazy serving state, and every cached artifact of the
        OLD state (bulk-load snapshot, replay memo) is dropped — the
        doc may have changed since they were computed. `snapshot_fn`
        rebuilds a CURRENT Ready/reopen snapshot from the sidecars on
        demand. The lazy loader stays, so the next live change
        re-adopts."""
        with self._lock:
            self._live_adopted = False
            self._lazy_clock = dict(clock)
            self._lazy_len = history_len
            self._snapshot_cache = None
            self._snapshot_fn = snapshot_fn
            self._replay_cache = None

    def set_actor_id(self, actor_id: str) -> None:
        with self._lock:
            self.actor_id = actor_id
        if self._announced:
            self._notify(
                {"type": "ActorId", "doc": self, "actorId": actor_id}
            )

    def apply_remote_changes(self, changes: List[Change]) -> None:
        # cross-doc re-entry guard: a frontend callback running under
        # ANOTHER doc's emission domain must not drag that domain into
        # this doc's handler (no two domains on one thread — the
        # write-plane invariant); the push replays on the deferred-
        # emission worker instead
        if emission.entered_other(self.id):
            items = list(changes)
            emission.defer(lambda: self.remote_q.push(items))
            return
        self.remote_q.push(list(changes))

    def apply_local_request(self, req: ChangeRequest) -> None:
        if emission.entered_other(self.id):
            emission.defer(lambda: self.local_q.push(req))
            return
        self.local_q.push(req)

    def update_minimum_clock(self, clock: clockmod.Clock) -> None:
        """Gate first render until we've caught up to this clock
        (reference updateMinimumClock/testMinimumClockSatisfied)."""
        with self._lock:
            if self._announced:
                return
            self.minimum_clock = clockmod.union(
                self.minimum_clock or {}, clock
            )
        self._check_ready()

    def _replay_opset(self) -> Optional[OpSet]:
        """An OpSet view for the explicit history / time-travel APIs.
        Live-adopted docs build a TEMPORARY replay from the feeds (the
        live engine owns the incremental state; host OpSet
        reconstruction remains only behind these APIs); other lazy docs
        install their OpSet as before."""
        with self._lock:
            if self.opset is not None:
                return self.opset
            if self._live_adopted:
                loader = self._lazy_loader
                base_clock = dict(self._lazy_clock or {})
                cached = self._replay_cache
                if cached is not None and cached[0] == base_clock:
                    return cached[1]
                sub = OpSet()
                if loader is not None:
                    with bench("doc:historyReplay"):
                        sub.apply_changes(
                            [
                                c
                                for c in loader()
                                if c.seq <= base_clock.get(c.actor, 0)
                            ]
                        )
                self._replay_cache = (base_clock, sub)
                return sub
            if self._lazy_loader is None:
                return None
            self._ensure_opset()
            return self.opset

    def materialize_at(self, n: int):
        with self._lock:
            opset = self._replay_opset()
            if opset is None:
                return None
            return opset.materialize_at(n)

    def history_patch(self, n: int):
        """Snapshot patch of the first n history changes (time travel;
        reconstructs the OpSet if this doc was bulk-loaded)."""
        with self._lock:
            opset = self._replay_opset()
            if opset is None:
                return None
            sub = OpSet()
            sub.apply_changes(opset.history[:n])
            return sub.snapshot_patch()

    def snapshot_patch(self):
        live = self._live
        with self._lock:
            adopted = self._live_adopted
        if adopted and live is not None:
            # the emission domain (doc.emit) ranks above the doc lock
            # in the declared hierarchy (analysis/hierarchy.py): never
            # call in with the doc lock held
            patch = live.snapshot_patch(self)
            if patch is not None:
                return patch
        with self._lock:
            if self.opset is not None:
                return self.opset.snapshot_patch()
            if self._snapshot_cache is not None:
                return self._snapshot_cache
            if self._snapshot_fn is not None:
                # Decode once and drop the closure: a bulk-load snapshot_fn
                # pins its slab's device/host lanes, which must not outlive
                # the first Ready it serves (the clock can't move while the
                # doc is still lazy, so the decoded Patch stays valid).
                fn, self._snapshot_fn = self._snapshot_fn, None
                self._snapshot_cache = fn()
                return self._snapshot_cache
            return None

    # ------------------------------------------------------------------

    def _minimum_satisfied(self) -> bool:
        # REQUIRES doc (analysis/guards.py): _check_ready calls in
        # under the doc lock
        if self.opset is None and self._lazy_clock is None:
            return False
        if self.minimum_clock is None:
            return True
        return clockmod.gte(self.clock, self.minimum_clock)

    def _check_ready(self, quiet: bool = False) -> None:
        with self._lock:
            if self._announced or not self._minimum_satisfied():
                return
            self._announced = True
        log("doc:back", self.id[:6], "ready")
        self._notify(
            {"type": "DocReadyQuiet" if quiet else "DocReady", "doc": self}
        )
        self.ready.push(True)

    def _handle_local(self, req: ChangeRequest) -> None:
        live = self._live
        if live is not None and self.opset is None:
            # lazy doc on the live path: resolve against the engine's
            # decoded state — no host OpSet reconstruction. The notify
            # runs inside THIS doc's emission domain (emit=) so the
            # echo patch (feed append included) reaches the frontend
            # queue before any tick's delta on the post-change state.
            def emit(change, patch):
                self._notify(
                    {
                        "type": "LocalPatch",
                        "doc": self,
                        "change": change,
                        "patch": patch,
                    }
                )

            try:
                res = live.apply_local(self, req, emit=emit)
            except ValueError as e:
                log("doc:back", "rejected local change:", e)
                return
            if res is not None:
                self._check_ready()
                return
        with self.emission:
            with self._lock:
                if self.opset is None:
                    self._ensure_opset()
                with bench("doc:applyLocalChange"):
                    try:
                        change, patch = self.opset.apply_local_request(req)
                    except ValueError as e:
                        log("doc:back", "rejected local change:", e)
                        return
            self._notify(
                {
                    "type": "LocalPatch",
                    "doc": self,
                    "change": change,
                    "patch": patch,
                }
            )
        self._check_ready()

    def _handle_remote(self, changes: List[Change]) -> None:
        live = self._live
        if live is not None and self.opset is None:
            # lazy doc on the live path: changes coalesce into the next
            # tick's batched kernel dispatch (backend/live.py); the
            # engine emits the RemotePatch + readiness itself
            if live.submit_remote(self, changes):
                return
        with self.emission:
            with self._lock:
                if self.opset is None:
                    self._ensure_opset()
                with bench("doc:applyRemoteChanges"):
                    patch = self.opset.apply_changes(changes)
            if self._announced and not patch.is_empty:
                self._notify(
                    {"type": "RemotePatch", "doc": self, "patch": patch}
                )
        self._check_ready()
