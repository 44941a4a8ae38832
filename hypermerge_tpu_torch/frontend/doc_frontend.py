"""DocFrontend — per-doc materialized state and change entry point.

Parity: reference src/DocFrontend.ts:23-192 — mode state machine
(pending -> read -> write), change fns queued until an actor id exists,
patches applied to the materialized state, new states fanned out to every
handle. The «blank -> preview -> final» sequence subscribers observe
matches the reference's change flow (src/DocFrontend.ts:135-150).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ..analysis.lockdep import make_rlock
from ..crdt.frontend_state import FrontendDoc
from ..crdt.patch import Patch
from ..utils.debug import bench, log
from ..utils.ids import to_doc_url
from .handle import Handle


class DocFrontend:
    def __init__(self, repo_frontend, doc_id: str,
                 actor_id: Optional[str] = None) -> None:
        self._repo = repo_frontend
        self.doc_id = doc_id
        self.url = to_doc_url(doc_id)
        self.actor_id = actor_id
        self.mode = "pending" if actor_id is None else "write"
        self.front = FrontendDoc()
        self.seq = 1
        self.history = 0
        self._handles: List[Handle] = []
        self._change_queue: List[tuple] = []
        self._lock = make_rlock("front.doc")
        # lazy-ready (bulk open): the backend has this doc materialized
        # but the Ready (with its snapshot patch) is fetched only when a
        # reader actually wants the value — a 10k-doc open_many must not
        # decode 10k snapshots eagerly
        self._lazy_ready = False
        self._ready_requested = False
        self._interested = False  # a reader poked before BulkReady landed
        # seq of the local change whose backend echo is outstanding.
        # Committed state only advances via echo patches, so change fns
        # must run one-per-echo: in-process the echo returns before
        # change() does (unchanged behavior); cross-process (net/ipc.py)
        # later fns queue here instead of running against stale state.
        self._inflight: Optional[int] = None

    # ------------------------------------------------------------------

    def mark_lazy_ready(self) -> None:
        """BulkReady: the backend can serve Ready on demand; fetch now
        only if a reader already wants it (a poke recorded interest, a
        subscriber attached, or a value() is blocking)."""
        with self._lock:
            self._lazy_ready = True
            want = self._interested or any(
                h.value_fn is not None for h in self._handles
            )
        if want:
            self.request_ready()

    def request_ready(self) -> None:
        with self._lock:
            if self._ready_requested or self.mode != "pending":
                return
            self._ready_requested = True
        from .. import msgs

        self._repo.to_backend.push(msgs.open_msg(self.doc_id))

    def poke(self) -> None:
        """A reader wants the value: resolve a pending lazy-ready doc.
        Interest is recorded even before BulkReady lands (backend
        messages may drain on another thread), so mark_lazy_ready can
        honor it then."""
        with self._lock:
            if self.mode != "pending":
                return
            self._interested = True
            if not self._lazy_ready:
                return
        self.request_ready()

    def handle(self) -> Handle:
        h = Handle(self)
        with self._lock:
            self._handles.append(h)
            if self.mode != "pending":
                h.push(self.front.materialize(), self.history)
        return h

    def release_handle(self, h: Handle) -> None:
        with self._lock:
            if h in self._handles:
                self._handles.remove(h)

    def change(self, fn: Callable[[Any], None], message: str = "") -> None:
        # a lazy-ready doc must materialize before the change fn runs,
        # else the fn would build ops against a blank document
        self.poke()
        with self._lock:
            needs_actor = self.mode == "pending" or self.actor_id is None
            if needs_actor:
                self._change_queue.append((fn, message))
        if needs_actor:
            # OUTSIDE self._lock: pushing to the backend queue can make
            # THIS thread the drainer of whatever is buffered there —
            # including another change's Request, which takes the
            # engine lock — while a tick holding the engine lock is
            # pushing a patch back into this doc's on_patch
            # (front.doc <-> live.engine AB/BA; caught by the first
            # HM_LOCKDEP=1 run over this tree). Queue callbacks for one
            # queue never run concurrently, so the append above is
            # already safely ordered.
            self._repo.needs_actor(self.doc_id)
            return
        self._run_change(fn, message)

    def _run_change(self, fn: Callable, message: str) -> None:
        with self._lock:
            if self._inflight is not None:
                # an echo is outstanding: the committed state this fn
                # would read is stale — run it when the echo lands
                self._change_queue.append((fn, message))
                return
            with bench("front:change"):
                request, preview = self.front.change(
                    fn, self.actor_id, self.seq, message
                )
            if request is None:
                return
            self.seq += 1
            self._inflight = request.seq
        self._fan_out(preview)  # «change preview»
        self._repo.send_request(self.doc_id, request)

    def send_doc_message(self, contents: Any) -> None:
        self._repo.send_doc_message(self.doc_id, contents)

    # ------------------------------------------------------------------
    # backend messages

    def on_ready(
        self,
        actor_id: Optional[str],
        patch_json: Optional[Dict],
        history: int,
    ) -> None:
        with self._lock:
            if self.mode != "pending":
                # Ready only initializes a pending doc (reference
                # DocFrontend.init, src/DocFrontend.ts:121-133). A doc
                # already reading/writing is AHEAD of this snapshot —
                # cross-process, the backend's Ready for a just-created
                # doc arrives after local optimistic changes, and
                # applying its blank snapshot would clobber them (the
                # backend's state reaches us through Patch echoes).
                return
            if patch_json is not None:
                with bench("front:patch"):
                    self.front.apply_patch(Patch.from_json(patch_json))
            if actor_id is not None:
                self.actor_id = actor_id
                self.seq = self.front.clock.get(actor_id, 0) + 1
            self.history = history
            self.mode = "write" if self.actor_id else "read"
            queued = list(self._change_queue)
            self._change_queue.clear()
        self._fan_out(self.front.materialize())
        for fn, message in queued:
            self._run_change(fn, message)

    def on_actor_id(self, actor_id: str) -> None:
        with self._lock:
            if self.mode == "write" and actor_id == self.actor_id:
                # duplicate notification (a NeedsActorId raced the Ready
                # that already enabled writes): resetting seq from the
                # clock here would corrupt the counter while a change's
                # echo is still in flight — the next request would reuse
                # its seq, be rejected by the backend, and strand the
                # in-flight queue forever
                return
            self.actor_id = actor_id
            if self.mode == "pending":
                # Ready (with the snapshot patch) hasn't landed: flipping
                # to write now would run queued change fns against a
                # blank doc. on_ready runs them once state exists —
                # matching the reference, where setActorId only enables
                # writes on an initialized doc (src/DocFrontend.ts:110-119).
                return
            self.seq = self.front.clock.get(actor_id, 0) + 1
            self.mode = "write"
            queued = list(self._change_queue)
            self._change_queue.clear()
        for fn, message in queued:
            self._run_change(fn, message)

    def on_patch(self, patch_json: Dict, history: int) -> None:
        queued = None
        with self._lock:
            if self.mode == "pending":
                # A patch can only precede this doc's Ready in the
                # queue when the backend announced between emitting the
                # patch and pushing the Ready — and that Ready snapshot
                # (computed under the live-engine lock, AFTER every
                # earlier emission) already contains the patch's
                # effects. Applying it to the blank doc would corrupt
                # the baseline and silently poison every later patch.
                return
            patch = Patch.from_json(patch_json)
            with bench("front:patch"):
                self.front.apply_patch(patch)
            self.history = history
            if (
                self._inflight is not None
                and patch.actor == self.actor_id
                and patch.seq == self._inflight
            ):
                self._inflight = None
                if self._change_queue:
                    queued = self._change_queue.pop(0)
            empty = patch.is_empty
        if not empty:
            self._fan_out(self.front.materialize())  # «change final» echo
        if queued is not None:
            self._run_change(*queued)
            # a no-op change fn produces no request and leaves _inflight
            # unset — keep draining, or the remaining queued changes
            # would strand until an unrelated patch happened to arrive
            while True:
                with self._lock:
                    if self._inflight is not None or not self._change_queue:
                        break
                    nxt = self._change_queue.pop(0)
                self._run_change(*nxt)

    def on_message(self, contents: Any) -> None:
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            h.push_message(contents)

    def on_progress(self, progress: Dict) -> None:
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            h.push_progress(progress)

    # ------------------------------------------------------------------

    def _fan_out(self, state: Any) -> None:
        with self._lock:
            handles = list(self._handles)
            history = self.history
        for h in handles:
            h.push(state, history)

    @property
    def clock(self):
        return dict(self.front.clock)
