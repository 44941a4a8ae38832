"""RepoFrontend — registry of open docs; API calls -> backend messages.

Parity: reference src/RepoFrontend.ts:28-272 — create/open/doc/watch/
change/merge/fork/materialize/meta/message/close/destroy/debug, all
communicating with the backend exclusively through JSON messages.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from ..analysis.lockdep import make_rlock
from .. import msgs
from ..crdt import clock as clockmod
from ..crdt.change import ChangeRequest
from ..crdt.frontend_state import FrontendDoc
from ..crdt.patch import Patch
from ..utils import keys as keymod
from ..utils.debug import log
from ..utils.ids import (
    DocUrl,
    to_doc_url,
    validate_doc_url,
    validate_url,
)
from ..utils.queue import Queue
from .doc_frontend import DocFrontend
from .handle import Handle


class RepoFrontend:
    def __init__(self) -> None:
        self.to_backend: Queue = Queue("frontend:toBackend")
        self.docs: Dict[str, DocFrontend] = {}
        self._queries: Dict[int, Callable[[Any], None]] = {}
        self._next_query = 0
        self._lock = make_rlock("front.repo")
        self.files = None  # FileServerClient, attached when files start

    # ------------------------------------------------------------------
    # public api (facade delegates here)

    def create(self, init: Optional[dict] = None) -> DocUrl:
        pair = keymod.create()
        doc_id = pair.public_key
        df = DocFrontend(self, doc_id, actor_id=doc_id)
        with self._lock:
            self.docs[doc_id] = df
        self.to_backend.push(
            msgs.create_msg(pair.public_key, pair.secret_key)
        )
        if init:
            df.change(lambda d: _assign(d, init))
        return to_doc_url(doc_id)

    def open(self, url: str) -> Handle:
        doc_id = validate_doc_url(url)
        with self._lock:
            df = self.docs.get(doc_id)
            if df is None:
                df = DocFrontend(self, doc_id)
                self.docs[doc_id] = df
        self.to_backend.push(msgs.open_msg(doc_id))
        return df.handle()

    def open_many(self, urls) -> list:
        """Bulk open: one OpenBulk message, one batched backend cold
        start (device slabs), lazy Ready per doc — reading a handle (or
        subscribing/changing) fetches that doc's snapshot then. The 10k-
        doc cold start stays one device dispatch chain with zero eager
        per-doc decodes. Contrast the reference's per-doc open loop
        (src/RepoFrontend.ts:155-159 + src/RepoBackend.ts:238-257)."""
        doc_ids = [validate_doc_url(u) for u in urls]
        handles = []
        with self._lock:
            for doc_id in doc_ids:
                df = self.docs.get(doc_id)
                if df is None:
                    df = DocFrontend(self, doc_id)
                    self.docs[doc_id] = df
                handles.append(df.handle())
        self.to_backend.push(msgs.open_bulk_msg(doc_ids))
        return handles

    def change(self, url: str, fn: Callable[[Any], None],
               message: str = "") -> None:
        doc_id = validate_doc_url(url)
        with self._lock:
            df = self.docs.get(doc_id)
        if df is None:
            h = self.open(url)
            h.close()
            df = self.docs[doc_id]
        df.change(fn, message)

    def doc(self, url: str, cb: Optional[Callable] = None) -> Any:
        """One-shot read. With cb: async callback(doc, clock). Without:
        blocking convenience (in-process wiring resolves synchronously)."""
        h = self.open(url)
        if cb is not None:
            def once(state, index):
                cb(state, index)
                h.close()

            h.once(once)
            return None
        try:
            return h.value()
        finally:
            h.close()

    def watch(self, url: str, cb: Callable[[Any, int], None]) -> Handle:
        return self.open(url).subscribe(cb)

    def merge(
        self, url: str, target: str, timeout: Optional[float] = 30.0
    ) -> None:
        doc_id = validate_doc_url(url)
        target_id = validate_doc_url(target)
        # need the target's clock; open it (resolves synchronously
        # in-process, or when its Ready lands cross-process)
        h = self.open(target)
        done = threading.Event()

        def go(_state, _index):
            done.set()
            clock = self.docs[target_id].clock
            self.to_backend.push(
                msgs.merge_msg(doc_id, clockmod.clock_to_strs(clock))
            )
            h.close()

        h.once(go)
        if done.is_set() or timeout is None:
            return

        # Target still pending (unknown doc, gated on replication): don't
        # let the merge dangle silently forever —
        # surface the failure and release the handle.
        def expire():
            if not done.is_set():
                log(
                    "repo:front",
                    f"merge {doc_id[:6]} <- {target_id[:6]} timed out "
                    f"after {timeout}s: target never became ready "
                    "(unknown doc with no replicating peer?)",
                )
                h.close()

        t = threading.Timer(timeout, expire)
        t.daemon = True
        t.start()

    def fork(self, url: str) -> DocUrl:
        new_url = self.create()
        self.merge(new_url, url)
        return new_url

    def materialize(
        self, url: str, history: int, cb: Callable[[Any], None]
    ) -> None:
        """Time travel: doc state after the first `history` changes."""
        doc_id = validate_doc_url(url)

        def on_reply(payload):
            if payload is None:
                cb(None)
                return
            front = FrontendDoc()
            front.apply_patch(Patch.from_json(payload))
            cb(front.materialize())

        self._query(msgs.materialize_query(doc_id, history), on_reply)

    def read(
        self,
        url: str,
        query: Dict[str, Any],
        cb: Optional[Callable[[Any], None]] = None,
        timeout: float = 30.0,
    ) -> Any:
        """One-shot read through the backend's serving tier
        (serve/tier.py READ_KINDS: lookup/index/text/len/clock/
        history). With cb: async callback(value). Without: blocking
        convenience. Returns the read VALUE; None for an unknown /
        not-ready doc or a broken path — identical under HM_SERVE=1
        (batched device kernels over device-resident state) and
        HM_SERVE=0 (per-request host materialization).

        Under overload (serve/overload.py SHED state) the backend may
        answer a typed refusal instead of a value: the blocking path
        raises ``Overload`` (retry_after_s/state/tenant attached); the
        cb path delivers ``{"_overload": {...}}`` — distinguishable
        from every real read value, which is never a dict with that
        key — so an async caller can back off instead of reading the
        refusal as "doc unknown".

        A device fault of the serving tier (a query kernel that does not
        build or launch, a failed install upload) is never a None: the
        blocking path raises ``ServeDeviceError``; the cb path delivers
        ``{"_error": message}``."""
        doc_id = validate_doc_url(url)
        if cb is not None:

            def on_reply(p):
                if isinstance(p, dict) and "overload" in p:
                    cb({"_overload": p["overload"]})
                    return
                if isinstance(p, dict) and "error" in p:
                    cb({"_error": p["error"]})
                    return
                cb(None if p is None else p.get("value"))

            self._query(msgs.read_query(doc_id, query), on_reply)
            return None
        done = threading.Event()
        slot: list = [None]

        def fin(payload):
            slot[0] = payload
            done.set()

        self._query(msgs.read_query(doc_id, query), fin)
        if not done.wait(timeout):
            raise TimeoutError(f"read of {doc_id[:6]} timed out")
        payload = slot[0]
        if isinstance(payload, dict) and "overload" in payload:
            from ..serve.overload import overload_error

            raise overload_error(payload["overload"])
        if isinstance(payload, dict) and "error" in payload:
            from ..serve.kernels import ServeDeviceError

            raise ServeDeviceError(payload["error"])
        return None if payload is None else payload.get("value")

    def meta(self, url: str, cb: Callable[[Any], None]) -> None:
        _scheme, id_ = validate_url(url)
        self._query(msgs.metadata_query(id_), cb)

    def telemetry(self, cb: Callable[[Any], None]) -> None:
        """The backend process' telemetry snapshot (registry counters,
        trace state) — what tools/top.py polls for live rates."""
        self._query(msgs.telemetry_query(), cb)

    def message(self, url: str, contents: Any) -> None:
        doc_id = validate_doc_url(url)
        self.to_backend.push(msgs.doc_message_msg(doc_id, contents))

    def close_doc(self, url: str) -> None:
        doc_id = validate_doc_url(url)
        with self._lock:
            self.docs.pop(doc_id, None)
        self.to_backend.push(msgs.close_msg(doc_id))

    def destroy(self, url: str) -> None:
        doc_id = validate_doc_url(url)
        with self._lock:
            self.docs.pop(doc_id, None)
        self.to_backend.push(msgs.destroy_msg(doc_id))

    def debug(self, url: str) -> Dict[str, Any]:
        doc_id = validate_doc_url(url)
        df = self.docs.get(doc_id)
        info = {
            "id": doc_id,
            "mode": df.mode if df else "closed",
            "clock": df.clock if df else {},
            "seq": df.seq if df else None,
        }
        log("repo:front", info)
        return info

    # ------------------------------------------------------------------
    # doc frontend plumbing

    def needs_actor(self, doc_id: str) -> None:
        self.to_backend.push(msgs.needs_actor_msg(doc_id))

    def send_request(self, doc_id: str, request: ChangeRequest) -> None:
        self.to_backend.push(msgs.request_msg(doc_id, request.to_json()))

    def send_doc_message(self, doc_id: str, contents: Any) -> None:
        self.to_backend.push(msgs.doc_message_msg(doc_id, contents))

    def _query(self, query: Dict, cb: Callable[[Any], None]) -> None:
        with self._lock:
            qid = self._next_query
            self._next_query += 1
            self._queries[qid] = cb
        self.to_backend.push(msgs.query_msg(qid, query))

    # ------------------------------------------------------------------
    # wiring

    def subscribe(self, subscriber: Callable[[Dict[str, Any]], None]) -> None:
        self.to_backend.subscribe(subscriber)

    def receive(self, msg: Dict[str, Any]) -> None:
        t = msg["type"]
        if t in ("Ready", "Patch", "ActorId", "DocMessageFwd", "Download"):
            df = self.docs.get(msg["id"])
            if df is None:
                return
            if t == "Ready":
                df.on_ready(msg["actorId"], msg["patch"], msg["history"])
            elif t == "Patch":
                df.on_patch(msg["patch"], msg["history"])
            elif t == "ActorId":
                df.on_actor_id(msg["actorId"])
            elif t == "DocMessageFwd":
                df.on_message(msg["contents"])
            elif t == "Download":
                df.on_progress(
                    {
                        "actor": msg["actorId"],
                        "index": msg["index"],
                        "size": msg["size"],
                        "time": msg["time"],
                    }
                )
        elif t == "Reply":
            with self._lock:
                cb = self._queries.pop(msg["queryId"], None)
            if cb is not None:
                cb(msg["payload"])
        elif t == "FileServerReady":
            from ..files.file_client import FileServerClient

            self.files = FileServerClient(msg["path"])
        elif t == "BulkReady":
            # bulk cold start: docs are ready backend-side; open
            # frontends fetch their Ready (with snapshot patch) lazily,
            # on first read — never 10k eager decodes
            for doc_id in msg["ids"]:
                df = self.docs.get(doc_id)
                if df is not None:
                    df.mark_lazy_ready()
        else:
            log("repo:front", "unknown msg", t)


def _assign(d, init: dict) -> None:
    for k, v in init.items():
        d[k] = v
