"""ServeTier — reads served from device-resident state (the port of
hypermerge_tpu/serve/tier.py).

The read path of the Repo facade, rebuilt for "millions of users,
mostly readers": instead of materializing a doc host-side per request
(summary fetch + parse — the stubborn cold-open constant), the tier
keeps each warm doc's summary columns resident in device memory
(serve/resident.py) and answers reads with batched query kernels
(serve/kernels.py) over the whole concurrent read batch
(serve/batcher.py). Host work per read is a handful of scalar decodes.

Read queries (all JSON-safe; `path` is map keys (str) / sequence
indices (int) from the root):

    {"kind": "lookup", "path": [..., key]}   -> leaf value / type marker
    {"kind": "index",  "path": [...], "index": i} -> element value
    {"kind": "text",   "path": [...]}        -> joined text string
    {"kind": "len",    "path": [...]}        -> entry / element count
    {"kind": "clock"}                        -> {actor: seq}
    {"kind": "history"}                      -> history length

`host_read` is the bit-identical twin (HM_SERVE=0 and the graceful-
degradation path): per-request host materialization through
snapshot_patch -> FrontendDoc -> traversal — exactly the cost the tier
amortizes away, kept observable so the fuzz tests can pin both paths
to the same answers. Clock/history queries sit on host metadata in
both modes (the device-resident clock matrix is the ClockStore's
mirror, ops/clock_mirror.py; no second copy here).

Degradation ladder: unresident or unrebuildable doc -> host path
(serve.fallbacks); device OOM during install -> evict LRU + retry once
(serve.evictions_pressure) -> host path; admission queue full -> host
path. A repeated host-path read of a clock-unmoved doc hits the tier's
host memo — zero wire parse on the warm fallback too. A device fault
is not degraded: a query kernel that does not build or launch, or an
install upload that fails for another reason than memory pressure,
answers every read of its batch with a ServeDeviceError payload
({"error": ...}), which the blocking `Repo.read` raises.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from .. import telemetry
from ..crdt import clock as clockmod
from ..crdt.frontend_state import FrontendDoc
from ..models import Counter, Table, Text
from ..ops.columnar import decode_value
from ..utils.debug import log
from .batcher import ReadBatcher, ReadRequest
from .kernels import ServeDeviceError
from .resident import ResidencyCache, build_entry, looks_like_oom

READ_KINDS = ("lookup", "index", "text", "len", "clock", "history")

_MAX_PATH_ROUNDS = 64  # path depth bound (per-level batched dispatches)


def _leaf(v: Any) -> Any:
    """JSON-safe leaf of a materialized value: containers collapse to
    type markers (reads address into them by path instead)."""
    if isinstance(v, Counter):
        return int(v)
    if isinstance(v, Text):
        return {"_type": "text"}
    if isinstance(v, Table):
        return {"_type": "table"}
    if isinstance(v, dict):
        return {"_type": "map"}
    if isinstance(v, list):
        return {"_type": "list"}
    return v


def _walk(tree: Any, steps: List) -> Any:
    """Follow `steps` through a materialized tree; None when the path
    breaks (missing key, index out of bounds, scalar mid-path)."""
    cur = tree
    for s in steps:
        if isinstance(s, str):
            if isinstance(cur, Table):
                cur = cur.by_id(s)
            elif isinstance(cur, dict):
                cur = cur.get(s)
            else:
                return None
        elif isinstance(s, int):
            if isinstance(cur, (list, Text)) and 0 <= s < len(cur):
                cur = cur[s]
            else:
                return None
        else:
            return None
    return cur


def host_value(doc, query: Dict) -> Any:
    """Evaluate one read against a materialized tree — the per-request
    host path (`tree` reuse is the tier's host-memo seam)."""
    return _eval_tree(_host_tree(doc), query)


def _host_tree(doc) -> Any:
    patch = doc.snapshot_patch()
    if patch is None:
        return None
    front = FrontendDoc()
    front.apply_patch(patch)
    return front.materialize()


def _eval_tree(tree: Any, query: Dict) -> Any:
    if tree is None:
        return None
    kind = query.get("kind")
    path = list(query.get("path") or [])
    if kind == "lookup":
        if not path or not isinstance(path[-1], str):
            return None
        container = _walk(tree, path[:-1])
        if isinstance(container, Table):
            return _leaf(container.by_id(path[-1]))
        if not isinstance(container, dict):
            return None
        if path[-1] not in container:
            return None
        return _leaf(container[path[-1]])
    target = _walk(tree, path)
    if kind == "text":
        return str(target) if isinstance(target, Text) else None
    if kind == "index":
        i = query.get("index")
        if not isinstance(i, int) or not isinstance(
            target, (list, Text)
        ) or not 0 <= i < len(target):
            return None
        return _leaf(target[i])
    if kind == "len":
        if isinstance(target, (dict, list, Text, Table)):
            return len(target)
        return None
    return None


def host_read(doc, query: Dict) -> Optional[Dict[str, Any]]:
    """The HM_SERVE=0 twin: one read, fully host-side, per request.
    Returns the same {"value": ...} payload the tier produces (None
    payload = doc unknown/not ready, same as the tier)."""
    kind = query.get("kind")
    if kind not in READ_KINDS:
        return None
    if kind == "clock":
        return {"value": clockmod.clock_to_strs(doc.clock)}
    if kind == "history":
        return {"value": doc.history_len}
    if not doc._announced:
        return None
    return {"value": host_value(doc, query)}


class ServeTier:
    """One per RepoBackend (HM_SERVE=1, the default)."""

    def __init__(self, backend) -> None:
        self._back = backend
        self._cache = ResidencyCache()
        self._batcher = ReadBatcher(self._flush)
        # host fallback memo: doc_id -> (clock, materialized tree,
        # byte estimate). Shares the serving invalidation check with
        # the residency cache (clock equality) under the same lock
        # class; budgeted like the device half.
        self._host_memo: "OrderedDict[str, tuple]" = OrderedDict()
        self._host_memo_bytes = 0
        self._closed = False
        reg = telemetry.REGISTRY
        inst = str(telemetry.next_instance())
        self._m: Dict[str, Any] = {
            k: reg.counter("serve." + k, inst=inst)
            for k in (
                "reads", "hits", "installs", "invalidations",
                "fallbacks", "evictions", "evictions_pressure",
                "batches", "memo_hits", "host_memo_hits", "dispatches",
                "overload_shed",
            )
        }
        for k in ("resident_docs", "resident_bytes", "queue_depth"):
            self._m[k] = reg.gauge("serve." + k, inst=inst)
        self._hist = reg.histogram("serve.read_s", inst=inst)

    # ------------------------------------------------------------------
    # public surface (RepoBackend routes reads here)

    def read_async(
        self, doc, query: Dict, cb: Callable[[Any], None]
    ) -> None:
        """Answer one read; `cb(payload)` fires on the batcher thread
        (or inline for metadata reads and degraded paths)."""
        self._m["reads"].add(1)
        kind = query.get("kind")
        req = ReadRequest(doc.id, dict(query), cb)
        req.t0 = time.perf_counter()
        req.span = telemetry.begin("serve.read", "serve", kind=kind)
        if kind == "clock":
            self._finish(req, clockmod.clock_to_strs(doc.clock))
            return
        if kind == "history":
            self._finish(req, doc.history_len)
            return
        if kind not in READ_KINDS:
            self._finish_raw(req, None)
            return
        if self._closed:
            self._m["fallbacks"].add(1)
            self._fallback(req, doc)
            return
        if not self._batcher.submit(req):
            # admission overflow is traffic pressure, not a device
            # degradation: its own signal (serve.overload_shed, never
            # serve.fallbacks); the read answers from the host path (the
            # reference's service plane, which may refuse it, is not
            # ported)
            self._m["overload_shed"].add(1)
            self._fallback(req, doc)
            return
        self._m["queue_depth"].set(self._batcher.depth)

    def read(self, doc, query: Dict, timeout: float = 30.0) -> Any:
        """Blocking convenience over read_async (bench, tools)."""
        done = threading.Event()
        slot: List[Any] = [None]

        def fin(payload):
            slot[0] = payload
            done.set()

        self.read_async(doc, query, fin)
        if not done.wait(timeout):
            raise TimeoutError("serve tier read timed out")
        return slot[0]

    def note_clock_moved(self, doc_id: str) -> None:
        """Write-path invalidation hook (patch emissions, live ticks):
        the doc's serving clock moved, so its resident entry and host
        memo row can never serve again. Reads would catch this at
        their own clock check anyway — the hook makes the invalidation
        eager and the counter exact. Called under the engine lock:
        bookkeeping only."""
        if self._cache.mark_stale(doc_id):
            self._m["invalidations"].add(1)
        with self._cache._lock:
            row = self._host_memo.pop(doc_id, None)
            if row is not None:
                self._host_memo_bytes -= row[2]

    def drop(self, doc_id: str) -> None:
        """close_doc/destroy: forget every cached read artifact."""
        self._cache.drop(doc_id)
        with self._cache._lock:
            row = self._host_memo.pop(doc_id, None)
            if row is not None:
                self._host_memo_bytes -= row[2]

    def residency_report(self) -> Dict[str, Any]:
        return self._cache.report()

    def flush_now(self, timeout: float = 5.0) -> bool:
        return self._batcher.flush_now(timeout)

    def close(self) -> None:
        self._closed = True
        self._batcher.close()
        self._cache.clear()
        telemetry.REGISTRY.retire(
            *self._m.values(), self._hist
        )

    # ------------------------------------------------------------------
    # the batch flush

    def _flush(self, reqs: List[ReadRequest]) -> None:
        """Resolve one admitted batch. Must never raise (a raised
        flush would re-queue the batch in the debouncer and double-
        fire callbacks): a device fault reaches every unanswered read
        as an error payload; any other failure lane degrades
        per-request."""
        try:
            with telemetry.span("serve.batch", "serve", reads=len(reqs)):
                self._m["batches"].add(1)
                self._flush_inner(reqs)
        except ServeDeviceError as e:
            log("serve", f"batch failed on the device: {e}")
            for r in reqs:
                if not r.done:
                    self._finish_raw(r, {"error": str(e)})
        except Exception as e:  # pragma: no cover - defensive: host bugs
            log("serve", f"batch flush failed: {e!r}")
            for r in reqs:
                if not r.done:
                    self._finish_raw(r, None)
        finally:
            self._m["queue_depth"].set(self._batcher.depth)

    def _flush_inner(self, reqs: List[ReadRequest]) -> None:
        by_doc: Dict[str, List[ReadRequest]] = {}
        for r in reqs:
            by_doc.setdefault(r.doc_id, []).append(r)
        ready: List[ReadRequest] = []
        cold: List = []  # (doc, clock, reqs) needing an install
        for doc_id, rs in by_doc.items():
            doc = self._back.docs.get(doc_id)
            if doc is None or not doc._announced:
                for r in rs:
                    self._finish_raw(r, None)
                continue
            clock = doc.clock
            entry = self._cache.get_fresh(doc_id, clock)
            if entry is None:
                cold.append((doc, clock, rs))
                continue
            self._m["hits"].add(len(rs))
            self._attach(entry, rs, ready)
        # warm requests dispatch BEFORE any cold doc's install runs:
        # a hot read's latency must not absorb a cold neighbor's
        # pack+kernel (the install cost belongs to the cold reader)
        if ready:
            self._resolve(ready)
        ready = []
        for doc, clock, rs in cold:
            entry = self._install(doc, clock)
            if entry is None:
                self._m["fallbacks"].add(len(rs))
                for r in rs:
                    self._fallback(r, doc)
                continue
            self._attach(entry, rs, ready)
        if ready:
            self._resolve(ready)

    @staticmethod
    def _attach(entry, rs, ready) -> None:
        for r in rs:
            r.entry = entry
            r.obj_row = -1
            r.steps = list(r.query.get("path") or [])
            ready.append(r)

    def _install(self, doc, clock):
        """Build + install a resident entry at `clock` (outside every
        lock), with the OOM ladder: evict LRU + retry once, then None
        (host path). A build that loses a clock race still serves this
        batch but is not cached."""
        entry = memo_hit = None
        for attempt in (0, 1):
            try:
                entry, memo_hit = build_entry(self._back, doc.id, clock)
                break
            except ServeDeviceError:
                raise  # a device fault: the flush answers it
            except Exception as e:
                if (
                    attempt == 1
                    or not looks_like_oom(e)
                    or self._cache.resident_docs == 0
                ):
                    # a deterministic build failure (corrupt sidecar,
                    # pack bug) must NOT thrash healthy residents out
                    # of the cache on every read of the one broken
                    # doc — only genuine memory pressure earns a shed
                    log("serve", f"install {doc.id[:6]} failed: {e!r}")
                    return None
                # device memory pressure: shed LRU residents and give
                # the install one more chance before degrading
                shed = self._cache.evict_lru(serve_max_bytes_retry())
                self._m["evictions_pressure"].add(len(shed))
                log(
                    "serve",
                    f"install {doc.id[:6]} hit device pressure; "
                    f"evicted {len(shed)} LRU entries, retrying",
                )
        if entry is None:
            return None  # sidecars cannot rebuild: dirty/unbacked
        self._m["installs"].add(1)
        if memo_hit:
            self._m["memo_hits"].add(1)
        if doc.clock == clock:  # install-and-recheck
            evicted = self._cache.install(entry)
            if evicted:
                self._m["evictions"].add(len(evicted))
        self._m["resident_docs"].set(self._cache.resident_docs)
        self._m["resident_bytes"].set(self._cache.resident_bytes)
        return entry

    # ------------------------------------------------------------------
    # batched path resolution + query dispatch

    def _resolve(self, reqs: List[ReadRequest]) -> None:
        from . import kernels

        live = [r for r in reqs if not r.done]
        for _round in range(_MAX_PATH_ROUNDS):
            if not live:
                return
            lookups: List[ReadRequest] = []
            orders: List[ReadRequest] = []
            fin_text: List[ReadRequest] = []
            fin_len: List[ReadRequest] = []
            fin_index: List[ReadRequest] = []
            for r in live:
                if r.steps:
                    s = r.steps[0]
                    if isinstance(s, str):
                        # a key the doc never saw resolves host-side
                        if s not in r.entry.key_index:
                            self._finish(r, None)
                        else:
                            lookups.append(r)
                    elif isinstance(s, int):
                        otype = r.entry.obj_type(r.obj_row)
                        if otype in ("list", "text"):
                            orders.append(r)
                        else:
                            self._finish(r, None)
                    else:
                        self._finish(r, None)
                    continue
                kind = r.query.get("kind")
                if kind == "text":
                    if r.entry.obj_type(r.obj_row) == "text":
                        fin_text.append(r)
                    else:
                        self._finish(r, None)
                elif kind == "index":
                    i = r.query.get("index")
                    if isinstance(i, int) and r.entry.obj_type(
                        r.obj_row
                    ) in ("list", "text"):
                        fin_index.append(r)
                    else:
                        self._finish(r, None)
                elif kind == "len":
                    fin_len.append(r)
                else:  # lookup with an exhausted path
                    self._finish(r, None)
            self._dispatch_lookups(kernels, lookups)
            self._dispatch_orders(
                kernels, orders + fin_index + fin_text
            )
            self._dispatch_counts(kernels, fin_len)
            # every round either finishes a request or consumes one of
            # its path steps, so this converges in <= depth rounds
            live = [r for r in reqs if not r.done]
        # pathological path depth: stop dispatching rounds, but keep
        # the twin contract — the host path answers what the kernel
        # walk did not finish (degrade, never a wrong None)
        for r in live:
            doc = self._back.docs.get(r.doc_id)
            if doc is None:
                self._finish_raw(r, None)
            else:
                self._m["fallbacks"].add(1)
                self._fallback(r, doc)

    def _by_bucket(self, rs: List[ReadRequest]) -> Dict[int, List]:
        groups: Dict[int, List[ReadRequest]] = {}
        for r in rs:
            groups.setdefault(r.entry.bucket, []).append(r)
        return groups

    def _dispatch_lookups(self, kernels, rs: List[ReadRequest]) -> None:
        """One map_lookup dispatch per shape bucket: resolve the next
        (string) path step of every request in the group."""
        for _bucket, group in self._by_bucket(rs).items():
            keys = [r.steps[0] for r in group]
            rows, found = _dispatch(
                kernels.map_lookup,
                [r.entry for r in group],
                [r.obj_row for r in group],
                [r.entry.key_index[k] for r, k in zip(group, keys)],
            )
            self._m["dispatches"].add(1)
            for i, r in enumerate(group):
                r.steps.pop(0)
                if not found[i]:
                    self._finish(r, None)
                    continue
                w = int(rows[i])
                if not r.steps and r.query.get("kind") == "lookup":
                    self._finish(r, self._row_leaf(r.entry, w))
                elif r.entry.obj_type(w) is not None:
                    r.obj_row = w  # descend into the linked object
                else:
                    self._finish(r, None)  # scalar mid-path

    def _dispatch_orders(self, kernels, rs: List[ReadRequest]) -> None:
        """One seq_order dispatch per bucket serves int path steps,
        final index lookups, and text joins together."""
        for _bucket, group in self._by_bucket(rs).items():
            order, count = _dispatch(
                kernels.seq_order,
                [r.entry for r in group], [r.obj_row for r in group],
            )
            self._m["dispatches"].add(1)
            for i, r in enumerate(group):
                e = r.entry
                n = int(count[i])
                if not r.steps and r.query.get("kind") == "text":
                    chars = [
                        str(self._row_value(e, int(e.elem_val[row])))
                        for row in order[i][:n]
                    ]
                    self._finish(r, "".join(chars))
                    continue
                if r.steps:  # int path step: descend through it
                    idx, descend = r.steps.pop(0), True
                else:  # final "index" query on the resolved sequence
                    idx, descend = r.query.get("index"), False
                if not isinstance(idx, int) or not 0 <= idx < n:
                    self._finish(r, None)
                    continue
                w = int(e.elem_val[int(order[i][idx])])
                if not descend:
                    self._finish(r, self._row_leaf(e, w))
                elif e.obj_type(w) is not None:
                    r.obj_row = w
                else:
                    self._finish(r, None)  # scalar mid-path

    def _dispatch_counts(self, kernels, rs: List[ReadRequest]) -> None:
        for _bucket, group in self._by_bucket(rs).items():
            n_elems, n_map = _dispatch(
                kernels.counts,
                [r.entry for r in group], [r.obj_row for r in group],
            )
            self._m["dispatches"].add(1)
            for i, r in enumerate(group):
                otype = r.entry.obj_type(r.obj_row)
                if otype in ("list", "text"):
                    self._finish(r, int(n_elems[i]))
                else:
                    self._finish(r, int(n_map[i]))

    # ------------------------------------------------------------------
    # host-side row decode (the host half of a device-served read)

    def _row_value(self, e, row: int) -> Any:
        v = decode_value(
            int(e.vkind[row]), int(e.value[row]), int(e.dt[row]),
            e.tables,
        )
        if int(e.dt[row]) == 1:  # counter: fold accumulated INCs
            v = (v or 0) + int(e.inc_total[row])
        return v

    def _row_leaf(self, e, row: int) -> Any:
        otype = e.obj_type(row)
        if otype is not None:
            return {"_type": otype}
        return self._row_value(e, row)

    # ------------------------------------------------------------------
    # degraded path + completion

    def _fallback(self, req: ReadRequest, doc) -> None:
        """Host-path read with the warm-doc memo: a clock-unmoved doc
        re-reads from its cached materialized tree — zero wire parse
        even when degraded."""
        if not doc._announced:
            self._finish_raw(req, None)
            return
        clock = doc.clock
        with self._cache._lock:
            row = self._host_memo.get(doc.id)
            tree = (
                row[1] if row is not None and row[0] == clock else None
            )
            if tree is not None:
                self._host_memo.move_to_end(doc.id)
        if tree is not None:
            self._m["host_memo_hits"].add(1)
        else:
            tree = _host_tree(doc)
            if tree is not None and doc.clock == clock:
                self._memoize_host(doc.id, clock, tree)
        self._finish(req, _eval_tree(tree, req.query))

    def _memoize_host(self, doc_id: str, clock, tree) -> None:
        from .resident import serve_max_bytes

        # byte estimate: clock rows + a flat per-change constant; the
        # cap is a budget, not an audit
        est = 256 + 96 * sum(clock.values())
        cap = serve_max_bytes()
        with self._cache._lock:
            old = self._host_memo.pop(doc_id, None)
            if old is not None:
                self._host_memo_bytes -= old[2]
            self._host_memo[doc_id] = (dict(clock), tree, est)
            self._host_memo_bytes += est
            while self._host_memo and self._host_memo_bytes > cap:
                _d, row = self._host_memo.popitem(last=False)
                self._host_memo_bytes -= row[2]

    def _finish(self, req: ReadRequest, value: Any) -> None:
        self._finish_raw(req, {"value": value})

    def _finish_raw(self, req: ReadRequest, payload: Any) -> None:
        if req.done:
            return
        req.done = True
        self._hist.observe(time.perf_counter() - req.t0)
        if req.span is not None:
            req.span.end()
        try:
            req.cb(payload)
        except Exception as e:  # a reader's cb must not kill the batch
            log("serve", f"read callback failed: {e!r}")


def serve_max_bytes_retry() -> int:
    """Bytes the OOM retry tries to free: half the budget — enough to
    matter, without flushing the whole cache for one hot doc."""
    from .resident import serve_max_bytes

    return max(1, serve_max_bytes() // 2)


def _dispatch(fn, *args):
    """One serve kernel dispatch. Whatever fails in it is the device's
    (a kernel that does not build or launch, a device fault): it leaves
    as a ServeDeviceError, which the flush hands to the batch's
    readers."""
    try:
        return fn(*args)
    except ServeDeviceError:
        raise
    except Exception as e:
        raise ServeDeviceError(
            f"{fn.__name__} dispatch failed: {e!r}"
        ) from e
