"""Streaming slab pipeline — overlap IO -> pack -> dispatch -> fetch (the
port's copy of hypermerge_tpu/backend/pipeline.py).

The serial bulk loader (HM_PIPELINE=0) pays a cold open as the SUM of
its per-slab stage costs: sidecar IO and specs, the pack, the dispatch
and the summary fetch each finish before the next begins. The stages are
independent per slab: slab N+1's sidecar reads and pack need nothing
from slab N beyond host buffers, and slab N's device work needs nothing
from the host. Four stages joined by small BOUNDED queues make the cold
open cost ~max(stage) instead of sum(stages), with at most
`HM_PIPELINE_DEPTH` (default 2) slabs of host staging alive per seam.

    io/spec thread:   slab read-ahead (storage/slab.py mmap slices +
                      colcache decode; file reads drop the GIL) and
                      per-doc feed specs, emitted as slab-sized entry
                      groups — the serial loader's chunks exactly, so
                      summaries are bit-identical.
    pack pool:        pack_docs_columns on HM_PACK_WORKERS threads. On
                      the device route (the port's default) a worker
                      marshals with one GIL-free native call and launches
                      pack_prefix.cu; on the host route (HM_DEVICE_PACK=0)
                      it runs the native hm_pack_prefix. Both native calls
                      go through ctypes.CDLL and release the GIL
                      (native/__init__.py pack_parallel_ok), so N workers
                      pack N slabs at once. The emit into the dispatch
                      queue is SEQUENCED (a turn counter under the
                      pipeline.pack_pool condition): slab order and bytes
                      match the single-worker and serial twins whichever
                      worker finishes first. Per-worker busy seconds are
                      kept apart (pack_busy[w]); their sum can exceed the
                      load's wall once packs overlap.
    caller thread:    the slab's one launch (run_batch_full, or round-robin
                      across visible ranks via parallel/sharded.py
                      SlabRoundRobin), the start of its summary wire's
                      copy into pinned memory, and deferred doc init;
                      never blocks on results.
    fetch workers:    the wait on that copy's event and the host parse of
                      slab N, overlapped with slab N+1's pack; with >1
                      rank one worker per rank (bounded, HM_FETCH_WORKERS).
                      The materialization barrier (fetch_bulk_summaries)
                      joins them and finds host arrays.

Failure contract: any stage raising aborts the whole pipeline — every
queue drains, every worker joins (bounded), device refs drop, and the
caller sees one PipelineError carrying the original exception. A fetch
failure after the load returned surfaces at the barrier via
FetchContext.join. The serial path stays behind HM_PIPELINE=0 as the
correctness twin.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

from ..analysis.lockdep import make_condition, make_lock
from .. import telemetry

# process-wide pipeline series (telemetry registry): cumulative stage
# busy seconds + slab counts across every bulk load, and live queue
# depth gauges — the "what is the cold open doing RIGHT NOW" view.
# last_bulk_stats stays the per-load truth; these are the
# process-lifetime aggregate.
_M_SLABS = telemetry.counter("pipeline.slabs")
_M_BUSY = {
    stage: telemetry.counter(f"pipeline.{stage}_busy_s")
    for stage in ("io", "pack", "dispatch", "fetch")
}


class PipelineError(RuntimeError):
    """A pipeline stage failed; the original exception is __cause__."""


class _Abort(Exception):
    """Internal: another stage failed; unwind quietly."""


_DONE = object()
_POLL_S = 0.05
_JOIN_S = 120.0


def pipeline_enabled() -> bool:
    """Pipeline gate, the reference's. Explicit HM_PIPELINE=0/1 always
    wins; the unset default enables the pipeline only when the native
    GIL-dropping pack is loadable (HM_NATIVE_PACK not 0). Without it the
    pack's host work holds the GIL for long stretches and starves the
    dispatch feeder, so that configuration stays on the serial twin
    unless forced."""
    v = os.environ.get("HM_PIPELINE")
    if v is not None:
        return v != "0"
    if os.environ.get("HM_NATIVE_PACK", "1") == "0":
        return False
    from .. import native

    return native.pack_drops_gil()


def queue_depth() -> int:
    return max(1, int(os.environ.get("HM_PIPELINE_DEPTH", "2")))


def pack_worker_count() -> int:
    """Size of the pack pool. HM_PACK_WORKERS=N pins N workers; 0 (the
    default) resolves automatically: min(4, cores) when the native pack
    entry points both drop the GIL and are safe to call concurrently
    (native.pack_parallel_ok — stateless C loops into caller-owned
    buffers), else 1 — without them the pack's host work holds the GIL
    for long stretches, so extra pack threads would only contend."""
    v = int(os.environ.get("HM_PACK_WORKERS", "0") or 0)
    if v > 0:
        return v
    from .. import native

    if not native.pack_parallel_ok():
        return 1
    return max(1, min(4, os.cpu_count() or 1))


class FetchContext:
    """Handle on the async fetch stage (one or more workers — with >1
    device the fetch overlaps ACROSS ranks: each worker can be pulling
    a different rank's wire concurrently). The barrier
    (RepoBackend.fetch_bulk_summaries) joins it before decoding; a
    fetch error recorded during the overlap window re-raises there."""

    def __init__(self) -> None:
        self.threads: List[threading.Thread] = []
        self.error: Optional[BaseException] = None

    def join(self, timeout: float = _JOIN_S) -> None:
        for t in self.threads:
            t.join(timeout)
            if t.is_alive():  # pragma: no cover - defensive
                raise PipelineError("pipeline fetch stage did not drain")
        if self.error is not None:
            raise PipelineError(
                "bulk summary fetch failed"
            ) from self.error


class SlabPipeline:
    """One bulk load's stage executor. All callables are supplied by
    RepoBackend (which owns locks, stats, and device handles):

      prefetch(doc_chunk)      read-ahead actors + sidecar columns
      classify(doc)            -> ("entry", e) | ("memo", (e, m))
                                  | ("fallback", doc)
      pack(entries, seq)       -> ColumnarBatch (seq = slab index in
                                  doc order — the device pack uses it
                                  for per-rank placement)
      dispatch(entries, batch) -> pending summary entry (runs on the
                                  CALLER thread — device dispatch and
                                  doc init stay single-threaded)
      fetch(entry)             transfer + parse one slab's summary
                                  (mutates the entry in place)
    """

    def __init__(
        self,
        docs: List[Any],
        *,
        prefetch: Callable[[List[Any]], None],
        classify: Callable[[Any], Tuple[str, Any]],
        pack: Callable[[List[Any], int], Any],
        dispatch: Callable[[List[Any], Any], Any],
        fetch: Callable[[Any], None],
        slab: int,
        fetch_workers: int = 1,
        pack_workers: int = 1,
    ) -> None:
        self.docs = docs
        self.prefetch = prefetch
        self.classify = classify
        self.pack = pack
        self.dispatch = dispatch
        self.fetch = fetch
        self.slab = max(1, int(slab))
        self.fetch_workers = max(1, int(fetch_workers))
        self.pack_workers = max(1, int(pack_workers))
        depth = queue_depth()
        self.pack_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.disp_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.fetch_q: "queue.Queue" = queue.Queue(maxsize=2 * depth)
        # live queue-depth gauges (one table per seam, process-wide:
        # concurrent loads share the gauges — last writer wins, which
        # is the right answer for a "now" view)
        self._q_gauges = {
            id(self.pack_q): telemetry.gauge("pipeline.q_pack"),
            id(self.disp_q): telemetry.gauge("pipeline.q_dispatch"),
            id(self.fetch_q): telemetry.gauge("pipeline.q_fetch"),
        }
        self.abort = threading.Event()
        self.error: Optional[BaseException] = None
        self.error_stage: Optional[str] = None
        self._err_lock = make_lock("pipeline.err")
        self.memo_hits: List[Any] = []
        self.fallbacks: List[Any] = []
        # -- pack pool sequencing + per-worker busy accounting ---------
        # slabs are packed CONCURRENTLY but emitted into disp_q in slab
        # order: a worker holding packed slab `seq` waits its turn on
        # the pack_pool condition, so downstream (dispatch, fetch, doc
        # init) sees the exact slab stream the serial twin produces.
        self._pack_cv = make_condition("pipeline.pack_pool")
        self._pack_turn = 0         # next slab seq allowed to emit
        self._pack_eof_claimed = False  # one worker forwards _DONE
        self.total_slabs: Optional[int] = None  # set by io before EOF
        # per-worker slots, single-writer by construction (worker w is
        # the only writer of index w) — read after the workers join
        self.pack_busy = [0.0] * self.pack_workers
        self.pack_t0 = [None] * self.pack_workers  # first pack start
        self.pack_t1 = [None] * self.pack_workers  # last pack end

    # -- queue plumbing (abort-aware: a failed stage must never leave a
    # sibling blocked forever on a full/empty bounded queue) ----------

    def _put(self, q: "queue.Queue", item: Any) -> None:
        while True:
            if self.abort.is_set():
                raise _Abort()
            try:
                q.put(item, timeout=_POLL_S)
                self._q_gauges[id(q)].set(q.qsize())
                return
            except queue.Full:
                continue

    def _get(self, q: "queue.Queue") -> Any:
        while True:
            if self.abort.is_set():
                raise _Abort()
            try:
                item = q.get(timeout=_POLL_S)
                self._q_gauges[id(q)].set(q.qsize())
                return item
            except queue.Empty:
                continue

    def _fail(self, stage: str, exc: BaseException) -> None:
        with self._err_lock:
            if self.error is None:
                self.error = exc
                self.error_stage = stage
        self.abort.set()

    # -- stages ---------------------------------------------------------

    def _io_loop(self) -> None:
        """Read-ahead + spec: emits slab-sized entry groups in doc
        order — exactly the chunks the serial loader would form, so
        pipeline and serial materialize bit-identical slabs."""
        try:
            buf: List[Any] = []
            seq = 0
            for base in range(0, len(self.docs), self.slab):
                if self.abort.is_set():
                    raise _Abort()
                chunk = self.docs[base : base + self.slab]
                t0 = time.perf_counter()
                with telemetry.span("pipeline.io", "pipeline"):
                    self.prefetch(chunk)
                    for doc in chunk:
                        kind, payload = self.classify(doc)
                        if kind == "entry":
                            buf.append(payload)
                        elif kind == "memo":
                            self.memo_hits.append(payload)
                        else:
                            self.fallbacks.append(payload)
                _M_BUSY["io"].add(time.perf_counter() - t0)
                # the put blocks on a full queue: that's backpressure
                # WAIT, not io busy — keep it outside the busy window
                while len(buf) >= self.slab:
                    self._put(self.pack_q, (seq, buf[: self.slab]))
                    seq += 1
                    buf = buf[self.slab :]
            if buf:
                self._put(self.pack_q, (seq, buf))
                seq += 1
            # publish the slab count BEFORE the EOF token: the worker
            # that claims EOF forwarding reads it after taking the
            # token off the queue (queue put/get is the happens-before)
            self.total_slabs = seq
            self._put(self.pack_q, _DONE)
        except _Abort:
            pass
        except BaseException as e:
            self._fail("io", e)

    def _await_pack_turn(self, seq: int) -> None:
        """Block until slab `seq` may emit into disp_q (ordered merge
        of the pack pool's out-of-order completions). Abort-aware."""
        with self._pack_cv:
            while self._pack_turn != seq:
                if self.abort.is_set():
                    raise _Abort()
                self._pack_cv.wait(_POLL_S)

    def _bump_pack_turn(self) -> None:
        with self._pack_cv:
            self._pack_turn += 1
            self._pack_cv.notify_all()

    def pack_wall(self) -> float:
        """Pack LANE span: first pack start -> last pack end across the
        pool. This is the wall-clock footprint of the pack stage; with
        N workers the busy SUM (sum(pack_busy)) exceeds it once packs
        genuinely overlap, and busy/wall is the measured parallel
        speedup. Read after the workers joined."""
        t0s = [t for t in self.pack_t0 if t is not None]
        t1s = [t for t in self.pack_t1 if t is not None]
        if not t0s or not t1s:
            return 0.0
        return max(0.0, max(t1s) - min(t0s))

    def _pack_loop(self, widx: int) -> None:
        """One pack-pool worker. Workers race through pack_q (slab
        compute overlaps across cores — hm_pack_prefix drops the GIL)
        but emit strictly in slab order via the turn counter, so the
        dispatch stream is byte-identical to a single pack thread. The
        EOF token recirculates to drain siblings; exactly one worker
        claims it and forwards _DONE only after every real slab
        emitted."""
        try:
            while True:
                item = self._get(self.pack_q)
                if item is _DONE:
                    # siblings need the token too
                    self._put(self.pack_q, _DONE)
                    with self._pack_cv:
                        if self._pack_eof_claimed:
                            return
                        self._pack_eof_claimed = True
                    self._await_pack_turn(self.total_slabs)
                    self._put(self.disp_q, _DONE)
                    return
                seq, entries = item
                t0 = time.perf_counter()
                with telemetry.span("pipeline.pack", "pipeline"):
                    packed = self.pack(entries, seq)
                t1 = time.perf_counter()
                self.pack_busy[widx] += t1 - t0
                if self.pack_t0[widx] is None:
                    self.pack_t0[widx] = t0
                self.pack_t1[widx] = t1
                _M_BUSY["pack"].add(t1 - t0)
                _M_SLABS.add(1)
                # ordered emit: the turn-wait is backpressure, not busy
                self._await_pack_turn(seq)
                self._put(self.disp_q, (entries, packed))
                self._bump_pack_turn()
        except _Abort:
            pass
        except BaseException as e:
            self._fail("pack", e)

    def _fetch_loop(self, ctx: FetchContext) -> None:
        try:
            while True:
                item = self._get(self.fetch_q)
                if item is _DONE:
                    # recirculate the token so sibling workers (fetch
                    # overlaps across ranks) see it and drain too
                    self._put(self.fetch_q, _DONE)
                    return
                t0 = time.perf_counter()
                with telemetry.span("pipeline.fetch", "pipeline"):
                    self.fetch(item)
                _M_BUSY["fetch"].add(time.perf_counter() - t0)
        except _Abort:
            pass
        except BaseException as e:
            self._fail("fetch", e)
            ctx.error = e

    # -- the caller's loop ------------------------------------------------

    def run(self, ctx: FetchContext) -> Tuple[List[Any], List[Any]]:
        """Run the pipeline to completion on the caller thread (which
        owns dispatch + doc init). Returns (memo_hits, fallbacks); the
        fetch thread may still be draining — `ctx` tracks it for the
        barrier. Raises PipelineError if any stage failed."""
        io_t = threading.Thread(
            target=self._io_loop, name="hm-pipe-io", daemon=True
        )
        pack_ts = [
            threading.Thread(
                target=self._pack_loop,
                args=(i,),
                name=f"hm-pipe-pack-{i}",
                daemon=True,
            )
            for i in range(self.pack_workers)
        ]
        fetch_ts = [
            threading.Thread(
                target=self._fetch_loop,
                args=(ctx,),
                name=f"hm-pipe-fetch-{i}",
                daemon=True,
            )
            for i in range(self.fetch_workers)
        ]
        ctx.threads = fetch_ts
        io_t.start()
        for t in pack_ts:
            t.start()
        for t in fetch_ts:
            t.start()
        try:
            while True:
                item = self._get(self.disp_q)
                if item is _DONE:
                    break
                entries, batch = item
                t0 = time.perf_counter()
                with telemetry.span("pipeline.dispatch", "pipeline"):
                    pending = self.dispatch(entries, batch)
                _M_BUSY["dispatch"].add(time.perf_counter() - t0)
                self._put(self.fetch_q, pending)
            self._put(self.fetch_q, _DONE)
        except _Abort:
            pass
        except BaseException as e:
            self._fail("dispatch", e)
        # upstream stages are done (or aborting): join them bounded
        io_t.join(_JOIN_S)
        for t in pack_ts:
            t.join(_JOIN_S)
        if self.error is not None:
            # drain so nothing pins batches/device refs, then take the
            # fetch workers down too — the load failed as a unit
            for t in fetch_ts:
                t.join(_JOIN_S)
            for q in (self.pack_q, self.disp_q, self.fetch_q):
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
            if (
                io_t.is_alive()
                or any(t.is_alive() for t in pack_ts)
                or any(t.is_alive() for t in fetch_ts)
            ):
                raise PipelineError(  # pragma: no cover - defensive
                    f"pipeline stage '{self.error_stage}' failed and "
                    "workers did not drain"
                ) from self.error
            raise PipelineError(
                f"bulk load pipeline stage '{self.error_stage}' failed"
            ) from self.error
        if io_t.is_alive() or any(t.is_alive() for t in pack_ts):
            raise PipelineError(  # pragma: no cover - defensive
                "pipeline workers did not drain"
            )
        return self.memo_hits, self.fallbacks
