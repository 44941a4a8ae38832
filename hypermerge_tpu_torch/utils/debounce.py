"""Keyed debouncer: coalesce bursts of per-key events into one flush.

Used for idempotent latest-state broadcasts (cursor/clock gossip,
inbound-sync application — backend/repo_backend.py) and for the
replication live tail (net/replication.py), which marks keys with a
VALUE (the earliest dirty block offset) merged across a burst.

Semantics:
- flush_fn(batch) receives a dict {key: value}; marks landing during
  the window (or while a flush is running) join the next flush.
- flush_fn runs on one daemon thread, never concurrently with itself.
- close() drains: everything marked before close is flushed before the
  thread exits (an orderly shutdown loses nothing).
- With max_window_s set the window ADAPTS: when a flush takes longer
  than the floor window (sustained load), the next window stretches to
  the flush duration so batches grow instead of flush count.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..analysis import lockdep
from ..analysis.lockdep import make_rlock
from .debug import log


class Debouncer:
    def __init__(
        self,
        flush_fn: Callable[[Dict], None],
        window_s: float = 0.002,
        max_window_s: Optional[float] = None,
        merge: Optional[Callable] = None,
        name: str = "debounce",
        eager: bool = False,
    ) -> None:
        self._fn = flush_fn
        self._window = window_s
        self._max_window = max_window_s
        self._merge = merge
        # work-conserving mode: a backlog that accumulated WHILE the
        # previous flush ran flushes immediately (the flush duration is
        # itself the batching window under sustained load); the idle
        # window only pads the leading edge of a burst. Right for flush
        # fns whose cost amortizes over batch size (the live tick);
        # wrong for pure rate-limiters (gossip).
        self._eager = eager
        self._lock = make_rlock("util.debounce")
        self._cv = threading.Condition(self._lock)
        self._keys: Dict = {}
        self._inflight: Dict = {}
        self._flushing = False
        self._closed = False
        self._name = name
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=name
        )
        self._thread.start()

    def mark(self, key, value=None) -> None:
        with self._cv:
            if self._closed:
                return
            if self._merge is not None and key in self._keys:
                value = self._merge(self._keys[key], value)
            self._keys[key] = value
            self._cv.notify()

    def pending(self) -> Dict:
        """Snapshot of everything marked but not yet durably flushed:
        the batch currently inside flush_fn plus keys awaiting the next
        window. Readers that consult the flush target directly overlay
        this to stay read-your-writes without blocking on the flusher."""
        with self._cv:
            if not self._inflight and not self._keys:
                return {}
            merged = dict(self._inflight)
            merged.update(self._keys)
            return merged

    def flush_now(self, timeout: float = 5.0) -> bool:
        """Block until everything currently marked has FINISHED
        flushing (not merely been picked up by the flusher). Returns
        False if the timeout expired with work still in flight, so
        callers whose next step assumes durability (destroy deleting
        rows a late flush would resurrect) can act on the failure."""
        with lockdep.blocking("flush_wait", self._name):
            deadline = time.monotonic() + timeout
            with self._cv:
                while self._keys or self._flushing:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._cv.wait(remaining)
        return True

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting marks and drain: pending keys are flushed
        before the flusher thread exits."""
        with lockdep.blocking("thread_join", self._name):
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            self._thread.join(timeout)

    def _loop(self) -> None:
        last_flush = 0.0
        failures = 0
        while True:
            waited = False
            with self._cv:
                while not self._keys and not self._closed:
                    self._cv.wait()
                    waited = True
                    last_flush = 0.0  # quiet period: back to low latency
                if self._closed and not self._keys:
                    return
                closing = self._closed
            if self._eager and not waited and not closing:
                pass  # backlog from the last flush: no window, go now
            elif not closing:  # closing: drain immediately, no window
                window = self._window
                if self._max_window is not None:
                    window = max(
                        window, min(last_flush, self._max_window)
                    )
                if window > 0:
                    time.sleep(window)
            with self._cv:
                batch = self._keys
                self._keys = {}
                self._inflight = batch
                self._flushing = True
            t0 = time.perf_counter()
            try:
                self._fn(batch)
                failures = 0
            except Exception as e:  # pragma: no cover - defensive
                failures += 1
                log("debounce", f"{self._name} flush failed: {e}")
                with self._cv:
                    if failures < 8:
                        # a transient error (sqlite busy, disk full)
                        # must not LOSE the batch: re-queue it for
                        # retry. Keys re-marked during the failed flush
                        # are newer — they win (or merge on top).
                        for k, v in batch.items():
                            if k not in self._keys:
                                self._keys[k] = v
                            elif self._merge is not None:
                                self._keys[k] = self._merge(
                                    v, self._keys[k]
                                )
                    else:
                        log(
                            "debounce",
                            f"{self._name} dropping batch after "
                            f"{failures} consecutive failures",
                        )
            finally:
                last_flush = time.perf_counter() - t0
                with self._cv:
                    self._inflight = {}
                    self._flushing = False
                    self._cv.notify_all()
            if failures:
                # bounded backoff so a persistent error can't hot-spin
                # the flusher (close()'s join timeout still bounds exit)
                time.sleep(min(0.05 * failures, 0.5))
