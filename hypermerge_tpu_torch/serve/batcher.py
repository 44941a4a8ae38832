"""The read batcher: bounded admission + debounced batch flush.

Reads enqueue from any thread (the backend receive thread, IPC
handlers, bench reader threads) and coalesce inside an
HM_SERVE_BATCH_MS window; the flush hands the whole batch to the tier,
which resolves it with one kernel dispatch per (query kind, shape
bucket). The debouncer is eager (the live-tick idiom): the leading
read of a burst flushes immediately and the flush duration itself
becomes the coalescing window, so a lone read pays ~0 latency while a
storm batches.

Admission is BOUNDED (HM_SERVE_QUEUE): a reader that would overflow
the queue is refused at submit and degrades to the host path in the
tier — backpressure becomes a counter (serve.fallbacks), never an
unbounded queue or an error.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List

from ..analysis.lockdep import make_lock
from ..utils.debounce import Debouncer


def _window_s() -> float:
    return float(os.environ.get("HM_SERVE_BATCH_MS", "1")) / 1e3


def _queue_cap() -> int:
    return int(os.environ.get("HM_SERVE_QUEUE", "4096"))


class ReadRequest:
    """One in-flight read: the query, its completion callback, and the
    resolution scratch the tier's path walk uses."""

    __slots__ = (
        "doc_id", "query", "cb", "t0", "span",
        "entry", "obj_row", "steps", "done",
    )

    def __init__(self, doc_id: str, query: Dict, cb: Callable) -> None:
        self.doc_id = doc_id
        self.query = query
        self.cb = cb
        self.t0 = 0.0
        self.span: Any = None
        self.entry: Any = None
        self.obj_row = -1
        self.steps: List = []
        self.done = False


class ReadBatcher:
    def __init__(self, flush: Callable[[List[ReadRequest]], None]) -> None:
        self._flush = flush
        self._lock = make_lock("serve.batch")
        self._depth = 0
        self._seq = 0
        self._cap = _queue_cap()  # read once: submit is the hot path
        self._closed = False
        self._deb = Debouncer(
            self._on_flush,
            window_s=_window_s(),
            name="serve-batch",
            eager=True,
        )

    def submit(self, req: ReadRequest) -> bool:
        """Enqueue for the next batch. False = queue full or batcher
        closed (the caller degrades to the host path).

        The mark happens INSIDE the lock, ordered against close():
        either this submit's mark lands before close() flips _closed
        (close's debouncer drain then flushes it), or the submit
        observes _closed and refuses — a mark can never vanish into an
        already-closed debouncer with True returned (the reader would
        block its full timeout on a callback that never fires)."""
        with self._lock:
            if self._closed or self._depth >= self._cap:
                return False
            self._depth += 1
            key = self._seq
            self._seq += 1
            self._deb.mark(key, req)
        return True

    @property
    def depth(self) -> int:
        return self._depth

    def _on_flush(self, batch: Dict[int, ReadRequest]) -> None:
        reqs = [batch[k] for k in sorted(batch)]
        with self._lock:
            self._depth -= len(reqs)
        self._flush(reqs)

    def flush_now(self, timeout: float = 5.0) -> bool:
        return self._deb.flush_now(timeout)

    def close(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._closed = True
        # OUTSIDE the lock: close joins the flusher thread, and the
        # flusher's _on_flush takes the lock to settle depth
        self._deb.close(timeout)
