"""Single-subscriber buffering queue — the universal async primitive.

Semantics match the reference's Queue (reference src/Queue.ts:3-73): items
pushed before a subscriber exists are buffered; `subscribe` first drains the
buffer then turns `push` into a direct call; a second concurrent subscriber is
an error (this is the structural race-avoidance device the whole runtime leans
on, reference src/Queue.ts:39-41).

Unlike the reference we are not on a single-threaded event loop, so the drain
and the direct-call handoff are guarded by a lock; the guarantee provided is
that callbacks for one queue are never run concurrently and never reordered.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Generic, List, Optional, TypeVar

from ..analysis import lockdep
from ..analysis.lockdep import make_rlock
from .debug import log

T = TypeVar("T")


class Queue(Generic[T]):
    def __init__(self, name: str = "q") -> None:
        self.name = name
        self._buffer: Deque[T] = deque()
        self._subscription: Optional[Callable[[T], None]] = None
        self._lock = make_rlock("util.queue")
        self._draining = False
        self._first_waiters: List[threading.Event] = []
        self._has_first = False
        self._first_value: Optional[T] = None

    @property
    def length(self) -> int:
        with self._lock:
            return len(self._buffer)

    def push(self, item: T) -> None:
        with self._lock:
            self._buffer.append(item)
            self._signal_first(item)
        self._drain()

    def subscribe(self, subscriber: Callable[[T], None]) -> None:
        with self._lock:
            if self._subscription is not None:
                raise RuntimeError(
                    f"queue {self.name!r} already has a subscriber"
                )
            log("queue:%s" % self.name, "subscribe")
            self._subscription = subscriber
        self._drain()

    def unsubscribe(self) -> None:
        with self._lock:
            self._subscription = None

    def once(self, subscriber: Callable[[T], None]) -> None:
        """Subscribe for exactly one item, then unsubscribe."""

        def one(item: T) -> None:
            self.unsubscribe()
            subscriber(item)

        self.subscribe(one)

    def first(self, timeout: Optional[float] = None) -> T:
        """Block until the first item is available and return it (does not
        consume — mirrors the promise-shaped `first()` of the reference,
        src/Queue.ts:16-20)."""
        with lockdep.blocking("queue_first", self.name):
            ev = threading.Event()
            with self._lock:
                if self._has_first:
                    return self._first_value  # type: ignore[return-value]
                self._first_waiters.append(ev)
            if not ev.wait(timeout):
                raise TimeoutError(
                    f"queue {self.name!r} first() timed out"
                )
            return self._first_value  # type: ignore[return-value]

    def drain(self) -> List[T]:
        with self._lock:
            items = list(self._buffer)
            self._buffer.clear()
            return items

    # -- internals ---------------------------------------------------------

    def _signal_first(self, item: T) -> None:
        if not self._has_first:
            self._has_first = True
            self._first_value = item
            for ev in self._first_waiters:
                ev.set()
            self._first_waiters.clear()

    def _drain(self) -> None:
        # Subscriber callbacks run OUTSIDE the lock (a subscriber may push
        # to other queues, or this one reentrantly). The _draining flag makes
        # exactly one thread the drainer at a time, preserving order and the
        # never-concurrent callback guarantee without holding the lock
        # across user code.
        while True:
            with self._lock:
                if (
                    self._draining
                    or not self._buffer
                    or self._subscription is None
                ):
                    return
                self._draining = True
                item = self._buffer.popleft()
                subscriber = self._subscription
            try:
                subscriber(item)
            finally:
                with self._lock:
                    self._draining = False
