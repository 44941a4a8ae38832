"""Duplex message transports.

The connection stack is built over a minimal object-message Duplex (send /
on_message / close). `DuplexPair` is the in-memory cross-wired pair used by
loopback tests and the LoopbackSwarm — deliveries are deferred through a
trampoline scheduler rather than invoked re-entrantly, the same race-
avoidance the reference's test duplex gets from setImmediate writes
(reference tests/misc.ts:70-112). A TCP adapter (net/tcp.py) carries the
same interface over sockets with JSON framing.

The port's copy of hypermerge_tpu/net/duplex.py.
"""

from __future__ import annotations

import threading
from collections import deque

from ..analysis.lockdep import make_rlock
from typing import Any, Callable, Optional


class Duplex:
    """One end of a bidirectional object-message pipe."""

    def __init__(self) -> None:
        self._on_message: Optional[Callable[[Any], None]] = None
        self._close_cbs: list = []
        self._inbox: deque = deque()
        self._peer: Optional["Duplex"] = None
        self._scheduler: Optional["_Trampoline"] = None
        self.closed = False

    def on_message(self, cb: Callable[[Any], None]) -> None:
        self._on_message = cb
        self._drain_inbox()

    def on_close(self, cb: Callable[[], None]) -> None:
        """Multi-listener, same contract as TcpDuplex.on_close: the
        connection stack AND wrappers (fault injection, supervisors)
        may both watch; registering after close fires immediately."""
        if self.closed:
            cb()
        else:
            self._close_cbs.append(cb)

    def send(self, msg: Any) -> None:
        if self.closed or self._peer is None:
            return
        peer = self._peer
        self._scheduler.defer(lambda: peer._deliver(msg))

    def _deliver(self, msg: Any) -> None:
        if self.closed:
            return
        if self._on_message is None:
            self._inbox.append(msg)
        else:
            self._on_message(msg)

    def _drain_inbox(self) -> None:
        while self._inbox and self._on_message is not None:
            self._on_message(self._inbox.popleft())

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for cb in list(self._close_cbs):
            cb()
        peer = self._peer
        if peer is not None and not peer.closed:
            self._scheduler.defer(peer.close)


class _Trampoline:
    """Defer callbacks without unbounded recursion: whoever starts the
    pump drains everything queued (including callbacks queued while
    pumping). Thread-safe; callbacks never run concurrently."""

    def __init__(self) -> None:
        self._queue: deque = deque()
        self._lock = make_rlock("net.duplex")
        self._pumping = False

    def defer(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._queue.append(fn)
        self._pump()

    def _pump(self) -> None:
        while True:
            with self._lock:
                if self._pumping or not self._queue:
                    return
                self._pumping = True
                fn = self._queue.popleft()
            try:
                fn()
            finally:
                with self._lock:
                    self._pumping = False


def duplex_pair() -> tuple:
    """Two cross-wired in-memory duplexes sharing one trampoline."""
    a, b = Duplex(), Duplex()
    tramp = _Trampoline()
    a._peer, b._peer = b, a
    a._scheduler = b._scheduler = tramp
    return a, b
