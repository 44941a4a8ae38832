"""Selector-based async transport: every TCP connection of a process
multiplexed onto ONE event-loop thread (`HM_NET_ASYNC=1`).

The thread-per-connection stack (net/tcp.py) spends 2 threads per
duplex (reader + writer) plus a keepalive thread per duplex plus a
parked session thread per supervised address plus a thread per accepted
handshake — ~4-5 threads per peer, which is exactly the wall the
50-daemon fleet hit. This module is the `=1` twin behind the SAME
`Duplex`/`Swarm`/`SessionSupervisor` seams:

- `AioLoop` — one lazily-created loop thread per process: a
  `selectors` poll over every non-blocking socket, a timer heap
  (keepalives fold into one wheel instead of a thread per duplex), a
  self-pipe wakeup, and a bounded dispatch pool (`HM_AIO_DISPATCH`)
  that runs user-facing callbacks OFF the loop so a blocking
  subscriber cannot stall every connection in the process.
- `AioDuplex` — the TcpDuplex contract (send never blocks / on_message
  single-subscriber queue / on_close multi-listener / outbox shed
  semantics / keepalive probes) driven entirely by loop callbacks: the
  handshake is an incremental state machine over the same wire frames
  (flags+key hello, optional encrypted ed25519 auth, net/secure.py),
  so the two stacks are bit-compatible on the wire and a process may
  run either side of a connection in either mode.

Ordering guarantees survive the multiplexing: per-direction nonce
counters stay strictly ordered because the single loop thread performs
every encrypt (tx) and decrypt (rx); inbound dispatch keeps the
`utils.queue.Queue` never-concurrent / never-reordered contract via a
per-connection pending deque drained by exactly one pool worker at a
time.

Wrappers (net/faults.py FaultDuplex) see only the public Duplex
surface — send/on_message/on_close/close/closed — so the chaos harness
wraps this transport unchanged.

The port's copy of hypermerge_tpu/net/aio.py.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import selectors
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

from ..analysis.lockdep import make_condition, make_lock, make_rlock
from ..utils.debug import log
from .. import telemetry
from .tcp import (
    _HDR,
    _MAX_FRAME,
    _PING,
    _PONG,
    _outbox_cap,
    _ping_misses,
    _ping_s,
)

# process-wide async-transport telemetry (tools/top.py [net] group):
# `conns` is the live multiplexed-connection gauge, `loop_busy_ms` the
# cumulative non-idle time of the loop thread — busy/wall is the loop
# saturation ratio the 1000-peer bench watches.
_M_CONNS = telemetry.gauge("net.aio.conns")
_M_BUSY_MS = telemetry.counter("net.aio.loop_busy_ms")
_M_FRAMES_TX = telemetry.counter("net.aio.frames_tx")
_M_FRAMES_RX = telemetry.counter("net.aio.frames_rx")
_M_BYTES_TX = telemetry.counter("net.aio.bytes_tx")
_M_BYTES_RX = telemetry.counter("net.aio.bytes_rx")
_M_PINGS = telemetry.counter("net.aio.pings_tx")
_M_SHEDS = telemetry.counter("net.aio.sheds")

# per-event fairness budgets: one hot connection must not starve the
# rest of the loop (level-triggered polling re-fires what remains)
_RX_BUDGET = 1 << 20
_TX_FRAME_BUDGET = 64


def _dispatch_n() -> int:
    return int(os.environ.get("HM_AIO_DISPATCH", "8"))


class _Timer:
    """One timer-wheel entry; `cancel` is a monotonic latch (the heap
    lazily drops cancelled entries when they surface)."""

    __slots__ = ("deadline", "fn", "cancelled")

    def __init__(self, deadline: float, fn: Callable[[], None]) -> None:
        self.deadline = deadline
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class AioLoop:
    """The process event loop: selector + timer heap + dispatch pool.

    All selector mutation happens on the loop thread (callers schedule
    through `call_soon`); timers and ready callbacks are submitted from
    any thread. `offload(fn)` runs `fn` on a bounded pool worker — the
    ONLY place user-facing callbacks (message subscribers, close
    listeners, deliver hooks) ever run, so they may block freely."""

    def __init__(self) -> None:
        self._sel = selectors.DefaultSelector()
        self._lock = make_lock("net.aio")
        self._ready: deque = deque()
        self._timers: list = []  # heap of (deadline, seq, _Timer)
        self._timer_seq = itertools.count()
        # self-pipe: a submit from off-loop interrupts the poll
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        # bounded dispatch pool, demand-spawned up to HM_AIO_DISPATCH
        self._dispatch_cv = make_condition("net.aio.dispatch")
        self._dispatch_q: deque = deque()
        self._dispatch_idle = 0
        self._workers = 0
        self._worker_cap = _dispatch_n()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="aio-loop"
        )
        self._thread.start()

    # -- submission (any thread) ---------------------------------------

    def on_loop(self) -> bool:
        return threading.current_thread() is self._thread

    def call_soon(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._ready.append(fn)
        self._wakeup()

    def call_later(self, delay: float, fn: Callable[[], None]) -> _Timer:
        t = _Timer(time.monotonic() + max(0.0, delay), fn)
        with self._lock:
            heapq.heappush(
                self._timers, (t.deadline, next(self._timer_seq), t)
            )
        self._wakeup()
        return t

    def offload(self, fn: Callable[[], None]) -> None:
        """Run `fn` on a dispatch worker (never the loop thread)."""
        spawn = False
        with self._dispatch_cv:
            self._dispatch_q.append(fn)
            if self._dispatch_idle > 0:
                self._dispatch_cv.notify()
            elif self._workers < self._worker_cap:
                self._workers += 1
                spawn = True
        if spawn:
            threading.Thread(
                target=self._dispatch_run, daemon=True,
                name="aio-dispatch",
            ).start()

    def _wakeup(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass  # pipe full: a wakeup is already pending

    # -- the loop thread -----------------------------------------------

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._ready:
                    timeout = 0.0
                elif self._timers:
                    timeout = max(
                        0.0, self._timers[0][0] - time.monotonic()
                    )
                else:
                    timeout = None
            events = self._sel.select(timeout)
            t0 = time.monotonic()
            for key, mask in events:
                if key.fileobj is self._wake_r:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except OSError:
                        pass
                    continue
                try:
                    key.data(mask)
                except Exception as e:  # a conn bug must not kill the loop
                    log("net:aio", f"io handler error: {e}")
            now = time.monotonic()
            due: List[_Timer] = []
            with self._lock:
                while self._timers and self._timers[0][0] <= now:
                    _d, _s, t = heapq.heappop(self._timers)
                    if not t.cancelled:
                        due.append(t)
            for t in due:
                try:
                    t.fn()
                except Exception as e:
                    log("net:aio", f"timer error: {e}")
            while True:
                with self._lock:
                    if not self._ready:
                        break
                    fn = self._ready.popleft()
                try:
                    fn()
                except Exception as e:
                    log("net:aio", f"callback error: {e}")
            _M_BUSY_MS.add((time.monotonic() - t0) * 1e3)

    def _dispatch_run(self) -> None:
        while True:
            with self._dispatch_cv:
                while not self._dispatch_q:
                    self._dispatch_idle += 1
                    self._dispatch_cv.wait()
                    self._dispatch_idle -= 1
                fn = self._dispatch_q.popleft()
            try:
                fn()
            except Exception as e:  # user callback bug: log, keep pool
                log("net:aio", f"dispatch error: {e}")

    # -- loop-side socket helpers (loop thread only) --------------------

    def register(self, sock, events, cb) -> None:
        self._sel.register(sock, events, cb)

    def modify(self, sock, events, cb) -> None:
        self._sel.modify(sock, events, cb)

    def unregister(self, sock) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass

    # -- non-blocking dial ----------------------------------------------

    def dial(
        self,
        address: Tuple[str, int],
        timeout: float,
        cb: Callable[[Optional[socket.socket], Optional[OSError]], None],
    ) -> None:
        """Start a non-blocking connect; `cb(sock, exc)` fires exactly
        once on the LOOP thread (connected socket, or None + OSError on
        refusal/timeout). Keep `cb` cheap — offload real work."""

        def start() -> None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setblocking(False)
            try:
                err = sock.connect_ex(address)
            except OSError as e:
                sock.close()
                cb(None, e)
                return
            if err not in (0, 115, 36, 10035):  # EINPROGRESS variants
                sock.close()
                cb(None, OSError(err, os.strerror(err)))
                return
            state = {"done": False}

            def settle(exc: Optional[OSError]) -> None:
                if state["done"]:
                    return
                state["done"] = True
                timer.cancel()
                self.unregister(sock)
                if exc is not None:
                    sock.close()
                    cb(None, exc)
                else:
                    cb(sock, None)

            def on_writable(_mask: int) -> None:
                err = sock.getsockopt(
                    socket.SOL_SOCKET, socket.SO_ERROR
                )
                if err:
                    settle(OSError(err, os.strerror(err)))
                else:
                    settle(None)

            timer = self.call_later(
                timeout, lambda: settle(OSError("dial timed out"))
            )
            try:
                self.register(sock, selectors.EVENT_WRITE, on_writable)
            except (OSError, ValueError) as e:
                settle(OSError(str(e)))

        self.call_soon(start)


_BOOT_LOCK = make_lock("net.aio")
_LOOP: Optional[AioLoop] = None


def get_loop() -> AioLoop:
    """The process's shared loop, created on first use."""
    global _LOOP
    with _BOOT_LOCK:
        if _LOOP is None:
            _LOOP = AioLoop()
        return _LOOP


class AioDuplex:
    """TcpDuplex's contract over a non-blocking socket on the shared
    loop. Constructible from any thread; `on_ready(duplex, exc)` fires
    exactly once on a dispatch worker when the handshake completes
    (exc None) or fails/closes first (exc set) — the accept and async
    supervisor paths key off it instead of a blocking constructor."""

    def __init__(
        self,
        sock: socket.socket,
        is_client: bool = False,
        identity: Optional[bytes] = None,
        on_ready: Optional[Callable[["AioDuplex", Optional[BaseException]], None]] = None,
        loop: Optional[AioLoop] = None,
    ) -> None:
        from ..utils.queue import Queue

        self._loop = loop if loop is not None else get_loop()
        self._sock = sock
        sock.setblocking(False)
        self._identity = identity
        self._on_ready = on_ready
        self._lock = make_rlock("net.aio.conn")
        self._outbox: deque = deque()  # plaintext frames
        self._out_bytes = 0
        self._out_inflight = False  # loop holds a partially-sent frame
        self._out_cap = _outbox_cap()
        self._stall_s = float(os.environ.get("HM_TCP_STALL_S", "10"))
        self._last_progress = time.monotonic()
        self._drained = threading.Event()
        self._drained.set()
        self._shed = False
        self._rx_eof = False
        self._inbox: "Queue" = Queue("aio:inbox")
        self._close_cbs: List[Callable[[], None]] = []
        self._rx_pending: deque = deque()
        self._rx_scheduled = False
        self._ready_fired = False
        self.closed = False
        self._last_rx = time.monotonic()
        # loop-confined state (only the loop thread touches these)
        self._rbuf = bytearray()
        self._wbuf = b""
        self._registered = False
        self._events = 0
        self._tx_scheduled = False
        self._counted = False
        self._hs_timer: Optional[_Timer] = None
        self._ka_timer: Optional[_Timer] = None
        self._ka_misses = 0
        self._ka_probe = float("-inf")
        self._session = None
        self._hs_phase = "done"
        self._hs_offer = False
        if os.environ.get("HM_TCP_PLAINTEXT") != "1":
            from .secure import SecureSession

            self._session = SecureSession(is_client)
            self._hs_phase = "hello"
        self._loop.call_soon(self._start)

    # -- public Duplex surface -----------------------------------------

    @property
    def channel_binding(self) -> Optional[bytes]:
        return self._session.channel_binding if self._session else None

    @property
    def peer_identity(self) -> Optional[str]:
        return self._session.peer_identity if self._session else None

    def on_message(self, cb: Callable[[Any], None]) -> None:
        self._inbox.subscribe(cb)

    def on_close(self, cb: Callable[[], None]) -> None:
        """Multi-listener, TcpDuplex contract: registering after close
        fires immediately (on the caller's thread)."""
        fire_now = False
        with self._lock:
            if self.closed:
                fire_now = True
            else:
                self._close_cbs.append(cb)
        if fire_now:
            cb()

    def send(self, msg: Any) -> None:
        """Queue a frame; never blocks on the socket. Same shed policy
        as TcpDuplex.send: past the outbox cap with no completed frame
        for HM_TCP_STALL_S, or past 4x the cap regardless, the
        connection sheds and the supervised peer redials."""
        if self.closed:
            return
        data = json.dumps(msg, separators=(",", ":")).encode("utf-8")
        kick = False
        with self._lock:
            if self.closed:
                return
            if not self._outbox and not self._out_inflight:
                # idle -> active: stall clock measures THIS burst
                self._last_progress = time.monotonic()
            self._outbox.append(data)
            self._out_bytes += len(data)
            over = self._out_bytes > self._out_cap
            self._drained.clear()
            if not self._tx_scheduled:
                self._tx_scheduled = True
                kick = True
        if kick:
            self._loop.call_soon(self._tx_kick)
        if over and (
            self._out_bytes > 4 * self._out_cap
            or time.monotonic() - self._last_progress > self._stall_s
        ):
            log(
                "net:aio",
                f"outbox over cap ({self._out_bytes}B) with a stalled "
                "peer: shedding connection",
            )
            _M_SHEDS.add(1)
            self._shed = True
            self.close()

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            drain = (
                not self._shed
                and not self._rx_eof
                and not self._loop.on_loop()
                and bool(self._outbox or self._out_inflight)
            )
        if drain:
            # orderly close loses nothing: bounded drain window (the
            # loop keeps flushing until the outbox empties)
            self._drained.wait(5.0)
        with self._lock:
            if self.closed:
                return
            self.closed = True
            listeners = list(self._close_cbs)
            self._close_cbs.clear()
        self._finish_ready(OSError("closed before handshake completed"))
        self._rx_enqueue(("close", listeners))
        self._loop.call_soon(self._teardown)

    # -- loop-thread machinery -----------------------------------------

    def _start(self) -> None:
        """First loop callback: register, count, open the handshake."""
        if self.closed:
            return
        try:
            self._events = selectors.EVENT_READ
            self._loop.register(self._sock, self._events, self._on_io)
            self._registered = True
        except (OSError, ValueError) as e:
            self._fail(OSError(f"register failed: {e}"))
            return
        _M_CONNS.add(1)
        self._counted = True
        if self._session is None:
            self._hs_complete()
            return
        offer, mode = self._hs_posture()
        if mode == "require" and self._identity is None:
            self._fail(ValueError(
                "HM_NET_AUTH=require but no identity set"
            ))
            return
        self._hs_offer = offer
        frame = (
            bytes([1 if offer else 0]) + self._session.handshake_bytes
        )
        self._wbuf += _HDR.pack(len(frame)) + frame
        self._want_write(True)
        self._hs_timer = self._loop.call_later(
            10.0, lambda: self._fail(OSError("handshake timed out"))
        )

    def _hs_posture(self) -> Tuple[bool, str]:
        mode = os.environ.get("HM_NET_AUTH", "1")
        return (self._identity is not None and mode != "0", mode)

    def _on_io(self, mask: int) -> None:
        if self.closed:
            return
        if mask & selectors.EVENT_READ:
            self._handle_readable()
        if self.closed:
            return
        if mask & selectors.EVENT_WRITE:
            self._handle_writable()

    def _want_write(self, on: bool) -> None:
        if not self._registered:
            return
        events = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if on else 0
        )
        if events != self._events:
            self._events = events
            try:
                self._loop.modify(self._sock, events, self._on_io)
            except (OSError, ValueError, KeyError):
                pass  # torn down concurrently

    def _tx_kick(self) -> None:
        with self._lock:
            self._tx_scheduled = False
        if self.closed or not self._registered:
            return
        self._handle_writable()

    def _handle_writable(self) -> None:
        budget = _TX_FRAME_BUDGET
        while budget > 0:
            if not self._wbuf:
                if self._hs_phase != "done":
                    self._want_write(False)
                    return  # app frames wait for the handshake
                with self._lock:
                    if not self._outbox:
                        self._out_inflight = False
                        self._drained.set()
                        self._want_write(False)
                        return
                    data = self._outbox.popleft()
                    self._out_bytes -= len(data)
                    self._out_inflight = True
                # the single loop thread orders encryption: nonce
                # counters stay strictly per-direction sequential
                if self._session is not None:
                    data = self._session.encrypt(data)
                self._wbuf = _HDR.pack(len(data)) + data
                budget -= 1
                _M_FRAMES_TX.add(1)
                _M_BYTES_TX.add(len(self._wbuf))
            try:
                n = self._sock.send(self._wbuf)
            except (BlockingIOError, InterruptedError):
                self._want_write(True)
                return
            except OSError:
                self._wire_dead()
                return
            self._wbuf = self._wbuf[n:]
            if self._wbuf:
                self._want_write(True)
                return  # socket buffer full: resume on writable
            self._last_progress = time.monotonic()
        self._want_write(True)  # budget spent, more queued: re-fire

    def _handle_readable(self) -> None:
        got = 0
        while got < _RX_BUDGET:
            try:
                chunk = self._sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                chunk = b""
            if not chunk:
                self._rx_eof = True
                self.close()
                return
            got += len(chunk)
            self._rbuf += chunk
            self._last_rx = time.monotonic()
        while True:
            if len(self._rbuf) < _HDR.size:
                return
            (size,) = _HDR.unpack(bytes(self._rbuf[: _HDR.size]))
            if size > _MAX_FRAME:
                log("net:aio", f"oversized frame {size}, closing")
                self._rx_eof = True
                self.close()
                return
            if len(self._rbuf) < _HDR.size + size:
                return
            payload = bytes(self._rbuf[_HDR.size:_HDR.size + size])
            del self._rbuf[: _HDR.size + size]
            if self._hs_phase != "done":
                self._hs_frame(payload)
                if self.closed:
                    return
                continue
            _M_FRAMES_RX.add(1)
            _M_BYTES_RX.add(_HDR.size + size)
            if self._session is not None:
                payload = self._session.decrypt(payload)
                if payload is None:
                    # tampering or desync: fatal, never skippable
                    log("net:aio", "ciphertext auth failed, closing")
                    self._rx_eof = True
                    self.close()
                    return
            try:
                msg = json.loads(payload.decode("utf-8"))
            except ValueError:
                continue  # corrupt frame: skip
            if isinstance(msg, dict):
                # keepalive frames stop here, never reach subscribers
                if _PING in msg:
                    self.send({_PONG: msg[_PING]})
                    continue
                if _PONG in msg:
                    continue
            self._rx_enqueue(("msg", msg))

    # -- handshake state machine (loop thread) --------------------------

    def _hs_frame(self, payload: bytes) -> None:
        if self._hs_phase == "hello":
            if len(payload) == 33:
                peer_offers = bool(payload[0] & 1)
                peer_pk = payload[1:]
            elif len(payload) == 32:
                peer_offers = False  # legacy anonymous endpoint
                peer_pk = payload
            else:
                self._fail(ValueError(
                    f"bad handshake frame size {len(payload)}"
                ))
                return
            self._session.complete(peer_pk)
            _offer, mode = self._hs_posture()
            if self._hs_offer and peer_offers:
                auth = self._session.encrypt(
                    self._session.auth_frame(self._identity)
                )
                self._wbuf += _HDR.pack(len(auth)) + auth
                self._want_write(True)
                self._hs_phase = "auth"
            elif mode == "require":
                self._fail(ValueError(
                    "peer did not offer identity auth "
                    "(HM_NET_AUTH=require)"
                ))
            else:
                self._hs_complete()
        elif self._hs_phase == "auth":
            if len(payload) > 1024:
                self._fail(ValueError(
                    f"bad auth frame size {len(payload)}"
                ))
                return
            frame = self._session.decrypt(payload)
            if frame is None or not self._session.verify_auth(frame):
                self._fail(ValueError(
                    "peer identity authentication FAILED "
                    "(MITM key substitution or signature over a "
                    "different transcript)"
                ))
                return
            self._hs_complete()

    def _hs_complete(self) -> None:
        self._hs_phase = "done"
        if self._hs_timer is not None:
            self._hs_timer.cancel()
            self._hs_timer = None
        self._finish_ready(None)
        ping = _ping_s()
        if ping > 0:
            self._ka_timer = self._loop.call_later(ping, self._ka_tick)
        with self._lock:
            pending = bool(self._outbox)
        if pending:
            self._handle_writable()

    def _fail(self, exc: BaseException) -> None:
        log("net:aio", f"handshake failed: {exc}")
        self._finish_ready(exc)
        self._rx_eof = True  # no point draining a dead negotiation
        self.close()

    def _finish_ready(self, exc: Optional[BaseException]) -> None:
        with self._lock:
            if self._ready_fired:
                return
            self._ready_fired = True
        if self._on_ready is not None:
            self._rx_enqueue(("ready", exc))

    # -- keepalive on the shared timer wheel (loop thread) --------------

    def _ka_tick(self) -> None:
        if self.closed:
            return
        now = time.monotonic()
        # a miss is "nothing arrived since my last probe" — NOT "idle
        # at check time" (same rule as TcpDuplex._keepalive_loop)
        if self._last_rx >= self._ka_probe:
            self._ka_misses = 0
        else:
            self._ka_misses += 1
            if self._ka_misses >= _ping_misses():
                log(
                    "net:aio",
                    f"keepalive: {self._ka_misses} unanswered probes: "
                    "half-open, shedding",
                )
                _M_SHEDS.add(1)
                self._shed = True
                self.close()
                return
        if now - self._last_rx >= _ping_s():
            self.send({_PING: self._ka_misses})
            _M_PINGS.add(1)
            self._ka_probe = now
        self._ka_timer = self._loop.call_later(_ping_s(), self._ka_tick)

    # -- teardown -------------------------------------------------------

    def _wire_dead(self) -> None:
        with self._lock:
            self._out_inflight = False
        self._drained.set()  # the outbox will never drain: wake closers
        self._rx_eof = True
        self.close()

    def _teardown(self) -> None:
        """Final loop callback: unregister, close the socket, retire
        the timers and the conns gauge."""
        for t in (self._hs_timer, self._ka_timer):
            if t is not None:
                t.cancel()
        if self._registered:
            self._loop.unregister(self._sock)
            self._registered = False
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._drained.set()
        if self._counted:
            self._counted = False
            _M_CONNS.add(-1)

    # -- ordered inbound dispatch (any thread -> one pool worker) -------

    def _rx_enqueue(self, item: Tuple[str, Any]) -> None:
        with self._lock:
            self._rx_pending.append(item)
            if self._rx_scheduled:
                return
            self._rx_scheduled = True
        self._loop.offload(self._rx_drain)

    def _rx_drain(self) -> None:
        """Dispatch-pool drainer; the `_rx_scheduled` latch makes it
        exactly one worker at a time per connection, preserving the
        inbox Queue's never-concurrent / never-reordered contract."""
        while True:
            with self._lock:
                if not self._rx_pending:
                    self._rx_scheduled = False
                    return
                kind, payload = self._rx_pending.popleft()
            if kind == "msg":
                try:
                    self._inbox.push(payload)
                except Exception as e:  # subscriber bug: drop, log
                    log("net:aio", f"inbound handler error: {e}")
            elif kind == "ready":
                cb = self._on_ready
                if cb is not None:
                    try:
                        cb(self, payload)
                    except Exception as e:
                        log("net:aio", f"ready hook error: {e}")
            else:  # close listeners, after every queued message
                for cb in payload:
                    try:
                        cb()
                    except Exception as e:
                        log("net:aio", f"close listener error: {e}")
