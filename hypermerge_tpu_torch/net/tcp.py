"""TCP transport: socket-backed Duplex + a dial/accept swarm.

Carries the same object-message Duplex interface as the in-memory pair
(net/duplex.py) over real sockets with length-prefixed JSON frames, so the
whole connection/peer/replication stack is transport-agnostic — exactly
the reference's layering (sockets at the bottom, reference
src/PeerConnection.ts; discovery injected from outside,
src/SwarmInterface.ts).

`TcpSwarm` accepts inbound connections and dials explicit addresses
(`connect`). DHT-style peer discovery stays pluggable/external like the
reference's hyperswarm; `connect` is the bootstrap primitive a discovery
implementation would call.

The port's copy of hypermerge_tpu/net/tcp.py.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

from ..analysis import lockdep
from ..analysis.lockdep import make_condition, make_lock, make_rlock
from ..utils.debug import log
from .. import telemetry
from .resilience import SessionSupervisor, dial_timeout_s
from .swarm import ConnectionDetails, Swarm

_HDR = struct.Struct("<I")
_MAX_FRAME = 64 * 1024 * 1024

# process-wide transport counters (every duplex shares them): frame +
# byte rates are the wire-level truth tools/top.py graphs under the
# per-channel replication counters. Counter.add is per-thread-sharded
# (one dict hit + one float add) — noise on a path that JSON-encodes
# and encrypts every frame.
_M_FRAMES_TX = telemetry.counter("net.tcp.frames_tx")
_M_FRAMES_RX = telemetry.counter("net.tcp.frames_rx")
_M_BYTES_TX = telemetry.counter("net.tcp.bytes_tx")
_M_BYTES_RX = telemetry.counter("net.tcp.bytes_rx")
_M_PINGS = telemetry.counter("net.tcp.pings_tx")
_M_SHEDS = telemetry.counter("net.tcp.sheds")

# keepalive frames: duplex-level, never delivered to subscribers. A
# pre-keepalive peer drops them as malformed channel frames
# (net/connection.py _on_raw) and never pongs — so a fully IDLE
# connection to such a peer is eventually shed and redialed (it is
# indistinguishable from half-open by design; any real frame from the
# peer counts as liveness). Every in-tree transport pongs.
_PING = "__hm_ping"
_PONG = "__hm_pong"


def _outbox_cap() -> int:
    """Max bytes queued behind a non-draining peer before the
    connection sheds (closes). The writer thread removed the old
    blocking-send backpressure; this cap bounds what replaces it."""
    return int(
        float(os.environ.get("HM_TCP_OUTBOX_MB", "64")) * (1 << 20)
    )


def _ping_s() -> float:
    """Keepalive period; 0 disables. A half-open socket (peer machine
    gone, NAT timeout, stalled reader) is detected within
    2 * HM_NET_PING_S * HM_NET_PING_MISSES seconds instead of at the
    64MB outbox bound."""
    return float(os.environ.get("HM_NET_PING_S", "15"))


def _ping_misses() -> int:
    return int(os.environ.get("HM_NET_PING_MISSES", "3"))


def _accept_pool_n() -> int:
    """Cap on concurrent inbound-handshake workers (legacy stack): an
    accept storm parks behind this pool instead of spawning a thread
    per accepted socket. Each slot is held at most the 10s handshake
    deadline."""
    return int(os.environ.get("HM_TCP_ACCEPT_POOL", "8"))


class TcpDuplex:
    """Object-message duplex over one socket (JSON frames, encrypted by
    default — sodium kx handshake + per-frame ChaCha20-Poly1305 with
    counter nonces, net/secure.py; the reference's noise wrapping,
    src/PeerConnection.ts:36). Inbound buffering rides utils.queue.Queue
    (same never-concurrent / never-reordered guarantees as the rest of
    the stack). HM_TCP_PLAINTEXT=1 disables encryption (both ends must
    agree)."""

    def __init__(
        self,
        sock: socket.socket,
        is_client: bool = False,
        identity: Optional[bytes] = None,
    ) -> None:
        from ..utils.queue import Queue

        self._sock = sock
        # Outbound frames go through a dedicated writer thread, never
        # straight to sendall: inbound dispatch runs synchronously on
        # the reader thread, and a reader that blocks on a full socket
        # buffer while the peer's reader does the same is a distributed
        # send deadlock (both sides wedge mid-burst, replication
        # freezes while the connection still reports open).
        self._outbox: deque = deque()
        self._out_cv = make_condition("net.tcp.outbox")
        self._out_inflight = False  # frame popped but not yet sent
        self._out_bytes = 0
        self._out_cap = _outbox_cap()  # read once: send() is hot
        self._stall_s = float(os.environ.get("HM_TCP_STALL_S", "10"))
        self._last_progress = time.monotonic()  # writer's last sendall
        self._shed = False  # over-cap close: skip the drain wait
        self._writer_dead = False  # writer hit a send error: no drain
        self._rx_eof = False  # peer closed/died: draining is pointless
        self._inbox: "Queue" = Queue("tcp:inbox")
        self._close_cbs: List[Callable[[], None]] = []
        self._lock = make_rlock("net.tcp")
        self.closed = False
        # keepalive: any complete inbound frame is liveness
        self._last_rx = time.monotonic()
        self._ka_stop = threading.Event()
        self._session = None
        self._identity = identity
        if os.environ.get("HM_TCP_PLAINTEXT") != "1":
            from .secure import SecureSession

            self._session = SecureSession(is_client)
            try:
                self._handshake()
            except (OSError, ValueError) as e:
                log("net:tcp", f"handshake failed: {e}")
                self.close()
                return
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        self._writer = threading.Thread(
            target=self._write_loop, daemon=True
        )
        self._writer.start()
        ping = _ping_s()
        if ping > 0:
            threading.Thread(
                target=self._keepalive_loop, args=(ping, _ping_misses()),
                daemon=True,
            ).start()

    @property
    def channel_binding(self) -> Optional[bytes]:
        return self._session.channel_binding if self._session else None

    @property
    def peer_identity(self) -> Optional[str]:
        return self._session.peer_identity if self._session else None

    def _handshake(self) -> None:
        """Exchange ephemeral public keys (the only plaintext frames:
        one flags byte + 32-byte key), then — when BOTH sides offered
        auth — one encrypted ed25519 auth frame each way over the
        transcript (net/secure.py). A peer that cannot sign the
        transcript (MITM key substitution) fails closed.

        Negotiation: the flags byte advertises whether this side will
        send an auth frame (bit 0). Auth runs only when both offer it;
        a mixed pair (identity-less peer, HM_NET_AUTH=0, legacy 32-byte
        handshake) falls back to the anonymous session — unless
        HM_NET_AUTH=require, which drops unauthenticated peers."""
        mode = os.environ.get("HM_NET_AUTH", "1")
        offer = self._identity is not None and mode != "0"
        if mode == "require" and self._identity is None:
            raise ValueError("HM_NET_AUTH=require but no identity set")
        self._sock.settimeout(10)
        pk = self._session.handshake_bytes
        frame = bytes([1 if offer else 0]) + pk
        with lockdep.blocking("socket_send", "handshake"):
            self._sock.sendall(_HDR.pack(len(frame)) + frame)
        hdr = self._read_exact(_HDR.size)
        if hdr is None:
            raise OSError("peer closed during handshake")
        (size,) = _HDR.unpack(hdr)
        if size == 33:
            flags = self._read_exact(1)
            if flags is None:
                raise OSError("peer closed during handshake")
            peer_offers = bool(flags[0] & 1)
        elif size == 32:
            peer_offers = False  # legacy anonymous endpoint
        else:
            raise ValueError(f"bad handshake frame size {size}")
        peer_pk = self._read_exact(32)
        if peer_pk is None:
            raise OSError("peer closed during handshake")
        self._session.complete(peer_pk)
        if offer and peer_offers:
            auth = self._session.encrypt(
                self._session.auth_frame(self._identity)
            )
            with lockdep.blocking("socket_send", "auth"):
                self._sock.sendall(_HDR.pack(len(auth)) + auth)
            hdr = self._read_exact(_HDR.size)
            if hdr is None:
                raise OSError("peer closed during auth")
            (size,) = _HDR.unpack(hdr)
            if size > 1024:
                raise ValueError(f"bad auth frame size {size}")
            wire = self._read_exact(size)
            if wire is None:
                raise OSError("peer closed during auth")
            frame = self._session.decrypt(wire)
            if frame is None or not self._session.verify_auth(frame):
                raise ValueError(
                    "peer identity authentication FAILED "
                    "(MITM key substitution or signature over a "
                    "different transcript)"
                )
        elif mode == "require":
            raise ValueError(
                "peer did not offer identity auth (HM_NET_AUTH=require)"
            )
        self._sock.settimeout(None)

    def on_message(self, cb: Callable[[Any], None]) -> None:
        self._inbox.subscribe(cb)

    def on_close(self, cb: Callable[[], None]) -> None:
        """Register a close listener. Multiple listeners are supported
        (the connection stack AND the redial supervisor both watch);
        a listener registered after close fires immediately."""
        fire_now = False
        with self._lock:
            if self.closed:
                fire_now = True  # closed before anyone registered
            else:
                self._close_cbs.append(cb)
        if fire_now:
            cb()

    def _keepalive_loop(self, period: float, miss_budget: int) -> None:
        """Ping when the inbound side goes quiet; shed after the miss
        budget. A half-open connection (peer machine gone, NAT timeout,
        reader stalled with the socket open) looks healthy to the
        writer until the outbox cap — this closes it in seconds: no
        inbound frame for `period` sends a ping, `miss_budget`
        consecutive quiet periods close the connection (and the redial
        supervisor, if any, dials a fresh one)."""
        misses = 0
        last_probe = float("-inf")
        while not self._ka_stop.wait(period):
            if self.closed:
                return
            now = time.monotonic()
            # a miss is "nothing arrived since my last probe" — NOT
            # "idle at check time": a pong that lands just after a
            # check must reset the budget even though the link is idle
            if self._last_rx >= last_probe:
                misses = 0
            else:
                misses += 1
                # shed ON the Nth unanswered probe (>=, not >): with
                # probes at period P the shed lands by (M+1)*P, inside
                # the documented 2*P*M bound for every M >= 1
                if misses >= miss_budget:
                    log(
                        "net:tcp",
                        f"keepalive: {misses} unanswered probes "
                        f"({period}s apart): half-open, shedding",
                    )
                    # a peer that answers no pings is by definition
                    # not draining: skip close()'s bounded drain wait
                    _M_SHEDS.add(1)
                    self._shed = True
                    self.close()
                    return
            if now - self._last_rx >= period:
                self.send({_PING: misses})
                _M_PINGS.add(1)
                last_probe = now

    def send(self, msg: Any) -> None:
        """Queue a frame for the writer thread. Never blocks on the
        socket — see _outbox above. The protocol's ack-paced block
        streams bound most of what piles up here, but patch/gossip
        frames are not ack-paced: a peer that stops reading while its
        socket stays open would otherwise grow the queue without limit.
        Past HM_TCP_OUTBOX_MB *with the writer stalled* (no completed
        frame for HM_TCP_STALL_S — a healthy peer absorbing a large
        burst keeps making progress and is never shed), or past 4x the
        cap regardless of progress (the hard memory bound: a slow-drip
        peer must not grow the queue forever), the connection sheds
        (closes); the peer redials and resyncs from its cursor."""
        if self.closed:
            return
        data = json.dumps(msg, separators=(",", ":")).encode("utf-8")
        with self._out_cv:
            if not self._outbox and not self._out_inflight:
                # idle -> active: the stall clock must measure from the
                # start of THIS burst, not from the last pre-idle frame
                self._last_progress = time.monotonic()
            self._outbox.append(data)
            self._out_bytes += len(data)
            over = self._out_bytes > self._out_cap
            self._out_cv.notify()
        if over and (
            self._out_bytes > 4 * self._out_cap
            or time.monotonic() - self._last_progress > self._stall_s
        ):
            log(
                "net:tcp",
                f"outbox over cap ({self._out_bytes}B) with a stalled "
                "writer: peer not draining, shedding connection",
            )
            _M_SHEDS.add(1)
            self._shed = True
            self.close()

    def _write_loop(self) -> None:
        while True:
            with self._out_cv:
                # the previous frame (if any) is fully on the wire only
                # once we get back here: signal close()'s drain AFTER
                # sendall, not when the frame is merely popped
                self._out_inflight = False
                if not self._outbox:
                    self._out_cv.notify_all()  # close() may be draining
                while not self._outbox and not self.closed:
                    self._out_cv.wait()
                if not self._outbox:  # closed and drained
                    return
                data = self._outbox.popleft()
                self._out_bytes -= len(data)
                self._out_inflight = True
            try:
                # nonce counters are per-direction and strictly ordered:
                # the single writer thread orders encryption and writes
                if self._session is not None:
                    data = self._session.encrypt(data)
                with lockdep.blocking("socket_send", "frame"):
                    self._sock.sendall(_HDR.pack(len(data)) + data)
                _M_FRAMES_TX.add(1)
                _M_BYTES_TX.add(_HDR.size + len(data))
                self._last_progress = time.monotonic()
            except OSError:
                # signal BEFORE close(): a concurrent closer may be
                # waiting on the drain cv while holding self._lock —
                # the frame is lost and the outbox will never drain, so
                # wake it now instead of letting it burn its deadline
                with self._out_cv:
                    self._out_inflight = False
                    self._writer_dead = True
                    self._out_cv.notify_all()
                self.close()
                return

    def _read_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _read_loop(self) -> None:
        while not self.closed:
            hdr = self._read_exact(_HDR.size)
            if hdr is None:
                break
            (size,) = _HDR.unpack(hdr)
            if size > _MAX_FRAME:
                log("net:tcp", f"oversized frame {size}, closing")
                break
            payload = self._read_exact(size)
            if payload is None:
                break
            _M_FRAMES_RX.add(1)
            _M_BYTES_RX.add(_HDR.size + size)
            self._last_rx = time.monotonic()  # any frame is liveness
            if self._session is not None:
                payload = self._session.decrypt(payload)
                if payload is None:
                    # authentication failure = tampering or desync:
                    # fatal, never skippable
                    log("net:tcp", "ciphertext auth failed, closing")
                    break
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
            try:
                self._inbox.push(msg)
            except Exception as e:  # subscriber bug must not kill reader
                log("net:tcp", f"inbound handler error: {e}")
                break
        self._rx_eof = True
        self.close()

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            # orderly close loses nothing: give the writer a bounded
            # window to drain queued frames. Skip when draining cannot
            # succeed or has no point: close() running ON the writer
            # after a send error (socket dead), an over-cap shed (peer
            # by definition not draining), a writer that already died
            # in sendall, or a reader EOF (the peer is gone and will
            # never read queued frames)
            if (
                not self._shed
                and not self._rx_eof
                and threading.current_thread()
                is not getattr(self, "_writer", None)
            ):
                deadline = 5.0
                with self._out_cv:
                    while (
                        (self._outbox or self._out_inflight)
                        and not self._writer_dead
                        and not self._rx_eof  # peer died mid-drain
                        and deadline > 0
                    ):
                        t0 = time.monotonic()
                        self._out_cv.wait(min(deadline, 0.2))
                        deadline -= time.monotonic() - t0
            self.closed = True
            listeners = list(self._close_cbs)
        self._ka_stop.set()
        with self._out_cv:
            self._out_cv.notify_all()  # writer exits
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        for cb in listeners:
            cb()


class TcpSwarm(Swarm):
    """Accepts inbound connections; dials peers via `connect(addr)`.

    Outbound addresses are owned by a `SessionSupervisor`
    (net/resilience.py): `connect` registers the address and returns
    immediately; the dial + handshake run off-thread, a failed dial
    backs off and retries instead of raising, and a dropped connection
    redials until its ConnectionDetails recorded `reconnect(False)` or
    `ban()`. Banned peer identities are also refused at ACCEPT time —
    a banned peer's inbound redial used to be accepted unconditionally."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        identity: Optional[bytes] = None,
    ) -> None:
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(16)
        self.address: Tuple[str, int] = self._server.getsockname()
        self.join_options: dict = {}
        self._cb: Optional[Callable] = None
        self._duplexes: List[TcpDuplex] = []
        self._dlock = make_lock("net.tcp.server")
        self._destroyed = False
        self._identity: Optional[bytes] = identity
        self._banned_ids: set = set()  # proven peer identities
        self._banned_addrs: set = set()  # outbound dial addresses
        self._banned_hosts: set = set()  # anonymous-peer fallback
        # transport twin selector: =1 multiplexes every connection of
        # the process onto the shared net/aio.py loop (bit-compatible
        # on the wire with the =0 thread-per-connection stack)
        self._async = os.environ.get("HM_NET_ASYNC", "0") == "1"
        self._loop = None
        if self._async:
            from .aio import get_loop

            self._loop = get_loop()
            self.supervisor = SessionSupervisor(
                dial=self._dial_async,
                deliver=self._deliver_outbound,
                banned=lambda addr: (
                    addr in self._banned_addrs
                    or addr[0] in self._banned_hosts
                ),
                connector=self._loop,
            )
        else:
            self.supervisor = SessionSupervisor(
                dial=self._dial,
                deliver=self._deliver_outbound,
                banned=lambda addr: (
                    addr in self._banned_addrs
                    or addr[0] in self._banned_hosts
                ),
            )
            # bounded inbound-handshake pool (legacy stack): an accept
            # storm queues here instead of spawning a thread per accept
            self._accept_cv = make_condition("net.tcp.accept")
            self._accept_q: deque = deque()
            self._accept_idle = 0
            self._accept_workers = 0
        self._accepter = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accepter.start()

    def set_identity(self, seed: Optional[bytes]) -> None:
        """Static ed25519 identity for the authenticated handshake
        (Network.set_swarm passes the repo keypair's seed). The accept
        loop runs from construction, so an inbound connection can race
        this call and handshake anonymously; _handle_inbound re-checks
        after the handshake and drops such connections (the peer
        reconnects into the authenticated path). Passing the identity
        to the constructor avoids the window entirely."""
        self._identity = seed

    def _accept_loop(self) -> None:
        while not self._destroyed:
            try:
                sock, _addr = self._server.accept()
            except OSError:
                break
            if self._async:
                # the handshake runs as loop callbacks — nothing to
                # park a thread on; checks resume in _inbound_ready
                self._accept_async(sock)
                continue
            # handshake per connection off the listener thread, but
            # BOUNDED: an accept storm (or a dialer that stalls inside
            # the 10s handshake window) queues here instead of
            # spawning an unbounded thread per accept
            spawn = False
            with self._accept_cv:
                self._accept_q.append(sock)
                if self._accept_idle > 0:
                    self._accept_cv.notify()
                elif self._accept_workers < _accept_pool_n():
                    self._accept_workers += 1
                    spawn = True
            if spawn:
                threading.Thread(
                    target=self._accept_worker, daemon=True
                ).start()

    def _accept_worker(self) -> None:
        while True:
            with self._accept_cv:
                while not self._accept_q:
                    if self._destroyed:
                        return
                    self._accept_idle += 1
                    self._accept_cv.wait()
                    self._accept_idle -= 1
                sock = self._accept_q.popleft()
            try:
                self._handle_inbound(sock)
            except Exception as e:  # one bad peer must not kill a slot
                log("net:tcp", f"inbound handshake error: {e}")
                try:
                    sock.close()
                except OSError:
                    pass

    def _accept_async(self, sock: socket.socket) -> None:
        """Inbound path under HM_NET_ASYNC=1: the same checks as
        _handle_inbound, split around the loop-driven handshake."""
        from .aio import AioDuplex

        try:
            peer_host = sock.getpeername()[0]
        except OSError:
            peer_host = None
        if peer_host is not None and peer_host in self._banned_hosts:
            log("net:tcp", f"refusing inbound from banned host {peer_host}")
            sock.close()
            return
        ident = self._identity
        AioDuplex(
            sock,
            is_client=False,
            identity=ident,
            on_ready=lambda d, exc: self._inbound_ready(d, exc, ident),
        )

    def _inbound_ready(self, duplex, exc, ident) -> None:
        """Dispatch-worker continuation of _accept_async (fires once
        per accepted connection when its handshake settles)."""
        if exc is not None:
            return  # the duplex is already tearing itself down
        if ident is None and self._identity is not None:
            # set_identity landed mid-handshake: this connection went
            # through anonymously and would bypass identity pinning —
            # drop it; the dialer retries into the authenticated path
            log("net:tcp", "dropping pre-identity inbound connection")
            duplex.close()
            return
        if (
            duplex.peer_identity is not None
            and duplex.peer_identity in self._banned_ids
        ):
            log(
                "net:tcp",
                f"refusing inbound redial from banned peer "
                f"{duplex.peer_identity[:6]}",
            )
            duplex.close()
            return
        self._track(duplex)
        if not duplex.closed and self._cb is not None:
            details = ConnectionDetails(client=False)
            details._on_ban = lambda: self._record_ban(duplex)
            self._cb(duplex, details)

    def _track(self, duplex: TcpDuplex) -> None:
        """Track a live duplex; closed duplexes LEAVE the list (a
        long-lived swarm under churn must not grow without bound). A
        duplex tracked after destroy() began — an inbound redial can
        complete its handshake between destroy's flag and its duplex
        snapshot — is closed here instead of living as a zombie on a
        destroyed swarm."""
        with self._dlock:
            self._duplexes.append(duplex)
            dead = self._destroyed
        duplex.on_close(lambda: self._untrack(duplex))
        if dead:
            duplex.close()

    def _untrack(self, duplex: TcpDuplex) -> None:
        with self._dlock:
            try:
                self._duplexes.remove(duplex)
            except ValueError:
                pass

    def _record_ban(self, duplex: TcpDuplex, address=None) -> None:
        """ConnectionDetails.ban() fired: sever the live connection NOW
        and refuse this peer from then on — its proven identity at
        accept AND dial time; on anonymous transports (no identity
        auth) the peer HOST is the only stable key, so the whole host
        is refused (blunt by necessity — run identity auth for
        per-peer precision). Outbound dial addresses are banned too."""
        ident = duplex.peer_identity
        if ident is not None:
            self._banned_ids.add(ident)
        else:
            try:
                self._banned_hosts.add(duplex._sock.getpeername()[0])
            except OSError:
                pass  # already disconnected: nothing stable to record
        if address is not None:
            self._banned_addrs.add(tuple(address))
        log("net:tcp", f"banned peer id={str(ident)[:6]} addr={address}")
        duplex.close()  # a ban is effective immediately, not at the
        # next natural drop (keepalive would keep a healthy banned
        # link alive indefinitely)

    def _handle_inbound(self, sock: socket.socket) -> None:
        try:
            peer_host = sock.getpeername()[0]
        except OSError:
            peer_host = None
        if peer_host is not None and peer_host in self._banned_hosts:
            log("net:tcp", f"refusing inbound from banned host {peer_host}")
            sock.close()
            return
        ident = self._identity
        duplex = TcpDuplex(sock, is_client=False, identity=ident)
        if ident is None and self._identity is not None:
            # set_identity landed mid-handshake: this connection went
            # through anonymously and would bypass identity pinning —
            # drop it; the dialer retries into the authenticated path
            log("net:tcp", "dropping pre-identity inbound connection")
            duplex.close()
            return
        if (
            duplex.peer_identity is not None
            and duplex.peer_identity in self._banned_ids
        ):
            log(
                "net:tcp",
                f"refusing inbound redial from banned peer "
                f"{duplex.peer_identity[:6]}",
            )
            duplex.close()
            return
        self._track(duplex)
        if not duplex.closed and self._cb is not None:
            details = ConnectionDetails(client=False)
            details._on_ban = lambda: self._record_ban(duplex)
            self._cb(duplex, details)

    def _dial(self, address: Tuple[str, int]) -> TcpDuplex:
        """One dial + handshake (supervisor thread). Raises OSError on
        failure so the supervisor schedules a backoff retry."""
        sock = socket.create_connection(address, timeout=dial_timeout_s())
        sock.settimeout(None)
        duplex = TcpDuplex(sock, is_client=True, identity=self._identity)
        if duplex.closed:
            raise OSError("handshake failed")
        if (
            duplex.peer_identity is not None
            and duplex.peer_identity in self._banned_ids
        ):
            duplex.close()
            self._banned_addrs.add(address)  # stop the session too
            raise OSError("peer identity is banned")
        self._track(duplex)
        return duplex

    def _dial_async(self, address: Tuple[str, int], cb) -> None:
        """Async-mode dial primitive (supervisor connector mode): a
        non-blocking connect + loop-driven handshake; `cb(duplex, exc)`
        fires exactly once on a dispatch worker."""
        from .aio import AioDuplex

        address = tuple(address)

        def ready(duplex, exc) -> None:
            if exc is not None:
                duplex.close()
                cb(None, OSError(f"handshake failed: {exc}"))
                return
            if (
                duplex.peer_identity is not None
                and duplex.peer_identity in self._banned_ids
            ):
                duplex.close()
                self._banned_addrs.add(address)  # stop the session too
                cb(None, OSError("peer identity is banned"))
                return
            self._track(duplex)
            cb(duplex, None)

        def dialed(sock, exc) -> None:  # loop thread: keep it cheap
            if exc is not None:
                cb(None, exc)
                return
            AioDuplex(
                sock,
                is_client=True,
                identity=self._identity,
                on_ready=ready,
            )

        self._loop.dial(address, dial_timeout_s(), dialed)

    def _deliver_outbound(
        self, duplex: TcpDuplex, details: ConnectionDetails
    ) -> None:
        try:
            address = duplex._sock.getpeername()
        except OSError:  # died between dial and deliver
            address = None
        details._on_ban = lambda: self._record_ban(duplex, address)
        if not duplex.closed and self._cb is not None:
            self._cb(duplex, details)

    def connect(self, address: Tuple[str, int]):
        """Supervised dial: registers `address` with the session
        supervisor and returns its Session immediately. A failed dial
        enqueues a jittered retry and surfaces through the
        supervisor's status hook (`swarm.supervisor.on_status`)
        instead of raising into the caller; a dropped connection
        redials until `reconnect(False)`/`ban()`."""
        return self.supervisor.connect(tuple(address))

    # discovery is external (reference: hyperswarm); topics are no-ops here
    def join(self, discovery_id: str, options=None) -> None:
        # topology is explicit (connect()); per-id discovery — and so
        # the announce/lookup asymmetry — doesn't apply, matching
        # hyperswarm-with-direct-connections semantics. Options are
        # recorded for introspection.
        from .swarm import DEFAULT_JOIN

        self.join_options[discovery_id] = options or DEFAULT_JOIN

    def leave(self, discovery_id: str) -> None:
        self.join_options.pop(discovery_id, None)

    def on_connection(self, cb) -> None:
        self._cb = cb

    def destroy(self) -> None:
        with self._dlock:
            self._destroyed = True  # _track closes later arrivals
        self.supervisor.stop()  # no redial races the teardown below
        try:
            self._server.close()
        except OSError:
            pass
        if not self._async:
            # wake parked handshake workers (they see _destroyed and
            # exit) and refuse the sockets still queued behind them
            with self._accept_cv:
                pending = list(self._accept_q)
                self._accept_q.clear()
                self._accept_cv.notify_all()
            for sock in pending:
                try:
                    sock.close()
                except OSError:
                    pass
        with self._dlock:
            live = list(self._duplexes)
        for d in live:
            d.close()
