"""PeerConnection — one transport with named multiplexed channels.

Parity: reference src/PeerConnection.ts:14-86 + src/MessageBus.ts — one
socket carrying noise-encrypted multiplexed substreams with a
`NetworkBus` channel always open, and channels opened by the remote side
first buffering until locally opened (the reference's pending-channel
hack, src/PeerConnection.ts:64-73).

Encryption lives at the Duplex transport layer: the in-memory test pair
needs none; the TCP adapter (net/tcp.py) encrypts every frame under an
X25519 kx handshake + ChaCha20-Poly1305 (net/secure.py, libsodium via
native/ with a pure fallback) — the reference's noise wrapping
(src/PeerConnection.ts:36).

The port's copy of hypermerge_tpu/net/connection.py.
"""

from __future__ import annotations

import threading
import uuid
from collections import deque
from typing import Any, Callable, Dict, Optional

from ..analysis.lockdep import make_lock
from ..utils.queue import Queue
from .duplex import Duplex

NETWORK_BUS = "NetworkBus"


class Channel:
    def __init__(self, conn: "PeerConnection", name: str) -> None:
        self._conn = conn
        self.name = name
        self.receive_q: Queue = Queue(f"ch:{name}")

    def send(self, msg: Any) -> None:
        self._conn._send_on(self.name, msg)

    def subscribe(self, cb: Callable[[Any], None]) -> None:
        self.receive_q.subscribe(cb)


class PeerConnection:
    def __init__(self, duplex: Duplex, is_client: bool) -> None:
        self.id = uuid.uuid4().hex
        self.is_client = is_client
        self._duplex = duplex
        self._channels: Dict[str, Channel] = {}
        self.is_open = True
        self._close_listeners = []
        self._close_lock = make_lock("net.conn")
        self.network_bus = self.open_channel(NETWORK_BUS)
        duplex.on_message(self._on_raw)
        duplex.on_close(self._on_transport_close)

    @property
    def peer_identity(self):
        """The peer's transport-proven ed25519 identity (base58), or
        None on unauthenticated transports (in-memory pairs, legacy
        anonymous TCP). See net/secure.py auth frames."""
        return getattr(self._duplex, "peer_identity", None)

    @property
    def channel_binding(self):
        """Session-unique exporter over the encrypted transport's
        ephemeral handshake transcript (None on plaintext transports).
        Replication MACs it into capability proofs so a proof minted on
        one connection is worthless on any other."""
        return getattr(self._duplex, "channel_binding", None)

    def open_channel(self, name: str) -> Channel:
        ch = self._channels.get(name)
        if ch is None:
            ch = Channel(self, name)
            self._channels[name] = ch
        return ch

    def _send_on(self, name: str, msg: Any) -> None:
        if self.is_open:
            self._duplex.send({"ch": name, "m": msg})

    def _on_raw(self, raw: Any) -> None:
        try:
            name, msg = raw["ch"], raw["m"]
        except (TypeError, KeyError):
            return  # malformed frame: drop
        # channels opened by the remote first buffer in their queue
        self.open_channel(name).receive_q.push(msg)

    def on_close(self, cb: Callable[[], None]) -> None:
        """A listener registered after the connection already closed
        fires immediately: under churn the transport can die between a
        caller's `is_open` check and its registration, and a silently
        dropped listener leaves the peer wired to a dead connection
        (NetworkPeer would never fire on_inactive -> replication never
        resets -> the redialed connection renegotiates against stale
        associations). The lock makes check-then-append atomic against
        the close path's listener snapshot — without it, a listener
        appended between the snapshot and is_open flipping is silently
        lost, the exact failure this method exists to prevent."""
        with self._close_lock:
            if self.is_open:
                self._close_listeners.append(cb)
                return
        cb()

    def _on_transport_close(self) -> None:
        with self._close_lock:
            if not self.is_open:
                return
            self.is_open = False
            listeners = list(self._close_listeners)
        for cb in listeners:
            cb()

    def close(self) -> None:
        with self._close_lock:
            if not self.is_open:
                return
            self.is_open = False
            listeners = list(self._close_listeners)
        self._duplex.close()
        for cb in listeners:
            cb()
