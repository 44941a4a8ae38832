"""NetworkPeer — one logical peer; dedups simultaneous connections.

Parity: reference src/NetworkPeer.ts:8-106 — when both sides dial each
other, the side whose id sorts higher has *authority* (reference
weHaveAuthority, :41-43): with an already-confirmed connection it closes
the duplicate (reference :52-55); otherwise it picks the incoming one and
sends ConfirmConnection; the other side closes everything else.

Lifecycle callbacks fire per connection, not once per peer: every time a
new connection becomes active, `on_active(peer)` lets the network layer
re-wire channels on it (the reference's connectionQ re-subscription,
src/NetworkPeer.ts:83-85); `on_inactive(peer)` fires when the active
connection is lost without a replacement, so replication state can reset.

The port's copy of hypermerge_tpu/net/peer.py.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from ..analysis.lockdep import make_lock
from .. import msgs
from ..utils.debug import log
from .connection import PeerConnection


class NetworkPeer:
    def __init__(
        self,
        self_id: str,
        peer_id: str,
        on_active: Callable[["NetworkPeer"], None],
        on_inactive: Optional[Callable[["NetworkPeer"], None]] = None,
    ) -> None:
        self.self_id = self_id
        self.id = peer_id
        self._on_active = on_active
        self._on_inactive = on_inactive
        self.connection: Optional[PeerConnection] = None
        self._pending: List[PeerConnection] = []
        # guards _pending: mutated from accept/supervisor threads
        # (add_connection) AND reader threads (close-driven prune)
        self._plock = make_lock("net.peer")

    @property
    def we_have_authority(self) -> bool:
        return self.self_id > self.id

    @property
    def is_connected(self) -> bool:
        return self.connection is not None and self.connection.is_open

    def add_connection(self, conn: PeerConnection) -> None:
        conn.network_bus.subscribe(lambda msg: self._on_bus(conn, msg))
        if self.we_have_authority:
            if self.is_connected:
                # duplicate dial: keep the confirmed connection
                conn.close()
                return
            self._confirm(conn)
            conn.network_bus.send(msgs.confirm_connection_msg(conn.id))
        else:
            # churn hygiene: dead connections must LEAVE pending, or a
            # reconnect after a lost ConfirmConnection finds
            # len(pending) > 1 forever and never optimistically wires
            # the only live connection
            with self._plock:
                self._pending = [c for c in self._pending if c.is_open]
                self._pending.append(conn)
                use_now = (
                    self.connection is None and len(self._pending) == 1
                )
            conn.on_close(lambda: self._prune_pending(conn))
            if use_now:
                # optimistically use the first connection until (unless)
                # the authority confirms a different one
                self._use(conn)

    def _prune_pending(self, conn: PeerConnection) -> None:
        with self._plock:
            try:
                self._pending.remove(conn)
            except ValueError:
                pass

    def try_send(self, channel: str, msg: Any) -> bool:
        """Snapshot-send on the active connection. THE send idiom for
        churn safety: `peer.connection` can flip to None between an
        `is_connected` check and the send, so callers must not
        check-then-use it themselves. False when no live connection
        (the dropped frame is recovered by the replacement
        connection's resync)."""
        conn = self.connection
        if conn is not None and conn.is_open:
            conn.open_channel(channel).send(msg)
            return True
        return False

    def _on_bus(self, conn: PeerConnection, msg) -> None:
        if isinstance(msg, dict) and msg.get("type") == "ConfirmConnection":
            # connection ids are side-local; the authority sends the
            # confirmation ON the connection it chose, so the arrival
            # connection is the confirmed one
            self._confirm(conn)

    def _confirm(self, conn: PeerConnection) -> None:
        with self._plock:
            others = [c for c in self._pending if c is not conn]
            self._pending = []
        for other in others:
            if other.is_open:
                other.close()
        self._use(conn)

    def _use(self, conn: PeerConnection) -> None:
        if self.connection is conn:
            return
        old = self.connection
        self.connection = conn
        conn.on_close(lambda: self._on_conn_close(conn))
        if old is not None and old.is_open and old is not conn:
            old.close()
        if conn.is_open:
            self._on_active(self)

    def _on_conn_close(self, conn: PeerConnection) -> None:
        if self.connection is conn:
            self.connection = None
            log("network:peer", f"connection to {self.id[:6]} closed")
            if self._on_inactive is not None:
                self._on_inactive(self)

    def close(self) -> None:
        if self.connection is not None:
            self.connection.close()
        with self._plock:
            pending = list(self._pending)
            self._pending = []
        for c in pending:
            if c.is_open:
                c.close()
