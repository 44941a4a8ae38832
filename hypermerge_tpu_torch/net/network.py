"""Network — swarm lifecycle, peer handshake, message routing.

Parity: reference src/Network.ts:7-112 (join/leave sets, connection
handshake with Info exchange + self-connect rejection) +
src/MessageRouter.ts (typed channels per peer) wired into the repo hub:
cursor/clock gossip and ephemeral doc messages ride the "Msgs" channel
(reference channel 'HypermergeMessages', src/RepoBackend.ts:113), feed
sync rides "Replication" (net/replication.py).

The port's copy of hypermerge_tpu/net/network.py.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, Optional, Set

from ..analysis.lockdep import make_rlock
from .. import msgs, telemetry
from ..crdt import clock as clockmod
from ..utils.debug import log
from .connection import PeerConnection
from .duplex import Duplex
from .peer import NetworkPeer
from .replication import ReplicationManager
from .swarm import DEFAULT_JOIN, ConnectionDetails, JoinOptions, Swarm

MSGS_CHANNEL = "Msgs"

# delta cursor gossip (HM_CURSOR_DELTA): steady-state frame sizes.
# full_tx counts whole-map frames (first frame per connection+doc and
# every repair-path send), delta_tx counts advanced-actors-only frames,
# suppressed counts gossip rounds skipped entirely because nothing
# advanced since the last frame this connection acked into the ledger.
_M_CUR_FULL = telemetry.counter("net.cursor.full_tx")
_M_CUR_DELTA = telemetry.counter("net.cursor.delta_tx")
_M_CUR_SUPPRESSED = telemetry.counter("net.cursor.suppressed")


def _cursor_delta_on() -> bool:
    """Delta cursor frames: steady-state gossip sends only the actors
    whose clock advanced since the last frame sent on this connection
    (full frame on (re)connect). Receiver-safe by construction — the
    receive path merges max-wins/union, so a partial map is just a
    small merge. =0 keeps the full-frame twin bit-compatible."""
    return os.environ.get("HM_CURSOR_DELTA", "1") == "1"


class Network:
    def __init__(self, backend) -> None:
        self.backend = backend
        self.self_id: str = backend.id
        self.swarm: Optional[Swarm] = None
        self.join_options: JoinOptions = DEFAULT_JOIN
        self.joined: Set[str] = set()
        self.pending_joins: Set[str] = set()
        self.peers: Dict[str, NetworkPeer] = {}
        self.closed_connection_count = 0
        self._lock = make_rlock("net.network")
        # bounded gossip relay (net/discovery/gossip.py): the
        # REPAIRABLE broadcast paths — replication live tails, cursor
        # gossip — target at most HM_GOSSIP_FANOUT peers per doc;
        # anti-entropy sweeps (and ephemeral doc messages, which have
        # no repair path) stay unsampled so convergence is bounded
        from .discovery.gossip import GossipSampler

        self.gossip = GossipSampler()
        self.replication = ReplicationManager(
            backend.feeds, self._on_feed_discovery, sampler=self.gossip
        )
        # sweep-time cursor repair: the anti-entropy pass re-sends doc
        # cursors a sampled gossip may have skipped (None for minimal
        # test backends that carry no cursor store)
        self.replication.on_sweep = getattr(
            backend, "send_sweep_cursors", None
        )
        # service plane (serve/overload.py): under BROWNOUT+ the
        # anti-entropy sweep skips its period and the gossip relay
        # thins its fanout — background repair yields to foreground
        # reads, bounded by the next healthy sweep
        ctl = getattr(backend, "overload", None)
        if ctl is not None:
            self.replication.overload_ctl = ctl
            self.gossip.overload_ctl = ctl

    # ------------------------------------------------------------------
    # swarm lifecycle

    def set_swarm(
        self, swarm: Swarm, join_options: Optional[JoinOptions] = None
    ) -> None:
        if self.swarm is not None:
            raise RuntimeError("swarm already set")
        fault_spec = os.environ.get("HM_FAULT")
        if fault_spec:
            # fault-injection soak mode: every connection of every
            # swarm rides a seeded FaultDuplex (net/faults.py), ticks
            # advanced on a wall-clock timer
            from .faults import FaultSwarm, parse_fault_spec

            swarm = FaultSwarm(swarm, parse_fault_spec(fault_spec))
            swarm.start_ticker()
            log("network", f"HM_FAULT active: {fault_spec}")
        self.swarm = swarm
        # the repo's swarm posture (reference Network.ts:22 — every
        # join uses it; server-ish repos announce, clients look up)
        self.join_options = join_options or DEFAULT_JOIN
        # authenticated transport: hand the repo's static ed25519 seed to
        # the swarm so every connection's handshake signs the ephemeral
        # transcript (net/secure.py auth; reference noise-peer static
        # keys, src/PeerConnection.ts:36). Readonly repos (no secret) and
        # swarms without identity support stay anonymous.
        set_id = getattr(swarm, "set_identity", None)
        if set_id is not None:
            set_id(self.backend.identity_seed())
        # demand-driven discovery (DhtSwarm): a lookup walk + dial only
        # while NO verified peer replicates the id — one connection
        # replicates every shared feed, so satisfied ids spend no
        # walk/dial budget, and a doc whose peers all churned away
        # flips back to needing one
        set_need = getattr(swarm, "set_need_hook", None)
        if set_need is not None:
            set_need(
                lambda did: not self.replication.peers_with_feed(did)
            )
        # push-seed receiver (HM_DHT_PUSH_SEED): a verified seed record
        # from the DHT names a doc this node is among the k-closest
        # for — open it so the creator stops serving the entire
        # cold-join first wave alone
        set_seed = getattr(swarm, "set_seed_hook", None)
        opener = getattr(self.backend, "open", None)
        if set_seed is not None and opener is not None:
            set_seed(opener)
        swarm.on_connection(self._on_connection)
        for did in self.backend.feeds.known_discovery_ids():
            self.join(did)
        for did in list(self.pending_joins):
            self.join(did)

    def join(
        self, discovery_id: str,
        options: Optional[JoinOptions] = None,
    ) -> None:
        if self.swarm is None:
            self.pending_joins.add(discovery_id)
            return
        with self._lock:
            if discovery_id in self.joined:
                return
            self.joined.add(discovery_id)
        self.swarm.join(discovery_id, options or self.join_options)

    def leave(self, discovery_id: str) -> None:
        with self._lock:
            self.joined.discard(discovery_id)
        if self.swarm is not None:
            self.swarm.leave(discovery_id)

    # ------------------------------------------------------------------
    # connections

    def _on_connection(
        self, duplex: Duplex, details: ConnectionDetails
    ) -> None:
        conn = PeerConnection(duplex, is_client=details.client)
        state = {"done": False}

        def on_info(msg: Any) -> None:
            if state["done"] or not isinstance(msg, dict):
                return
            if msg.get("type") != "Info":
                return
            state["done"] = True
            timer = state.pop("timer", None)
            if timer is not None:  # reaper thread retires on success
                timer.cancel()
            # hand the bus off to the NetworkPeer (single-subscriber
            # queue); anything arriving in between buffers
            conn.network_bus.receive_q.unsubscribe()
            peer_id = msg.get("peerId")
            if peer_id == self.self_id:
                log("network", "rejecting self-connection")
                details.reconnect(False)
                conn.close()
                return
            # identity pinning: when the transport authenticated the
            # peer (net/secure.py auth frames), the repo id it CLAIMS
            # must be the identity it PROVED — otherwise any
            # authenticated peer could impersonate another repo
            proven = conn.peer_identity
            if proven is not None and peer_id != proven:
                log(
                    "network",
                    f"rejecting peer: claimed id {str(peer_id)[:6]} != "
                    f"authenticated identity {proven[:6]}",
                )
                conn.close()
                return
            self._add_peer_connection(peer_id, conn)

        conn.network_bus.subscribe(on_info)
        conn.network_bus.send(msgs.info_msg(self.self_id))
        conn.on_close(self._count_close)
        # half-wired reaper: a connection whose Info exchange never
        # completes (the peer's frame lost to a faulty middlebox or
        # injected fault) must not idle forever behind healthy
        # keepalives — close it so the supervised redial renegotiates
        # from scratch
        timeout = float(os.environ.get("HM_INFO_TIMEOUT_S", "20"))
        if timeout > 0:
            def reap() -> None:
                if not state["done"] and conn.is_open:
                    log(
                        "network",
                        "Info exchange timed out: closing "
                        "half-wired connection",
                    )
                    conn.close()

            timer = threading.Timer(timeout, reap)
            timer.daemon = True
            state["timer"] = timer
            timer.start()
            conn.on_close(timer.cancel)
            if state["done"]:  # Info landed before the timer stored
                timer.cancel()

    def _count_close(self) -> None:
        self.closed_connection_count += 1

    def _add_peer_connection(
        self, peer_id: str, conn: PeerConnection
    ) -> None:
        with self._lock:
            peer = self.peers.get(peer_id)
            if peer is None:
                peer = NetworkPeer(
                    self.self_id,
                    peer_id,
                    self._on_peer_active,
                    self._on_peer_inactive,
                )
                self.peers[peer_id] = peer
        peer.add_connection(conn)

    def _on_peer_active(self, peer: NetworkPeer) -> None:
        """Fires for EVERY connection that becomes active (including
        replacements after churn): wire channels on the new connection."""
        log("network", f"peer active {peer.id[:6]}")
        conn = peer.connection
        if conn is None or not conn.is_open:
            # lost the race to a concurrent close: raising here would
            # kill the transport reader that delivered the activation;
            # the close path fires on_inactive and the next connection
            # re-wires cleanly
            return
        # wire each CONNECTION exactly once: a stale activation (its
        # own connection already replaced) reads the newer connection
        # here, and without the latch the real activation's duplicate
        # channel subscribe would raise mid-wiring, leaving
        # replication unnegotiated on the surviving connection
        with self._lock:
            if getattr(conn, "_hm_wired", False):
                return
            conn._hm_wired = True
        ch = conn.open_channel(MSGS_CHANNEL)
        ch.subscribe(lambda msg: self._on_peer_msg(peer, msg))
        self.replication.on_peer(peer)

    def _on_peer_inactive(self, peer: NetworkPeer) -> None:
        """Active connection lost without replacement: reset replication
        associations so a reconnect renegotiates from scratch."""
        log("network", f"peer inactive {peer.id[:6]}")
        self.replication.on_peer_closed(peer)

    # ------------------------------------------------------------------
    # message routing

    def _on_peer_msg(self, peer: NetworkPeer, msg: Any) -> None:
        if not isinstance(msg, dict):
            return
        try:
            t = msg.get("type")
            if t == "CursorMessage":
                self.backend.on_cursor_message(
                    peer,
                    msg["id"],
                    clockmod.strs_to_clock(msg["cursors"]),
                    clockmod.strs_to_clock(msg["clocks"]),
                )
            elif t == "DocumentMessage":
                self.backend.deliver_doc_message(msg["id"], msg["contents"])
        except (KeyError, TypeError, ValueError) as e:
            # malformed frames from buggy/hostile peers must not kill the
            # transport's reader
            log("network", f"malformed peer msg from {peer.id[:6]}: {e}")

    def _on_feed_discovery(self, public_id: str, peer: NetworkPeer) -> None:
        self.backend.on_discovery(public_id, peer)

    # ------------------------------------------------------------------
    # outbound (called by RepoBackend)

    def announce_feed(self, feed) -> None:
        self.join(feed.discovery_id, self._feed_join_options(feed))
        self.replication.announce(feed)

    def _feed_join_options(self, feed) -> Optional[JoinOptions]:
        """Announce aggregation: a feed that belongs to a known doc
        joins the DHT VIA the doc's discovery id — one signed record
        per doc key instead of one per placeholder actor feed (the
        O(actors) announce walks a per-feed join costs). Push-seeding
        (HM_DHT_PUSH_SEED) rides the same options. None = no doc
        association known here; the feed announces under its own key."""
        cursors = getattr(self.backend, "cursors", None)
        if cursors is None:
            return None
        from ..utils import keys as keymod

        docs = sorted(
            cursors.docs_with_actor(self.backend.id, feed.public_key)
        )
        if not docs:
            return None
        doc_id = docs[0]  # deterministic pick for multi-doc actors
        opts = dataclasses.replace(
            self.join_options, via=keymod.discovery_id(doc_id)
        )
        if os.environ.get("HM_DHT_PUSH_SEED", "0") == "1":
            opts = dataclasses.replace(opts, seed=doc_id)
        return opts

    def _peers_for_doc(self, doc_id: str) -> Set[NetworkPeer]:
        from ..utils import keys as keymod

        peers: Set[NetworkPeer] = set()
        for actor_id in self.backend.cursors.actors_for(
            self.backend.id, doc_id
        ):
            did = keymod.discovery_id(actor_id)
            peers.update(self.replication.peers_with_feed(did))
        return peers

    def send_cursor_to(self, peer: NetworkPeer, doc_id: str,
                       cursor: clockmod.Clock, clock: clockmod.Clock,
                       full: bool = True) -> None:
        """Send a cursor frame to one peer. `full=True` (the repair
        paths: discovery replies, anti-entropy sweeps) always carries
        the whole maps; `full=False` (steady-state gossip) sends a
        delta against this connection's send ledger when
        HM_CURSOR_DELTA is on — or nothing at all when no actor
        advanced since the last frame."""
        conn = peer.connection  # snapshot: ledger rides the connection
        # (a replacement connection starts with no ledger, so the
        # first frame after churn is full — the resync guarantee)
        use_delta = not full and _cursor_delta_on() and conn is not None
        msg_cursor, msg_clock = cursor, clock
        if use_delta:
            with self._lock:
                ledger = getattr(conn, "_hm_cursor_sent", None)
                sent = None if ledger is None else ledger.get(doc_id)
                if sent is not None:
                    s_cur, s_clk = sent
                    msg_cursor = {
                        k: v for k, v in cursor.items()
                        if s_cur.get(k, -1) < v
                    }
                    msg_clock = {
                        k: v for k, v in clock.items()
                        if s_clk.get(k, -1) < v
                    }
            if sent is None:
                msg_cursor, msg_clock = cursor, clock
                use_delta = False  # first frame per conn+doc is full
            elif not msg_cursor and not msg_clock:
                _M_CUR_SUPPRESSED.add(1)
                return
        ok = peer.try_send(
            MSGS_CHANNEL,
            msgs.cursor_message(
                doc_id,
                clockmod.clock_to_strs(msg_cursor),
                clockmod.clock_to_strs(msg_clock),
            ),
        )
        if not ok:
            return  # dropped to churn; the replacement resyncs full
        (_M_CUR_DELTA if use_delta else _M_CUR_FULL).add(1)
        if not _cursor_delta_on() or conn is None:
            return
        # ledger merge (max-wins, like the receiver): record the FULL
        # new maps — the peer now knows at least this much, whether
        # the frame carried all of it or just the advancing slice
        with self._lock:
            ledger = getattr(conn, "_hm_cursor_sent", None)
            if ledger is None:
                ledger = {}
                conn._hm_cursor_sent = ledger
            s_cur, s_clk = ledger.get(doc_id, ({}, {}))
            ns_cur, ns_clk = dict(s_cur), dict(s_clk)
            for k, v in cursor.items():
                if ns_cur.get(k, -1) < v:
                    ns_cur[k] = v
            for k, v in clock.items():
                if ns_clk.get(k, -1) < v:
                    ns_clk[k] = v
            ledger[doc_id] = (ns_cur, ns_clk)

    def gossip_cursor(
        self, doc_id: str, cursor: clockmod.Clock, clock: clockmod.Clock
    ) -> None:
        peers = self.gossip.sample(doc_id, list(self._peers_for_doc(doc_id)))
        for peer in peers:
            self.send_cursor_to(peer, doc_id, cursor, clock, full=False)

    def broadcast_doc_message(self, doc_id: str, contents: Any) -> None:
        # deliberately UNSAMPLED: ephemeral doc messages are one-shot
        # with no relay hop (receivers only deliver to their frontend)
        # and no anti-entropy repair — a sampled-away peer would lose
        # the message forever, not late. The bounded-fanout claim
        # covers the repairable paths (live tails, cursor gossip).
        for peer in self._peers_for_doc(doc_id):
            peer.try_send(
                MSGS_CHANNEL, msgs.document_message(doc_id, contents)
            )

    def discovery_report(self) -> Optional[Dict[str, Any]]:
        """The attached swarm's DHT introspection block, when it has
        one (DhtSwarm.discovery_report; FaultSwarm passes through)."""
        fn = getattr(self.swarm, "discovery_report", None)
        return fn() if fn is not None else None

    # ------------------------------------------------------------------

    def close(self) -> None:
        self.replication.close()
        for peer in list(self.peers.values()):
            peer.close()
        self.peers.clear()
        if self.swarm is not None:
            self.swarm.destroy()
