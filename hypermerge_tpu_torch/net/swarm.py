"""Swarm interface + in-process loopback implementation.

Parity: the reference never hard-depends on a discovery mechanism — any
object with join/leave/on-connection/destroy works (reference
src/SwarmInterface.ts:6-58, README.md:26-34). `LoopbackSwarm` is the
in-process implementation (the testSwarm/testDuplexPair role from the
reference's tests, tests/misc.ts:34-36, :70-112); net/tcp.py provides a
socket-based swarm for real inter-process networking.

The port's copy of hypermerge_tpu/net/swarm.py.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..analysis.lockdep import make_rlock
from .duplex import Duplex, duplex_pair


@dataclass(frozen=True)
class JoinOptions:
    """Discovery asymmetry (reference src/SwarmInterface.ts:22-25 +
    Network.ts:22 — the repo's swarm posture): `announce` makes a
    joined id discoverable by peers looking it up; `lookup` actively
    seeks announcers. Server-ish peers announce, clients look up;
    default is both.

    `via` is the announce-aggregation key (HM discovery ids only): a
    feed id joined with via=<doc discovery id> is announced and looked
    up under ONE signed DHT record per doc key instead of one per
    placeholder actor feed — peers of the doc find each other through
    the doc key, and replication negotiates the individual feeds over
    the connection. `seed` optionally names the doc id to push-seed to
    the DHT's k-closest at announce time (HM_DHT_PUSH_SEED)."""

    announce: bool = True
    lookup: bool = True
    via: Optional[str] = None
    seed: Optional[str] = None


DEFAULT_JOIN = JoinOptions()


class ConnectionDetails:
    """Per-connection policy record. `reconnect(False)` and `ban()` are
    CONSULTED now, not merely recorded: the redial supervisor
    (net/resilience.py) stops a session whose details carry either, and
    a transport may attach `_on_ban` to learn of bans as they happen
    (net/tcp.py records the peer's identity/address and refuses it at
    both dial and accept time)."""

    def __init__(self, client: bool, peer_info=None) -> None:
        self.client = client
        self.peer = peer_info
        self._reconnect_allowed = True
        self.banned = False
        self._on_ban: Optional[Callable[[], None]] = None

    def reconnect(self, allowed: bool) -> None:
        self._reconnect_allowed = allowed

    def ban(self) -> None:
        self.banned = True
        if self._on_ban is not None:
            self._on_ban()


class Swarm:
    """Structural base: join/leave by discovery id; emits connections."""

    def set_identity(self, seed: bytes) -> None:
        """Static ed25519 seed for transports that authenticate peers
        (net/tcp.py). Default: ignored — in-process loopback pairs have
        no wire to protect."""

    def join(
        self, discovery_id: str, options: JoinOptions = DEFAULT_JOIN
    ) -> None:
        raise NotImplementedError

    def leave(self, discovery_id: str) -> None:
        raise NotImplementedError

    def on_connection(
        self, cb: Callable[[Duplex, ConnectionDetails], None]
    ) -> None:
        raise NotImplementedError

    def destroy(self) -> None:
        raise NotImplementedError


class LoopbackHub:
    """Shared rendezvous for LoopbackSwarms in one process: when one
    swarm LOOKS UP a discovery id another swarm ANNOUNCES, a duplex
    pair connects them (the looker-up is the client). Two lookup-only
    members never pair — a lookup-only join is invisible to inbound
    discovery (reference JoinOptions asymmetry)."""

    def __init__(self) -> None:
        self._lock = make_rlock("net.swarm")
        self._members: Dict[
            str, List[Tuple["LoopbackSwarm", JoinOptions]]
        ] = {}

    def join(
        self,
        swarm: "LoopbackSwarm",
        discovery_id: str,
        options: JoinOptions = DEFAULT_JOIN,
    ) -> None:
        with self._lock:
            if discovery_id not in swarm.joined:
                # a leave raced this join (the swarm records intent
                # BEFORE calling the hub, in both directions): the
                # leave already ran its hub.leave, so registering now
                # would strand a member entry that keeps pairing the
                # departed swarm forever
                return
            members = self._members.setdefault(discovery_id, [])
            members[:] = [(s, o) for s, o in members if s is not swarm]
            members.append((swarm, options))
            others = [(s, o) for s, o in members if s is not swarm]
        for other, other_opts in others:
            if options.lookup and other_opts.announce:
                client, server = swarm, other
            elif options.announce and other_opts.lookup:
                client, server = other, swarm
            else:
                continue  # lookup/lookup or announce/announce: no pair
            if (client, server) not in _connected_pairs(client, server):
                _connect(client, server)

    def leave(self, swarm: "LoopbackSwarm", discovery_id: str) -> None:
        with self._lock:
            members = self._members.get(discovery_id, [])
            members[:] = [(s, o) for s, o in members if s is not swarm]


def _connected_pairs(a: "LoopbackSwarm", b: "LoopbackSwarm") -> Set:
    return a.connected & {(a, b), (b, a)}


def _connect(client: "LoopbackSwarm", server: "LoopbackSwarm") -> None:
    if (client, server) in client.connected:
        return
    client.connected.add((client, server))
    server.connected.add((client, server))
    d1, d2 = duplex_pair()
    client.emit(d1, ConnectionDetails(client=True))
    server.emit(d2, ConnectionDetails(client=False))


class LoopbackSwarm(Swarm):
    def __init__(self, hub: LoopbackHub) -> None:
        self.hub = hub
        self.joined: Set[str] = set()
        self.connected: Set = set()
        self._cb: Optional[Callable] = None

    def join(
        self, discovery_id: str, options: JoinOptions = DEFAULT_JOIN
    ) -> None:
        self.joined.add(discovery_id)
        self.hub.join(self, discovery_id, options)

    def leave(self, discovery_id: str) -> None:
        # intent first: a join racing this leave re-checks `joined`
        # inside the hub lock and cancels itself (LoopbackHub.join), so
        # a leave also cancels the PENDING join it interleaved with
        self.joined.discard(discovery_id)
        self.hub.leave(self, discovery_id)

    def on_connection(self, cb) -> None:
        self._cb = cb

    def emit(self, duplex: Duplex, details: ConnectionDetails) -> None:
        if self._cb is not None:
            self._cb(duplex, details)

    def destroy(self) -> None:
        for d in list(self.joined):
            self.leave(d)
