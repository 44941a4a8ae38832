"""DhtSwarm — the Swarm seam filled by the DHT.

`Network.set_swarm` + `join(discovery_id)` is all the repo knows about
discovery (net/swarm.py Swarm). `LoopbackSwarm` fills the seam
in-process and `TcpSwarm` with explicit `connect()` addresses; this
class fills it fleet-style, hyperswarm-shaped:

- join(id, announce=True)  publishes a signed record mapping the id's
  DHT key to OUR TCP listen address, re-published every
  `HM_DHT_ANNOUNCE_S` (records expire at `HM_DHT_TTL_S`);
- join(id, lookup=True)    walks the DHT for announcers every
  `HM_DHT_LOOKUP_S` and supervise-dials a bounded subset of them
  (`HM_DHT_TARGETS` — the HyParView-style active view);
- leave(id)                stops the re-announce/lookup; the published
  record evaporates at its TTL, and live connections stay up (other
  shared docs may ride them — the supervisor owns their lifecycle).

Dials go through the wrapped `TcpSwarm`'s `SessionSupervisor`
(net/resilience.py), so redial/backoff/ban apply to DHT-discovered
addresses exactly as to explicit ones. Bootstrap comes from the
constructor or `HM_DHT_BOOTSTRAP`; an empty routing table re-runs the
bootstrap every maintenance pass, so a bootstrap node that was down at
our start is adopted when it appears (and a restarted one re-learns us
from our next announce walk).

Four rules keep a FLEET (not a pair) healthy, each earned by the
50-daemon soak failing without it:

- the active view is STABLE and SHARED across ids: targets persist
  while announced, deficits fill from addresses other ids already
  dialed, and only uncovered ids dial fresh (per-id resampling
  accumulated sessions toward a full mesh — a fleet doc carries one
  placeholder actor feed per peer);
- lookups are DEMAND-driven (`set_need_hook`): an id some verified
  peer already replicates spends no walk/dial budget, with a
  slow-cadence shuffle every 10th period so mutually-satisfied
  data-less ISLANDS still merge;
- of any announcer pair exactly ONE side dials (the higher address) —
  mutual dialing was a dedup-close + supervised-redial churn loop;
- walk work per maintenance pass is budgeted (`_PASS_BUDGET`), so a
  cursor merge that joins O(peers) ids at once becomes a trickle, not
  a storm.

The port's copy of hypermerge_tpu/net/discovery/swarm.py.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from ...analysis.lockdep import make_lock
from ...utils.debug import log
from ..swarm import DEFAULT_JOIN, JoinOptions, Swarm
from ..tcp import TcpSwarm
from .dht import DhtNode, key_id, _id_hex


def _announce_s() -> float:
    return float(os.environ.get("HM_DHT_ANNOUNCE_S", "30"))


def _lookup_s() -> float:
    return float(os.environ.get("HM_DHT_LOOKUP_S", "10"))


def _targets_n() -> int:
    return int(os.environ.get("HM_DHT_TARGETS", "4"))


# max announce/lookup walks one maintenance pass performs; remaining
# due ids carry over to the next pass (0.05-1s later)
_PASS_BUDGET = 8


class DhtSwarm(Swarm):
    """Swarm whose dial targets come from DHT lookups instead of
    explicit addresses. Wraps a TcpSwarm (inbound accept + supervised
    outbound) and a DhtNode (UDP announce/lookup)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        bootstrap: Optional[List[Tuple[str, int]]] = None,
        dht_port: int = 0,
        tcp: Optional[TcpSwarm] = None,
    ) -> None:
        self.tcp = tcp if tcp is not None else TcpSwarm(host, port)
        self.node = DhtNode(host, dht_port, bootstrap=bootstrap)
        self._lock = make_lock("net.dht.swarm")
        self._joined: Dict[str, JoinOptions] = {}
        # id -> dial addresses of the current sampled active view
        self._targets: Dict[str, Tuple[Tuple[str, int], ...]] = {}
        self._rng = random.Random()
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._pass_waiters: List[threading.Event] = []
        # demand hook (Network.set_swarm wires it): lookup walks run
        # only for ids the repo still NEEDS peers for. Without it,
        # every placeholder actor feed a doc's cursor carries (one per
        # peer in a fleet) gets walked and its single announcer dialed
        # — O(peers^2) sessions that the active-view bound cannot see.
        self._need: Optional[callable] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"dht-swarm:{self.tcp.address[1]}",
        )
        self._thread.start()

    # -- Swarm interface ------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        """The TCP listen address announce records publish."""
        return self.tcp.address

    @property
    def dht_address(self) -> Tuple[str, int]:
        """The UDP address other nodes bootstrap from."""
        return self.node.address

    @property
    def supervisor(self):
        return self.tcp.supervisor

    def set_identity(self, seed: Optional[bytes]) -> None:
        self.tcp.set_identity(seed)
        if seed is not None:
            # announce records certify with the repo identity, not the
            # ephemeral node key (Network.set_swarm wires this before
            # any join)
            self.node.set_announce_seed(seed)

    def set_need_hook(self, fn) -> None:
        """`fn(discovery_id) -> bool`: True while the repo still needs
        peers for the id (Network wires `no verified peer replicates
        it yet`). Lookups for satisfied ids are skipped — one
        connection replicates every shared feed, so the walk + dial
        budget goes to genuinely uncovered ids. When a doc's peers all
        churn away the hook flips back and lookups resume."""
        self._need = fn

    def set_seed_hook(self, fn) -> None:
        """`fn(doc_id)`: a verified push-seed record landed on our DHT
        node (HM_DHT_PUSH_SEED — we are among the doc key's k closest;
        Network wires backend.open so this node becomes a replica)."""
        self.node.set_seed_hook(fn)

    def join(
        self, discovery_id: str, options: JoinOptions = DEFAULT_JOIN
    ) -> None:
        with self._lock:
            self._joined[discovery_id] = options
        self._kick.set()

    def leave(self, discovery_id: str) -> None:
        with self._lock:
            self._joined.pop(discovery_id, None)
            self._targets.pop(discovery_id, None)

    def connect(self, address: Tuple[str, int]):
        """Explicit supervised dial (bootstrap escape hatch — the DHT
        path never needs it)."""
        return self.tcp.connect(address)

    def on_connection(self, cb) -> None:
        self.tcp.on_connection(cb)

    def destroy(self) -> None:
        self._stop.set()
        # close the node FIRST: an in-flight maintenance walk fails
        # fast (DhtNode._send_rpc short-circuits on a closed node)
        # instead of waiting out an RPC timeout per round
        self.node.close()
        self._kick.set()
        self._thread.join(timeout=2.0)
        self.tcp.destroy()

    # -- maintenance loop -----------------------------------------------

    def poke(self, timeout: float = 0.0) -> None:
        """Wake the maintenance loop now (tests; churn hooks). With a
        timeout, block until the woken pass finished."""
        if timeout <= 0:
            self._kick.set()
            return
        done = threading.Event()
        with self._lock:
            self._pass_waiters.append(done)
        self._kick.set()
        done.wait(timeout)

    def _run(self) -> None:
        announce_s = _announce_s()
        lookup_s = _lookup_s()
        # per-id next-due stamps live on this thread only
        announced_at: Dict[str, float] = {}
        looked_at: Dict[str, float] = {}
        skipped: Dict[str, int] = {}
        while not self._stop.is_set():
            backlog = False
            try:
                backlog = self._pass(
                    announced_at, looked_at, skipped,
                    announce_s, lookup_s,
                )
            except Exception as e:  # a flaky pass must not kill the loop
                log("net:dht", f"maintenance pass failed: {e}")
            with self._lock:
                waiters = list(self._pass_waiters)
                self._pass_waiters[:] = []
            for w in waiters:
                w.set()
            # wake at the earliest due stamp (bounded so a kick or a
            # newly-due id is picked up promptly); budget-deferred
            # backlog continues on the short edge
            due = [
                t
                for t in list(announced_at.values())
                + list(looked_at.values())
            ]
            now = time.monotonic()
            delay = min((t - now for t in due), default=1.0)
            if backlog:
                delay = 0.0
            self._kick.wait(min(max(delay, 0.05), 1.0))
            self._kick.clear()

    def _pass(
        self,
        announced_at: Dict[str, float],
        looked_at: Dict[str, float],
        skipped: Dict[str, int],
        announce_s: float,
        lookup_s: float,
    ) -> bool:
        """One maintenance pass; True when budget-deferred work
        remains (the loop continues promptly instead of sleeping)."""
        if self.node.table.size() == 0 and self.node.bootstrap:
            # not bootstrapped (or every known node churned away):
            # retry every pass until the fleet answers
            self.node.bootstrap_now()
            if self.node.table.size():
                # fresh view of the fleet: publish immediately
                announced_at.clear()
                looked_at.clear()
        with self._lock:
            joined = dict(self._joined)
        # announce AGGREGATION (JoinOptions.via): every id joined via
        # the same doc key folds into ONE group — one signed announce
        # record and one lookup walk per doc per period, instead of
        # one of each per placeholder actor feed. Replication
        # negotiates the individual feeds over the connection the doc
        # key produced, so nothing is lost — only O(actors) walks. Ids
        # joined without a via keep their own key (legacy shape).
        groups: Dict[str, List[Tuple[str, JoinOptions]]] = {}
        for did, opts in joined.items():
            groups.setdefault(opts.via or did, []).append((did, opts))
        now = time.monotonic()
        host, port = self.tcp.address
        # bounded work per pass: a doc whose cursor carries one
        # placeholder actor per peer joins O(peers) ids at once, and
        # walking them all back-to-back every pass is the fleet's CPU
        # gone (each walk is ~alpha*hops RPCs, signed records, k
        # verifies per store). Oldest-due first, the rest next pass —
        # the FIRST joined id (the doc being opened) always leads.
        due = []
        for gkey, members in groups.items():
            if (
                any(o.announce for _d, o in members)
                and now >= announced_at.get(gkey, 0.0)
            ):
                seed_doc = next(
                    (o.seed for _d, o in members if o.seed is not None),
                    None,
                )
                due.append(
                    (announced_at.get(gkey, 0.0), "a", gkey, seed_doc)
                )
            lookers = [d for d, o in members if o.lookup]
            if lookers and now >= looked_at.get(gkey, 0.0):
                if self._need is not None and not any(
                    self._need(d) for d in lookers
                ):
                    # already replicating with someone: usually no
                    # walk, no dial — but every 10th period walk
                    # anyway. Two data-less peers that found only
                    # each other are mutually "satisfied" yet an
                    # ISLAND (with one-side dialing the lower-address
                    # data holder can never dial out); the slow-
                    # cadence shuffle is what merges islands.
                    n_skip = skipped.get(gkey, 0) + 1
                    if n_skip < 10:
                        skipped[gkey] = n_skip
                        looked_at[gkey] = now + lookup_s
                        continue
                    # do NOT reset the counter here: the budget below
                    # may defer this entry, and a reset-on-schedule
                    # would restart the 10-period clock without the
                    # walk ever running (the executed branch clears it)
                due.append((looked_at.get(gkey, 0.0), "l", gkey, lookers))
        due.sort(key=lambda e: e[0])
        for _t, kind, gkey, extra in due[:_PASS_BUDGET]:
            key = _id_hex(key_id(gkey))
            if kind == "a":
                self.node.announce(key, host, port, seed_doc=extra)
                announced_at[gkey] = time.monotonic() + announce_s
            else:
                self._lookup_and_dial(gkey, key, extra)
                looked_at[gkey] = time.monotonic() + lookup_s
                skipped.pop(gkey, None)  # the walk ran: island-shuffle
                # clock restarts only on an EXECUTED lookup
        # group keys whose members all left drop their stamps + view
        for table in (announced_at, looked_at, skipped):
            for gkey in list(table):
                if gkey not in groups:
                    table.pop(gkey, None)
        with self._lock:
            for gkey in list(self._targets):
                if gkey not in groups:
                    self._targets.pop(gkey, None)
        return len(due) > _PASS_BUDGET

    def _lookup_and_dial(
        self, gkey: str, key: str, members: List[str]
    ) -> None:
        records = self.node.lookup(key)
        own_addr = tuple(self.tcp.address)
        addrs = []
        seen = set()
        for r in records:
            addr = (str(r["host"]), int(r["port"]))
            if addr == own_addr or addr in seen:
                continue  # our own record / duplicate announcer
            seen.add(addr)
            # deterministic dial direction: of any announcer pair,
            # exactly ONE side dials (the higher address) — both
            # dialing each other would make every pair a dedup close
            # + supervised-redial churn loop. The lower side gets the
            # edge inbound; the union graph is identical.
            if addr < own_addr:
                addrs.append(addr)
        if not addrs:
            return
        n = _targets_n()
        with self._lock:
            current = self._targets.get(gkey, ())
            active = {a for t in self._targets.values() for a in t}
        # the bounded active view is STABLE and SHARED: keep targets
        # still being announced, and cover any deficit FIRST from
        # addresses some other id already dialed — a connection
        # replicates every feed the pair shares, so one well-connected
        # peer covers all of a doc's per-actor ids. Only a genuinely
        # uncovered id dials fresh addresses. (Wholesale resampling
        # per refresh, or per-id-independent dialing, both accumulate
        # supervised sessions until the fleet is a full mesh — the
        # opposite of the bound.) A target whose record expired (peer
        # gone, TTL elapsed) drops out here and its slot is refilled.
        keep = [a for a in current if a in seen]
        deficit = max(0, n - len(keep)) if n > 0 else len(addrs)
        reuse = [a for a in addrs if a in active and a not in keep]
        take = reuse[:deficit]
        deficit -= len(take)
        pool = [a for a in addrs if a not in active and a not in keep]
        if n > 0 and len(pool) > deficit:
            pool = self._rng.sample(pool, deficit)
        view = keep + take + pool
        with self._lock:
            if not any(d in self._joined for d in members):
                return  # leave() raced the lookup: no dials
            self._targets[gkey] = tuple(view)
        for addr in pool:
            try:
                self.tcp.connect(addr)
            except RuntimeError:
                return  # supervisor stopped: we are being destroyed

    # -- introspection --------------------------------------------------

    def discovery_report(self) -> Dict:
        """The `dht` block of the Telemetry payload (tools/meta.py
        --dht, tools/ls.py header, bench config_swarm)."""
        with self._lock:
            joined = {
                did: {
                    "announce": o.announce,
                    "lookup": o.lookup,
                    **({"via": o.via} if o.via else {}),
                }
                for did, o in self._joined.items()
            }
            targets = {did: len(t) for did, t in self._targets.items()}
        return {
            "node_id": self.node.id_hex,
            "dht_address": list(self.node.address),
            "tcp_address": list(self.tcp.address),
            "nodes": self.node.table.size(),
            "buckets": self.node.table.occupancy(),
            "records": self.node.records.size(),
            "joined": joined,
            "targets": targets,
        }
