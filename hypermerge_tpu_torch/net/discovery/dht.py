"""Kademlia-lite DHT: announce/lookup by discovery id over UDP.

The reference treats discovery as a pluggable seam (src/SwarmInterface.ts
— any object with join/leave works; hyperswarm fills it in production).
This module is that filling: a 160-bit-keyspace DHT (Maymounkov &
Mazières 2002) sized for a fleet of repo daemons, not the open
internet — JSON datagrams on UDP, ed25519-signed announce records, and
the three primitives a swarm needs:

  find_node(target)   iterative routing-table walk toward `target`
  announce(key, addr) publish a signed+TTL'd {key -> dial address}
                      record on the k nodes closest to `key`
  lookup(key)         iterative walk that collects verified records

Routing state is the classic k-bucket array: one LRU-ordered bucket
per shared-prefix length, `HM_DHT_K` contacts each. A full bucket
NEVER evicts on sight — the long-lived node wins (Kademlia's uptime
heuristic): the newcomer parks in a bounded replacement cache while
the least-recently-seen contact is liveness-pinged; only an unanswered
ping evicts (and promotes the freshest replacement).

Announce records are self-certifying: the announcer signs
(key, host, port, ts, ttl) with its repo ed25519 identity (or an
ephemeral node key when anonymous), so a storing node — and every
looker-up — verifies without trusting the path the record traveled.
Expiry is the announcer's problem: records die at ts+ttl and the
owning swarm re-publishes every `HM_DHT_ANNOUNCE_S` (net/discovery/
swarm.py), so a crashed peer's stale address evaporates within a TTL.

Node ids are sha1(node public key): 160 bits, the keyspace of
`key_id(discovery_id)`. All RPCs ride one bound UDP socket per node, so
the datagram source address IS the node's reachable address (datacenter
/ loopback scope; NAT traversal is out of scope like the reference's).

The port's copy of hypermerge_tpu/net/discovery/dht.py.
"""

from __future__ import annotations

import base64
import hashlib
import itertools
import json
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from ...analysis.lockdep import make_lock
from ...utils import crypto
from ...utils.debug import log
from ... import telemetry

ID_BITS = 160
_MAX_DATAGRAM = 60 * 1024
_MAX_HOPS = 16  # iterative-walk backstop (log2 of any sane fleet)
_MAX_RECORDS_PER_REPLY = 32

# process-wide DHT counters (every node shares them, like net.tcp.*):
# the [dht] group in tools/top.py and the bench config_swarm block
_M_RPC_TX = telemetry.counter("dht.rpc_tx")
_M_RPC_RX = telemetry.counter("dht.rpc_rx")
_M_TIMEOUTS = telemetry.counter("dht.rpc_timeouts")
_M_LOOKUPS = telemetry.counter("dht.lookups")
_M_HOPS = telemetry.counter("dht.lookup_hops")
_M_FOUND = telemetry.counter("dht.records_found")
_M_ANNOUNCES = telemetry.counter("dht.announces")
_M_STORED = telemetry.counter("dht.records_stored")
_M_REJECTED = telemetry.counter("dht.records_rejected")
_M_EVICTIONS = telemetry.counter("dht.stale_evictions")
_M_SIGN_CACHE = telemetry.counter("dht.sign_cache_hits")
_M_SEEDS_TX = telemetry.counter("dht.seeds_tx")
_M_SEEDS_RX = telemetry.counter("dht.seeds_rx")


def _k() -> int:
    return int(os.environ.get("HM_DHT_K", "16"))


def _alpha() -> int:
    return int(os.environ.get("HM_DHT_ALPHA", "3"))


def _rpc_timeout_s() -> float:
    return float(os.environ.get("HM_DHT_RPC_TIMEOUT_S", "1"))


def _ttl_s() -> float:
    return float(os.environ.get("HM_DHT_TTL_S", "120"))


def bootstrap_from_env() -> List[Tuple[str, int]]:
    """Parse HM_DHT_BOOTSTRAP ("host:port,host:port") into addresses."""
    spec = os.environ.get("HM_DHT_BOOTSTRAP")
    if not spec:
        return []
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.append((host, int(port)))
    return out


def key_id(name: str) -> int:
    """A discovery id's position in the 160-bit keyspace."""
    return int.from_bytes(hashlib.sha1(name.encode("utf-8")).digest(), "big")


def _id_hex(i: int) -> str:
    return f"{i:040x}"


def _bucket_index(self_id: int, other: int) -> int:
    """0..159 by shared-prefix length; -1 for self (never bucketed)."""
    return (self_id ^ other).bit_length() - 1


class Contact(NamedTuple):
    id: int
    addr: Tuple[str, int]


class RoutingTable:
    """The k-bucket array. `observe` is the single ingest point: every
    datagram's sender lands here; a full bucket returns the LRU contact
    for the caller to liveness-probe (evict/refresh resolve the probe)
    while the newcomer waits in the bucket's replacement cache."""

    def __init__(self, self_id: int, k: Optional[int] = None) -> None:
        self.self_id = self_id
        self.k = _k() if k is None else k
        self._lock = make_lock("net.dht")
        # deque per bucket, LRU at the left / MRU at the right
        self._buckets: List[deque] = [deque() for _ in range(ID_BITS)]
        self._replacements: List[deque] = [deque() for _ in range(ID_BITS)]
        # buckets with a liveness probe in flight: at fleet scale every
        # datagram from a non-resident would otherwise fire a fresh
        # ping (the top bucket holds ~half the fleet) — one outstanding
        # probe per bucket bounds the storm
        self._probing: set = set()

    def observe(self, node_id: int, addr: Tuple[str, int]) -> Optional[Contact]:
        """Record a live sighting. Returns None when absorbed; returns
        the bucket's LRU contact when the bucket is full — the caller
        pings it and calls `refresh` (alive: newcomer stays parked) or
        `evict` (dead: freshest replacement promoted)."""
        i = _bucket_index(self.self_id, node_id)
        if i < 0:
            return None
        c = Contact(node_id, (addr[0], int(addr[1])))
        with self._lock:
            b = self._buckets[i]
            for existing in b:
                if existing.id == node_id:
                    b.remove(existing)
                    b.append(c)  # MRU + address refresh
                    return None
            if len(b) < self.k:
                b.append(c)
                return None
            r = self._replacements[i]
            for existing in list(r):
                if existing.id == node_id:
                    r.remove(existing)
            r.append(c)
            while len(r) > self.k:
                r.popleft()  # oldest parked newcomer sheds first
            if i in self._probing:
                return None  # a probe is already deciding this bucket
            self._probing.add(i)
            return b[0]

    def refresh(self, contact: Contact) -> None:
        """The probed LRU answered: it keeps its slot (moved to MRU)."""
        i = _bucket_index(self.self_id, contact.id)
        if i < 0:
            return
        with self._lock:
            self._probing.discard(i)
            b = self._buckets[i]
            for existing in list(b):
                if existing.id == contact.id:
                    b.remove(existing)
                    b.append(existing)
                    return

    def evict(self, contact: Contact) -> None:
        """The probed LRU never answered: drop it and promote the
        freshest parked replacement."""
        i = _bucket_index(self.self_id, contact.id)
        if i < 0:
            return
        with self._lock:
            self._probing.discard(i)
            b = self._buckets[i]
            for existing in list(b):
                if existing.id == contact.id:
                    b.remove(existing)
                    _M_EVICTIONS.add(1)
                    break
            r = self._replacements[i]
            while r and len(b) < self.k:
                cand = r.pop()  # freshest first
                if all(e.id != cand.id for e in b):
                    b.append(cand)

    def closest(self, target: int, n: Optional[int] = None) -> List[Contact]:
        with self._lock:
            all_c = [c for b in self._buckets for c in b]
        all_c.sort(key=lambda c: c.id ^ target)
        return all_c[: self.k if n is None else n]

    def size(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buckets)

    def occupancy(self) -> Dict[int, int]:
        """Non-empty bucket index -> contact count (tools/meta.py)."""
        with self._lock:
            return {
                i: len(b) for i, b in enumerate(self._buckets) if b
            }


# ---------------------------------------------------------------------------
# signed announce records


def _record_bytes(rec: Dict[str, Any]) -> bytes:
    body = {
        k: rec[k] for k in ("key", "host", "port", "ts", "ttl", "pk")
    }
    return json.dumps(body, sort_keys=True, separators=(",", ":")).encode(
        "utf-8"
    )


def make_record(
    key_hex: str,
    host: str,
    port: int,
    seed: bytes,
    ttl: Optional[float] = None,
) -> Dict[str, Any]:
    """A signed announce record: `seed` (the repo's ed25519 identity,
    or the node's ephemeral key) certifies {key -> host:port} until
    ts+ttl."""
    pk = crypto.public_key(seed)
    rec = {
        "key": key_hex,
        "host": host,
        "port": int(port),
        "ts": round(time.time(), 3),
        "ttl": float(_ttl_s() if ttl is None else ttl),
        "pk": base64.b64encode(pk).decode("ascii"),
    }
    rec["sig"] = base64.b64encode(
        crypto.sign(_record_bytes(rec), seed)
    ).decode("ascii")
    return rec


def _seed_record_bytes(rec: Dict[str, Any]) -> bytes:
    body = {
        k: rec[k] for k in ("key", "doc", "ts", "ttl", "pk")
    }
    return json.dumps(body, sort_keys=True, separators=(",", ":")).encode(
        "utf-8"
    )


def make_seed_record(
    key_hex: str,
    doc_id: str,
    seed: bytes,
    ttl: Optional[float] = None,
) -> Dict[str, Any]:
    """A signed push-seed record (HM_DHT_PUSH_SEED): the announcer
    asks the k nodes closest to `key_hex` — the doc's own keyspace
    position — to OPEN `doc_id` and become replicas, so the creator
    stops serving the entire cold-join first wave alone."""
    pk = crypto.public_key(seed)
    rec = {
        "key": key_hex,
        "doc": str(doc_id),
        "ts": round(time.time(), 3),
        "ttl": float(_ttl_s() if ttl is None else ttl),
        "pk": base64.b64encode(pk).decode("ascii"),
    }
    rec["sig"] = base64.b64encode(
        crypto.sign(_seed_record_bytes(rec), seed)
    ).decode("ascii")
    return rec


def verify_seed_record(rec: Any, now: Optional[float] = None) -> bool:
    if not isinstance(rec, dict):
        return False
    try:
        pk = base64.b64decode(rec["pk"])
        sig = base64.b64decode(rec["sig"])
        ts = float(rec["ts"])
        ttl = float(rec["ttl"])
        payload = _seed_record_bytes(rec)
    except (KeyError, TypeError, ValueError):
        return False
    if not crypto.verify(payload, sig, pk):
        return False
    now = time.time() if now is None else now
    return ts + ttl > now and ts < now + 60


def verify_record(rec: Any, now: Optional[float] = None) -> bool:
    """Signature valid AND not expired AND not implausibly future-
    stamped (>60s of clock skew is a forged/replayed ts, not skew)."""
    if not isinstance(rec, dict):
        return False
    try:
        pk = base64.b64decode(rec["pk"])
        sig = base64.b64decode(rec["sig"])
        ts = float(rec["ts"])
        ttl = float(rec["ttl"])
        payload = _record_bytes(rec)
    except (KeyError, TypeError, ValueError):
        return False
    if not crypto.verify(payload, sig, pk):
        return False
    now = time.time() if now is None else now
    return ts + ttl > now and ts < now + 60


class RecordStore:
    """TTL'd announce records, one per (key, announcer pk), freshest
    ts wins. Expiry is lazy (reads prune) — announcers re-publish, so
    a key nobody reads or refreshes simply ages out on its next
    touch."""

    def __init__(self) -> None:
        self._lock = make_lock("net.dht.store")
        # key_hex -> {pk_b64 -> record}
        self._records: Dict[str, Dict[str, Dict[str, Any]]] = {}

    def put(self, rec: Any) -> bool:
        if not verify_record(rec):
            _M_REJECTED.add(1)
            return False
        with self._lock:
            by_pk = self._records.setdefault(rec["key"], {})
            old = by_pk.get(rec["pk"])
            if old is None or float(old["ts"]) <= float(rec["ts"]):
                by_pk[rec["pk"]] = rec
        _M_STORED.add(1)
        return True

    def get(self, key_hex: str) -> List[Dict[str, Any]]:
        now = time.time()
        with self._lock:
            by_pk = self._records.get(key_hex)
            if not by_pk:
                return []
            live = {
                pk: r
                for pk, r in by_pk.items()
                if float(r["ts"]) + float(r["ttl"]) > now
            }
            if live:
                self._records[key_hex] = live
            else:
                self._records.pop(key_hex, None)
            return list(live.values())

    def size(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._records.values())


# ---------------------------------------------------------------------------
# the node


class DhtNode:
    """One DHT participant: a bound UDP socket, a routing table, a
    record store, and the iterative find_node/announce/lookup walks.

    RPCs are fire-and-correlate: every request carries an `rpc` id; the
    reader thread resolves the pending entry (reply) or a timer fires
    it (timeout). The iterative walks batch `HM_DHT_ALPHA` in-flight
    probes per round and count rounds as hops (`dht.lookup_hops`)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        bootstrap: Optional[List[Tuple[str, int]]] = None,
        seed: Optional[bytes] = None,
        k: Optional[int] = None,
    ) -> None:
        self._seed = seed if seed is not None else os.urandom(32)
        self.public_key = crypto.public_key(self._seed)
        self.id = int.from_bytes(
            hashlib.sha1(self.public_key).digest(), "big"
        )
        # announce records sign with the OWNING repo's identity when the
        # swarm wires one (set_announce_seed); the ephemeral node key
        # covers anonymous nodes. Set before traffic flows.
        self._announce_seed = self._seed
        # announce-record signing cache: re-publishing an unchanged
        # {key,host,port,ttl} within the TTL window reuses the signed
        # record instead of paying an ed25519 sign per period per key
        self._sign_cache: Dict[Tuple, Dict[str, Any]] = {}
        # push-seed receiver state: hook fired once per doc id
        self._seed_hook: Optional[Callable[[str], None]] = None
        self._seeded: set = set()
        self.table = RoutingTable(self.id, k)
        self.records = RecordStore()
        self._plock = make_lock("net.dht.rpc")
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._rpc_ids = itertools.count(1)
        self._closed = False
        self.bootstrap = list(
            bootstrap if bootstrap is not None else bootstrap_from_env()
        )
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"dht:{self.address[1]}",
        )
        self._reader.start()
        # ONE expiry sweeper per node, not a threading.Timer per RPC:
        # at fleet RPC rates a timer thread per probe piles into
        # thousands of live threads and the scheduler thrash makes its
        # own timeouts
        self._sweep_stop = threading.Event()
        self._sweeper = threading.Thread(
            target=self._sweep_loop, daemon=True,
            name=f"dht-sweep:{self.address[1]}",
        )
        self._sweeper.start()

    @property
    def id_hex(self) -> str:
        return _id_hex(self.id)

    def set_announce_seed(self, seed: bytes) -> None:
        """Sign future announce records with the repo identity instead
        of the ephemeral node key (DhtSwarm.set_identity)."""
        self._announce_seed = seed
        self._sign_cache = {}  # cached records carry the old key

    def set_seed_hook(self, hook: Callable[[str], None]) -> None:
        """Push-seed receiver (HM_DHT_PUSH_SEED): `hook(doc_id)` fires
        once per doc named by a verified seed record addressed to this
        node (Network wires backend.open — the node becomes a replica)."""
        self._seed_hook = hook

    # -- inbound --------------------------------------------------------

    def _read_loop(self) -> None:
        while not self._closed:
            try:
                data, addr = self._sock.recvfrom(_MAX_DATAGRAM + 4096)
            except OSError:
                return  # closed
            try:
                msg = json.loads(data.decode("utf-8"))
            except ValueError:
                continue  # corrupt datagram: skip
            if not isinstance(msg, dict):
                continue
            _M_RPC_RX.add(1)
            try:
                self._handle(msg, addr)
            except (KeyError, TypeError, ValueError) as e:
                # malformed frames from buggy peers must not kill the
                # reader (same contract as the TCP stack)
                log("net:dht", f"malformed dht msg from {addr}: {e}")

    def _handle(self, msg: Dict[str, Any], addr: Tuple[str, int]) -> None:
        sender = msg.get("from")
        if isinstance(sender, str):
            try:
                self._observe(int(sender, 16), addr)
            except ValueError:
                return
        t = msg.get("t")
        rid = msg.get("rpc")
        if t == "ping":
            self._send(addr, {"t": "pong", "rpc": rid})
        elif t == "find_node":
            target = int(msg["target"], 16)
            self._send(addr, {
                "t": "nodes",
                "rpc": rid,
                "nodes": self._node_triples(target),
            })
        elif t == "lookup":
            key = str(msg["key"])
            self._send(addr, {
                "t": "values",
                "rpc": rid,
                "records": self.records.get(key)[:_MAX_RECORDS_PER_REPLY],
                "nodes": self._node_triples(int(key, 16)),
            })
        elif t == "announce":
            ok = self.records.put(msg.get("record"))
            self._send(addr, {"t": "stored", "rpc": rid, "ok": ok})
        elif t == "seed":
            ok = self._handle_seed(msg.get("record"))
            self._send(addr, {"t": "stored", "rpc": rid, "ok": ok})
        elif t in ("pong", "nodes", "values", "stored"):
            self._resolve(rid, msg)

    def _handle_seed(self, rec: Any) -> bool:
        """A push-seed request landed (we are among the k closest to
        the doc's key). Verify the signature AND that the named doc
        really owns the record's keyspace position — a record may ask
        us to replicate only the doc whose key it is stored under."""
        if not verify_seed_record(rec):
            return False
        doc_id = str(rec["doc"])
        from ...utils import keys as keymod

        if rec["key"] != _id_hex(key_id(keymod.discovery_id(doc_id))):
            return False
        _M_SEEDS_RX.add(1)
        hook = self._seed_hook
        if hook is None or doc_id in self._seeded:
            return True
        self._seeded.add(doc_id)
        # off the reader thread: opening a doc does storage I/O and
        # may re-enter the network stack
        threading.Thread(
            target=lambda: hook(doc_id), daemon=True,
            name=f"dht-seed:{doc_id[:6]}",
        ).start()
        return True

    def _node_triples(self, target: int) -> List[List[Any]]:
        return [
            [_id_hex(c.id), c.addr[0], c.addr[1]]
            for c in self.table.closest(target)
        ]

    def _observe(self, node_id: int, addr: Tuple[str, int]) -> None:
        lru = self.table.observe(node_id, addr)
        if lru is not None:
            # full bucket: liveness-probe the LRU; the Kademlia uptime
            # rule — only an unanswered ping evicts
            self._send_rpc(
                lru.addr, {"t": "ping"},
                on_reply=lambda _m, c=lru: self.table.refresh(c),
                on_timeout=lambda c=lru: self.table.evict(c),
            )

    # -- outbound -------------------------------------------------------

    def _send(self, addr: Tuple[str, int], msg: Dict[str, Any]) -> None:
        msg.setdefault("from", self.id_hex)
        try:
            data = json.dumps(msg, separators=(",", ":")).encode("utf-8")
            if len(data) > _MAX_DATAGRAM:
                log("net:dht", f"oversized dht reply dropped ({len(data)}B)")
                return
            self._sock.sendto(data, addr)
            _M_RPC_TX.add(1)
        except OSError:
            pass  # closed socket / unreachable: timers handle the rest

    def _send_rpc(
        self,
        addr: Tuple[str, int],
        msg: Dict[str, Any],
        on_reply: Optional[Callable[[Dict[str, Any]], None]] = None,
        on_timeout: Optional[Callable[[], None]] = None,
        timeout: Optional[float] = None,
    ) -> None:
        if self._closed:
            # fail fast: an in-flight iterative walk on a closing node
            # must collapse instead of waiting out a timeout per round
            if on_timeout is not None:
                on_timeout()
            return
        rid = next(self._rpc_ids)
        timeout = _rpc_timeout_s() if timeout is None else timeout
        with self._plock:
            self._pending[rid] = {
                "on_reply": on_reply,
                "on_timeout": on_timeout,
                "deadline": time.monotonic() + timeout,
            }
        self._send(addr, {**msg, "rpc": rid})

    def _sweep_loop(self) -> None:
        """Expire pending RPCs past their deadline (the per-node
        timeout authority; replaces a thread per in-flight probe)."""
        while not self._sweep_stop.wait(0.05):
            now = time.monotonic()
            expired = []
            with self._plock:
                for rid, entry in list(self._pending.items()):
                    if entry["deadline"] <= now:
                        expired.append(self._pending.pop(rid))
            for entry in expired:
                _M_TIMEOUTS.add(1)
                cb = entry["on_timeout"]
                if cb is not None:
                    try:
                        cb()
                    except Exception as e:  # a probe hook must not
                        log("net:dht", f"timeout hook error: {e}")

    def _resolve(self, rid: Any, msg: Dict[str, Any]) -> None:
        with self._plock:
            entry = self._pending.pop(rid, None)
        if entry is None:
            return  # late reply after the sweep expired it
        cb = entry["on_reply"]
        if cb is not None:
            cb(msg)

    def _query_round(
        self,
        contacts: List[Contact],
        msg: Dict[str, Any],
        timeout: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """One alpha-wide probe round: send to every contact, wait the
        RPC timeout, return the replies that landed."""
        timeout = _rpc_timeout_s() if timeout is None else timeout
        done = threading.Event()
        replies: List[Dict[str, Any]] = []
        remaining = [len(contacts)]

        def _account() -> None:
            # reader thread (replies), sweeper thread (expiries) and
            # the caller (closed-node fast path) all decrement: the
            # RMW must serialize or a lost update waits out the full
            # round timeout instead of completing on the last reply
            with self._plock:
                remaining[0] -= 1
                settled = remaining[0] <= 0
            if settled:
                done.set()

        def on_reply(m: Dict[str, Any]) -> None:
            replies.append(m)  # GIL-atomic list append
            _account()

        for c in contacts:
            self._send_rpc(
                c.addr, dict(msg), on_reply=on_reply,
                on_timeout=_account, timeout=timeout,
            )
        done.wait(timeout + 0.5)
        return list(replies)

    def _iterative(
        self, target: int, msg: Dict[str, Any]
    ) -> Tuple[List[Contact], List[Dict[str, Any]], int]:
        """The Kademlia walk: probe the alpha closest unqueried
        contacts per round, absorb returned nodes, stop when the k
        closest known are all queried (or nothing new surfaces).
        Returns (k closest contacts, verified records seen, hops)."""
        alpha = _alpha()
        k = self.table.k
        shortlist: Dict[int, Contact] = {
            c.id: c for c in self.table.closest(target)
        }
        queried: set = set()
        records: Dict[str, Dict[str, Any]] = {}
        hops = 0
        while hops < _MAX_HOPS:
            candidates = sorted(
                (c for c in shortlist.values() if c.id not in queried),
                key=lambda c: c.id ^ target,
            )
            # termination: every one of the k closest known is queried
            frontier = sorted(
                shortlist.values(), key=lambda c: c.id ^ target
            )[:k]
            if all(c.id in queried for c in frontier) or not candidates:
                break
            batch = candidates[:alpha]
            hops += 1
            replies = self._query_round(batch, msg)
            for c in batch:
                queried.add(c.id)
            for rep in replies:
                for r in rep.get("records", ()):
                    if verify_record(r):
                        old = records.get(r["pk"])
                        if old is None or float(old["ts"]) <= float(r["ts"]):
                            records[r["pk"]] = r
                for triple in rep.get("nodes", ()):
                    nid_hex, host, port = triple
                    nid = int(nid_hex, 16)
                    if nid != self.id and nid not in shortlist:
                        shortlist[nid] = Contact(nid, (str(host), int(port)))
        closest = sorted(
            shortlist.values(), key=lambda c: c.id ^ target
        )[:k]
        return closest, list(records.values()), hops

    # -- the three primitives ------------------------------------------

    def find_node(self, target: int) -> List[Contact]:
        closest, _recs, _hops = self._iterative(
            target, {"t": "find_node", "target": _id_hex(target)}
        )
        return closest

    def lookup(self, key_hex: str) -> List[Dict[str, Any]]:
        """Verified, unexpired announce records for `key_hex` — from
        the iterative walk AND our own store (we may be one of the k
        closest)."""
        _M_LOOKUPS.add(1)
        _closest, recs, hops = self._iterative(
            int(key_hex, 16), {"t": "lookup", "key": key_hex}
        )
        _M_HOPS.add(hops)
        by_pk = {r["pk"]: r for r in self.records.get(key_hex)}
        for r in recs:
            old = by_pk.get(r["pk"])
            if old is None or float(old["ts"]) <= float(r["ts"]):
                by_pk[r["pk"]] = r
        _M_FOUND.add(len(by_pk))
        return list(by_pk.values())

    def announce(
        self,
        key_hex: str,
        host: str,
        port: int,
        ttl: Optional[float] = None,
        seed_doc: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Publish a signed record for `key_hex` on the k nodes closest
        to it (plus our own store — a two-node fleet has no third party
        to delegate to). An unchanged {key,host,port,ttl} re-publish
        within the first half of the record's TTL window reuses the
        cached signature (`dht.sign_cache_hits`) — the second half
        re-signs so the record never expires out from under its
        refresher. `seed_doc` push-seeds the doc to the same k-closest
        targets (HM_DHT_PUSH_SEED), reusing the one walk."""
        ck = (key_hex, host, int(port), ttl)
        rec = self._sign_cache.get(ck)
        if (
            rec is not None
            and time.time() < float(rec["ts"]) + float(rec["ttl"]) / 2
        ):
            _M_SIGN_CACHE.add(1)
        else:
            rec = make_record(
                key_hex, host, port, self._announce_seed, ttl
            )
            self._sign_cache[ck] = rec
        self.records.put(rec)
        targets = self.find_node(int(key_hex, 16))
        for c in targets:
            self._send_rpc(c.addr, {"t": "announce", "record": rec})
        _M_ANNOUNCES.add(1)
        if seed_doc is not None:
            sk = ("seed", key_hex, seed_doc)
            srec = self._sign_cache.get(sk)
            if (
                srec is None
                or time.time() >= float(srec["ts"]) + float(srec["ttl"]) / 2
            ):
                srec = make_seed_record(
                    key_hex, seed_doc, self._announce_seed, ttl
                )
                self._sign_cache[sk] = srec
            else:
                _M_SIGN_CACHE.add(1)
            for c in targets:
                self._send_rpc(c.addr, {"t": "seed", "record": srec})
                _M_SEEDS_TX.add(1)
        return rec

    def bootstrap_now(self, timeout: Optional[float] = None) -> int:
        """Ping the bootstrap list (a dead entry just times out), then
        walk toward our own id to populate the near buckets. Returns
        the routing-table size — callers retry while it stays 0 (a
        bootstrap node that was down comes back within a period)."""
        for addr in self.bootstrap:
            if tuple(addr) != tuple(self.address):
                self._send_rpc(tuple(addr), {"t": "ping"}, timeout=timeout)
        # give the pongs one RPC window to land before walking
        deadline = time.monotonic() + (
            _rpc_timeout_s() if timeout is None else timeout
        )
        while self.table.size() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        if self.table.size():
            self.find_node(self.id)
        return self.table.size()

    def close(self) -> None:
        self._closed = True
        self._sweep_stop.set()
        with self._plock:
            self._pending.clear()  # waiters are deadline-bounded
        try:
            self._sock.close()
        except OSError:
            pass
