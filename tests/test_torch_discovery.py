"""Fleet-scale discovery on the port (hypermerge_tpu_torch/net/discovery/:
the Kademlia-lite DHT of dht.py, the DhtSwarm of swarm.py, and the
GossipSampler), on the CPU.

- Every case of tests/test_discovery.py under its own name on the port's
  modules: signed announce and seed records, k-buckets, iterative walks
  over UDP, bootstrap churn, the signing cache, push seeding, the gossip
  sampler, repos joined through the DHT alone (no connect()), with and
  without a seeded FaultSwarm, and bounded fanout over 20 peers. Repos
  are `Repo(memory=True, device="cpu")`. Like the reference's suite,
  this one runs under the lockdep and racedep module fixtures of
  tests/test_torch_analysis.py (on the port's analysis/lockdep.py),
  whose teardown fails on any finding. The `made` fixture of tests/test_torch_chaos.py closes every repo, swarm
  and DHT node a case made (a node's UDP reader and sweeper threads
  would outlive it).
- Parity with the JAX package: `key_id` and the records of `make_record`
  and `make_seed_record` are equal for a seed and a clock; a port record
  verifies under the reference's `verify_record` and the other way round
  (and a tampered one under neither); a port DhtNode and a reference
  DhtNode share one overlay, and each finds the other's announce over
  UDP.

Tolerance: exact.
"""

import json
import os
import time

import numpy as np
import pytest

from hypermerge_tpu_torch.net.discovery import (
    GossipSampler,
    RecordStore,
    RoutingTable,
    key_id,
    make_record,
    verify_record,
)
from hypermerge_tpu_torch.net.discovery import dht as _dht
from hypermerge_tpu_torch.net.discovery import swarm as _dswarm
from hypermerge_tpu_torch.net.discovery.dht import (
    Contact,
    _id_hex,
    make_seed_record,
    verify_seed_record,
)
from hypermerge_tpu_torch.net.faults import FaultPlan
from hypermerge_tpu_torch.net.swarm import JoinOptions, LoopbackHub, LoopbackSwarm

from helpers import wait_until
from test_torch_analysis import lockdep_suite, racedep_suite
from test_torch_chaos import FaultSwarm, Repo, _tracked, made  # noqa: F401

_lockdep_suite = lockdep_suite()
_racedep_suite = racedep_suite()

DhtNode = _tracked(_dht.DhtNode)
DhtSwarm = _tracked(_dswarm.DhtSwarm)

SEED = b"\x07" * 32


@pytest.fixture
def fast_dht(monkeypatch):
    """Test-speed periods: sub-second announce/lookup refresh, fast
    redial, no keepalive thread storm."""
    monkeypatch.setenv("HM_DHT_ANNOUNCE_S", "0.2")
    monkeypatch.setenv("HM_DHT_LOOKUP_S", "0.2")
    monkeypatch.setenv("HM_REDIAL_BASE_MS", "30")
    monkeypatch.setenv("HM_REDIAL_MAX_S", "0.5")
    monkeypatch.setenv("HM_NET_PING_S", "0")


# ---------------------------------------------------------------------------
# records


class TestRecords:
    def test_sign_verify_roundtrip(self):
        rec = make_record("ab" * 20, "10.0.0.1", 4242, SEED, ttl=60)
        assert verify_record(rec)

    def test_tampered_record_rejected(self):
        rec = make_record("ab" * 20, "10.0.0.1", 4242, SEED, ttl=60)
        evil = dict(rec, port=6666)  # redirect the dial target
        assert not verify_record(evil)
        evil2 = dict(rec, sig=rec["sig"][:-4] + "AAA=")
        assert not verify_record(evil2)

    def test_ttl_expiry(self):
        rec = make_record("ab" * 20, "10.0.0.1", 4242, SEED, ttl=5)
        assert verify_record(rec, now=rec["ts"] + 4)
        assert not verify_record(rec, now=rec["ts"] + 6)

    def test_future_stamp_rejected(self):
        rec = make_record("ab" * 20, "10.0.0.1", 4242, SEED, ttl=60)
        assert not verify_record(rec, now=rec["ts"] - 120)

    def test_store_expires_and_freshest_wins(self):
        store = RecordStore()
        key = "cd" * 20
        old = make_record(key, "10.0.0.1", 1111, SEED, ttl=60)
        time.sleep(0.01)
        new = make_record(key, "10.0.0.1", 2222, SEED, ttl=60)
        assert store.put(new) and store.put(old)
        got = store.get(key)  # same announcer pk: freshest ts wins
        assert [r["port"] for r in got] == [2222]
        # an expired record vanishes from reads (lazy expiry)
        short = make_record(key, "10.0.0.1", 3333, os.urandom(32),
                            ttl=0.05)
        assert store.put(short)
        assert len(store.get(key)) == 2
        time.sleep(0.08)
        assert [r["port"] for r in store.get(key)] == [2222]

    def test_store_rejects_invalid(self):
        store = RecordStore()
        assert not store.put({"key": "junk"})
        assert not store.put(None)
        assert store.size() == 0

    def test_seed_record_roundtrip(self):
        rec = make_seed_record("ab" * 20, "doc-xyz", SEED, ttl=60)
        assert verify_seed_record(rec)

    def test_seed_record_tamper_rejected(self):
        rec = make_seed_record("ab" * 20, "doc-xyz", SEED, ttl=60)
        # redirect the replication ask to a different doc
        assert not verify_seed_record(dict(rec, doc="doc-evil"))
        assert not verify_seed_record(dict(rec, key="cd" * 20))
        assert not verify_seed_record(
            dict(rec, sig=rec["sig"][:-4] + "AAA=")
        )

    def test_seed_record_ttl_expiry(self):
        rec = make_seed_record("ab" * 20, "doc-xyz", SEED, ttl=5)
        assert verify_seed_record(rec, now=rec["ts"] + 4)
        assert not verify_seed_record(rec, now=rec["ts"] + 6)


# ---------------------------------------------------------------------------
# k-buckets


def _contact(i):
    return Contact(i, ("127.0.0.1", 10000 + (i % 5000)))


class TestRoutingTable:
    def test_insert_update_and_closest(self):
        t = RoutingTable(self_id=0, k=4)
        for i in (0b1000, 0b1001, 0b1010):
            assert t.observe(i, ("127.0.0.1", 9000 + i)) is None
        assert t.size() == 3
        # re-observe refreshes the address in place, no duplicate
        assert t.observe(0b1000, ("127.0.0.1", 7777)) is None
        assert t.size() == 3
        close = t.closest(0b1001, 2)
        assert close[0].id == 0b1001
        assert {c.id for c in close} == {0b1001, 0b1000}
        # the refreshed address stuck
        assert [
            c.addr for c in t.closest(0b1000, 1)
        ] == [("127.0.0.1", 7777)]

    def test_full_bucket_returns_lru_not_evicts(self):
        """Kademlia's uptime rule: a full bucket NEVER evicts on
        sight — observe returns the LRU for a liveness probe and parks
        the newcomer in the replacement cache."""
        t = RoutingTable(self_id=0, k=3)
        # ids 8..15 share bucket index 3
        for i in (8, 9, 10):
            assert t.observe(i, ("127.0.0.1", 9000 + i)) is None
        lru = t.observe(11, ("127.0.0.1", 9011))
        assert lru is not None and lru.id == 8  # oldest sighting
        assert {c.id for c in t.closest(8)} == {8, 9, 10}  # unchanged

    def test_evict_promotes_replacement(self):
        t = RoutingTable(self_id=0, k=3)
        for i in (8, 9, 10):
            t.observe(i, ("127.0.0.1", 9000 + i))
        lru = t.observe(11, ("127.0.0.1", 9011))
        t.evict(lru)  # the probe timed out: newcomer takes the slot
        assert {c.id for c in t.closest(8)} == {9, 10, 11}

    def test_refresh_keeps_lru_newcomer_stays_parked(self):
        t = RoutingTable(self_id=0, k=3)
        for i in (8, 9, 10):
            t.observe(i, ("127.0.0.1", 9000 + i))
        lru = t.observe(11, ("127.0.0.1", 9011))
        t.refresh(lru)  # the probe answered: long-lived node wins
        assert {c.id for c in t.closest(8)} == {8, 9, 10}
        # and 8 moved to MRU: the next full-bucket probe targets 9
        nxt = t.observe(12, ("127.0.0.1", 9012))
        assert nxt.id == 9

    def test_replacement_cache_bounded_freshest_promoted(self):
        t = RoutingTable(self_id=0, k=2)
        t.observe(8, ("127.0.0.1", 9008))
        t.observe(9, ("127.0.0.1", 9009))
        probes = [t.observe(i, ("127.0.0.1", 9000 + i))
                  for i in (10, 11, 12)]
        # ONE liveness probe per bucket at a time (every sighting from
        # a non-resident would otherwise fire a ping — a storm at
        # fleet scale): the first full-bucket observe returns the LRU,
        # the rest just park in the replacement cache
        assert probes[0] is not None and probes[0].id == 8
        assert probes[1] is None and probes[2] is None
        t.evict(probes[0])
        # the FRESHEST parked newcomer (12) got the slot
        assert {c.id for c in t.closest(8)} == {9, 12}
        # the probe latch cleared: the next full-bucket observe probes
        assert t.observe(13, ("127.0.0.1", 9013)) is not None

    def test_self_never_bucketed(self):
        t = RoutingTable(self_id=42, k=4)
        assert t.observe(42, ("127.0.0.1", 9000)) is None
        assert t.size() == 0

    def test_occupancy(self):
        t = RoutingTable(self_id=0, k=4)
        t.observe(1, ("127.0.0.1", 9001))   # bucket 0
        t.observe(8, ("127.0.0.1", 9008))   # bucket 3
        t.observe(9, ("127.0.0.1", 9009))   # bucket 3
        assert t.occupancy() == {0: 1, 3: 2}


# ---------------------------------------------------------------------------
# nodes: RPC, iterative walks, bootstrap


def _mesh(n, k=None):
    """n nodes all bootstrapped off node 0."""
    nodes = [DhtNode(k=k)]
    for _ in range(n - 1):
        nodes.append(DhtNode(bootstrap=[nodes[0].address], k=k))
    for node in nodes[1:]:
        node.bootstrap_now()
    return nodes


class TestDhtNode:
    def test_ping_populates_both_tables(self):
        a = DhtNode()
        b = DhtNode(bootstrap=[a.address])
        try:
            b.bootstrap_now()
            assert b.table.size() == 1
            wait_until(lambda: a.table.size() == 1)
        finally:
            a.close()
            b.close()

    def test_iterative_lookup_converges(self):
        """An announcer and a looker-up that share only the bootstrap
        node find each other through the iterative walk, and the walk
        counts hops."""
        from hypermerge_tpu_torch import telemetry

        nodes = _mesh(10, k=4)  # small k: forces multi-hop routing
        try:
            key = _id_hex(key_id("some-shared-doc"))
            nodes[3].announce(key, "127.0.0.1", 7333)
            wait_until(
                lambda: any(
                    n.records.get(key) for n in nodes if n is not nodes[3]
                )
            )
            before = telemetry.snapshot().get("dht.lookup_hops", 0)
            found = nodes[9].lookup(key)
            assert [r["port"] for r in found] == [7333]
            assert telemetry.snapshot()["dht.lookup_hops"] > before
        finally:
            for n in nodes:
                n.close()

    def test_multiple_announcers_all_found(self):
        nodes = _mesh(8)
        try:
            key = _id_hex(key_id("popular-doc"))
            for i in (1, 2, 3):
                nodes[i].announce(key, "127.0.0.1", 7000 + i)
            found = nodes[7].lookup(key)
            assert {r["port"] for r in found} == {7001, 7002, 7003}
        finally:
            for n in nodes:
                n.close()

    def test_announce_ttl_expires_fleet_wide(self):
        nodes = _mesh(4)
        try:
            key = _id_hex(key_id("short-lived"))
            nodes[1].announce(key, "127.0.0.1", 7001, ttl=0.3)
            assert [
                r["port"] for r in nodes[3].lookup(key)
            ] == [7001]
            time.sleep(0.4)
            assert nodes[3].lookup(key) == []
        finally:
            for n in nodes:
                n.close()

    def test_bootstrap_churn(self, monkeypatch):
        """A dead bootstrap entry is tolerated (the walk rides the
        live one), and a node that missed its bootstrap window retries
        until the fleet answers."""
        monkeypatch.setenv("HM_DHT_RPC_TIMEOUT_S", "0.2")
        a = DhtNode()
        b = DhtNode(bootstrap=[a.address])
        b.bootstrap_now()
        dead = DhtNode()
        dead_addr = dead.address
        dead.close()
        # dead entry FIRST in the list: must not mask the live one
        c = DhtNode(bootstrap=[dead_addr, b.address])
        try:
            assert c.bootstrap_now() >= 1
            key = _id_hex(key_id("post-churn"))
            a.announce(key, "127.0.0.1", 7100)
            wait_until(lambda: c.lookup(key))
        finally:
            for n in (a, b, c):
                n.close()

    def test_bootstrap_all_dead_returns_zero_then_recovers(
        self, monkeypatch
    ):
        monkeypatch.setenv("HM_DHT_RPC_TIMEOUT_S", "0.2")
        a = DhtNode()
        addr = a.address
        a.close()
        late = DhtNode(bootstrap=[addr])
        try:
            assert late.bootstrap_now() == 0
            # the bootstrap node comes back on the same port: the next
            # retry (DhtSwarm re-runs it every maintenance pass while
            # the table is empty) adopts it
            revived = DhtNode(port=addr[1])
            try:
                assert late.bootstrap_now() == 1
            finally:
                revived.close()
        finally:
            late.close()

    def test_closed_node_fails_fast(self):
        a = DhtNode()
        a.close()
        t0 = time.monotonic()
        assert a.lookup(_id_hex(key_id("x"))) == []
        assert time.monotonic() - t0 < 1.0  # no timeout-per-round wait


# ---------------------------------------------------------------------------
# announce signing cache + push seeding (O(1) steady-state gossip)


class TestSignCache:
    def _counting_sign(self, monkeypatch):
        from hypermerge_tpu_torch.utils import crypto

        calls = []
        real = crypto.sign
        monkeypatch.setattr(
            crypto, "sign",
            lambda payload, seed: calls.append(1) or real(payload, seed),
        )
        return calls

    def test_one_sign_per_half_ttl_window(self, monkeypatch):
        """The steady-state refresher's signature bill: an unchanged
        {key,host,port,ttl} re-announce inside the first half of the
        TTL window reuses the cached record — exactly one Ed25519 sign
        per window, the rest count dht.sign_cache_hits."""
        from hypermerge_tpu_torch import telemetry

        calls = self._counting_sign(monkeypatch)
        node = DhtNode()
        try:
            key = _id_hex(key_id("sign-cache-doc"))
            before = telemetry.snapshot().get("dht.sign_cache_hits", 0)
            node.announce(key, "127.0.0.1", 7001, ttl=60)
            assert len(calls) == 1
            node.announce(key, "127.0.0.1", 7001, ttl=60)
            node.announce(key, "127.0.0.1", 7001, ttl=60)
            assert len(calls) == 1
            got = telemetry.snapshot()["dht.sign_cache_hits"] - before
            assert got == 2
            # a changed endpoint is a different record: re-sign
            node.announce(key, "127.0.0.1", 7002, ttl=60)
            assert len(calls) == 2
        finally:
            node.close()

    def test_resigns_past_half_window(self, monkeypatch):
        """The second half of the TTL window re-signs so the record
        never expires out from under its refresher."""
        calls = self._counting_sign(monkeypatch)
        node = DhtNode()
        try:
            key = _id_hex(key_id("short-ttl-doc"))
            node.announce(key, "127.0.0.1", 7003, ttl=0.12)
            assert len(calls) == 1
            time.sleep(0.08)  # past ttl/2
            node.announce(key, "127.0.0.1", 7003, ttl=0.12)
            assert len(calls) == 2
        finally:
            node.close()

    def test_identity_change_invalidates_cache(self, monkeypatch):
        """set_announce_seed drops cached records — they carry the old
        key's signature and would verify against the wrong identity."""
        calls = self._counting_sign(monkeypatch)
        node = DhtNode()
        try:
            key = _id_hex(key_id("rekeyed-doc"))
            node.announce(key, "127.0.0.1", 7004, ttl=60)
            assert len(calls) == 1
            node.set_announce_seed(os.urandom(32))
            node.announce(key, "127.0.0.1", 7004, ttl=60)
            assert len(calls) == 2
        finally:
            node.close()


class TestPushSeed:
    def test_seed_fires_hook_once_per_doc(self):
        """announce(seed_doc=...) rides the same k-closest walk: every
        receiver's hook fires exactly once per doc — a cached refresh
        re-sends the record but the _seeded dedup never re-opens."""
        from hypermerge_tpu_torch import telemetry
        from hypermerge_tpu_torch.utils import keys as keymod

        nodes = _mesh(4)
        seen = []
        try:
            for n in nodes[1:]:
                n.set_seed_hook(seen.append)
            doc_id = keymod.create().public_key
            key = _id_hex(key_id(keymod.discovery_id(doc_id)))
            before = telemetry.snapshot().get("dht.seeds_rx", 0)
            nodes[0].announce(key, "127.0.0.1", 7100, seed_doc=doc_id)
            wait_until(lambda: len(seen) >= 3)
            assert seen == [doc_id] * 3
            assert telemetry.snapshot()["dht.seeds_rx"] - before >= 3
            nodes[0].announce(key, "127.0.0.1", 7100, seed_doc=doc_id)
            time.sleep(0.2)
            assert len(seen) == 3  # dedup: a refresh never re-opens
        finally:
            for n in nodes:
                n.close()

    def test_key_mismatch_rejected(self):
        """A valid signature is not enough: the record may only ask us
        to replicate the doc whose keyspace position it is stored
        under, or any announcer could push arbitrary docs onto the
        fleet."""
        from hypermerge_tpu_torch.utils import keys as keymod

        node = DhtNode()
        seen = []
        node.set_seed_hook(seen.append)
        try:
            doc_id = keymod.create().public_key
            wrong_key = _id_hex(key_id("not-this-doc"))
            rec = make_seed_record(wrong_key, doc_id, SEED, ttl=60)
            assert not node._handle_seed(rec)
            time.sleep(0.1)
            assert seen == []
        finally:
            node.close()


# ---------------------------------------------------------------------------
# gossip sampler


class _P:
    def __init__(self, i):
        self.id = f"peer{i:03d}"


class TestGossipSampler:
    def test_caps_at_fanout_and_stays_stable(self):
        peers = [_P(i) for i in range(20)]
        g = GossipSampler(fanout=4, reshuffle_s=60, seed=7)
        s1 = g.sample("doc", peers)
        assert len(s1) == 4
        assert [p.id for p in g.sample("doc", peers)] == [
            p.id for p in s1
        ]

    def test_small_peer_sets_pass_through(self):
        peers = [_P(i) for i in range(3)]
        g = GossipSampler(fanout=4, reshuffle_s=60)
        assert g.sample("doc", peers) == peers
        g0 = GossipSampler(fanout=0, reshuffle_s=60)
        assert g0.sample("doc", [_P(i) for i in range(50)]) is not None
        assert len(g0.sample("doc", [_P(i) for i in range(50)])) == 50

    def test_reshuffle_after_period(self):
        peers = [_P(i) for i in range(30)]
        g = GossipSampler(fanout=4, reshuffle_s=0.05, seed=7)
        s1 = {p.id for p in g.sample("doc", peers)}
        time.sleep(0.08)
        seen = set(s1)
        for _ in range(20):
            time.sleep(0.06)
            seen |= {p.id for p in g.sample("doc", peers)}
        assert len(seen) > 4  # rotated through fresh subsets

    def test_departed_peer_triggers_resample(self):
        peers = [_P(i) for i in range(10)]
        g = GossipSampler(fanout=4, reshuffle_s=60, seed=7)
        s1 = g.sample("doc", peers)
        survivors = [p for p in peers if p is not s1[0]]
        s2 = g.sample("doc", survivors)
        assert len(s2) == 4
        assert s1[0].id not in {p.id for p in s2}

    def test_per_key_independent(self):
        peers = [_P(i) for i in range(30)]
        g = GossipSampler(fanout=4, reshuffle_s=60, seed=7)
        a = {p.id for p in g.sample("doc-a", peers)}
        b = {p.id for p in g.sample("doc-b", peers)}
        assert a != b  # overwhelmingly likely with 30C4 per key


# ---------------------------------------------------------------------------
# the swarm seam: repos discover each other through the DHT only


def _dht_fleet(n, boot, fault_plans=None):
    """n memory repos on DhtSwarms bootstrapped off `boot`; optional
    {index: FaultPlan} wraps those swarms for seeded churn."""
    repos, swarms = [], []
    for i in range(n):
        r = Repo(memory=True)
        sw = DhtSwarm(bootstrap=[boot.address])
        if fault_plans and i in fault_plans:
            sw = FaultSwarm(sw, fault_plans[i])
        r.set_swarm(sw)
        repos.append(r)
        swarms.append(sw)
    return repos, swarms


def _teardown(repos, swarms, boot):
    for r in repos:
        r.close()
    for sw in swarms:
        sw.destroy()
    boot.close()


class TestDhtSwarm:
    def test_fleet_converges_dht_only(self, fast_dht):
        """Three repos, zero connect() calls: announce/lookup walks
        find the creator, supervised dials wire the sessions, edits
        converge bidirectionally."""
        boot = DhtNode()
        repos, swarms = _dht_fleet(3, boot)
        try:
            url = repos[0].create({"edits": []})
            handles = [r.open(url) for r in repos[1:]]
            assert all(h.value(timeout=60) is not None for h in handles)
            repos[0].change(url, lambda d: d["edits"].append("a"))
            handles[0].change(lambda d: d["edits"].append("b"))
            wait_until(
                lambda: all(
                    sorted((h.value() or {}).get("edits", []))
                    == ["a", "b"]
                    for h in handles
                )
                and sorted(repos[0].doc(url)["edits"]) == ["a", "b"],
                timeout=60,
            )
        finally:
            _teardown(repos, swarms, boot)

    def test_identity_signs_announces(self, fast_dht):
        """Network.set_swarm wires the repo identity into announce
        records: the published record's pk is the repo's ed25519
        public key, not the ephemeral node key."""
        import base64

        from hypermerge_tpu_torch.utils import crypto

        boot = DhtNode()
        repos, swarms = _dht_fleet(2, boot)
        try:
            url = repos[0].create({"x": 1})
            assert repos[1].open(url).value(timeout=60) is not None
            rep = swarms[0].discovery_report()
            did = next(iter(rep["joined"]))
            key = _id_hex(key_id(did))
            recs = swarms[1].node.lookup(key)
            want = base64.b64encode(
                crypto.public_key(repos[0].back.identity_seed())
            ).decode("ascii")
            assert want in {r["pk"] for r in recs}
        finally:
            _teardown(repos, swarms, boot)

    def test_kill_heal_churn_reconverges(self, fast_dht):
        """The tier-1 slice of the soak: seeded kill mid-burst on one
        peer; the supervised redial + lookup refresh restore it and
        the fleet reconverges bit-identically."""
        plan = FaultPlan(seed=15, events=[(1, "kill"), (2, "heal")])
        boot = DhtNode()
        repos, swarms = _dht_fleet(4, boot, fault_plans={2: plan})
        try:
            url = repos[0].create({"edits": []})
            handles = [r.open(url) for r in repos[1:]]
            assert all(h.value(timeout=60) is not None for h in handles)
            for i in range(12):
                repos[0].change(url, lambda d, i=i: d["edits"].append(i))
                if i == 4:
                    swarms[2].tick()  # kill fires mid-burst
                if i == 8:
                    swarms[2].tick()  # heal
            while plan.tick < 2:
                swarms[2].tick()
            want = list(range(12))
            wait_until(
                lambda: all(
                    (h.value() or {}).get("edits") == want
                    for h in handles
                ),
                timeout=90,
            )
            blobs = {
                json.dumps(h.value(), sort_keys=True) for h in handles
            }
            assert len(blobs) == 1
        finally:
            _teardown(repos, swarms, boot)

    def test_leave_stops_refresh(self, fast_dht):
        boot = DhtNode()
        repos, swarms = _dht_fleet(2, boot)
        try:
            url = repos[0].create({"x": 1})
            assert repos[1].open(url).value(timeout=60) is not None
            rep = swarms[0].discovery_report()
            did = next(iter(rep["joined"]))
            swarms[0].leave(did)
            rep2 = swarms[0].discovery_report()
            assert did not in rep2["joined"]
            assert did not in rep2["targets"]
        finally:
            _teardown(repos, swarms, boot)

    def test_discovery_report_in_telemetry_payload(self, fast_dht):
        boot = DhtNode()
        repos, swarms = _dht_fleet(2, boot)
        try:
            url = repos[0].create({"x": 1})
            assert repos[1].open(url).value(timeout=60) is not None
            payload = repos[0].back.telemetry_payload()
            assert payload["dht"]["node_id"] == swarms[0].node.id_hex
            assert payload["dht"]["nodes"] >= 1
            docs = payload["net"]["docs"]
            ent = next(iter(docs.values()))
            assert ent["announced"] is True
            wait_until(
                lambda: next(
                    iter(
                        repos[0].back.telemetry_payload()["net"][
                            "docs"
                        ].values()
                    )
                )["peers"]
                >= 1,
                timeout=30,
            )
        finally:
            _teardown(repos, swarms, boot)


class TestAnnounceAggregation:
    def test_shared_via_is_one_announce_per_period(
        self, fast_dht, monkeypatch
    ):
        """Two ids joined via the same doc key fold into ONE signed
        announce record and one walk per period — O(docs), not
        O(actor feeds) — and the per-feed keys never hit the DHT."""
        from hypermerge_tpu_torch import telemetry

        # one announce window for the whole test: any extra passes the
        # maintenance loop squeezes in must be provably skip-only
        monkeypatch.setenv("HM_DHT_ANNOUNCE_S", "30")
        boot = DhtNode()
        sw = DhtSwarm(bootstrap=[boot.address])
        try:
            before = telemetry.snapshot().get("dht.announces", 0)
            opts = JoinOptions(announce=True, lookup=False, via="doc-key")
            sw.join("feed-one", opts)
            sw.join("feed-two", opts)
            sw.poke(timeout=5)
            assert telemetry.snapshot()["dht.announces"] - before == 1
            gkey = _id_hex(key_id("doc-key"))
            assert sw.node.records.get(gkey)
            assert not sw.node.records.get(_id_hex(key_id("feed-one")))
            assert not sw.node.records.get(_id_hex(key_id("feed-two")))
        finally:
            sw.destroy()
            boot.close()


# ---------------------------------------------------------------------------
# bounded fanout: 20 peers, HM_GOSSIP_FANOUT=4


class TestBoundedFanout:
    def test_twenty_peers_fanout_four(self, monkeypatch):
        """The satellite claim verbatim: 20 peers on one doc with
        HM_GOSSIP_FANOUT=4 — the creator's replication frames stay
        O(fanout) per edit (an unbounded broadcast would pay ~19 per
        edit), while EVERY peer still converges through relay hops
        plus the anti-entropy sweep."""
        n, fanout, edits = 20, 4, 24
        monkeypatch.setenv("HM_GOSSIP_FANOUT", str(fanout))
        monkeypatch.setenv("HM_GOSSIP_RESHUFFLE_S", "30")
        monkeypatch.setenv("HM_ANTIENTROPY_S", "0")  # sweeps manual
        hub = LoopbackHub()
        repos = []
        try:
            for _ in range(n):
                r = Repo(memory=True)
                r.set_swarm(LoopbackSwarm(hub))
                repos.append(r)
            url = repos[0].create({"edits": []})
            handles = [r.open(url) for r in repos[1:]]
            assert all(
                h.value(timeout=60) is not None for h in handles
            )
            rm = repos[0].back.network.replication
            frames0 = rm.stats["frames_tx"]
            for i in range(edits):
                repos[0].change(url, lambda d, i=i: d["edits"].append(i))
                time.sleep(0.01)  # one flush window per edit: the
                # coalescer must not hide the fanout bound

            want = list(range(edits))

            def converged():
                # anti-entropy path: every NON-creator sweeps (the
                # frames under test are the creator's)
                for r in repos[1:]:
                    r.back.network.replication.sweep_now()
                return all(
                    (h.value() or {}).get("edits") == want
                    for h in handles
                )

            wait_until(converged, timeout=90, interval=0.25)
            frames = rm.stats["frames_tx"] - frames0
            # O(fanout): ~4/edit + straggler pulls; O(peers) would be
            # >= 19/edit = 456
            assert frames <= edits * (fanout + 2) + 60, frames
            blobs = {
                json.dumps(h.value(), sort_keys=True) for h in handles
            }
            assert len(blobs) == 1
        finally:
            for r in repos:
                r.close()

    def test_fanout_zero_broadcasts_to_all(self, monkeypatch):
        monkeypatch.setenv("HM_GOSSIP_FANOUT", "0")
        hub = LoopbackHub()
        repos = []
        try:
            for _ in range(6):
                r = Repo(memory=True)
                r.set_swarm(LoopbackSwarm(hub))
                repos.append(r)
            url = repos[0].create({"edits": []})
            handles = [r.open(url) for r in repos[1:]]
            assert all(
                h.value(timeout=60) is not None for h in handles
            )
            repos[0].change(url, lambda d: d["edits"].append(1))
            wait_until(
                lambda: all(
                    (h.value() or {}).get("edits") == [1]
                    for h in handles
                )
            )
        finally:
            for r in repos:
                r.close()


# the 50-peer churn soak lives in tests/test_fleet_soak.py (-m slow):
# at that scale the lockdep/racedep module instrumentation this suite
# runs under would dominate the wall clock — the guard/lock coverage
# of the discovery classes comes from the tier-1 tests above.


# ---------------------------------------------------------------------------
# parity with the JAX package


def _seeded(rng, n):
    return bytes(rng.integers(0, 256, n, dtype=np.uint8).tolist())


@pytest.mark.parametrize("seed", range(4))
def test_records_equal_reference(seed, monkeypatch):
    """key_id is equal in both packages, and so are the signed records
    (announce and push-seed) for one identity seed and one clock:
    ed25519 signs deterministically, so every byte agrees. Each
    package verifies the other's records, and neither takes a tampered
    one."""
    from hypermerge_tpu.net.discovery import dht as ref

    rng = np.random.default_rng(seed)
    identity = _seeded(rng, 32)
    names = ["doc-%d" % int(rng.integers(1 << 30)), "", "é-ü",
             _seeded(rng, 16).hex()]
    for name in names:
        assert key_id(name) == ref.key_id(name)
        assert _id_hex(key_id(name)) == ref._id_hex(ref.key_id(name))
    key = _id_hex(key_id(names[0]))
    port_n = int(rng.integers(1, 65536))
    now = 1.7e9 + float(rng.uniform(0, 1e6))
    monkeypatch.setattr(time, "time", lambda: now)
    rec = make_record(key, "10.0.0.%d" % seed, port_n, identity, ttl=60)
    ref_rec = ref.make_record(key, "10.0.0.%d" % seed, port_n, identity,
                              ttl=60)
    assert json.dumps(rec, sort_keys=True) == json.dumps(ref_rec,
                                                         sort_keys=True)
    assert _dht._record_bytes(rec) == ref._record_bytes(ref_rec)
    srec = make_seed_record(key, "doc-xyz", identity, ttl=60)
    ref_srec = ref.make_seed_record(key, "doc-xyz", identity, ttl=60)
    assert srec == ref_srec
    assert _dht._seed_record_bytes(srec) == ref._seed_record_bytes(ref_srec)
    # each package's record verifies under the other's check
    other = make_record(key, "127.0.0.1", 4242, _seeded(rng, 32), ttl=30)
    ref_other = ref.make_record(key, "127.0.0.1", 4343, _seeded(rng, 32),
                                ttl=30)
    assert ref.verify_record(other) and verify_record(ref_other)
    assert ref.verify_seed_record(srec) and verify_seed_record(ref_srec)
    for evil in (dict(other, port=6666), dict(ref_other, host="10.9.9.9")):
        assert not verify_record(evil) and not ref.verify_record(evil)
    assert not verify_record(other, now=now + 31)
    assert not ref.verify_record(other, now=now + 31)


def test_port_and_reference_nodes_share_an_overlay(monkeypatch):
    """A port DhtNode and a reference DhtNode speak one UDP protocol: the
    reference node bootstraps off the port node, each announces a key,
    and each finds the other's record by an iterative lookup."""
    from hypermerge_tpu.net.discovery.dht import DhtNode as RefDhtNode

    monkeypatch.setenv("HM_DHT_RPC_TIMEOUT_S", "0.5")
    port_node = DhtNode()
    ref_node = RefDhtNode(bootstrap=[port_node.address])
    try:
        assert ref_node.bootstrap_now() == 1
        wait_until(lambda: port_node.table.size() == 1)
        k_port = _id_hex(key_id("announced-by-the-port"))
        k_ref = _id_hex(key_id("announced-by-the-reference"))
        port_node.announce(k_port, "127.0.0.1", 7201)
        ref_node.announce(k_ref, "127.0.0.1", 7202)
        wait_until(lambda: [r["port"] for r in ref_node.lookup(k_port)]
                   == [7201])
        wait_until(lambda: [r["port"] for r in port_node.lookup(k_ref)]
                   == [7202])
        assert port_node.lookup(k_ref)[0]["pk"] == ref_node.lookup(
            k_ref)[0]["pk"]
    finally:
        ref_node.close()
