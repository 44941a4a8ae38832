"""The network slice on the port (hypermerge_tpu_torch/net/, the backend's
network hooks and `Repo.set_swarm`), on the CPU.

- Every case of tests/test_net.py (duplex pairs, channels, peer dedup,
  replication with sparse fetch, join options, TCP, churn) and of
  tests/test_secure.py (the crypto primitives, the kx session, encrypted
  and authenticated TCP), under the same names, on the port's modules.
  Repos are `Repo(memory=True, device="cpu")`, so the live tick runs its
  plain version; the `net` fixture closes every repo and swarm a case
  made (a leaked flusher thread would hang the run).
- tests/test_crash.py `test_crash_recover_reconverges_with_clean_twin`
  over LoopbackSwarm, with the port's CrashRecorder.
- Parity with the JAX package: the port's chacha and native X25519 /
  ChaCha20-Poly1305, and its libcrypto ed25519 (utils/ossl.py), are
  byte-equal to the reference's on keys, nonces and messages made from a
  seed with numpy, authentication failures included; the libcrypto
  ed25519 refuses the edge cases libsodium refuses (non-canonical S, a
  small-order key or R, a non-canonical key); with the native library's
  libsodium hidden, the crypto facade and a secure session's auth frame
  take the libcrypto route;
  a port Repo and a reference Repo converge to equal values over a
  TcpSwarm pair, one from each package (encrypted and authenticated, and
  again under HM_TCP_PLAINTEXT=1).
- HM_FAULT (net/faults.py) and HM_NET_ASYNC=1 (net/aio.py) are held to
  the reference in tests/test_torch_chaos.py, the DHT in
  tests/test_torch_discovery.py.

Tolerance: exact.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from hypermerge_tpu_torch import native
from hypermerge_tpu_torch.net.connection import PeerConnection
from hypermerge_tpu_torch.net.duplex import duplex_pair
from hypermerge_tpu_torch.net.peer import NetworkPeer
from hypermerge_tpu_torch.net.replication import ReplicationManager
from hypermerge_tpu_torch.net.secure import SecureSession
from hypermerge_tpu_torch.net.swarm import LoopbackHub, LoopbackSwarm
from hypermerge_tpu_torch.net.tcp import TcpDuplex, TcpSwarm
from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.storage.feed import FeedStore, memory_storage_fn
from hypermerge_tpu_torch.utils import chacha
from hypermerge_tpu_torch.utils import keys as keymod
from hypermerge_tpu_torch.utils.ids import validate_doc_url

from helpers import wait_until
from test_torch_repo import plain

_HDR = struct.Struct("<I")


class _Net:
    """The repos and swarms one case made, closed at its end: each repo
    before the swarms (a repo's network destroys its own swarm)."""

    def __init__(self):
        self.repos = []
        self.swarms = []

    def repo(self, **kw):
        kw.setdefault("memory", True)
        r = _PortRepo(device="cpu", **kw)
        self.repos.append(r)
        return r

    def tcp(self):
        s = TcpSwarm()
        self.swarms.append(s)
        return s

    def close(self):
        for r in self.repos:
            if not r.back._closed:
                r.close()
        for s in self.swarms:
            s.destroy()


@pytest.fixture
def net():
    n = _Net()
    try:
        yield n
    finally:
        n.close()


# ---------------------------------------------------------------------------
# tests/test_net.py on the port


class TestDuplex:
    def test_roundtrip_and_buffering(self):
        a, b = duplex_pair()
        got = []
        a.send({"n": 1})  # sent before b subscribes: buffers
        b.on_message(got.append)
        a.send({"n": 2})
        assert got == [{"n": 1}, {"n": 2}]

    def test_close_propagates(self):
        a, b = duplex_pair()
        closed = []
        b.on_close(lambda: closed.append(True))
        a.close()
        assert b.closed and closed == [True]


class TestPeerConnection:
    def test_channels_and_remote_first_buffering(self):
        da, db = duplex_pair()
        ca = PeerConnection(da, is_client=True)
        cb = PeerConnection(db, is_client=False)
        # a sends on a channel b hasn't opened yet
        ca.open_channel("late").send({"x": 1})
        got = []
        cb.open_channel("late").subscribe(got.append)
        assert got == [{"x": 1}]
        # reverse direction on another channel
        got2 = []
        ca.open_channel("other").subscribe(got2.append)
        cb.open_channel("other").send("hi")
        assert got2 == ["hi"]


class TestNetworkPeer:
    def test_duplicate_connection_dedup(self):
        ready = []
        pa = NetworkPeer("idB", "idA", ready.append)  # authority (B > A)
        pb = NetworkPeer("idA", "idB", ready.append)
        # two simultaneous dials = two duplex pairs
        d1a, d1b = duplex_pair()
        d2a, d2b = duplex_pair()
        c1a, c1b = (
            PeerConnection(d1a, True), PeerConnection(d1b, False),
        )
        c2a, c2b = (
            PeerConnection(d2a, False), PeerConnection(d2b, True),
        )
        pa.add_connection(c1a)
        pb.add_connection(c1b)
        pa.add_connection(c2a)
        pb.add_connection(c2b)
        # authority picked for both sides; exactly one live connection each
        assert pa.is_connected and pb.is_connected
        assert len(ready) == 2
        live_a = [c for c in (c1a, c2a) if c.is_open]
        live_b = [c for c in (c1b, c2b) if c.is_open]
        assert len(live_a) == 1 and len(live_b) == 1


class TestReplication:
    def _mgr(self):
        feeds = FeedStore(memory_storage_fn)
        events = []
        mgr = ReplicationManager(
            feeds, lambda pk, peer: events.append(pk)
        )
        return feeds, mgr, events

    def _connect(self, mgr_a, mgr_b):
        da, db = duplex_pair()
        ca, cb = PeerConnection(da, True), PeerConnection(db, False)
        ready = []
        pa = NetworkPeer("B", "A", ready.append)
        pb = NetworkPeer("A", "B", ready.append)
        pa.add_connection(ca)
        pb.add_connection(cb)
        mgr_a.on_peer(pa)
        mgr_b.on_peer(pb)
        return pa, pb

    def test_shared_feed_replicates_both_directions(self):
        feeds_a, mgr_a, ev_a = self._mgr()
        feeds_b, mgr_b, ev_b = self._mgr()
        pair = keymod.create()
        fa = feeds_a.create(pair)
        fa.append(b"one")
        fa.append(b"two")
        fb = feeds_b.open_feed(pair.public_key)  # knows the key, no data
        self._connect(mgr_a, mgr_b)
        try:
            assert fb.read_all() == [b"one", b"two"]
            assert ev_a and ev_b  # discovery fired on both sides
            # live tail after connect (batched flush: asynchronous)
            fa.append(b"three")
            wait_until(lambda: fb.length == 3)
            assert fb.read_all() == [b"one", b"two", b"three"]
        finally:
            mgr_a.close()
            mgr_b.close()

    def test_live_tail_batches_bursts(self):
        """A burst of appends coalesces into O(1) signed frames per
        flush window, not one frame per append."""
        feeds_a, mgr_a, _ = self._mgr()
        feeds_b, mgr_b, _ = self._mgr()
        pair = keymod.create()
        fa = feeds_a.create(pair)
        fb = feeds_b.open_feed(pair.public_key)
        self._connect(mgr_a, mgr_b)
        frames = []
        orig = mgr_a._send

        def counting_send(peer, msg):
            if msg.get("type") == "Blocks":
                frames.append(len(msg["blocks"]))
            orig(peer, msg)

        mgr_a._send = counting_send
        try:
            n = 200
            for i in range(n):
                fa.append(b"blk%d" % i)
            wait_until(lambda: fb.length == n)
            assert fb.read_all() == [b"blk%d" % i for i in range(n)]
            # every block arrived, in far fewer frames than appends
            assert len(frames) <= n // 4, (len(frames), frames)
        finally:
            mgr_a.close()
            mgr_b.close()

    def test_unknown_feed_not_replicated(self):
        feeds_a, mgr_a, _ = self._mgr()
        feeds_b, mgr_b, ev_b = self._mgr()
        fa = feeds_a.create(keymod.create())
        fa.append(b"secret")
        self._connect(mgr_a, mgr_b)
        try:
            # b never learns the public key, so nothing arrives
            assert not ev_b
            assert feeds_b.known_discovery_ids() == []
        finally:
            mgr_a.close()
            mgr_b.close()

    def test_late_feed_announcement(self):
        feeds_a, mgr_a, _ = self._mgr()
        feeds_b, mgr_b, _ = self._mgr()
        self._connect(mgr_a, mgr_b)
        try:
            pair = keymod.create()
            fb = feeds_b.open_feed(pair.public_key)
            fa = feeds_a.create(pair)  # created after connection
            mgr_a.announce(fa)
            mgr_b.announce(fb)
            fa.append(b"late")
            wait_until(lambda: fb.length == 1)
            assert fb.read_all() == [b"late"]
        finally:
            mgr_a.close()
            mgr_b.close()


class TestTwoRepos:
    """Whole-repo convergence over a loopback swarm (reference
    tests/multiple-repos.test.ts)."""

    def _pair(self, net):
        hub = LoopbackHub()
        ra, rb = net.repo(), net.repo()
        ra.set_swarm(LoopbackSwarm(hub))
        rb.set_swarm(LoopbackSwarm(hub))
        return ra, rb

    def test_share_a_doc(self, net):
        ra, rb = self._pair(net)
        url = ra.create({"hello": "world"})
        doc = rb.doc(url)
        assert doc == {"hello": "world"}

    def test_bidirectional_edits(self, net):
        ra, rb = self._pair(net)
        url = ra.create({"from_a": 1})
        assert rb.doc(url)["from_a"] == 1
        rb.change(url, lambda d: d.__setitem__("from_b", 2))
        wait_until(lambda: ra.doc(url) == {"from_a": 1, "from_b": 2})
        ra.change(url, lambda d: d.__setitem__("from_a", 11))
        wait_until(lambda: rb.doc(url) == {"from_a": 11, "from_b": 2})

    def test_remote_patch_reaches_lazily_loaded_doc(self, net):
        """A doc served from the lazy path must still emit live
        RemotePatches: the incoming window produces a real patch."""
        ra, rb = self._pair(net)
        url = ra.create({"x": 1})
        states = []
        h = rb.open(url)
        h.subscribe(lambda d, i: states.append(dict(d) if d else d))
        assert states and states[-1]["x"] == 1
        ra.change(url, lambda d: d.__setitem__("x", 2))
        # no re-open: the update must arrive via the live patch stream
        wait_until(lambda: states and states[-1]["x"] == 2)
        assert h.value()["x"] == 2
        h.close()

    def test_stale_ready_does_not_clobber_local_state(self, net):
        """A Ready snapshot arriving for a doc already in write mode
        (cross-process ordering) is ignored — local optimistic state
        stays ahead (reference DocFrontend.init is pending-only)."""
        repo = net.repo()
        url = repo.create({"a": 1, "log": []})
        df = repo.front.docs[validate_doc_url(url)]
        # simulate a late (stale, empty-doc) Ready crossing the seam
        df.on_ready(df.actor_id, {"clock": {}, "deps": {}, "maxOp": 0,
                                  "diffs": []}, 0)
        # local state intact and still writable
        repo.change(url, lambda d: d["log"].append(7))
        got = repo.doc(url)
        assert got["a"] == 1 and list(got["log"]) == [7]

    def test_watch_remote_updates(self, net):
        ra, rb = self._pair(net)
        url = ra.create({"n": 0})
        seen = []
        h = rb.open(url).subscribe(lambda doc, _i: seen.append(doc.get("n")))
        for i in range(1, 4):
            ra.change(url, lambda d, i=i: d.__setitem__("n", i))
        wait_until(lambda: seen and seen[-1] == 3)
        h.close()

    def test_doc_message_ephemeral(self, net):
        ra, rb = self._pair(net)
        url = ra.create({"x": 1})
        inbox = []
        h = rb.open(url)
        h.subscribe_message(inbox.append)
        assert h.value() == {"x": 1}  # wait until replicated/connected
        ra.message(url, {"ping": True})
        wait_until(lambda: inbox == [{"ping": True}])
        h.close()

    def test_three_repos_converge(self, net):
        hub = LoopbackHub()
        repos = [net.repo() for _ in range(3)]
        for r in repos:
            r.set_swarm(LoopbackSwarm(hub))
        url = repos[0].create({"base": True})
        for i, r in enumerate(repos):
            r.change(url, lambda d, i=i: d.__setitem__(f"r{i}", i))
        want = {"base": True, "r0": 0, "r1": 1, "r2": 2}
        wait_until(lambda: all(r.doc(url) == want for r in repos))

    def test_three_repo_tcp_relay_exact_convergence(self, net):
        """Concurrent edits on an A<->B<->C TCP line: every edit lands on
        every repo, exactly once (relay re-serving included)."""
        import random

        repos = [net.repo() for _ in range(3)]
        swarms = [net.tcp() for _ in range(3)]
        for r, s in zip(repos, swarms):
            r.set_swarm(s)
        swarms[1].connect(swarms[0].address)
        swarms[2].connect(swarms[1].address)
        urls = [repos[0].create({"edits": []}) for _ in range(3)]
        for r in repos[1:]:
            for u in urls:
                r.open(u)
        stop = time.time() + 8
        counts = [0, 0, 0]

        def churn(idx):
            rng = random.Random(idx)
            while time.time() < stop:
                repos[idx].change(
                    rng.choice(urls),
                    lambda d, i=idx: d["edits"].append(i),
                )
                counts[idx] += 1
                time.sleep(rng.random() * 0.01)

        ts = [threading.Thread(target=churn, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        sent = sum(counts)
        deadline = time.time() + 90
        while time.time() < deadline:
            try:
                totals = [
                    sum(len(r.doc(u)["edits"]) for u in urls)
                    for r in repos
                ]
            except TimeoutError:
                time.sleep(0.2)
                continue
            if totals == [sent] * 3:
                break
            time.sleep(0.2)
        assert totals == [sent] * 3, (totals, sent)


class TestSparseFetch:
    """Arbitrary-range block fetch with merkle inclusion proofs
    (hypercore's sparse download — reference
    src/types/hypercore.d.ts:132-188): a peer can pull the TAIL of a
    long feed, verified, without the contiguous prefix."""

    @pytest.fixture
    def pair(self):
        feeds_a = FeedStore(memory_storage_fn)
        feeds_b = FeedStore(memory_storage_fn)
        mgr_a = ReplicationManager(feeds_a, lambda pk, p: None)
        mgr_b = ReplicationManager(feeds_b, lambda pk, p: None)
        # the client opts OUT of contiguous backfill: capability
        # verification still runs, but it never REQUESTS blocks
        # (sparse-only consumer)
        mgr_b._request_msg = lambda *a, **k: None
        da, db = duplex_pair()
        ca, cb = PeerConnection(da, True), PeerConnection(db, False)
        pa = NetworkPeer("B", "A", lambda p: None)
        pb = NetworkPeer("A", "B", lambda p: None)
        pa.add_connection(ca)
        pb.add_connection(cb)
        mgr_a.on_peer(pa)
        mgr_b.on_peer(pb)
        try:
            yield feeds_a, feeds_b, mgr_a, mgr_b, pb
        finally:
            mgr_a.close()
            mgr_b.close()

    def test_tail_fetch_without_prefix(self, pair):
        feeds_a, feeds_b, mgr_a, mgr_b, _ = pair
        kp = keymod.create()
        fa = feeds_a.create(kp)
        for i in range(300):
            fa.append(b"blk%d" % i)
        fb = feeds_b.open_feed(kp.public_key)
        mgr_a.announce(fa)
        mgr_b.announce(fb)
        # B holds NOTHING contiguous, then asks for the tail only
        assert fb.length == 0
        wait_until(
            lambda: mgr_b.request_range(fa.discovery_id, 290, 300)
        )
        wait_until(lambda: fb.has_block(299))
        assert fb.length == 0  # still no contiguous prefix
        for i in range(290, 300):
            assert fb.get_sparse(i) == b"blk%d" % i
        assert fb.get_sparse(0) is None

    def test_tampered_sparse_block_rejected(self, pair):
        import base64 as b64mod

        feeds_a, feeds_b, mgr_a, mgr_b, pb = pair
        kp = keymod.create()
        fa = feeds_a.create(kp)
        for i in range(64):
            fa.append(b"blk%d" % i)
        fb = feeds_b.open_feed(kp.public_key)
        mgr_a.announce(fa)
        mgr_b.announce(fb)
        wait_until(
            lambda: mgr_b.request_range(fa.discovery_id, 60, 64)
        )
        wait_until(lambda: fb.has_block(63))
        # now forge a SparseBlocks frame with a swapped block
        served = fa.integrity.range_proofs(fa, 10, 11)
        length, sig, pairs = served
        evil = b"evil"
        mgr_b._on_sparse_blocks(
            pb,
            fa.discovery_id,
            10,
            length,
            b64mod.b64encode(sig).decode(),
            [b64mod.b64encode(evil).decode()],
            [[b64mod.b64encode(h).decode() for h in pairs[0][1]]],
        )
        assert not fb.has_block(10), "forged sparse block stored"

    def test_sparse_buffer_defers_to_contiguous_log(self):
        feeds = FeedStore(memory_storage_fn)
        f = feeds.create(keymod.create())
        f.append(b"real0")
        f.put_sparse(0, b"ignored")  # head already covers index 0
        assert f.get_sparse(0) == b"real0"
        f.put_sparse(5, b"future")
        assert f.get_sparse(5) == b"future"
        f.append(b"real1")
        assert f.get_sparse(1) == b"real1"

    def test_unsolicited_sparse_push_never_lands(self, pair):
        """A push of VALID proof-carrying blocks the receiver never
        requested must neither store blocks nor grow memory — only
        outstanding requested ranges may land."""
        import base64 as b64mod

        feeds_a, feeds_b, mgr_a, mgr_b, pb = pair
        kp = keymod.create()
        fa = feeds_a.create(kp)
        for i in range(64):
            fa.append(b"blk%d" % i)
        fb = feeds_b.open_feed(kp.public_key)
        mgr_a.announce(fa)
        mgr_b.announce(fb)
        # B never called request_range: craft a fully VALID frame
        served = fa.integrity.range_proofs(fa, 10, 14)
        length, sig, pairs = served

        def push():
            mgr_b._on_sparse_blocks(
                pb,
                fa.discovery_id,
                10,
                length,
                b64mod.b64encode(sig).decode(),
                [b64mod.b64encode(b).decode() for b, _p in pairs],
                [
                    [b64mod.b64encode(h).decode() for h in p]
                    for _b, p in pairs
                ],
            )

        push()
        assert not any(fb.has_block(i) for i in range(10, 14))
        assert len(fb._sparse) == 0, "unsolicited push grew the buffer"

        # a real request keeps working, and indices OUTSIDE it drop
        wait_until(lambda: mgr_b.request_range(fa.discovery_id, 20, 22))
        wait_until(lambda: fb.has_block(21))
        assert fb.get_sparse(20) == b"blk20"
        before = len(fb._sparse)
        push()  # replay of the unrequested frame
        assert len(fb._sparse) == before
        assert not fb.has_block(10)

    def test_sparse_buffer_cap_evicts_furthest(self, monkeypatch):
        """HM_SPARSE_CAP bounds Feed._sparse; eviction drops the entry
        FURTHEST beyond the contiguous head."""
        monkeypatch.setenv("HM_SPARSE_CAP", "4")
        feeds = FeedStore(memory_storage_fn)
        f = feeds.create(keymod.create())
        for i in range(10, 22):
            f.put_sparse(i, b"s%d" % i)
        assert len(f._sparse) == 4
        assert sorted(f._sparse) == [10, 11, 12, 13]
        # nearer-than-buffered still displaces the furthest
        f.put_sparse(5, b"s5")
        assert sorted(f._sparse) == [5, 10, 11, 12]
        # duplicates of buffered indices never evict
        f.put_sparse(11, b"s11")
        assert sorted(f._sparse) == [5, 10, 11, 12]

    def test_sparse_cap_zero_drops_instead_of_crashing(self, monkeypatch):
        """HM_SPARSE_CAP<=0 disables the buffer: put_sparse must report
        the drop (False), not raise max() on an empty dict."""
        monkeypatch.setenv("HM_SPARSE_CAP", "0")
        feeds = FeedStore(memory_storage_fn)
        f = feeds.create(keymod.create())
        assert f.put_sparse(3, b"s3") is False
        assert f._sparse == {}
        # blocks the contiguous log already holds still report True
        f.append(b"real0")
        assert f.put_sparse(0, b"dup") is True


class TestJoinOptions:
    """Discovery asymmetry (reference src/SwarmInterface.ts:22-25):
    server-ish peers announce, clients look up; a lookup-only join is
    invisible to inbound discovery."""

    def test_lookup_only_finds_announcer(self, net):
        from hypermerge_tpu_torch.net.swarm import JoinOptions

        hub = LoopbackHub()
        server, client = net.repo(), net.repo()
        server.set_swarm(
            LoopbackSwarm(hub), JoinOptions(announce=True, lookup=False)
        )
        client.set_swarm(
            LoopbackSwarm(hub), JoinOptions(announce=False, lookup=True)
        )
        url = server.create({"served": True})
        assert client.doc(url) == {"served": True}

    def test_two_lookup_only_peers_never_pair(self, net):
        from hypermerge_tpu_torch.net.swarm import JoinOptions

        hub = LoopbackHub()
        ra, rb = net.repo(), net.repo()
        lookup = JoinOptions(announce=False, lookup=True)
        sa, sb = LoopbackSwarm(hub), LoopbackSwarm(hub)
        ra.set_swarm(sa, lookup)
        rb.set_swarm(sb, lookup)
        url = ra.create({"x": 1})
        rb.open(url)
        time.sleep(0.3)
        # neither accepted inbound discovery: no connection formed
        assert not sa.connected and not sb.connected
        assert not ra.back.network.peers and not rb.back.network.peers

    def test_two_announce_only_peers_never_pair(self, net):
        from hypermerge_tpu_torch.net.swarm import JoinOptions

        hub = LoopbackHub()
        ra, rb = net.repo(), net.repo()
        ann = JoinOptions(announce=True, lookup=False)
        sa, sb = LoopbackSwarm(hub), LoopbackSwarm(hub)
        ra.set_swarm(sa, ann)
        rb.set_swarm(sb, ann)
        ra.create({"x": 1})
        time.sleep(0.2)
        assert not sa.connected and not sb.connected

    def test_leave_cancels_pending_join(self):
        """A leave racing a join must not strand a member entry: the
        late hub registration cancels itself (LoopbackHub.join re-checks
        `joined` inside the hub lock)."""
        from hypermerge_tpu_torch.net.swarm import DEFAULT_JOIN

        hub = LoopbackHub()
        s = LoopbackSwarm(hub)
        did = "race-doc"
        # the racy interleave, step by step: join's first half...
        s.joined.add(did)
        # ...a concurrent leave runs completely...
        s.leave(did)
        # ...then join's second half (the hub registration) lands late
        hub.join(s, did, DEFAULT_JOIN)
        assert not hub._members.get(did), "leave left a member behind"
        # and a member entry stranded this way would actually pair: a
        # fresh looker-up must NOT connect to the departed swarm
        other = LoopbackSwarm(hub)
        got = []
        other.on_connection(lambda d, det: got.append(d))
        other.join(did)
        assert not got and not other.connected

    def test_leave_then_rejoin_still_pairs(self):
        """The leave fix must not eat a genuine re-join."""
        hub = LoopbackHub()
        sa, sb = LoopbackSwarm(hub), LoopbackSwarm(hub)
        conns = []
        sa.on_connection(lambda d, det: conns.append(d))
        sb.on_connection(lambda d, det: conns.append(d))
        sa.join("doc")
        sa.leave("doc")
        sa.join("doc")
        sb.join("doc")
        assert conns and sa.connected

    def test_default_join_is_symmetric(self, net):
        hub = LoopbackHub()
        ra, rb = net.repo(), net.repo()
        ra.set_swarm(LoopbackSwarm(hub))
        rb.set_swarm(LoopbackSwarm(hub))
        url = ra.create({"x": 1})
        assert rb.doc(url) == {"x": 1}


class TestTcp:
    """Real-socket transport: two repos converge over localhost TCP."""

    def test_two_repos_over_tcp(self, net):
        ra, rb = net.repo(), net.repo()
        sa, sb = net.tcp(), net.tcp()
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        url = ra.create({"over": "tcp"})
        doc = rb.open(url).value(timeout=10)
        assert doc == {"over": "tcp"}
        rb.change(url, lambda d: d.__setitem__("back", True))
        deadline = time.time() + 10
        while time.time() < deadline:
            if ra.doc(url).get("back"):
                break
            time.sleep(0.05)
        assert ra.doc(url) == {"over": "tcp", "back": True}

    def test_non_draining_peer_sheds_connection(self, monkeypatch):
        """A peer that stops reading while its socket stays open must
        shed the connection at HM_TCP_OUTBOX_MB, not grow the outbox
        forever."""
        monkeypatch.setenv("HM_TCP_PLAINTEXT", "1")
        monkeypatch.setenv("HM_TCP_OUTBOX_MB", "0.01")  # ~10 KB
        monkeypatch.setenv("HM_TCP_STALL_S", "0.2")
        a, b = socket.socketpair()
        # tiny kernel buffers so the writer wedges in sendall quickly
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        d = TcpDuplex(a)
        payload = {"pad": "x" * 4096}
        deadline = time.time() + 10
        while not d.closed and time.time() < deadline:
            d.send(payload)
        assert d.closed, "outbox grew past the cap without shedding"
        b.close()

    def test_close_with_wedged_writer_is_prompt(self, monkeypatch):
        """A peer that dies with a frame wedged in sendall must not
        make close() burn its full 5s drain deadline."""
        monkeypatch.setenv("HM_TCP_PLAINTEXT", "1")
        a, b = socket.socketpair()
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        d = TcpDuplex(a)
        payload = {"pad": "x" * 4096}
        for _ in range(64):  # wedge the writer, queue a backlog
            d.send(payload)
        t0 = time.monotonic()
        b.close()  # peer dies: frames queued + one mid-sendall
        deadline = time.monotonic() + 10
        while not d.closed and time.monotonic() < deadline:
            time.sleep(0.02)
        assert d.closed
        d.close()  # idempotent, and must return promptly too
        assert time.monotonic() - t0 < 3.0, "close stalled on drain"


class TestChurn:
    def test_reconnect_resumes_replication(self, net):
        """After the transport drops, a redial must renegotiate feeds and
        deliver new changes."""
        ra, rb = net.repo(), net.repo()
        sa, sb = net.tcp(), net.tcp()
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        url = ra.create({"v": 1})
        assert rb.open(url).value(timeout=10)["v"] == 1

        # hard-drop every transport on b's side
        for d in list(sb._duplexes):
            d.close()
        deadline = time.time() + 5
        while time.time() < deadline:
            peer = next(iter(rb.back.network.peers.values()), None)
            if peer is not None and not peer.is_connected:
                break
            time.sleep(0.05)

        # change while disconnected, then redial
        ra.change(url, lambda d: d.__setitem__("v", 2))
        sb.connect(sa.address)
        deadline = time.time() + 10
        while time.time() < deadline:
            if rb.doc(url).get("v") == 2:
                break
            time.sleep(0.05)
        assert rb.doc(url)["v"] == 2

    def test_malformed_peer_messages_survive(self, net):
        """Garbage on the Msgs/Replication channels must not kill sync."""
        ra, rb = net.repo(), net.repo()
        hub = LoopbackHub()
        ra.set_swarm(LoopbackSwarm(hub))
        rb.set_swarm(LoopbackSwarm(hub))
        url = ra.create({"x": 1})
        assert rb.doc(url) == {"x": 1}
        # inject malformed frames from a's side toward b
        peer = next(iter(ra.back.network.peers.values()))
        ch = peer.connection.open_channel("Msgs")
        ch.send({"type": "CursorMessage"})  # missing fields
        ch.send({"type": "DocumentMessage"})
        ch.send(42)
        rch = peer.connection.open_channel("Replication")
        rch.send({"type": "Blocks", "id": "nope", "from": "NaN", "blocks": 3})
        rch.send({"type": "FeedLength"})
        # sparse-fetch surface: malformed ranges, bogus proofs, junk b64
        rch.send({"type": "RequestRange", "id": "nope", "from": 0})
        rch.send({"type": "RequestRange", "id": "nope", "from": -5,
                  "to": "many", "cap": 7})
        rch.send({"type": "SparseBlocks", "id": "nope", "from": 0,
                  "len": 1, "sig": "!!notb64!!", "blocks": ["@@"],
                  "proofs": [[]]})
        rch.send({"type": "SparseBlocks", "id": "nope", "from": 0,
                  "len": "x", "sig": None, "blocks": 1, "proofs": {}})
        # sync still works afterwards
        ra.change(url, lambda d: d.__setitem__("x", 2))
        wait_until(lambda: rb.doc(url).get("x") == 2)


# ---------------------------------------------------------------------------
# tests/test_secure.py on the port


class TestPrimitives:
    def test_pure_x25519_agrees_with_itself(self):
        sk1, sk2 = b"\x01" * 32, b"\x02" * 32
        pk1 = chacha.x25519_base(sk1)
        pk2 = chacha.x25519_base(sk2)
        assert chacha.x25519(sk1, pk2) == chacha.x25519(sk2, pk1)

    def test_rfc7748_vector(self):
        # RFC 7748 §5.2 test vector 1
        k = bytes.fromhex(
            "a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4"
        )
        u = bytes.fromhex(
            "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c"
        )
        want = bytes.fromhex(
            "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
        )
        assert chacha.x25519(k, u) == want

    def test_aead_roundtrip_and_tamper(self):
        key, nonce = b"k" * 32, b"n" * 12
        ct = chacha.aead_encrypt(key, nonce, b"secret payload")
        assert chacha.aead_decrypt(key, nonce, ct) == b"secret payload"
        bad = ct[:-1] + bytes([ct[-1] ^ 1])
        assert chacha.aead_decrypt(key, nonce, bad) is None

    @pytest.mark.skipif(not native.available(), reason="no native layer")
    def test_pure_interops_with_native(self):
        sk = b"\x07" * 32
        assert chacha.x25519_base(sk) == native.x25519_base(sk)
        key, nonce = b"K" * 32, b"N" * 12
        msg = b"cross-implementation frame"
        assert native.aead_decrypt(
            key, nonce, chacha.aead_encrypt(key, nonce, msg)
        ) == msg
        assert chacha.aead_decrypt(
            key, nonce, native.aead_encrypt(key, nonce, msg)
        ) == msg


class TestSecureSession:
    def _pair(self):
        c, s = SecureSession(True), SecureSession(False)
        c.complete(s.handshake_bytes)
        s.complete(c.handshake_bytes)
        return c, s

    def test_roundtrip_both_directions(self):
        c, s = self._pair()
        assert s.decrypt(c.encrypt(b"hello")) == b"hello"
        assert c.decrypt(s.encrypt(b"world")) == b"world"
        # counters advance: repeated frames differ on the wire
        w1, w2 = c.encrypt(b"same"), c.encrypt(b"same")
        assert w1 != w2
        assert s.decrypt(w1) == b"same" and s.decrypt(w2) == b"same"

    def test_tampered_frame_rejected(self):
        c, s = self._pair()
        wire = bytearray(c.encrypt(b"payload"))
        wire[3] ^= 0x40
        assert s.decrypt(bytes(wire)) is None

    def test_wire_is_not_plaintext(self):
        c, s = self._pair()
        assert b"payload" not in c.encrypt(b'{"x": "payload"}')

    def test_low_order_handshake_key_rejected(self):
        s = SecureSession(False)
        with pytest.raises(ValueError):
            s.complete(b"\x00" * 32)  # neutral-element point -> q = 0


class TestTcpEncrypted:
    def _duplex_pair(self):
        a, b = socket.socketpair()
        out = {}

        def server():
            out["s"] = TcpDuplex(b, is_client=False)

        t = threading.Thread(target=server)
        t.start()
        da = TcpDuplex(a, is_client=True)
        t.join()
        return da, out["s"], a, b

    def test_encrypted_roundtrip(self):
        da, db, _a, _b = self._duplex_pair()
        got = []
        db.on_message(got.append)
        da.send({"secret": "value"})
        for _ in range(100):
            if got:
                break
            time.sleep(0.01)
        assert got == [{"secret": "value"}]
        da.close()
        db.close()

    def test_tampered_ciphertext_drops_connection(self):
        da, db, a, _b = self._duplex_pair()
        got = []
        db.on_message(got.append)
        # inject a forged frame directly on the raw socket, bypassing
        # da's session: authentication must fail and db must close
        forged = b"\x00" * 24
        a.sendall(_HDR.pack(len(forged)) + forged)
        for _ in range(200):
            if db.closed:
                break
            time.sleep(0.01)
        assert db.closed
        assert got == []
        da.close()

    def test_two_repos_converge_over_encrypted_tcp(self, net):
        ra, rb = net.repo(), net.repo()
        sa, sb = net.tcp(), net.tcp()
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        url = ra.create({"enc": "rypted"})
        doc_id = validate_doc_url(url)
        h = rb.open(url)
        for _ in range(200):
            doc = rb.back.docs.get(doc_id)
            if doc is not None and doc._announced:
                break
            time.sleep(0.02)
        assert h.value()["enc"] == "rypted"


class TestAuthenticatedHandshake:
    """Identity auth: the repo's static ed25519 keypair signs the
    ephemeral handshake transcript — noise-peer's XX upgrade over the
    anonymous NN exchange."""

    def _session_pair(self):
        a, b = SecureSession(True), SecureSession(False)
        a.complete(b.handshake_bytes)
        b.complete(a.handshake_bytes)
        return a, b

    def test_auth_frame_roundtrip_pins_identity(self):
        pa, pb = keymod.create(), keymod.create()
        sa, sb = self._session_pair()
        seed_a = keymod.decode_pair(pa).secret_key
        seed_b = keymod.decode_pair(pb).secret_key
        assert sb.verify_auth(sa.auth_frame(seed_a))
        assert sa.verify_auth(sb.auth_frame(seed_b))
        assert sb.peer_identity == pa.public_key
        assert sa.peer_identity == pb.public_key

    def test_auth_frame_role_bound(self):
        """A reflected auth frame (our own, or one signed for the wrong
        role) never verifies — mirror attacks fail."""
        pa = keymod.create()
        seed = keymod.decode_pair(pa).secret_key
        sa, sb = self._session_pair()
        frame = sa.auth_frame(seed)  # signed with role C
        assert not sa.verify_auth(frame)  # reflected back to its maker
        assert sb.verify_auth(frame)

    def test_channel_binding_unique_per_session(self):
        sa, sb = self._session_pair()
        sc, sd = self._session_pair()
        assert sa.channel_binding == sb.channel_binding
        assert sa.channel_binding != sc.channel_binding

    def test_mitm_key_substitution_fails_closed(self):
        """An active attacker terminates the crypto on both legs with
        its own ephemerals and relays every frame (including the
        victims' auth frames). The signatures cover the ephemeral
        transcript each VICTIM saw, so verify_auth fails on both ends."""
        pa, pb = keymod.create(), keymod.create()
        seed_a = keymod.decode_pair(pa).secret_key
        seed_b = keymod.decode_pair(pb).secret_key

        alice = SecureSession(True)     # dials who she thinks is Bob
        mitm_srv = SecureSession(False)  # attacker's leg toward Alice
        mitm_cli = SecureSession(True)   # attacker's leg toward Bob
        bob = SecureSession(False)

        alice.complete(mitm_srv.handshake_bytes)
        mitm_srv.complete(alice.handshake_bytes)
        mitm_cli.complete(bob.handshake_bytes)
        bob.complete(mitm_cli.handshake_bytes)

        # attacker relays the auth frames across its two sessions
        alice_auth = mitm_srv.decrypt(
            alice.encrypt(alice.auth_frame(seed_a))
        )
        relayed_to_bob = bob.decrypt(mitm_cli.encrypt(alice_auth))
        assert not bob.verify_auth(relayed_to_bob)

        bob_auth = mitm_cli.decrypt(bob.encrypt(bob.auth_frame(seed_b)))
        relayed_to_alice = alice.decrypt(mitm_srv.encrypt(bob_auth))
        assert not alice.verify_auth(relayed_to_alice)

    def test_tcp_mitm_relay_drops_both_sides(self):
        """End-to-end over sockets: a crypto-terminating relay between
        two identity-bearing TcpDuplexes; both transports must close
        during the handshake."""
        seed_a = keymod.decode_pair(keymod.create()).secret_key
        seed_b = keymod.decode_pair(keymod.create()).secret_key

        a_sock, m1 = socket.socketpair()
        m2, b_sock = socket.socketpair()

        def read_exact(s, n):
            buf = b""
            while len(buf) < n:
                c = s.recv(n - len(buf))
                if not c:
                    return None
                buf += c
            return buf

        def relay_leg(sess, sock_in, other_sess, sock_out, n_frames):
            # read n encrypted frames, re-encrypt on the other leg
            for _ in range(n_frames):
                hdr = read_exact(sock_in, 4)
                if hdr is None:
                    return
                (size,) = struct.unpack("<I", hdr)
                wire = read_exact(sock_in, size)
                if wire is None:
                    return
                plain_frame = sess.decrypt(wire)
                if plain_frame is None:
                    return
                out = other_sess.encrypt(plain_frame)
                try:
                    sock_out.sendall(struct.pack("<I", len(out)) + out)
                except OSError:
                    return

        def mitm():
            srv = SecureSession(False)  # toward Alice (she dials)
            cli = SecureSession(True)   # toward Bob
            # ephemeral exchange, substituting our own keys; the MITM
            # keeps the auth offer bit set — clearing it would
            # downgrade to an anonymous session, not break auth
            hdr = read_exact(m1, 4)
            alice_frame = read_exact(m1, struct.unpack("<I", hdr)[0])
            m1.sendall(struct.pack("<I", 33) + b"\x01" + srv.handshake_bytes)
            srv.complete(alice_frame[-32:])
            m2.sendall(struct.pack("<I", 33) + b"\x01" + cli.handshake_bytes)
            hdr = read_exact(m2, 4)
            bob_frame = read_exact(m2, struct.unpack("<I", hdr)[0])
            cli.complete(bob_frame[-32:])
            # relay the (encrypted) auth frames both ways
            t = threading.Thread(
                target=relay_leg, args=(srv, m1, cli, m2, 4), daemon=True
            )
            t.start()
            relay_leg(cli, m2, srv, m1, 4)
            t.join(timeout=5)

        mt = threading.Thread(target=mitm, daemon=True)
        mt.start()
        out = {}

        def bob_side():
            out["b"] = TcpDuplex(b_sock, is_client=False, identity=seed_b)

        bt = threading.Thread(target=bob_side, daemon=True)
        bt.start()
        da = TcpDuplex(a_sock, is_client=True, identity=seed_a)
        bt.join(timeout=10)
        mt.join(timeout=10)
        assert da.closed
        assert out["b"].closed

    def test_repo_peers_pin_each_others_identity(self, net):
        """Two repos over authenticated TCP: each peer's transport-proven
        identity IS the other repo's id."""
        ra, rb = net.repo(), net.repo()
        sa, sb = net.tcp(), net.tcp()
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        for _ in range(200):
            if ra.back.network.peers and rb.back.network.peers:
                break
            time.sleep(0.02)
        (pa,) = ra.back.network.peers.values()
        (pb,) = rb.back.network.peers.values()
        assert pa.connection.peer_identity == rb.back.id
        assert pb.connection.peer_identity == ra.back.id

    def test_claimed_peer_id_must_match_proven_identity(self):
        """Network rejects an Info whose peerId differs from the
        transport-authenticated identity (impersonation)."""
        from hypermerge_tpu_torch.net.network import Network
        from hypermerge_tpu_torch.net.swarm import ConnectionDetails

        class FakeDuplex:
            peer_identity = "PROVEN-IDENTITY"

            def __init__(self):
                self.sent = []
                self.closed = False

            def on_message(self, cb):
                self._cb = cb

            def on_close(self, cb):
                pass

            def send(self, msg):
                self.sent.append(msg)

            def close(self):
                self.closed = True

        class FakeBackend:
            id = "ME"

            class feeds:
                @staticmethod
                def known_discovery_ids():
                    return []

        network = Network(FakeBackend())
        try:
            dup = FakeDuplex()
            network._on_connection(dup, ConnectionDetails(client=False))
            # the peer CLAIMS a different repo id than it proved
            dup._cb({"ch": "NetworkBus",
                     "m": {"type": "Info", "peerId": "SOMEONE-ELSE"}})
            assert dup.closed
            assert "SOMEONE-ELSE" not in network.peers

            # and a matching claim is accepted
            dup2 = FakeDuplex()
            network._on_connection(dup2, ConnectionDetails(client=False))
            dup2._cb({"ch": "NetworkBus",
                      "m": {"type": "Info", "peerId": "PROVEN-IDENTITY"}})
            assert not dup2.closed
            assert "PROVEN-IDENTITY" in network.peers
        finally:
            network.replication.close()

    def test_mixed_pair_falls_back_to_anonymous(self):
        """An identity-bearing endpoint still interoperates with an
        identity-less one: the session downgrades to anonymous instead
        of deadlocking or dropping."""
        seed = keymod.decode_pair(keymod.create()).secret_key
        a_sock, b_sock = socket.socketpair()
        out = {}

        def anon_side():
            out["b"] = TcpDuplex(b_sock, is_client=False, identity=None)

        t = threading.Thread(target=anon_side, daemon=True)
        t.start()
        da = TcpDuplex(a_sock, is_client=True, identity=seed)
        t.join(timeout=10)
        db = out["b"]
        assert not da.closed and not db.closed
        assert da.peer_identity is None  # anonymous session
        got = []
        db.on_message(got.append)
        da.send({"mixed": True})
        for _ in range(100):
            if got:
                break
            time.sleep(0.01)
        assert got == [{"mixed": True}]
        da.close()
        db.close()

    def test_require_mode_rejects_unauthenticated_peer(self, monkeypatch):
        """HM_NET_AUTH=require: an identity-less endpoint fails closed
        (no anonymous fallback), and so does the peer talking to it."""
        monkeypatch.setenv("HM_NET_AUTH", "require")
        seed = keymod.decode_pair(keymod.create()).secret_key
        a_sock, b_sock = socket.socketpair()
        out = {}

        def anon_side():
            out["b"] = TcpDuplex(b_sock, is_client=False, identity=None)

        t = threading.Thread(target=anon_side, daemon=True)
        t.start()
        da = TcpDuplex(a_sock, is_client=True, identity=seed)
        t.join(timeout=10)
        assert out["b"].closed  # refuses to run without an identity
        assert da.closed  # its peer drops too (handshake never answered)


# ---------------------------------------------------------------------------
# tests/test_crash.py's clean-twin reconvergence on the port


@pytest.mark.parametrize("live", ["1", "0"])
def test_crash_recover_reconverges_with_clean_twin(
    tmp_path, monkeypatch, net, live
):
    """A crashed-then-recovered repo, resynced against a clean twin
    holding the full acked history, reconverges bit-identically —
    including blocks the recovery truncated (they re-replicate)."""
    from hypermerge_tpu_torch.storage import faults as F

    monkeypatch.setenv("HM_LIVE", live)
    hub = LoopbackHub()
    work = tmp_path / "work"
    rec = F.CrashRecorder(str(work))
    rb = net.repo()
    rb.set_swarm(LoopbackSwarm(hub))
    with F.activate(recorder=rec):
        ra = _PortRepo(path=str(work), device="cpu")
        sa = LoopbackSwarm(hub)
        try:
            ra.set_swarm(sa)
            url = ra.create({"edits": []})
            hb = rb.open(url)
            assert hb.value(timeout=30) is not None
            for i in range(6):
                ra.change(url, lambda d, i=i: d["edits"].append(i))
                if i % 2 == 0:
                    hb.change(lambda d, i=i: d["edits"].append(100 + i))
            want = 6 + 3
            wait_until(
                lambda: len((rb.doc(url) or {}).get("edits", [])) >= want
                and len((ra.doc(url) or {}).get("edits", [])) >= want,
                timeout=60,
            )
            doc_id = validate_doc_url(url)
            twin = plain(rb.doc(url))
            twin_clock = dict(rb.back.docs[doc_id].clock)
            k_max = rec.n_points - 1
        finally:
            sa.destroy()
            ra.close()

    step = max(1, k_max // 3)
    for k in sorted(set(range(0, k_max, step)) | {k_max}):
        dst = str(tmp_path / f"c{k}")
        rec.materialize(dst, k)
        r2 = net.repo(path=dst, memory=False)
        r2.set_swarm(LoopbackSwarm(hub))
        h2 = r2.open(url)
        assert h2.value(timeout=60) is not None

        def converged():
            d2 = r2.back.docs.get(doc_id)
            if d2 is None or dict(d2.clock) != twin_clock:
                return False
            return plain(r2.doc(url)) == twin

        wait_until(converged, timeout=60)
        r2.close()


# ---------------------------------------------------------------------------
# parity with the JAX package


def _seeded_bytes(rng, n):
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


CRYPTO_SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", CRYPTO_SEEDS)
def test_chacha_byte_equal_to_reference(seed):
    """The port's pure X25519 and ChaCha20-Poly1305 against the
    reference's on seeded keys, nonces and messages (lengths across the
    64-byte block and 16-byte tag edges), and the same verdict on a
    tampered tag and a truncated frame."""
    from hypermerge_tpu.utils import chacha as ref_chacha

    rng = np.random.default_rng(seed)
    sk, sk2 = _seeded_bytes(rng, 32), _seeded_bytes(rng, 32)
    pk = chacha.x25519_base(sk)
    assert pk == ref_chacha.x25519_base(sk)
    pk2 = ref_chacha.x25519_base(sk2)
    assert chacha.x25519(sk, pk2) == ref_chacha.x25519(sk, pk2)
    key, nonce = _seeded_bytes(rng, 32), _seeded_bytes(rng, 12)
    for n in (0, 1, 15, 16, 63, 64, 65, 1000):
        msg = _seeded_bytes(rng, n)
        ct = chacha.aead_encrypt(key, nonce, msg)
        assert ct == ref_chacha.aead_encrypt(key, nonce, msg)
        assert chacha.aead_decrypt(key, nonce, ct) == msg
        bad = ct[:-1] + bytes([ct[-1] ^ 0x80])
        assert chacha.aead_decrypt(key, nonce, bad) is None
        assert ref_chacha.aead_decrypt(key, nonce, bad) is None
    assert chacha.aead_decrypt(key, nonce, b"short") is None
    assert ref_chacha.aead_decrypt(key, nonce, b"short") is None


# frames whose keystream ends at, just before and just after one pass of
# lane-packed blocks (block 0, the Poly1305 key, shares the first pass)
LANE_SIZES = [
    64 * (chacha._CHUNK - 1) - 1, 64 * (chacha._CHUNK - 1),
    64 * (chacha._CHUNK - 1) + 1, 64 * (2 * chacha._CHUNK - 1) + 7,
]


@pytest.mark.parametrize("n", LANE_SIZES)
def test_chacha_lane_passes_byte_equal_to_reference(n):
    """ChaCha20 runs every block of a frame in one integer a lane each,
    a pass at most `_CHUNK` blocks wide: frames across a pass's end
    encrypt to the reference's bytes (and libsodium's where it loaded),
    and a flipped ciphertext byte in the second pass fails the tag."""
    from hypermerge_tpu.utils import chacha as ref_chacha

    rng = np.random.default_rng(n)
    key, nonce = _seeded_bytes(rng, 32), _seeded_bytes(rng, 12)
    msg = _seeded_bytes(rng, n)
    ct = chacha.aead_encrypt(key, nonce, msg)
    assert ct == ref_chacha.aead_encrypt(key, nonce, msg)
    sodium = native.aead_encrypt(key, nonce, msg)
    assert sodium is None or sodium == ct
    assert chacha.aead_decrypt(key, nonce, ct) == msg
    bad = bytearray(ct)
    bad[n - 1] ^= 0x01
    assert chacha.aead_decrypt(key, nonce, bytes(bad)) is None
    assert ref_chacha.aead_decrypt(key, nonce, bytes(bad)) is None


@pytest.mark.parametrize("seed", CRYPTO_SEEDS)
def test_libcrypto_crypto_byte_equal_to_reference(seed):
    """utils/ossl.py, the ed25519 route where the native library has no
    libsodium, against the reference's pure ed25519 on seeded inputs:
    signatures byte-equal, and the verdict on a good, a tampered-message,
    a tampered-signature and a wrong-key check."""
    from hypermerge_tpu.utils import ed25519 as ref_ed
    from hypermerge_tpu_torch.utils import ossl

    assert ossl.load() is not None
    rng = np.random.default_rng(200 + seed)
    seed_a, seed_b = _seeded_bytes(rng, 32), _seeded_bytes(rng, 32)
    pub = ref_ed.public_key(seed_a)
    for n in (0, 1, 64, 1000):
        msg = _seeded_bytes(rng, n)
        sig = ossl.ed25519_sign(seed_a, msg)
        assert sig == ref_ed.sign(msg, seed_a)
        bad_sig = sig[:-1] + bytes([sig[-1] ^ 0x01])
        other = ref_ed.public_key(seed_b)
        for args in ((msg, sig, pub), (msg + b"x", sig, pub),
                     (msg, bad_sig, pub), (msg, sig, other)):
            assert ossl.ed25519_verify(args[2], args[0], args[1]) == \
                ref_ed.verify(*args)


def _forged(case):
    """(message, signature, public key, whether the reference's pure
    ed25519 accepts it) for an ed25519 edge case. The forgeries hold the
    verification equation, so only libsodium's checks refuse them."""
    from hypermerge_tpu_torch.utils import ed25519 as ed

    def enc_y(y, sign=0):
        return (y | sign << 255).to_bytes(32, "little")

    def k_of(r, a, m):
        return int.from_bytes(ed._sha512(r + a + m), "little") % ed._L

    seed = bytes(range(32))
    pub = ed.public_key(seed)
    msg = b"edge"
    if case == "honest":
        return msg, ed.sign(msg, seed), pub, True
    if case == "s_plus_l":
        sig = ed.sign(msg, seed)
        s = int.from_bytes(sig[32:], "little") + ed._L
        return msg, sig[:32] + s.to_bytes(32, "little"), pub, False
    r = 12345
    big_r = ed._compress(ed._scalarmult(ed._B, r))
    sig = big_r + r.to_bytes(32, "little")
    if case == "identity_key":
        # A = 0: [k]A vanishes, so R = [S]B holds for any message
        return msg, sig, enc_y(1), True
    if case == "noncanonical_identity_key":  # y = p + 1, i.e. 1
        return msg, sig, enc_y(ed._P + 1), False
    if case.startswith("order8_key"):
        from hypermerge_tpu_torch.utils.ossl import _Y8

        a = enc_y(_Y8, int(case[-1]))
        # [k]A vanishes when 8 divides k: find such a message
        m = next(bytes([i]) * 8 for i in range(256)
                 if k_of(big_r, a, bytes([i]) * 8) % 8 == 0)
        return m, sig, a, True
    if case == "identity_r":
        # R = 0: S = k a mod L gives [S]B = [k]A = R + [k]A
        h = ed._sha512(seed)
        a = ed._clamp(h[:32])
        zero = enc_y(1)
        s = (k_of(zero, pub, msg) * a) % ed._L
        return msg, zero + s.to_bytes(32, "little"), pub, True
    raise ValueError(case)


@pytest.mark.skipif(not native.available()
                    or not native.caps() & native.CAP_SODIUM,
                    reason="no libsodium to hold the route against")
@pytest.mark.parametrize("case", [
    "honest", "s_plus_l", "identity_key", "noncanonical_identity_key",
    "order8_key0", "order8_key1", "identity_r"])
def test_libcrypto_ed25519_edge_cases_match_libsodium(case):
    """The libcrypto route refuses what libsodium refuses: a
    non-canonical S, a key or R of small order (the forgeries hold the
    verification equation, so the reference's pure ed25519 accepts them)
    and a non-canonical key encoding; an honest signature passes. The
    answer is held to the port's own libsodium route, and to the
    reference's crypto facade only where the reference's library loaded
    with libsodium: without it that facade takes its pure ed25519, which
    accepts the small-order forgeries (a test worker can find the
    reference's library mid-build: ROADMAP.md Queue 3)."""
    from hypermerge_tpu import native as ref_native
    from hypermerge_tpu.utils import crypto as ref_crypto
    from hypermerge_tpu.utils import ed25519 as ref_ed
    from hypermerge_tpu_torch.utils import ossl

    msg, sig, pub, pure = _forged(case)
    assert ref_ed.verify(msg, sig, pub) is pure
    want = case == "honest"
    assert native.ed25519_verify(pub, msg, sig) is want
    ref_sodium = ref_native.available() and bool(
        ref_native.caps() & ref_native.CAP_SODIUM
    )
    if ref_sodium:
        assert ref_crypto.verify(msg, sig, pub) is want
    assert ossl.ed25519_verify(pub, msg, sig) is want


def test_libcrypto_route_without_libsodium(monkeypatch):
    """With the native library's libsodium entries hidden (a host whose
    build found no libsodium), the crypto facade signs and verifies
    through libcrypto, a secure session's auth frame included, and the
    bytes still equal the reference's."""
    from hypermerge_tpu.utils import ed25519 as ref_ed
    from hypermerge_tpu_torch.utils import crypto, ossl

    calls = []
    for name in ("ed25519_sign", "ed25519_verify"):
        fn = getattr(ossl, name)

        def spy(*a, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*a)

        monkeypatch.setattr(ossl, name, spy)
    monkeypatch.setattr(native, "_sodium", lambda: None)
    seed = bytes(range(32))
    sig = crypto.sign(b"record", seed)
    assert sig == ref_ed.sign(b"record", seed)
    assert crypto.verify(b"record", sig, ref_ed.public_key(seed))
    assert not crypto.verify(b"record!", sig, ref_ed.public_key(seed))
    c, s = SecureSession(True), SecureSession(False)
    c.complete(s.handshake_bytes)
    s.complete(c.handshake_bytes)
    assert s.verify_auth(c.auth_frame(seed))
    assert s.decrypt(c.encrypt(b"frame")) == b"frame"
    assert calls.count("ed25519_sign") == 2
    assert calls.count("ed25519_verify") == 3


@pytest.mark.skipif(
    not native.available() or not native.caps() & native.CAP_SODIUM,
    reason="no libsodium",
)
@pytest.mark.parametrize("seed", CRYPTO_SEEDS)
def test_native_crypto_byte_equal_to_reference(seed):
    """The port's native hm_x25519_base / hm_x25519 / hm_aead_* against
    the reference's native entries and both packages' chacha, on seeded
    inputs; a failed authentication is `_AEAD_FAIL` in both packages."""
    from hypermerge_tpu import native as ref_native
    from hypermerge_tpu.utils import chacha as ref_chacha

    # the reference's own choice (net/secure.py): its native entry where
    # its library loaded, its chacha otherwise (a test worker can find
    # the reference's library mid-build: ROADMAP.md Queue 3)
    ref_sodium = ref_native.available() and bool(
        ref_native.caps() & ref_native.CAP_SODIUM
    )
    ref = ref_native if ref_sodium else ref_chacha

    rng = np.random.default_rng(100 + seed)
    sk, sk2 = _seeded_bytes(rng, 32), _seeded_bytes(rng, 32)
    pk = native.x25519_base(sk)
    assert pk == ref.x25519_base(sk) == chacha.x25519_base(sk)
    pk2 = native.x25519_base(sk2)
    assert native.x25519(sk, pk2) == ref.x25519(sk, pk2)
    assert native.x25519(sk, pk2) == native.x25519(sk2, pk)
    key, nonce = _seeded_bytes(rng, 32), _seeded_bytes(rng, 12)
    for n in (0, 1, 16, 64, 65, 4096):
        msg = _seeded_bytes(rng, n)
        ct = native.aead_encrypt(key, nonce, msg)
        assert ct == ref.aead_encrypt(key, nonce, msg)
        assert ct == ref_chacha.aead_encrypt(key, nonce, msg)
        assert native.aead_decrypt(key, nonce, ct) == msg
        bad = bytes([ct[0] ^ 1]) + ct[1:]
        assert native.aead_decrypt(key, nonce, bad) is native._AEAD_FAIL
        if ref_sodium:
            assert (ref_native.aead_decrypt(key, nonce, bad)
                    is ref_native._AEAD_FAIL)
        assert ref_chacha.aead_decrypt(key, nonce, bad) is None
    assert native.aead_decrypt(key, nonce, b"x" * 15) is native._AEAD_FAIL


@pytest.mark.parametrize("plaintext", ["0", "1"],
                         ids=["encrypted", "plaintext"])
def test_port_and_reference_converge_over_tcp(monkeypatch, net, plaintext):
    """Wire compatibility: a port Repo on the port's TcpSwarm and a
    reference Repo on the reference's, one dialing the other, share
    docs both ways (each side creates one and edits the other's) and
    converge to equal values — authenticated and encrypted (the
    default), and again under HM_TCP_PLAINTEXT=1."""
    from hypermerge_tpu.net.tcp import TcpSwarm as RefTcpSwarm
    from hypermerge_tpu.repo import Repo as RefRepo

    monkeypatch.setenv("HM_TCP_PLAINTEXT", plaintext)
    monkeypatch.setenv("HM_SERVICE", "0")
    rp = net.repo()
    rr = RefRepo(memory=True)
    sr = RefTcpSwarm()
    sp = net.tcp()
    try:
        rp.set_swarm(sp)
        rr.set_swarm(sr)
        sp.connect(sr.address)
        u_ref = rr.create({"from": "reference", "edits": []})
        u_port = rp.create({"from": "port", "edits": []})
        hp = rp.open(u_ref)
        hr = rr.open(u_port)
        assert plain(hp.value(timeout=30))["from"] == "reference"
        assert plain(hr.value(timeout=30))["from"] == "port"
        for i in range(5):
            rp.change(u_ref, lambda d, i=i: d["edits"].append(i))
            rr.change(u_port, lambda d, i=i: d["edits"].append(10 + i))
            rr.change(u_ref, lambda d, i=i: d["edits"].append(20 + i))
            rp.change(u_port, lambda d, i=i: d["edits"].append(30 + i))

        def converged():
            for u in (u_ref, u_port):
                a, b = plain(rp.doc(u)), plain(rr.doc(u))
                if a != b or len(a["edits"]) != 10:
                    return False
            return True

        wait_until(converged, timeout=60)
        (peer,) = rp.back.network.peers.values()
        if plaintext == "0":
            assert peer.connection.peer_identity == rr.back.id
        else:
            assert peer.connection.peer_identity is None
    finally:
        rr.close()
        sr.destroy()


def test_repo_without_swarm_has_no_network(net):
    """With no swarm set, the backend runs as before: no Network, the
    hooks are no-ops, and the telemetry payload has no `net` block."""
    r = net.repo()
    url = r.create({"x": 1})
    r.change(url, lambda d: d.__setitem__("x", 2))
    r.message(url, {"ping": True})
    assert r.back.network is None
    assert "net" not in r.back.telemetry_payload()
    assert r.doc(url) == {"x": 2}


def test_network_block_of_the_telemetry_payload(net):
    """A repo with a swarm reports, per doc, its connected peers and
    whether its feeds are joined (the reference's `net` block)."""
    hub = LoopbackHub()
    ra, rb = net.repo(), net.repo()
    ra.set_swarm(LoopbackSwarm(hub))
    rb.set_swarm(LoopbackSwarm(hub))
    url = ra.create({"x": 1})
    assert rb.doc(url) == {"x": 1}
    doc_id = validate_doc_url(url)
    wait_until(
        lambda: rb.back.telemetry_payload()["net"]["docs"][doc_id]["peers"]
    )
    got = rb.back.telemetry_payload()["net"]["docs"][doc_id]
    assert got == {"peers": 1, "announced": True}
