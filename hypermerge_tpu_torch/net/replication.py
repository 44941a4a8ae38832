"""ReplicationManager — feed sync between peers.

Parity: reference src/ReplicationManager.ts:25-137 — peers exchange the
discovery ids of every feed they know (never the public keys: a peer only
replicates a feed it already knows the key for), intersect, replicate
shared feeds, announce newly-created feeds, and surface Discovery events
so the repo can send cursor gossip (reference :56-112).

Wire protocol on the "Replication" channel (replaces hypercore-protocol,
with hypercore's trust model: every extension arrives under an ed25519
signature over the feed's merkle root and is verified against the feed
public key BEFORE storage — storage/integrity.py, reference
src/types/hypercore.d.ts:132-188):

  DiscoveryIds {ids}                      full/delta announcement
  FeedLength   {id, length}               my block count for a shared feed
  Request      {id, from}                 send me blocks starting at `from`
  RequestRange {id, from, to}             sparse fetch: arbitrary range,
                                          out of order (hypercore's
                                          sparse download: prioritize
                                          the tail of a long feed)
  SparseBlocks {id, from, len, sig,
                blocks(b64), proofs}      ranged reply: each block
                                          carries a merkle INCLUSION
                                          proof against the signed
                                          root at `len` (verified
                                          without the prefix; landed in
                                          the feed's sparse buffer)
  Blocks       {id, from, blocks(b64),
                len, sig(b64), total}     one verified chunk: blocks fill
                                          [from, len); sig covers the
                                          merkle root at `len`; `total` is
                                          the sender's head, so a receiver
                                          still behind re-requests — an
                                          ack-paced stream with one
                                          bounded chunk in flight (no
                                          whole-feed frames)

Backfill chunking: a sender slices at its stored signature records
(HM_REPL_CHUNK blocks per chunk, default 1024). Unsigned legacy blocks
are dropped unless HM_ALLOW_UNSIGNED_FEEDS=1.

Live tail: local appends mark the feed dirty; a flusher thread
coalesces every append that lands within one flush window
(HM_REPL_FLUSH_MS, default 2ms) into ONE signed Blocks msg per feed —
a burst of N interactive edits costs O(1) frames, not N (the batched
block sync of hypercore-protocol; reference
src/ReplicationManager.ts:114-136). Frames still respect the
chunk block/byte budgets via _pick_boundary.

The port's copy of hypermerge_tpu/net/replication.py.
"""

from __future__ import annotations

import base64
import hmac
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from ..analysis.lockdep import make_rlock
from ..storage.feed import Feed, FeedStore
from ..storage.integrity import allow_unsigned, capability
from ..utils.debug import log
from ..utils.mapset import MapSet
from .. import telemetry
from .peer import NetworkPeer

CHANNEL = "Replication"


def _chunk_blocks() -> int:
    return int(os.environ.get("HM_REPL_CHUNK", "1024"))


def _chunk_bytes() -> int:
    # well under tcp.py's 64MB frame cap even after base64+JSON framing
    return int(os.environ.get("HM_REPL_CHUNK_BYTES", str(8 * 1024 * 1024)))


def _flush_window_s() -> float:
    return float(os.environ.get("HM_REPL_FLUSH_MS", "2")) / 1e3


def _flush_window_max_s() -> float:
    return float(os.environ.get("HM_REPL_FLUSH_MAX_MS", "25")) / 1e3


def _antientropy_s() -> float:
    """Anti-entropy sweep period (0 disables). The gap-driven protocol
    only recovers a LOST replication frame at the next tail flush or a
    reconnect renegotiation; a periodic FeedLength re-announce bounds
    that staleness by the sweep interval — and a crash-recovered
    (truncated) peer re-advertises its true lengths promptly instead
    of waiting for new local writes."""
    return float(os.environ.get("HM_ANTIENTROPY_S", "30"))


class ReplicationManager:
    def __init__(
        self,
        feeds: FeedStore,
        on_discovery: Callable[[str, NetworkPeer], None],
        sampler=None,
    ) -> None:
        self.feeds = feeds
        self._on_discovery = on_discovery
        # bounded gossip relay (net/discovery/gossip.py GossipSampler
        # or None = broadcast): live-tail flushes target a per-feed
        # sampled peer subset so a hot doc's frame cost stays
        # O(fanout), not O(peers); receivers relay to THEIR samples
        # (their on_extended marks their flusher), and the unsampled
        # anti-entropy sweep bounds any straggler by one period
        self._sampler = sampler
        self._lock = make_rlock("net.repl")
        self._peers: Set[NetworkPeer] = set()
        # discovery_id -> peers replicating it with us. Membership
        # requires CAPABILITY verification: a peer only enters (and so
        # only ever receives blocks/tails/gossip for the feed) after
        # proving knowledge of the feed public key — learning a
        # discovery id from announcements must not unlock data
        # (hypercore-protocol's capability check).
        self._replicating: MapSet = MapSet()
        self._verified: MapSet = MapSet()  # did -> peers that proved
        self._tailed: Set[str] = set()  # feeds we attached appenders to
        # per-connection random capability challenges: ours (what peers
        # must prove against) and theirs (what we prove against)
        self._challenge_local: Dict[NetworkPeer, bytes] = {}
        self._challenge_remote: Dict[NetworkPeer, bytes] = {}
        # outstanding sparse-fetch indices per feed: only blocks WE
        # asked for may land in the sparse buffer — an unsolicited
        # SparseBlocks push (even with valid proofs) must not grow
        # memory on a peer that never requested it
        self._sparse_wanted: Dict[str, Set[int]] = {}
        # churn accounting: a peer re-activating after a close is a
        # RESYNC (the supervised redial restored it); t_resync_ms sums
        # redial -> first post-reconnect replication data frame.
        # Series live on the process telemetry registry (labeled per
        # manager); `stats` rebuilds the historical dict. The sharded
        # counter closes the old unlocked `stats["t_resync_ms"] +=`
        # read-modify-write race from reader threads.
        inst = str(telemetry.next_instance())
        self._m = {
            k: telemetry.counter("net.repl." + k, inst=inst)
            for k in (
                "resyncs", "t_resync_ms", "antientropy_sweeps",
                "frames_tx", "frames_rx",
            )
        }
        self._seen_closed: Set[str] = set()
        self._resync_t0: Dict[str, float] = {}
        # live-tail coalescing: public_key -> earliest unflushed block,
        # adaptive window (batches grow under sustained load instead of
        # frame count), drained on close
        from ..utils.debounce import Debouncer

        self._flusher = Debouncer(
            self._flush_batch,
            window_s=_flush_window_s(),
            max_window_s=_flush_window_max_s(),
            merge=min,
            name="repl-flush",
        )
        # anti-entropy sweep: periodic FeedLength re-announce to every
        # verified peer (thread starts lazily on the first peer; a
        # peerless manager never pays for it)
        self._ae_interval = _antientropy_s()
        self._ae_stop = threading.Event()
        self._ae_thread: Optional[threading.Thread] = None
        # sweep-time cursor repair hook: called (peer, public_keys)
        # once per peer per sweep (Network wires it to
        # RepoBackend.send_sweep_cursors). Set before traffic flows.
        self.on_sweep: Optional[Callable] = None
        # service-plane hook (same wiring window): an
        # OverloadController whose BROWNOUT+ states skip the periodic
        # sweep — repair is deferrable, foreground reads are not
        self.overload_ctl = None

    @property
    def stats(self) -> Dict[str, float]:
        """The historical stats dict shape (registry-backed,
        read-only): resyncs, t_resync_ms, antientropy_sweeps."""
        m = self._m
        return {
            "resyncs": int(m["resyncs"].value()),
            "t_resync_ms": round(m["t_resync_ms"].value(), 6),
            "antientropy_sweeps": int(
                m["antientropy_sweeps"].value()
            ),
            "frames_tx": int(m["frames_tx"].value()),
            "frames_rx": int(m["frames_rx"].value()),
        }

    # ------------------------------------------------------------------

    def _challenge_for(self, peer: NetworkPeer) -> bytes:
        with self._lock:
            c = self._challenge_local.get(peer)
            if c is None:
                c = os.urandom(32)
                self._challenge_local[peer] = c
            return c

    def on_peer(self, peer: NetworkPeer) -> None:
        conn = peer.connection
        if conn is None:  # torn down while the activation was in flight
            return
        with self._lock:
            self._peers.add(peer)
            if peer.id in self._seen_closed:
                self._m["resyncs"].add(1)
                self._resync_t0[peer.id] = time.monotonic()
            if self._ae_thread is None and self._ae_interval > 0:
                self._ae_thread = threading.Thread(
                    target=self._ae_loop, daemon=True, name="antientropy"
                )
                self._ae_thread.start()
        ch = conn.open_channel(CHANNEL)
        ch.subscribe(lambda msg: self._on_message(peer, msg))
        ch.send({
            "type": "DiscoveryIds",
            "ids": self.feeds.known_discovery_ids(),
            "challenge": base64.b64encode(
                self._challenge_for(peer)
            ).decode("ascii"),
        })

    def on_peer_closed(self, peer: NetworkPeer) -> None:
        with self._lock:
            self._peers.discard(peer)
            self._seen_closed.add(peer.id)
            self._resync_t0.pop(peer.id, None)
            for did in self._replicating.keys_with(peer):
                self._replicating.remove(did, peer)
            for did in self._verified.keys_with(peer):
                self._verified.remove(did, peer)
            self._challenge_local.pop(peer, None)
            self._challenge_remote.pop(peer, None)

    def announce(self, feed: Feed) -> None:
        """A newly created/opened feed: tell every connected peer
        (reference's late-feed announcement, ReplicationManager.ts:91-96)."""
        self._tail(feed)
        with self._lock:
            peers = list(self._peers)
        for peer in peers:
            self._send(peer, {
                "type": "DiscoveryIds",
                "ids": [feed.discovery_id],
                "challenge": base64.b64encode(
                    self._challenge_for(peer)
                ).decode("ascii"),
            })

    def peers_with_feed(self, discovery_id: str) -> List[NetworkPeer]:
        with self._lock:
            return [
                p for p in self._replicating.get(discovery_id)
                if p.is_connected
            ]

    # ------------------------------------------------------------------

    def _on_message(self, peer: NetworkPeer, msg: Dict) -> None:
        if not isinstance(msg, dict):
            return
        self._m["frames_rx"].add(1)
        try:
            t = msg.get("type")
            if t != "DiscoveryIds" and self._resync_t0:
                # the reconnect's opener is DiscoveryIds; the first
                # DATA-path frame after it closes the resync window.
                # The unlocked emptiness pre-check keeps the steady-
                # state data path lock-free (the dict is almost always
                # empty); a window nothing ever closed (no shared
                # feeds, idle link) must not charge the whole idle gap
                # to a late unrelated frame: past 60s the resync is
                # moot
                with self._lock:
                    t0 = self._resync_t0.pop(peer.id, None)
                if t0 is not None:
                    elapsed = time.monotonic() - t0
                    if elapsed < 60:
                        self._m["t_resync_ms"].add(elapsed * 1e3)
                        telemetry.instant(
                            "net.resync", cat="net",
                            ms=round(elapsed * 1e3, 1),
                        )
            if t == "DiscoveryIds":
                if "challenge" in msg:
                    with self._lock:
                        self._challenge_remote[peer] = base64.b64decode(
                            msg["challenge"]
                        )
                self._on_discovery_ids(peer, list(msg["ids"]))
            elif t == "FeedLength":
                self._on_feed_length(
                    peer, msg["id"], int(msg["length"]), msg.get("cap")
                )
            elif t == "Request":
                self._on_request(
                    peer, msg["id"], int(msg["from"]), msg.get("cap")
                )
            elif t == "RequestRange":
                self._on_request_range(
                    peer,
                    msg["id"],
                    int(msg["from"]),
                    int(msg["to"]),
                    msg.get("cap"),
                )
            elif t == "SparseBlocks":
                self._on_sparse_blocks(
                    peer,
                    msg["id"],
                    int(msg["from"]),
                    int(msg["len"]),
                    msg["sig"],
                    list(msg["blocks"]),
                    list(msg["proofs"]),
                )
            elif t == "Blocks":
                self._on_blocks(
                    peer,
                    msg["id"],
                    int(msg["from"]),
                    list(msg["blocks"]),
                    int(msg.get("len", -1)),
                    msg.get("sig"),
                    int(msg.get("total", -1)),
                )
        except (KeyError, TypeError, ValueError) as e:
            log("replication", f"malformed msg from {peer.id[:6]}: {e}")

    def _session_binding(self, peer: NetworkPeer) -> tuple:
        """(channel binding, our transport role) for the peer's CURRENT
        connection — the two session-unique values capability proofs MAC
        in (storage/integrity.capability). Plaintext/in-memory
        transports have no binding; proofs there are challenge+role-only."""
        conn = peer.connection
        if conn is None:  # connection torn down with messages in flight
            return (b"", None)
        return (conn.channel_binding or b"", conn.is_client)

    def _feed_length_msg(
        self, feed: Feed, peer: NetworkPeer, conceal: bool = False
    ) -> Optional[Dict]:
        """Our proof + length for a peer. `conceal` hides the real
        length from peers that haven't proven key knowledge yet (feed
        size is metadata the capability gates too). None when the peer's
        challenge hasn't arrived (its DiscoveryIds opener is in flight —
        the exchange resumes off their reply)."""
        with self._lock:
            challenge = self._challenge_remote.get(peer)
        if challenge is None:
            return None
        binding, we_are_client = self._session_binding(peer)
        return {
            "type": "FeedLength",
            "id": feed.discovery_id,
            "length": 0 if conceal else feed.length,
            "cap": capability(
                feed.public_key, challenge, binding, we_are_client
            ),
        }

    def _request_msg(
        self, feed: Feed, peer: NetworkPeer, start: int
    ) -> Optional[Dict]:
        with self._lock:
            challenge = self._challenge_remote.get(peer)
        if challenge is None:
            return None
        binding, we_are_client = self._session_binding(peer)
        return {
            "type": "Request",
            "id": feed.discovery_id,
            "from": start,
            "cap": capability(
                feed.public_key, challenge, binding, we_are_client
            ),
        }

    def _check_cap(
        self, peer: NetworkPeer, feed: Feed, cap
    ) -> bool:
        """Verify the sender's capability proof against OUR random
        per-connection challenge + the transport session binding + the
        sender's role (see storage/integrity.capability for what each
        binds against); on first success mark the peer
        replication-eligible for the feed (and reply with our own proof
        so both directions activate). Returns eligibility.

        Peers already verified for the feed short-circuit: follow-up
        messages (e.g. live-tail FeedLengths for unsigned feeds, which
        broadcast without per-peer caps) must not stall or log spurious
        failures."""
        if peer in self._verified.get(feed.discovery_id):
            return True
        binding, we_are_client = self._session_binding(peer)
        want = capability(
            feed.public_key,
            self._challenge_for(peer),
            binding,
            # the PROVER here is the peer (None = torn-down connection:
            # the compare below fails and the message is moot anyway)
            None if we_are_client is None else not we_are_client,
        )
        if not isinstance(cap, str) or not hmac.compare_digest(cap, want):
            log(
                "replication",
                f"capability check FAILED for {feed.public_key[:6]} "
                f"from {peer.id[:6]}: withholding blocks",
            )
            return False
        newly = self._verified.add(feed.discovery_id, peer)
        if newly:
            self._replicating.add(feed.discovery_id, peer)
            self._tail(feed)
            self._on_discovery(feed.public_key, peer)
            # prove ourselves back so the peer activates us too (the
            # exchange terminates: replies only fire on FIRST proof)
            reply = self._feed_length_msg(feed, peer)
            if reply is not None:
                self._send(peer, reply)
        return True

    def _on_discovery_ids(self, peer: NetworkPeer, ids: List[str]) -> None:
        for did in ids:
            feed = self.feeds.by_discovery_id(did)
            if feed is None:
                continue  # we don't know this feed's key — can't replicate
            self._tail(feed)
            # announce with our capability proof but CONCEAL the length:
            # the peer gets data (and metadata) only after proving its own
            msg = self._feed_length_msg(feed, peer, conceal=True)
            if msg is not None:
                self._send(peer, msg)

    def _on_feed_length(
        self, peer: NetworkPeer, did: str, their_len: int, cap
    ) -> None:
        feed = self.feeds.by_discovery_id(did)
        if feed is None:
            return
        if not self._check_cap(peer, feed, cap):
            return
        if feed.length < their_len:
            msg = self._request_msg(feed, peer, feed.length)
        elif feed.length > their_len:
            msg = self._feed_length_msg(feed, peer)
        else:
            return
        if msg is not None:
            self._send(peer, msg)

    def _pick_boundary(self, feed: Feed, start: int) -> int:
        """End of the next backfill chunk, bounded in BLOCKS and BYTES
        (a frame must stay far below tcp.py's 64MB cap). A feed we hold
        the secret key of can sign ANY boundary on demand
        (integrity.record_for), so the budgeted end is used directly;
        otherwise the largest STORED signed-record length within both
        budgets, else the first record past `start`, else the head
        (legacy unsigned feeds)."""
        have = feed.length
        if feed.integrity is None:
            return have
        writable = feed.secret_key is not None
        if not writable:
            lengths = [
                r[0] for r in feed.integrity.records() if r[0] > start
            ]
            if not lengths:
                return have
        # shrink the block budget until the byte budget holds
        want = min(have, start + _chunk_blocks())
        budget = _chunk_bytes()
        total = 0
        count = 0
        for b in feed.get_batch(start, want):
            total += len(b)
            count += 1
            if total > budget and count > 1:
                count -= 1
                break
        want = start + max(count, 1)
        if writable:
            return want
        within = [l for l in lengths if l <= want]
        if within:
            return max(within)
        end = min(lengths)
        if end - start > _chunk_blocks():
            log(
                "replication",
                f"sparse signature records on {feed.public_key[:6]}: "
                f"serving an oversized chunk {start}..{end}",
            )
        return end

    def _blocks_msg(self, feed: Feed, did: str, start: int, end: int):
        rec = (
            feed.integrity.record_for(feed, end)
            if feed.integrity is not None
            else None
        )
        return {
            "type": "Blocks",
            "id": did,
            "from": start,
            "blocks": [
                base64.b64encode(b).decode("ascii")
                for b in feed.get_batch(start, end)
            ],
            "len": end,
            "sig": (
                base64.b64encode(rec[2]).decode("ascii") if rec else None
            ),
            "total": feed.length,
        }

    def _on_request(
        self, peer: NetworkPeer, did: str, start: int, cap
    ) -> None:
        feed = self.feeds.by_discovery_id(did)
        if feed is None:
            return
        if not self._check_cap(peer, feed, cap):
            return  # no key knowledge proven: no data
        if start >= feed.length:
            return
        end = self._pick_boundary(feed, start)
        self._send(peer, self._blocks_msg(feed, did, start, end))

    def _on_blocks(
        self,
        peer: NetworkPeer,
        did: str,
        start: int,
        blocks: List[str],
        length: int,
        sig_b64: Optional[str],
        total: int,
    ) -> None:
        feed = self.feeds.by_discovery_id(did)
        if feed is None:
            return
        # an unverified peer's Blocks may still be appended (the merkle
        # signature chain is the real gate), but it earns no re-request
        # replies: a Request's `from` field is feed.length, metadata
        # _feed_length_msg deliberately conceals from peers that haven't
        # proven key knowledge
        verified = peer in self._verified.get(did)
        if start > feed.length:
            # gap: re-request from our actual head
            if verified:
                msg = self._request_msg(feed, peer, feed.length)
                if msg is not None:
                    self._send(peer, msg)
            return
        raw = [base64.b64decode(b) for b in blocks]
        if sig_b64 is not None and length >= 0:
            ok = feed.append_verified(
                start, raw, length, base64.b64decode(sig_b64)
            )
            if not ok:
                log(
                    "replication",
                    f"REJECTED unverified extension of "
                    f"{feed.public_key[:6]} from {peer.id[:6]} "
                    f"(len {length})",
                )
                return
        elif allow_unsigned():
            for i, b in enumerate(raw):
                index = start + i
                if index < feed.length:
                    continue  # duplicate
                feed._append_raw(b)
        else:
            log(
                "replication",
                f"DROPPED unsigned blocks for {feed.public_key[:6]} "
                f"from {peer.id[:6]} (set HM_ALLOW_UNSIGNED_FEEDS=1 "
                "to accept legacy feeds)",
            )
            return
        if total > feed.length and verified:
            # ack-paced stream: pull the next chunk
            msg = self._request_msg(feed, peer, feed.length)
            if msg is not None:
                self._send(peer, msg)

    def request_range(
        self, discovery_id: str, start: int, end: int
    ) -> bool:
        """Ask a verified peer for blocks [start, end) out of order
        (sparse fetch — e.g. prioritize the tail of a long feed for a
        progress UI while contiguous backfill catches up). ONE bounded
        chunk per call: the server clamps the reply to its block+byte
        budgets (HM_REPL_CHUNK / HM_REPL_CHUNK_BYTES) and serves
        contiguously from `start`, so watch the feed's sparse buffer
        and re-issue from the first missing index for more. Returns
        False when no verified peer holds the feed."""
        feed = self.feeds.by_discovery_id(discovery_id)
        if feed is None:
            return False
        for peer in self.peers_with_feed(discovery_id):
            with self._lock:
                challenge = self._challenge_remote.get(peer)
            if challenge is None:
                continue
            binding, we_are_client = self._session_binding(peer)
            with self._lock:
                w = self._sparse_wanted.setdefault(discovery_id, set())
                w.update(range(start, end))
                # unanswered requests must not leak for the process
                # lifetime (a peer may vanish before serving): bound the
                # outstanding set, shedding the indices FURTHEST out —
                # the same near-head-first policy as the sparse buffer
                cap = int(
                    os.environ.get("HM_SPARSE_WANTED_CAP", "8192")
                )
                if len(w) > cap:
                    for i in sorted(w, reverse=True)[: len(w) - cap]:
                        w.discard(i)
            self._send(peer, {
                "type": "RequestRange",
                "id": discovery_id,
                "from": start,
                "to": end,
                "cap": capability(
                    feed.public_key, challenge, binding, we_are_client
                ),
            })
            return True
        return False

    def _on_request_range(
        self, peer: NetworkPeer, did: str, start: int, end: int, cap
    ) -> None:
        feed = self.feeds.by_discovery_id(did)
        if feed is None or feed.integrity is None:
            return
        if not self._check_cap(peer, feed, cap):
            return  # no key knowledge proven: no data
        start = max(0, start)
        end = min(end, feed.length, start + _chunk_blocks())
        if start >= end:
            return
        # byte budget too: a frame must stay far below the transport cap
        budget = _chunk_bytes()
        total = 0
        count = 0
        for b in feed.get_batch(start, end):
            total += len(b)
            count += 1
            if total > budget and count > 1:
                count -= 1
                break
        end = start + max(count, 1)
        served = feed.integrity.range_proofs(feed, start, end)
        if served is None:
            return  # no signed record covers the range
        length, sig, pairs = served
        self._send(peer, {
            "type": "SparseBlocks",
            "id": did,
            "from": start,
            "len": length,
            "sig": base64.b64encode(sig).decode("ascii"),
            "blocks": [
                base64.b64encode(b).decode("ascii") for b, _p in pairs
            ],
            "proofs": [
                [base64.b64encode(h).decode("ascii") for h in p]
                for _b, p in pairs
            ],
        })

    def _on_sparse_blocks(
        self,
        peer: NetworkPeer,
        did: str,
        start: int,
        length: int,
        sig_b64: str,
        blocks: List[str],
        proofs: List[List[str]],
    ) -> None:
        from ..storage.integrity import verify_inclusion
        from ..utils import crypto

        feed = self.feeds.by_discovery_id(did)
        if feed is None or len(blocks) != len(proofs):
            return
        with self._lock:
            wanted = self._sparse_wanted.get(did)
        if not wanted:
            log(
                "replication",
                f"DROPPED unsolicited sparse blocks for "
                f"{feed.public_key[:6]} from {peer.id[:6]}",
            )
            return
        sig = base64.b64decode(sig_b64)
        for i, (b64, proof64) in enumerate(zip(blocks, proofs)):
            index = start + i
            with self._lock:
                if index not in wanted:
                    continue  # not an index we asked for: never lands
            raw = base64.b64decode(b64)
            ok = verify_inclusion(
                feed.public_key,
                crypto.leaf_hash(raw),
                index,
                length,
                [base64.b64decode(h) for h in proof64],
                sig,
            )
            if not ok:
                log(
                    "replication",
                    f"REJECTED sparse block {index} of "
                    f"{feed.public_key[:6]} from {peer.id[:6]}: "
                    "bad inclusion proof",
                )
                return
            if not feed.put_sparse(index, raw):
                continue  # sparse cap dropped it: stays outstanding so
                # a later re-serve of the re-issued request is accepted
            with self._lock:
                wanted.discard(index)
                # only retire the mapping if OUR set still backs it — a
                # concurrent request_range may have installed a fresh
                # set that must keep accepting its own response
                if not wanted and self._sparse_wanted.get(did) is wanted:
                    self._sparse_wanted.pop(did, None)

    def _tail(self, feed: Feed) -> None:
        with self._lock:
            if feed.public_key in self._tailed:
                return
            self._tailed.add(feed.public_key)

        def on_extended(start: int, end: int) -> None:
            # mark dirty and let the flusher coalesce: a burst of
            # appends within one flush window rides ONE signed frame
            self._flusher.mark(feed.public_key, start)

        feed.on_extended(on_extended)

    def _flush_batch(self, batch: Dict[str, int]) -> None:
        with telemetry.span("net.repl.flush", "net", feeds=len(batch)):
            for pk, start in batch.items():
                feed = self.feeds.get_feed(pk)
                if feed is None:
                    continue
                try:
                    self._flush_feed(feed, start)
                except Exception as e:  # a bad feed must not kill tails
                    log(
                        "replication", f"tail flush failed {pk[:6]}: {e}"
                    )

    def _flush_feed(self, feed: Feed, start: int) -> None:
        did = feed.discovery_id
        peers = self.peers_with_feed(did)
        if self._sampler is not None:
            # bounded fanout: the tail rides to a sampled subset; the
            # rest converge via relay hops and the anti-entropy sweep
            peers = self._sampler.sample(did, peers)
        if not peers:
            return
        head = feed.length
        while start < head:
            # _pick_boundary keeps each frame inside the chunk block +
            # byte budgets even when a window coalesced a huge range
            end = self._pick_boundary(feed, start)
            rec = (
                feed.integrity.record_for(feed, end)
                if feed.integrity is not None
                else None
            )
            if rec is None:
                # no signature at this length (mid-chunk race on a
                # relayed feed, or unsigned legacy): announce and let
                # peers pull a chunk we CAN sign for. Built per peer so
                # each frame carries that peer's capability proof —
                # receivers run _check_cap on every FeedLength, and
                # already-verified peers short-circuit either way
                for peer in peers:
                    msg = self._feed_length_msg(feed, peer)
                    if msg is not None:
                        self._send(peer, msg)
                return
            payload = self._blocks_msg(feed, did, start, end)
            for peer in peers:
                self._send(peer, payload)
            start = end

    def flush_now(self, timeout: float = 5.0) -> bool:
        """Block until every currently-dirty tail has FINISHED
        flushing (tests and orderly shutdown)."""
        return self._flusher.flush_now(timeout)

    # -- anti-entropy ---------------------------------------------------

    def _ae_loop(self) -> None:
        while not self._ae_stop.wait(self._ae_interval):
            ctl = self.overload_ctl
            if ctl is not None and ctl.deprioritize():
                # brownout: the sweep yields this period (the NEXT
                # healthy period repairs everything it would have —
                # idempotent latest-state, just one period later)
                ctl.note_skipped_sweep()
                continue
            try:
                self.sweep_now()
            except Exception as e:  # a bad peer must not kill the sweep
                log("replication", f"anti-entropy sweep failed: {e}")

    def sweep_now(self) -> int:
        """One anti-entropy pass NOW (the timer's body; tests call it
        directly): re-announce our length for every feed each verified
        peer replicates with us, and re-fire the discovery hook so the
        repo re-sends its CURSORS for the docs those feeds belong to.
        Both are idempotent latest-state — a peer that already matches
        ignores them; a peer that lost a tail frame (app-layer loss on
        a surviving connection), truncated in crash recovery, or
        missed a SAMPLED cursor gossip (the bounded-fanout relay,
        net/discovery/gossip.py — a one-shot broadcast a peer wasn't
        sampled into would otherwise be lost forever) requests the gap
        within one sweep period. Returns frames sent."""
        with self._lock:
            peers = list(self._peers)
        sent = 0
        for peer in peers:
            if not peer.is_connected:
                continue
            with self._lock:
                dids = list(self._verified.keys_with(peer))
            pks = []
            for did in dids:
                feed = self.feeds.by_discovery_id(did)
                if feed is None:
                    continue
                pks.append(feed.public_key)
                if feed.length == 0:
                    # nothing to repair FROM us: a zero-length feed's
                    # holder side announces (a fleet doc carries one
                    # empty placeholder feed per peer — re-announcing
                    # them all every sweep is O(peers^2) noise)
                    continue
                msg = self._feed_length_msg(feed, peer)
                if msg is not None:
                    self._send(peer, msg)
                    sent += 1
            if self.on_sweep is not None and pks:
                # cursor repair (ONE pass per peer, not per feed): a
                # bounded-fanout cursor gossip the peer wasn't sampled
                # into is one-shot — this bounds that staleness by the
                # sweep period (RepoBackend.send_sweep_cursors)
                try:
                    self.on_sweep(peer, pks)
                except Exception as e:  # repo-side hook bug: keep sweeping
                    log("replication", f"sweep cursor hook failed: {e}")
        self._m["antientropy_sweeps"].add(1)
        return sent

    def close(self) -> None:
        self._ae_stop.set()
        # drains: tails marked before close still reach peers
        self._flusher.close()
        # join the sweep thread BEFORE retiring the series: a sweep
        # finishing after the fold would bump a dropped handle and the
        # process snapshot would undercount rm.stats forever. The join
        # is bounded by one in-flight sweep (the stop flag already
        # short-circuits the next wait).
        t = self._ae_thread
        if t is not None:
            t.join(timeout=10.0)
        # registry hygiene: fold this manager's series into the closed
        # aggregate (stats stays readable — it is handle-based)
        telemetry.REGISTRY.retire(*self._m.values())

    def _send(self, peer: NetworkPeer, msg: Dict) -> None:
        self._m["frames_tx"].add(1)
        peer.try_send(CHANNEL, msg)
