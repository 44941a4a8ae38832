"""Every case of tests/test_integrity.py under its own name on the port
(hypermerge_tpu_torch), repos on the CPU, waits as they are.

The twinned file's own docstring follows.

Feed integrity: signed merkle logs, replication-boundary verification,
on-disk tamper detection (VERDICT r3 missing #1 — the trust model).
Reference anchor: hypercore's signed tree + per-block verification
(src/types/hypercore.d.ts:132-188)."""

import base64
import os
import time

import pytest

from hypermerge_tpu_torch.net.duplex import duplex_pair
from hypermerge_tpu_torch.net.connection import PeerConnection
from hypermerge_tpu_torch.net.peer import NetworkPeer
from hypermerge_tpu_torch.net.replication import ReplicationManager
from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.storage.feed import FeedStore, memory_storage_fn
from hypermerge_tpu_torch.storage.integrity import Peaks, signable
from hypermerge_tpu_torch.utils import crypto
from hypermerge_tpu_torch.utils import keys as keymod

from helpers import wait_until


def Repo(*args, **kw):
    """The port's Repo on the CPU (tests run where no card is present)."""
    kw.setdefault("device", "cpu")
    return _PortRepo(*args, **kw)


class TestMerklePeaks:
    def test_incremental_root_matches_bulk(self):
        """Writer's O(log n) peak root == bulk recompute at EVERY length."""
        peaks = Peaks()
        leaves = []
        for i in range(40):
            leaf = crypto.leaf_hash(f"block{i}".encode())
            leaves.append(leaf)
            peaks.append(leaf)
            assert peaks.root() == crypto.merkle_root(leaves), i

    def test_empty_root(self):
        assert Peaks().root() == b"\x00" * 32 == crypto.merkle_root([])


def _mgr():
    feeds = FeedStore(memory_storage_fn)
    events = []
    mgr = ReplicationManager(feeds, lambda pk, peer: events.append(pk))
    return feeds, mgr, events


def _connect(mgr_a, mgr_b):
    da, db = duplex_pair()
    ca, cb = PeerConnection(da, True), PeerConnection(db, False)
    pa = NetworkPeer("B", "A", lambda p: None)
    pb = NetworkPeer("A", "B", lambda p: None)
    pa.add_connection(ca)
    pb.add_connection(cb)
    mgr_a.on_peer(pa)
    mgr_b.on_peer(pb)
    return pa, pb


class TestWriterSigning:
    def test_writer_appends_sign_and_audit(self):
        feeds = FeedStore(memory_storage_fn)
        f = feeds.create(keymod.create())
        for i in range(5):
            f.append(f"block{i}".encode())
        # live appends sign lazily; audit seals the head first
        assert f.audit()
        assert f.integrity.signed_length == 5

    def test_lazy_signing_seals_on_close(self, tmp_path):
        """Appends below the sign interval leave no per-append records;
        close() persists one covering the head, and a fresh process
        audits clean (the crash-recovery contract of lazy signing)."""
        from hypermerge_tpu_torch.storage.feed import FeedStore, file_storage_fn
        from hypermerge_tpu_torch.storage.integrity import file_sig_storage_fn

        root = str(tmp_path)
        feeds = FeedStore(
            file_storage_fn(root), sig_fn=file_sig_storage_fn(root)
        )
        pair = keymod.create()
        f = feeds.create(pair)
        for i in range(5):
            f.append(f"block{i}".encode())
        assert f.integrity.unsigned_tail
        feeds.close()
        feeds2 = FeedStore(
            file_storage_fn(root), sig_fn=file_sig_storage_fn(root)
        )
        f2 = feeds2.create(pair)
        assert f2.integrity.signed_length == 5
        assert f2.audit()
        feeds2.close()

    def test_crash_orphaned_unsigned_tail_distinct_status(self, tmp_path):
        """Lazy signing + crash: a WRITABLE feed reopened with blocks
        beyond its last signed record must report the distinct
        "unsigned_tail" status (recoverable via seal()), not the
        tamper-indistinguishable False/"tampered" — while audit()'s
        strict boolean contract stays False until sealed."""
        from hypermerge_tpu_torch.storage.feed import FeedStore, file_storage_fn
        from hypermerge_tpu_torch.storage.integrity import (
            AUDIT_OK,
            AUDIT_TAMPERED,
            AUDIT_UNSIGNED_TAIL,
            file_sig_storage_fn,
        )

        root = str(tmp_path)
        feeds = FeedStore(
            file_storage_fn(root), sig_fn=file_sig_storage_fn(root)
        )
        pair = keymod.create()
        f = feeds.create(pair)
        for i in range(5):
            f.append(f"block{i}".encode())
        f.integrity.record_for(f, 3)  # signed record below the head
        # crash: the process never seals — reopen straight from disk
        feeds2 = FeedStore(
            file_storage_fn(root), sig_fn=file_sig_storage_fn(root)
        )
        f2 = feeds2.create(pair)
        assert f2.integrity.signed_length == 3 and f2.length == 5
        assert f2.audit_status() == AUDIT_UNSIGNED_TAIL
        assert f2.audit() is False  # strict boolean stays strict
        # recovery path: seal() signs a fresh head record
        f2.seal()
        assert f2.audit_status() == AUDIT_OK
        assert f2.audit() is True
        feeds2.close()

        # a READ-ONLY holder of the same shape cannot distinguish the
        # tail from a foreign append: must stay "tampered"
        root2 = str(tmp_path / "ro")
        feeds3 = FeedStore(
            file_storage_fn(root2), sig_fn=file_sig_storage_fn(root2)
        )
        g = feeds3.create(pair)
        for i in range(4):
            g.append(f"ro{i}".encode())
        g.integrity.record_for(g, 2)
        feeds4 = FeedStore(
            file_storage_fn(root2), sig_fn=file_sig_storage_fn(root2)
        )
        g2 = feeds4.open_feed(pair.public_key)
        assert not g2.writable
        assert g2.audit_status() == AUDIT_TAMPERED
        assert g2.audit() is False
        feeds4.close()

    def test_unsigned_tail_with_no_records_at_all(self, tmp_path):
        """A writable feed that crashed before its FIRST record is the
        same recoverable shape (whole log is the unsigned tail)."""
        from hypermerge_tpu_torch.storage.feed import FeedStore, file_storage_fn
        from hypermerge_tpu_torch.storage.integrity import (
            AUDIT_OK,
            AUDIT_UNSIGNED_TAIL,
            file_sig_storage_fn,
        )

        root = str(tmp_path)
        feeds = FeedStore(
            file_storage_fn(root), sig_fn=file_sig_storage_fn(root)
        )
        pair = keymod.create()
        f = feeds.create(pair)
        f.append(b"only-block")
        feeds2 = FeedStore(
            file_storage_fn(root), sig_fn=file_sig_storage_fn(root)
        )
        f2 = feeds2.create(pair)
        assert f2.integrity.signed_length == 0 and f2.length == 1
        assert f2.audit_status() == AUDIT_UNSIGNED_TAIL
        f2.seal()
        assert f2.audit_status() == AUDIT_OK
        feeds2.close()

    def test_on_disk_block_tamper_detected(self, tmp_path):
        repo = Repo(path=str(tmp_path))
        url = repo.create({"x": 1})
        repo.change(url, lambda d: d.__setitem__("y", 2))
        repo.close()

        # find the doc's block log and flip one byte
        feeds = os.path.join(str(tmp_path), "feeds")
        victim = None
        for root, _dirs, files in os.walk(feeds):
            for name in files:
                if "." not in name:
                    victim = os.path.join(root, name)
        assert victim
        data = bytearray(open(victim, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(victim, "wb").write(bytes(data))

        repo2 = Repo(path=str(tmp_path))
        doc_id = os.path.basename(victim)
        feed = repo2.back.feeds.open_feed(doc_id)
        assert feed.audit() is False
        repo2.close()

    def test_on_disk_sig_tamper_detected(self, tmp_path):
        repo = Repo(path=str(tmp_path))
        url = repo.create({"x": 1})
        repo.close()
        feeds = os.path.join(str(tmp_path), "feeds")
        victim = None
        for root, _dirs, files in os.walk(feeds):
            for name in files:
                if name.endswith(".sig"):
                    victim = os.path.join(root, name)
        assert victim
        data = bytearray(open(victim, "rb").read())
        data[-1] ^= 0xFF  # corrupt the newest signature
        open(victim, "wb").write(bytes(data))

        repo2 = Repo(path=str(tmp_path))
        feed = repo2.back.feeds.open_feed(
            os.path.basename(victim)[: -len(".sig")]
        )
        assert feed.audit() is False
        repo2.close()

    def test_untampered_disk_audits_clean(self, tmp_path):
        repo = Repo(path=str(tmp_path))
        url = repo.create({"x": 1})
        repo.change(url, lambda d: d.__setitem__("y", 2))
        from hypermerge_tpu_torch.utils.ids import validate_doc_url

        doc_id = validate_doc_url(url)
        repo.close()
        repo2 = Repo(path=str(tmp_path))
        assert repo2.back.feeds.open_feed(doc_id).audit()
        repo2.close()


class TestLazySigningAudit:
    def _file_feeds(self, root):
        from hypermerge_tpu_torch.storage.feed import FeedStore, file_storage_fn
        from hypermerge_tpu_torch.storage.integrity import file_sig_storage_fn

        return FeedStore(
            file_storage_fn(root), sig_fn=file_sig_storage_fn(root)
        )

    def test_foreign_tail_block_fails_audit_not_laundered(self, tmp_path):
        """A block appended to the on-disk log beyond the signed chain
        (crash leftovers or attacker) must FAIL the audit on reopen —
        never be sealed into validity by the writer's own key."""
        import struct

        root = str(tmp_path)
        feeds = self._file_feeds(root)
        pair = keymod.create()
        f = feeds.create(pair)
        for i in range(3):
            f.append(b"block%d" % i)
        feeds.close()  # seals at length 3

        log_path = os.path.join(
            root, pair.public_key[:2], pair.public_key
        )
        forged = b"forged!"
        with open(log_path, "ab") as fh:
            fh.write(struct.pack("<I", len(forged)) + forged)
        # .len sidecar now mismatches -> storage rescans and sees 4
        os.remove(log_path + ".len")

        feeds2 = self._file_feeds(root)
        f2 = feeds2.create(pair)  # writable: the dangerous case
        assert f2.length == 4
        assert f2.audit() is False, "foreign tail must not be sealed"
        # and the chain on disk still stops at 3
        assert f2.integrity.signed_length == 3
        feeds2.close()

    def test_in_process_tail_still_audits_clean(self):
        feeds = FeedStore(memory_storage_fn)
        f = feeds.create(keymod.create())
        f.append(b"one")
        f.append(b"two")
        assert f.audit()  # in-process unsigned tail: sealed + verified


class TestSignChain:
    def test_sign_chain_matches_live_writer_records(self, tmp_path):
        """integrity.sign_chain (dense corpus format) and the live
        writer agree on every boundary: a sealed live feed's head record
        equals sign_chain's last record byte-for-byte, and record_for
        reproduces ANY intermediate record of the dense chain."""
        from hypermerge_tpu_torch.storage.feed import FeedStore, file_storage_fn
        from hypermerge_tpu_torch.storage.integrity import (
            _REC,
            file_sig_storage_fn,
            sign_chain,
        )

        root = str(tmp_path)
        feeds = FeedStore(
            file_storage_fn(root), sig_fn=file_sig_storage_fn(root)
        )
        pair = keymod.create()
        f = feeds.create(pair)
        blocks = [f"block{i}".encode() for i in range(7)]
        for b in blocks:
            f.append(b)
        f.seal()
        sig_path = os.path.join(
            root, pair.public_key[:2], pair.public_key + ".sig"
        )
        on_disk = open(sig_path, "rb").read()
        dense = sign_chain(blocks, keymod.decode(pair.secret_key))
        assert on_disk == dense[-_REC.size:]  # head record identical
        # every intermediate boundary the dense chain stores is
        # reproducible on demand by the live writer
        for i in range(7):
            want = _REC.unpack_from(dense, i * _REC.size)
            got = f.integrity.record_for(f, i + 1)
            assert got == want, i


class TestReplicationVerification:
    def test_signed_replication_end_to_end(self):
        feeds_a, mgr_a, _ = _mgr()
        feeds_b, mgr_b, _ = _mgr()
        pair = keymod.create()
        fa = feeds_a.create(pair)
        for i in range(5):
            fa.append(f"b{i}".encode())
        fb = feeds_b.open_feed(pair.public_key)
        _connect(mgr_a, mgr_b)
        assert fb.read_all() == fa.read_all()
        # the replica stored verified records it can audit and re-serve
        assert fb.audit()
        # live tail stays verified (batched flush: asynchronous)
        fa.append(b"live")
        wait_until(lambda: fb.length == 6)
        assert fb.read_all()[-1] == b"live"
        assert fb.audit()

    def test_tampered_block_rejected(self):
        """A forged Blocks message (valid-looking bytes, bad signature)
        must be dropped BEFORE storage."""
        feeds_a, mgr_a, _ = _mgr()
        feeds_b, mgr_b, _ = _mgr()
        pair = keymod.create()
        fa = feeds_a.create(pair)
        fa.append(b"real")
        fb = feeds_b.open_feed(pair.public_key)
        pa, pb = _connect(mgr_a, mgr_b)
        assert fb.read_all() == [b"real"]

        # attacker crafts an extension with its OWN key's signature
        evil = keymod.create()
        evil_seed = keymod.decode(evil.secret_key)
        leaves = [crypto.leaf_hash(b"real"), crypto.leaf_hash(b"evil")]
        root = crypto.merkle_root(leaves)
        sig = crypto.sign(signable(2, root), evil_seed)
        mgr_b._on_blocks(
            pb,
            fa.discovery_id,
            1,
            [base64.b64encode(b"evil").decode()],
            2,
            base64.b64encode(sig).decode(),
            2,
        )
        assert fb.read_all() == [b"real"]  # nothing stored

        # altered payload under the real writer's signature also fails
        rec = fa.integrity.latest()
        mgr_b._on_blocks(
            pb,
            fa.discovery_id,
            1,
            [base64.b64encode(b"evil").decode()],
            2,
            base64.b64encode(rec[2]).decode(),
            2,
        )
        assert fb.read_all() == [b"real"]

    def test_discovery_id_alone_cannot_fetch_blocks(self):
        """Capability verification (hypercore-protocol parity): a peer
        that learned a feed's discovery id from announcements but does
        NOT know the feed public key gets no data — its Requests carry
        no valid key-derived capability."""
        feeds_a, mgr_a, _ = _mgr()
        feeds_b, mgr_b, _ = _mgr()
        pair = keymod.create()
        fa = feeds_a.create(pair)
        fa.append(b"secret-block")
        pa, pb = _connect(mgr_a, mgr_b)  # b shares NO feeds with a

        # attacker on b's side: craft Requests with the announced did;
        # spy on everything b's manager receives back
        got = []
        orig = mgr_b._on_message
        mgr_b._on_message = lambda peer, msg: (
            got.append(msg), orig(peer, msg)
        )
        ch = pb.connection.open_channel("Replication")
        did = fa.discovery_id
        ch.send({"type": "Request", "id": did, "from": 0, "cap": "bogus"})
        ch.send({"type": "Request", "id": did, "from": 0})
        assert not any(
            m.get("type") == "Blocks" for m in got if isinstance(m, dict)
        ), got

        # whereas a peer proving the capability (key + A's challenge)
        # does get data
        from hypermerge_tpu_torch.storage.integrity import capability

        challenge = mgr_a._challenge_local[pa]
        ch.send({
            "type": "Request", "id": did, "from": 0,
            # B proves from the server side of the a<->b duplex pair
            "cap": capability(pair.public_key, challenge, b"", False),
        })
        assert any(
            m.get("type") == "Blocks" for m in got if isinstance(m, dict)
        ), got

    def test_capability_not_replayable_across_connections(self):
        """A cap captured on one connection is useless on another: proofs
        bind to the verifier's per-connection random challenge — an
        impersonator armed with a stolen proof still gets nothing."""
        from hypermerge_tpu_torch.storage.integrity import capability

        feeds_a, mgr_a, _ = _mgr()
        feeds_b, mgr_b, _ = _mgr()
        feeds_c, mgr_c, _ = _mgr()
        pair = keymod.create()
        fa = feeds_a.create(pair)
        fa.append(b"data")
        fb = feeds_b.open_feed(pair.public_key)
        pa, _pb = _connect(mgr_a, mgr_b)
        assert fb.read_all() == [b"data"]  # legit sync worked

        # the cap B proved with on the a<->b connection (bound to the
        # challenge A issued there)
        stale_cap = capability(
            pair.public_key, mgr_a._challenge_local[pa], b"", False
        )
        # attacker C (knows only the discovery id) replays it on a<->c
        _pca, pcc = _connect(mgr_a, mgr_c)
        got = []
        orig = mgr_c._on_message
        mgr_c._on_message = lambda peer, msg: (
            got.append(msg), orig(peer, msg)
        )
        ch = pcc.connection.open_channel("Replication")
        ch.send({
            "type": "Request", "id": fa.discovery_id, "from": 0,
            "cap": stale_cap,
        })
        assert not any(
            m.get("type") == "Blocks" for m in got if isinstance(m, dict)
        ), got

    def test_capability_not_mintable_by_challenge_reflection(self):
        """ADVICE r4 high: an attacker knowing only the discovery id
        sets ITS challenge equal to the one we issued it, then replays
        the proactive proof from our concealed FeedLength as its own.
        The proof MACs the PROVER's transport role, so the mirrored
        value never verifies and blocks stay withheld."""
        feeds_a, mgr_a, _ = _mgr()
        pair = keymod.create()
        fa = feeds_a.create(pair)
        fa.append(b"secret-block")

        # raw attacker endpoint: a bare PeerConnection, no manager
        da, db = duplex_pair()
        ca, cb = PeerConnection(da, True), PeerConnection(db, False)
        pa = NetworkPeer("X", "A", lambda p: None)
        pa.add_connection(ca)
        mgr_a.on_peer(pa)

        got = []
        cb.open_channel("Replication").subscribe(got.append)
        # A's opener carries the challenge A wants proofs against
        for _ in range(100):
            if got:
                break
            time.sleep(0.01)
        opener = got[0]
        assert opener["type"] == "DiscoveryIds"
        a_challenge = opener["challenge"]

        # reflect: announce the did with challenge := A's own challenge
        cb.open_channel("Replication").send({
            "type": "DiscoveryIds",
            "ids": [fa.discovery_id],
            "challenge": a_challenge,
        })
        # A proactively sends its concealed FeedLength whose cap is
        # capability(pk, a_challenge, binding, A's role)
        for _ in range(100):
            if any(m.get("type") == "FeedLength" for m in got[1:]):
                break
            time.sleep(0.01)
        fl = next(m for m in got[1:] if m.get("type") == "FeedLength")
        assert fl["length"] == 0  # concealed from the unproven peer

        # mirror the cap straight back as our "proof"
        cb.open_channel("Replication").send({
            "type": "Request", "id": fa.discovery_id, "from": 0,
            "cap": fl["cap"],
        })
        time.sleep(0.2)
        assert not any(
            m.get("type") == "Blocks" for m in got if isinstance(m, dict)
        ), got

    def test_unsigned_blocks_dropped_by_default(self):
        feeds_b, mgr_b, _ = _mgr()
        pair = keymod.create()
        fb = feeds_b.open_feed(pair.public_key)
        pa = object.__new__(NetworkPeer)
        pa.id = "X"
        mgr_b._on_blocks(
            pa, fb.discovery_id, 0,
            [base64.b64encode(b"nosig").decode()], -1, None, 1,
        )
        assert fb.read_all() == []

    def test_unsigned_blocks_accepted_with_escape_hatch(self, monkeypatch):
        monkeypatch.setenv("HM_ALLOW_UNSIGNED_FEEDS", "1")
        feeds_b, mgr_b, _ = _mgr()
        pair = keymod.create()
        fb = feeds_b.open_feed(pair.public_key)
        pa = object.__new__(NetworkPeer)
        pa.id = "X"
        mgr_b._on_blocks(
            pa, fb.discovery_id, 0,
            [base64.b64encode(b"nosig").decode()], -1, None, 1,
        )
        assert fb.read_all() == [b"nosig"]

    def test_byte_bounded_chunks_converge(self, monkeypatch):
        """Large blocks shrink the chunk so frames stay bounded in bytes,
        not just block count (a 64KB-block feed must never produce a
        frame past the transport cap)."""
        monkeypatch.setenv("HM_REPL_CHUNK_BYTES", "2500")
        feeds_a, mgr_a, _ = _mgr()
        feeds_b, mgr_b, _ = _mgr()
        pair = keymod.create()
        fa = feeds_a.create(pair)
        for i in range(10):
            fa.append(bytes([i]) * 1000)  # 1KB blocks
        fb = feeds_b.open_feed(pair.public_key)
        sent_sizes = []
        orig = mgr_a._blocks_msg

        def spy(feed, did, start, end):
            sent_sizes.append(end - start)
            return orig(feed, did, start, end)

        mgr_a._blocks_msg = spy
        _connect(mgr_a, mgr_b)
        assert fb.read_all() == fa.read_all()
        assert sent_sizes and max(sent_sizes) <= 2

    def test_chunked_backfill_converges(self, monkeypatch):
        """A 30-block feed replicates in 7-block ack-paced chunks (no
        whole-feed frame; VERDICT r3 missing #6)."""
        monkeypatch.setenv("HM_REPL_CHUNK", "7")
        feeds_a, mgr_a, _ = _mgr()
        feeds_b, mgr_b, _ = _mgr()
        pair = keymod.create()
        fa = feeds_a.create(pair)
        for i in range(30):
            fa.append(f"blk{i:02d}".encode())
        fb = feeds_b.open_feed(pair.public_key)
        _connect(mgr_a, mgr_b)
        assert fb.read_all() == fa.read_all()
        assert fb.audit()


class TestTamperFuzz:
    def test_random_on_disk_tampering_always_detected(self, tmp_path):
        """Flip random bytes anywhere in a feed's block log or signature
        records: audit() must never report clean."""
        import random

        from hypermerge_tpu_torch.storage.feed import (
            FeedStore,
            file_storage_fn,
        )
        from hypermerge_tpu_torch.storage.integrity import file_sig_storage_fn

        rng = random.Random(7)
        root = str(tmp_path)
        feeds = FeedStore(
            file_storage_fn(root), sig_fn=file_sig_storage_fn(root)
        )
        pair = keymod.create()
        f = feeds.create(pair)
        for i in range(12):
            f.append(rng.randbytes(rng.randint(5, 200)))
        assert f.audit()
        feeds.close()

        pk = pair.public_key
        block_path = os.path.join(root, pk[:2], pk)
        sig_path = block_path + ".sig"
        for trial in range(16):
            victim = block_path if trial % 2 == 0 else sig_path
            orig = open(victim, "rb").read()
            data = bytearray(orig)
            pos = rng.randrange(len(data))
            data[pos] ^= 1 << rng.randrange(8)
            open(victim, "wb").write(bytes(data))
            try:
                fresh = FeedStore(
                    file_storage_fn(root),
                    sig_fn=file_sig_storage_fn(root),
                )
                feed = fresh.open_feed(pk)
                assert feed.audit() is False, (
                    f"trial {trial}: flipped bit {pos} in "
                    f"{os.path.basename(victim)} went undetected"
                )
                fresh.close()
            finally:
                open(victim, "wb").write(orig)

    def test_random_wire_tampering_never_stored(self):
        """Fuzz the verified-append boundary: random corruptions of a
        valid (blocks, length, sig) extension never persist."""
        import random

        rng = random.Random(11)
        feeds_a, _mgr_a, _ = _mgr()
        pair = keymod.create()
        fa = feeds_a.create(pair)
        blocks = [rng.randbytes(rng.randint(10, 80)) for _ in range(6)]
        for b in blocks:
            fa.append(b)
        fa.seal()  # lazy signing: pin a head record to tamper against
        rec = fa.integrity.latest()

        for trial in range(24):
            feeds_b, _mgr_b, _ = _mgr()
            fb = feeds_b.open_feed(pair.public_key)
            send = [bytearray(b) for b in blocks]
            sig = bytearray(rec[2])
            length = rec[0]
            kind = trial % 3
            if kind == 0:  # corrupt one block
                tgt = send[rng.randrange(len(send))]
                tgt[rng.randrange(len(tgt))] ^= 0xFF
            elif kind == 1:  # corrupt the signature
                sig[rng.randrange(64)] ^= 1 << rng.randrange(8)
            else:  # lie about the length
                length = rng.randint(1, 5)
            ok = fb.append_verified(
                0, [bytes(b) for b in send], length, bytes(sig)
            )
            assert not ok, f"trial {trial} accepted tampering"
            assert fb.read_all() == [], (
                f"trial {trial}: tampered data persisted"
            )


class TestProgressEvents:
    def test_download_progress_fires_during_sync(self):
        """subscribe_progress callbacks fire while a doc replicates in
        (VERDICT r3 weak #3: the Download pipeline was dead code)."""
        from hypermerge_tpu_torch.net.swarm import LoopbackHub, LoopbackSwarm

        hub = LoopbackHub()
        ra, rb = Repo(memory=True), Repo(memory=True)
        ra.set_swarm(LoopbackSwarm(hub))
        rb.set_swarm(LoopbackSwarm(hub))
        url = ra.create({"n": 0})
        events = []
        h = rb.open(url)
        h.subscribe_progress(lambda *a: events.append(a))
        for i in range(5):
            ra.change(url, lambda d: d.__setitem__("n", i))
        wait_until(lambda: rb.doc(url).get("n") == 4)
        assert events, "no Download progress events during sync"
        ra.close()
        rb.close()


class TestProofServer:
    """Satellites: the lock-order fix in the leaf cache and the cached
    proof-level forest (O(range x log n) serving)."""

    def _feed(self, n_blocks=64):
        feeds = FeedStore(memory_storage_fn)
        feed = feeds.create(keymod.create())
        for i in range(n_blocks):
            feed.append(b"blk%d" % i)
        feed.seal()
        return feed

    def test_range_proofs_never_hold_integrity_lock_into_feed(self):
        """Lock-order regression: serving a range with a STALE leaf
        cache must snapshot blocks via the feed lock WITHOUT holding
        the integrity lock (feed -> integrity is the documented order;
        the old code inverted it here)."""
        feed = self._feed(32)
        from hypermerge_tpu_torch.storage.integrity import (
            FeedIntegrity,
            MemorySigStorage,
        )

        # fresh integrity instance over the same records: leaf cache
        # is empty (stale), so range_proofs must rebuild it
        store = MemorySigStorage()
        for rec in feed.integrity.records():
            store.append(*rec)
        integ = FeedIntegrity(store, feed.public_key)
        orig = feed.get_batch
        violations = []

        def checked_get_batch(s, e):
            if integ._lock._is_owned():
                violations.append((s, e))
            return orig(s, e)

        feed.get_batch = checked_get_batch
        try:
            served = integ.range_proofs(feed, 10, 14)
        finally:
            feed.get_batch = orig
        assert served is not None
        assert not violations, (
            "feed.get_batch called while holding the integrity lock "
            f"(deadlock-prone inversion): {violations}"
        )

    def test_stale_leaf_cache_concurrent_with_append_no_deadlock(self):
        """The concrete interleaving the inversion deadlocked on: a
        prover paused inside its block snapshot while a writer appends
        (feed lock -> integrity lock). Exercised under a timeout."""
        import threading

        feeds = FeedStore(memory_storage_fn)
        feed = feeds.create(keymod.create())
        for i in range(8):
            feed.append(b"blk%d" % i)
        feed.seal()
        from hypermerge_tpu_torch.storage.integrity import (
            FeedIntegrity,
            MemorySigStorage,
        )

        store = MemorySigStorage()
        for rec in feed.integrity.records():
            store.append(*rec)
        integ = FeedIntegrity(store, feed.public_key)  # stale leaves
        orig = feed.get_batch
        in_snapshot = threading.Event()
        release = threading.Event()

        def gated_get_batch(s, e):
            if threading.current_thread().name == "prover":
                in_snapshot.set()
                release.wait(5)
            return orig(s, e)

        feed.get_batch = gated_get_batch
        served = []

        def prove():
            served.append(integ.range_proofs(feed, 0, 4))

        prover = threading.Thread(target=prove, name="prover", daemon=True)
        appender = threading.Thread(
            target=lambda: feed.append(b"late"), daemon=True
        )
        try:
            prover.start()
            assert in_snapshot.wait(5), "prover never reached its snapshot"
            appender.start()  # feed lock -> integrity lock
            appender.join(3)
            dead = appender.is_alive()
            release.set()
            prover.join(5)
            appender.join(5)
            assert not dead, (
                "append deadlocked against a proof server holding the "
                "integrity lock across its block snapshot"
            )
            assert not prover.is_alive() and not appender.is_alive()
            assert served and served[0] is not None
        finally:
            release.set()
            feed.get_batch = orig

    def test_repeated_range_proofs_hash_count_bounded(self, monkeypatch):
        """Proof-level cache: the first RequestRange against a record
        pays the one O(n) level build; EVERY later range against the
        same record is pure lookup — zero parent hashes. (The pre-cache
        server rebuilt all levels per request: O(range x n).)"""
        from hypermerge_tpu_torch.storage import integrity as integ_mod

        feed = self._feed(128)
        length = feed.length
        calls = [0]
        orig_parent = integ_mod._parent

        def counting_parent(left, right):
            calls[0] += 1
            return orig_parent(left, right)

        monkeypatch.setattr(integ_mod, "_parent", counting_parent)
        integ = feed.integrity
        integ._proof_cache.clear()
        served = integ.range_proofs(feed, 0, 8)
        assert served is not None
        first_build = calls[0]
        assert first_build <= 2 * length, "level build must be O(n)"
        calls[0] = 0
        for start in (8, 40, 100, 0):
            served = integ.range_proofs(feed, start, start + 8)
            assert served is not None
        assert calls[0] == 0, (
            f"repeat ranges re-hashed {calls[0]} parents; expected the "
            "cached forest to serve them hash-free"
        )
        # and the proofs still verify
        from hypermerge_tpu_torch.storage.integrity import verify_inclusion

        length2, sig, pairs = served
        ok = verify_inclusion(
            feed.public_key,
            crypto.leaf_hash(pairs[0][0]),
            0,
            length2,
            pairs[0][1],
            sig,
        )
        assert ok
