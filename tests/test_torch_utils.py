"""Every case of tests/test_utils.py under its own name on the port
(hypermerge_tpu_torch.utils).

The twinned file's own docstring follows.

Utility layer: queue discipline, mapset, base58, ids, ed25519, json."""

import threading

import pytest

from hypermerge_tpu_torch.utils import base58, ed25519, ids, keys
from hypermerge_tpu_torch.utils.json_buffer import bufferify, parse, parse_all_valid
from hypermerge_tpu_torch.utils.mapset import MapSet
from hypermerge_tpu_torch.utils.queue import Queue


class TestQueue:
    def test_buffers_until_subscribe_then_direct(self):
        q = Queue("t")
        q.push(1)
        q.push(2)
        seen = []
        q.subscribe(seen.append)
        assert seen == [1, 2]
        q.push(3)
        assert seen == [1, 2, 3]

    def test_second_subscriber_raises(self):
        q = Queue("t")
        q.subscribe(lambda x: None)
        with pytest.raises(RuntimeError):
            q.subscribe(lambda x: None)

    def test_once(self):
        q = Queue("t")
        seen = []
        q.once(seen.append)
        q.push("a")
        q.push("b")
        assert seen == ["a"]
        # "b" stays buffered for the next subscriber
        out = []
        q.subscribe(out.append)
        assert out == ["b"]

    def test_first_blocks_until_push(self):
        q = Queue("t")
        result = []

        def waiter():
            result.append(q.first(timeout=5))

        th = threading.Thread(target=waiter)
        th.start()
        q.push(42)
        th.join(5)
        assert result == [42]

    def test_reentrant_push_preserves_order(self):
        q = Queue("t")
        seen = []

        def sub(x):
            seen.append(x)
            if x == 1:
                q.push(3)

        q.subscribe(sub)
        q.push(1)
        q.push(2)
        assert seen == [1, 3, 2]

    def test_drain(self):
        q = Queue("t")
        q.push(1)
        q.push(2)
        assert q.drain() == [1, 2]
        assert q.length == 0


class TestMapSet:
    def test_add_get_keyswith(self):
        ms = MapSet()
        assert ms.add("x", 1)
        assert not ms.add("x", 1)
        ms.add("x", 2)
        ms.add("y", 2)
        assert ms.get("x") == {1, 2}
        assert sorted(ms.keys_with(2)) == ["x", "y"]
        assert ms.keys_with(99) == []

    def test_remove_cleans_empty(self):
        ms = MapSet()
        ms.add("x", 1)
        ms.remove("x", 1)
        assert "x" not in ms.keys()


class TestBase58:
    def test_roundtrip(self):
        for data in [b"", b"\x00", b"\x00\x00hello", b"\xff" * 32, bytes(range(32))]:
            assert base58.decode(base58.encode(data)) == data

    def test_known_vector(self):
        # 'hello world' standard base58 vector
        assert base58.encode(b"hello world") == "StV1DL6CwTryKyV"
        assert base58.decode("StV1DL6CwTryKyV") == b"hello world"

    def test_invalid_char(self):
        with pytest.raises(ValueError):
            base58.decode("0OIl")


class TestEd25519:
    def test_rfc8032_vector_1(self):
        # RFC 8032 §7.1 TEST 1 (empty message)
        seed = bytes.fromhex(
            "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60"
        )
        pub = bytes.fromhex(
            "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"
        )
        sig = bytes.fromhex(
            "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
            "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"
        )
        assert ed25519.public_key(seed) == pub
        assert ed25519.sign(b"", seed) == sig
        assert ed25519.verify(b"", sig, pub)

    def test_rfc8032_vector_2(self):
        seed = bytes.fromhex(
            "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb"
        )
        pub = bytes.fromhex(
            "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c"
        )
        msg = bytes.fromhex("72")
        sig = ed25519.sign(msg, seed)
        assert sig == bytes.fromhex(
            "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
            "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"
        )
        assert ed25519.verify(msg, sig, pub)
        assert not ed25519.verify(b"tampered", sig, pub)

    def test_keys_roundtrip_and_discovery(self):
        pair = keys.create()
        buf = keys.decode_pair(pair)
        assert keys.encode_pair(buf) == pair
        assert len(buf.public_key) == 32
        d1 = keys.discovery_id(pair.public_key)
        d2 = keys.discovery_id(pair.public_key)
        assert d1 == d2
        other = keys.create()
        assert keys.discovery_id(other.public_key) != d1
        # signing with the pair's seed verifies under its public key
        sig = ed25519.sign(b"block", buf.secret_key)
        assert ed25519.verify(b"block", sig, buf.public_key)


class TestIds:
    def test_url_roundtrip(self):
        pair = keys.create()
        url = ids.to_doc_url(pair.public_key)
        assert ids.validate_doc_url(url) == pair.public_key
        assert ids.url_to_id(url) == pair.public_key
        furl = ids.to_hyperfile_url(pair.public_key)
        assert ids.validate_file_url(furl) == pair.public_key
        assert ids.is_doc_url(url) and not ids.is_doc_url(furl)

    def test_invalid_urls(self):
        with pytest.raises(ValueError):
            ids.validate_doc_url("hypermerge:/notakey")
        with pytest.raises(ValueError):
            ids.validate_doc_url("http://example.com")
        with pytest.raises(ValueError):
            ids.validate_url("nonsense")

    def test_root_actor_identity(self):
        pair = keys.create()
        assert ids.root_actor_id(ids.DocId(pair.public_key)) == pair.public_key


class TestJsonBuffer:
    def test_roundtrip(self):
        obj = {"b": 1, "a": [1, 2, {"x": None}]}
        assert parse(bufferify(obj)) == obj

    def test_parse_all_valid_skips_corrupt(self):
        bufs = [bufferify({"ok": 1}), b"\xff\xfe garbage", bufferify(2)]
        assert parse_all_valid(bufs) == [{"ok": 1}, 2]


def test_queue_first_with_none_item():
    q = Queue("t")
    q.push(None)
    q.push(7)
    assert q.first(timeout=1) is None


def test_queue_no_deadlock_cross_push():
    # two queues whose subscribers push to each other must not deadlock
    import threading as _t

    q1, q2 = Queue("q1"), Queue("q2")
    seen = []
    q1.subscribe(lambda x: (seen.append(("q1", x)), q2.push(x + 1) if x < 3 else None))
    q2.subscribe(lambda x: (seen.append(("q2", x)), q1.push(x + 1) if x < 3 else None))
    t1 = _t.Thread(target=lambda: q1.push(0))
    t2 = _t.Thread(target=lambda: q2.push(0))
    t1.start(); t2.start()
    t1.join(5); t2.join(5)
    assert not t1.is_alive() and not t2.is_alive()
    assert len(seen) == 8


def test_ed25519_rejects_noncanonical_encoding():
    seed = bytes(32)
    pub = ed25519.public_key(seed)
    sig = ed25519.sign(b"m", seed)
    # y >= p re-encoding of R must be rejected, not verified
    p = 2**255 - 19
    r_int = int.from_bytes(sig[:32], "little")
    y = r_int & ((1 << 255) - 1)
    if y < 19:  # re-encodable; otherwise just assert canonical verify works
        bad = (y + p) | (r_int & (1 << 255))
        bad_sig = bad.to_bytes(32, "little") + sig[32:]
        assert not ed25519.verify(b"m", bad_sig, pub)
    assert ed25519.verify(b"m", sig, pub)


class TestDebouncer:
    def test_coalesces_and_flushes(self):
        import time as _t

        from hypermerge_tpu_torch.utils.debounce import Debouncer

        batches = []
        d = Debouncer(batches.append, window_s=0.01)
        for i in range(50):
            d.mark("k", i)
        d.flush_now()
        assert batches and len(batches) <= 3
        assert batches[0]["k"] == 49  # default merge: latest wins
        d.close()

    def test_merge_fn(self):
        from hypermerge_tpu_torch.utils.debounce import Debouncer

        batches = []
        d = Debouncer(batches.append, window_s=0.01, merge=min)
        d.mark("k", 7)
        d.mark("k", 3)
        d.mark("k", 9)
        d.flush_now()
        assert batches[0]["k"] == 3
        d.close()

    def test_close_drains_pending(self):
        """Marks made before close() still flush — orderly shutdown
        loses nothing (the replication tail relies on this)."""
        from hypermerge_tpu_torch.utils.debounce import Debouncer

        batches = []
        d = Debouncer(batches.append, window_s=5.0)  # huge window
        d.mark("a", 1)
        d.mark("b", 2)
        d.close()  # must not wait the 5s window
        assert {"a": 1, "b": 2} in batches

    def test_flush_now_waits_for_inflight_flush(self):
        """flush_now returns only after flush_fn FINISHED, not merely
        after the pending set was swapped out."""
        import threading as _th

        from hypermerge_tpu_torch.utils.debounce import Debouncer

        started = _th.Event()
        release = _th.Event()
        done = []

        def slow_flush(batch):
            started.set()
            release.wait(5)
            done.append(batch)

        d = Debouncer(slow_flush, window_s=0.0)
        d.mark("k")
        assert started.wait(5)
        waiter_done = _th.Event()

        def waiter():
            d.flush_now(timeout=5)
            waiter_done.set()

        t = _th.Thread(target=waiter)
        t.start()
        assert not waiter_done.wait(0.1), "returned during in-flight flush"
        release.set()
        assert waiter_done.wait(5)
        assert done
        t.join(5)
        d.close()

    def test_flush_now_reports_timeout(self):
        """flush_now returns False when the drain did not finish inside
        the timeout — destroy() relies on this to refuse deleting rows
        a late flush would resurrect — and True once it has."""
        import threading as _th

        from hypermerge_tpu_torch.utils.debounce import Debouncer

        release = _th.Event()

        def stuck_flush(batch):
            release.wait(5)

        d = Debouncer(stuck_flush, window_s=0.0)
        d.mark("k")
        assert d.flush_now(timeout=0.05) is False
        release.set()
        assert d.flush_now(timeout=5) is True
        d.close()


def test_debouncer_adaptive_window_stretches_under_load():
    """With max_window_s set, a slow flush stretches the next window so
    batches grow instead of flush count (the replication live tail's
    self-balancing behavior)."""
    import threading as _th
    import time as _t

    from hypermerge_tpu_torch.utils.debounce import Debouncer

    batches = []

    def slow_flush(batch):
        batches.append(dict(batch))
        _t.sleep(0.05)  # flushing is slower than the floor window

    d = Debouncer(slow_flush, window_s=0.001, max_window_s=0.2)
    stop = _t.monotonic() + 0.5
    i = 0
    while _t.monotonic() < stop:
        d.mark(i % 4, i)
        i += 1
        _t.sleep(0.001)
    d.flush_now(timeout=5)
    d.close()
    total_marks = sum(len(b) for b in batches)
    assert total_marks >= 4  # all keys flushed at least once
    # with ~0.05s flushes over 0.5s, a non-adaptive 1ms window would do
    # hundreds of flushes; adaptation caps it near duration/flush_time
    assert len(batches) <= 14, len(batches)


# ---------------------------------------------------------------------------
# debug namespaces honor RUNTIME changes (round 13: daemons toggle
# namespaces without a restart — the patterns were parsed once at
# import before)


def test_debug_enabled_tracks_env_changes(monkeypatch):
    from hypermerge_tpu_torch.utils import debug

    monkeypatch.setenv("DEBUG", "")
    assert not debug.enabled("live")
    monkeypatch.setenv("DEBUG", "live,net:*")
    assert debug.enabled("live")
    assert debug.enabled("net:tcp")
    assert not debug.enabled("storage")
    monkeypatch.setenv("DEBUG", "storage")
    assert debug.enabled("storage")
    assert not debug.enabled("live")


def test_debug_set_patterns_overrides_env(monkeypatch):
    from hypermerge_tpu_torch.utils import debug

    monkeypatch.setenv("DEBUG", "live")
    debug.set_patterns("repl*")
    try:
        assert debug.enabled("replication")
        assert not debug.enabled("live")  # override wins over env
        debug.set_patterns(["a", "b:*"])
        assert debug.enabled("b:x") and debug.enabled("a")
    finally:
        debug.set_patterns(None)  # back to the env
    assert debug.enabled("live")
