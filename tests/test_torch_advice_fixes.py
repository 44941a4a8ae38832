"""Every case of tests/test_advice_fixes.py under its own name on the port
(hypermerge_tpu_torch), repos on the CPU; the reference's test helpers
(tests/helpers.py Site / plainify / sync, test_bulk_cold_start.py's
_caches_from_history / _patch_doc) are kept here as port copies.

The twinned file's own docstring follows.

Regression tests for the round-2 advisor findings (ADVICE.md).

Each test reproduces the reported failure before the fix:
- pack_docs_columns key-LUT IndexError when the last feed has no keyed ops
- a columnar sidecar AHEAD of its feed being silently trusted
- a truncated upload being durably recorded as a complete file
- HEAD error responses carrying bodies
- duplicate metadata ledger appends
- bulk load skipping the minimum-clock readiness gate
- bulk clock shortcut trusting an unchecked seq-contiguity invariant
- slab DecodedBatch retention via never-cleared snapshot closures
"""

import os
import socket
import tempfile
import time

import numpy as np
import pytest

from hypermerge_tpu_torch.backend.actor import Actor
from hypermerge_tpu_torch.backend.metadata import Metadata
from hypermerge_tpu_torch.crdt.frontend_state import FrontendDoc
from hypermerge_tpu_torch.crdt.opset import OpSet
from hypermerge_tpu_torch.models import Counter, Table, Text
from hypermerge_tpu_torch.ops.columnar import pack_docs, pack_docs_columns
from hypermerge_tpu_torch.ops.crdt_kernels import run_batch
from hypermerge_tpu_torch.ops.materialize import DecodedBatch, decode_patch
from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.storage import block as blockmod
from hypermerge_tpu_torch.storage.colcache import (
    ROW_FIELDS,
    FeedColumnCache,
    MemoryColumnStorage,
)
from hypermerge_tpu_torch.storage.feed import Feed, FeedStore, MemoryFeedStorage, memory_storage_fn
from hypermerge_tpu_torch.storage.sql import SqlDatabase
from hypermerge_tpu_torch.storage.stores import KeyStore
from hypermerge_tpu_torch.utils import keys as keymod
from hypermerge_tpu_torch.utils.ids import validate_doc_url


def Repo(*args, **kw):
    """The port's Repo on the CPU (tests run where no card is present)."""
    kw.setdefault("device", "cpu")
    return _PortRepo(*args, **kw)


INF = float("inf")


# -- port copies of the reference's test helpers -------------------------
# (tests/helpers.py and tests/test_bulk_cold_start.py build reference
# objects; these build the port's)


class Site:
    def __init__(self, actor: str):
        self.actor = actor
        self.front = FrontendDoc()
        self.opset = OpSet()
        self.seq = 1

    def change(self, fn, message=""):
        req, preview = self.front.change(fn, self.actor, self.seq, message)
        if req is None:
            return None, preview
        self.seq += 1
        change, patch = self.opset.apply_local_request(req)
        self.front.apply_patch(patch)
        return change, preview

    def receive(self, changes):
        patch = self.opset.apply_changes(changes)
        self.front.apply_patch(patch)

    @property
    def doc(self):
        return self.front.materialize()


def plainify(v):
    if isinstance(v, Text):
        return ("__text__", str(v))
    if isinstance(v, Table):
        return ("__table__", {k: plainify(v.by_id(k)) for k in v.ids})
    if isinstance(v, Counter):
        return ("__counter__", int(v))
    if isinstance(v, dict):
        return {k: plainify(x) for k, x in v.items()}
    if isinstance(v, list):
        return [plainify(x) for x in v]
    return v


def sync(*sites):
    for a in sites:
        for b in sites:
            if a is not b:
                a.receive(list(b.opset.history))


def _caches_from_history(history):
    caches = {}
    for c in sorted(history, key=lambda c: (c.actor, c.seq)):
        cc = caches.setdefault(
            c.actor, FeedColumnCache(MemoryColumnStorage(), writer=c.actor)
        )
        cc.append_change(c)
    return caches


def _patch_doc(batch, d):
    dec = DecodedBatch(batch, run_batch(batch, device="cpu"))
    front = FrontendDoc()
    front.apply_patch(decode_patch(dec, d))
    return plainify(front.materialize())


# -- pack_docs_columns: empty key table at the end of the LUT ------------


def test_pack_columns_empty_key_table_last_feed():
    """A collaborator feed containing only keyless ops (text inserts) has
    an empty key table; placed last in the flat LUT its offset equals
    len(klut), and the eager np.where gather used to IndexError."""
    a, b = Site("actorA"), Site("actorB")
    a.change(lambda d: d.__setitem__("t", Text("x")))
    sync(a, b)
    b.change(lambda d: d["t"].insert(1, "y"))
    sync(a, b)
    history = list(a.opset.history)
    caches = _caches_from_history(history)
    # actorB's feed (keyless ops only) must come LAST in the spec
    spec = [
        (caches["actorA"].columns(), 0, INF),
        (caches["actorB"].columns(), 0, INF),
    ]
    batch = pack_docs_columns([spec], device="cpu")  # used to raise IndexError
    ref = pack_docs([history])
    assert batch.n_ops.tolist() == ref.n_ops.tolist()
    assert _patch_doc(batch, 0) == _patch_doc(ref, 0) == plainify(a.doc)


# -- sidecar ahead of feed ----------------------------------------------


def test_sidecar_ahead_of_feed_rebuilds():
    """A sidecar claiming more changes than its feed holds (feed file
    replaced / truncated out-of-band) must be discarded and rebuilt from
    blocks — blocks are the source of truth."""
    site = Site("actorX")
    for i in range(5):
        site.change(lambda d, i=i: d.__setitem__(f"k{i}", i))
    history = list(site.opset.history)

    pair = keymod.create()
    feed = Feed(pair.public_key, MemoryFeedStorage(), pair.secret_key)
    # feed holds only the first 3 blocks...
    for c in history[:3]:
        feed.append(blockmod.pack(c.to_json()))
    # ...but the sidecar committed all 5
    cache = FeedColumnCache(MemoryColumnStorage(), writer=pair.public_key)
    for c in history:
        cache.append_change(c)
    assert cache.n_changes == 5
    feed.colcache = cache

    actor = Actor(feed, lambda e: None)
    fc = actor.columns()
    assert fc.n_changes == 3  # rebuilt to match the block log
    assert fc.changes_in_window(0, INF) == 3
    # and the rebuilt rows equal a from-scratch encode of the same blocks
    ref = FeedColumnCache(MemoryColumnStorage(), writer=pair.public_key)
    for c in history[:3]:
        ref.append_change(c)
    assert np.array_equal(fc.rows, ref.columns().rows)


# -- file server: truncated upload + HEAD errors ------------------------


def _server_path() -> str:
    import uuid

    return os.path.join(
        tempfile.gettempdir(),
        f"hypermerge-tpu-test-{uuid.uuid4().hex[:8]}.sock",
    )


def test_truncated_upload_not_recorded_complete():
    """A client disconnect mid-upload must not append the trailing header
    block: the feed stays an incomplete upload, nothing reaches the
    write log / metadata ledger."""
    repo = Repo(memory=True)
    path = _server_path()
    try:
        repo.start_file_server(path)
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(path)
        s.sendall(
            b"POST / HTTP/1.1\r\n"
            b"Host: unix\r\n"
            b"Content-Type: text/plain\r\n"
            b"Content-Length: 100000\r\n\r\n" + b"x" * 1000
        )
        s.close()  # disconnect with 99000 bytes unread
        # the handler aborts on the recv EOF; give its thread a beat
        time.sleep(0.25)
        assert repo.back.meta.files == {}
        # the server still works for a subsequent complete upload
        header = repo.files.write(b"ok", "text/plain")
        assert len(repo.back.meta.files) == 1  # only the good one recorded
        _h, body = repo.files.read(header.url)
        assert body == b"ok"
    finally:
        repo.close()


def test_head_error_response_has_no_body():
    """HEAD responses are headers-only even for errors (RFC 9110) — a
    body would desync keep-alive framing."""
    repo = Repo(memory=True)
    path = _server_path()
    try:
        repo.start_file_server(path)
        bogus = keymod.create().public_key
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(path)
        s.sendall(
            f"HEAD /hyperfile:/{bogus} HTTP/1.1\r\n"
            f"Host: unix\r\nConnection: close\r\n\r\n".encode()
        )
        raw = b""
        while True:
            chunk = s.recv(4096)
            if not chunk:
                break
            raw += chunk
        s.close()
        head, _, body = raw.partition(b"\r\n\r\n")
        assert b"404" in head.split(b"\r\n")[0]
        assert body == b""
    finally:
        repo.close()


# -- metadata ledger: no duplicate appends ------------------------------


def test_metadata_no_duplicate_ledger_appends():
    feeds = FeedStore(memory_storage_fn)
    key_store = KeyStore(SqlDatabase(":memory:"))
    meta = Metadata(feeds, key_store)
    url = f"hyperfile:/{keymod.create().public_key}"
    meta.add_file(url, 5, "a/b")
    assert meta.ledger.length == 1
    meta.add_file(url, 5, "a/b")  # identical: must not grow the ledger
    assert meta.ledger.length == 1
    meta.add_file(url, 6, "a/b")  # changed: re-recorded
    assert meta.ledger.length == 2


# -- bulk load: minimum-clock gate --------------------------------------


def test_bulk_load_gates_unknown_empty_doc():
    """An unknown doc id with no local history must not announce as an
    empty document — it waits on the root actor's first replicated
    change, like _load_document's minimumClock gate."""
    repo = Repo(memory=True)
    try:
        unknown = keymod.create().public_key
        repo.back.load_documents_bulk([unknown])
        doc = repo.back.docs[unknown]
        assert not doc._announced
        assert doc.minimum_clock == {unknown: 1}
    finally:
        repo.close()


# -- bulk load: seq-contiguity check ------------------------------------


def test_bulk_load_falls_back_on_seq_gap(tmp_path):
    """A sidecar with a seq gap (e.g. restored from a different feed
    generation) must not produce a silently wrong clock — the doc routes
    through the safe per-doc replay path instead."""
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"x": 1})
    repo.change(url, lambda d: d.__setitem__("y", 2))
    repo.change(url, lambda d: d.__setitem__("z", 3))
    want = plainify(repo.doc(url))
    doc_id = validate_doc_url(url)
    want_clock = dict(repo.back.docs[doc_id].clock)
    repo.close()

    # corrupt the sidecar: bump the last change's seq to fake a gap
    # (sidecars live in the corpus slab now — supersede each feed's
    # image with the edited record stream; `.cols2` files are walked
    # too for the HM_SLAB=0 layout)
    from hypermerge_tpu_torch.storage.colcache import (
        FileColumnStorageV2,
        file_column_storage_fn,
        pack_v2_record,
    )

    feeds_dir = os.path.join(path, "feeds")

    def _edit(rows, preds, tables, commits):
        if not len(rows):
            return None
        max_seq = rows[:, 2].max()
        if max_seq < 2:
            return None
        rows = rows.copy()
        rows[rows[:, 2] == max_seq, 2] = max_seq + 1
        # re-frame the same per-change records with the edited rows
        recs = []
        pr = pp = pt = 0
        for tr, tp, tt, flag in commits:
            recs.append(
                pack_v2_record(
                    rows[pr:tr], preds[pp:tp], tables[pt:tt], flag
                )
            )
            pr, pp, pt = tr, tp, tt
        return b"".join(recs)

    edited = False
    fn = file_column_storage_fn(feeds_dir)
    if fn.slab is not None:
        from hypermerge_tpu_torch.storage.slab import KIND_IMAGE

        for name in fn.slab.feed_names():
            blob = _edit(*fn(name).load())
            if blob is not None:
                fn.slab.append(KIND_IMAGE, name, blob)
                edited = True
        fn.slab.close()
    for root, _dirs, files in os.walk(feeds_dir):
        for f in files:
            if not f.endswith(".cols2"):
                continue
            st = FileColumnStorageV2(os.path.join(root, f))
            blob = _edit(*st.load())
            if blob is None:
                continue
            with open(os.path.join(root, f), "wb") as fh:
                fh.write(blob)
            edited = True
    assert edited

    repo2 = Repo(path=path)
    try:
        repo2.back.load_documents_bulk([doc_id])
        doc = repo2.back.docs[doc_id]
        # fallback path replays host-side (opset exists) with the true clock
        assert doc.opset is not None
        assert doc.clock == want_clock
        assert plainify(repo2.doc(url)) == want
    finally:
        repo2.close()


# -- bulk load: snapshot closure released after first use ---------------


def test_bulk_snapshot_fn_released_after_first_ready(tmp_path):
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"a": 1})
    repo.close()

    repo2 = Repo(path=path)
    try:
        doc_id = validate_doc_url(url)
        repo2.back.load_documents_bulk([doc_id])
        doc = repo2.back.docs[doc_id]
        p1 = doc.snapshot_patch()
        assert doc._snapshot_fn is None  # closure (and its slab) released
        assert doc.snapshot_patch() is p1  # later reads serve the cache
        assert doc.opset is None  # still lazy
    finally:
        repo2.close()


def test_noop_change_does_not_strand_queue():
    """ADVICE r5 low (doc_frontend.py): when the echo-paced queue pops a
    change fn that produces no ops, the drain must continue to the next
    queued change instead of stranding until an unrelated patch."""
    from hypermerge_tpu_torch.frontend.doc_frontend import DocFrontend

    sent = []

    class StubRepo:
        class to_backend:
            @staticmethod
            def push(msg):
                pass

        @staticmethod
        def send_request(doc_id, request):
            sent.append(request)

        @staticmethod
        def needs_actor(doc_id):
            pass

    doc_id = "d" * 43
    fe = DocFrontend(StubRepo(), doc_id, actor_id=doc_id)

    fe.change(lambda d: d.__setitem__("a", 1))
    assert len(sent) == 1 and fe._inflight is not None

    # queue while the echo is outstanding: a no-op fn, then a real one
    fe.change(lambda d: None)
    fe.change(lambda d: d.__setitem__("b", 2))
    assert len(sent) == 1  # both queued behind the in-flight echo

    # the echo lands: the no-op pops (produces nothing) and the drain
    # must continue to the real change in the same pass
    req = sent[0]
    fe.on_patch(
        {
            "actor": req.actor,
            "seq": req.seq,
            "diffs": [],
            "deps": {},
            "maxOp": 1,
            "clock": {req.actor: req.seq},
        },
        1,
    )
    assert len(sent) == 2, "queued change stranded behind a no-op fn"
