"""Every case of tests/test_bulk_cold_start.py under its own name on the
port (hypermerge_tpu_torch): pack_docs / pack_docs_columns, the feed
column caches (storage/colcache.py: v2 files, legacy dirs, v3 plane
checkpoints, `compact`), and the bulk cold open of a port `Repo(path,
device="cpu")` (`load_documents_bulk`, `open_many`,
`fetch_bulk_summaries`) under the same HM_PIPELINE x HM_LIVE matrix.
Histories come from the port's Site (tests/port_helpers.py). Each value
a case checks is also held against the reference package on the same
inputs: its packed batch and decoded patch for the same history, its
column caches' read of the port's files (on a copy) and the bytes it
writes for the same changes, and its Repo's docs and summaries on a copy
of the port's repo directory (under HM_LIVE=0 HM_PIPELINE=0 HM_WAL=0
HM_SERVICE=0); tolerance 0.

The twinned file's own docstring follows.

Bulk cold-start path: columnar feed caches + vectorized packing +
lazy DocBackend reconstruction.

This is the north-star path (BASELINE config 4): feeds -> columnar
sidecar -> pack_docs_columns -> device kernel, with the per-op host
loop (`pack_docs`) as the correctness reference and the host OpSet as
ground truth (SURVEY.md §7.3 items 4 & 6: dual paths must agree)."""

import random
import tempfile

import numpy as np
import pytest

from hypermerge_tpu_torch.crdt.frontend_state import FrontendDoc
from hypermerge_tpu_torch.models import Text
from hypermerge_tpu_torch.ops.columnar import pack_docs, pack_docs_columns
from hypermerge_tpu_torch.ops.crdt_kernels import run_batch
from hypermerge_tpu_torch.ops.materialize import DecodedBatch, decode_patch
from hypermerge_tpu_torch.storage.colcache import (
    FeedColumnCache,
    FileColumnStorage,
    MemoryColumnStorage,
)
from hypermerge_tpu_torch.utils.ids import validate_doc_url

from hypermerge_tpu.crdt.frontend_state import FrontendDoc as RefFrontendDoc
from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu.ops.crdt_kernels import run_batch as ref_run_batch
from hypermerge_tpu.ops.materialize import DecodedBatch as RefDecodedBatch
from hypermerge_tpu.ops.materialize import decode_patch as ref_decode_patch
from hypermerge_tpu.storage import colcache as ref_colcache
from port_helpers import (
    Repo,
    Site,
    assert_batch_equal,
    copy_repo,
    plainify,
    random_mutation,
    ref_bulk_summaries,
    ref_docs,
    ref_plain,
    assert_reference_reads,
    assert_reference_summaries,
    sync,
    to_reference,
    wait_until,
)

INF = float("inf")


@pytest.fixture(params=["0", "1"], ids=["serial", "pipeline"])
def pipeline_mode(request, monkeypatch):
    """Env-matrix: every bulk cold-start test runs under BOTH the
    serial twin (HM_PIPELINE=0) and the streaming slab pipeline
    (HM_PIPELINE=1, the product default) — the pipeline is a pure
    scheduling change and must pass the identical contract."""
    monkeypatch.setenv("HM_PIPELINE", request.param)
    return request.param


@pytest.fixture(params=["0", "1"], ids=["host", "live"])
def live_mode(request, monkeypatch):
    """Env-matrix: HM_LIVE=0 is the host-OpSet correctness twin; the
    live apply engine (HM_LIVE=1, the product default) must honor the
    same incremental-change contract without reconstructing an OpSet."""
    monkeypatch.setenv("HM_LIVE", request.param)
    return request.param


def _history(seed: int, n_actors: int = 3, n_mut: int = 40):
    r = random.Random(seed)
    sites = [Site(f"actor{i:02d}") for i in range(n_actors)]
    for _ in range(n_mut):
        random_mutation(r.choice(sites), r)
        if r.random() < 0.3:
            sync(*sites)
    sync(*sites)
    return sites[0], list(sites[0].opset.history)


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


def _ref_patch_doc(ref_batch, d):
    """_patch_doc of the reference on its batch."""
    dec = RefDecodedBatch(ref_batch, ref_run_batch(ref_batch))
    front = RefFrontendDoc()
    front.apply_patch(ref_decode_patch(dec, d))
    return ref_plain(front.materialize())


def _ref_caches_from_history(history):
    """_caches_from_history in the reference, on the same changes."""
    caches = {}
    for c in sorted(to_reference(history), key=lambda c: (c.actor, c.seq)):
        cc = caches.setdefault(c.actor, ref_colcache.FeedColumnCache(
            ref_colcache.MemoryColumnStorage(), writer=c.actor))
        cc.append_change(c)
    return caches


def _ref_pack_columns(history, window=None, keep=None):
    """The reference's pack_docs_columns over its own caches of the same
    history: `window(actor, fc) -> end` cuts each feed, `keep` the
    actors packed."""
    specs = []
    for actor, cc in _ref_caches_from_history(history).items():
        if keep is not None and actor not in keep:
            continue
        fc = cc.columns()
        specs.append((fc, 0, INF if window is None else window(actor, fc)))
    return ref_columnar.pack_docs_columns([specs])


def _same_columns(got, want):
    """Two packages' FeedColumns (or the same package's) hold the same
    rows, preds, actors, keys and change count."""
    assert np.array_equal(got.ensure_rows(), want.ensure_rows())
    assert np.array_equal(got.preds, want.preds)
    assert list(got.actors) == list(want.actors)
    assert list(got.keys) == list(want.keys)
    assert got.n_changes == want.n_changes
    assert np.array_equal(got.row_ends, want.row_ends)


def _ref_read(storage_cls, path, writer, tmp):
    """The reference's FeedColumns read from a copy of the port's
    sidecar at `path` (a file or a legacy directory)."""
    import os
    import shutil

    dst = os.path.join(str(tmp), "ref-read-" + os.path.basename(path))
    if os.path.isdir(path):
        shutil.copytree(path, dst)
    else:
        shutil.copyfile(path, dst)
    cc = ref_colcache.FeedColumnCache(storage_cls(dst), writer=writer)
    try:
        return cc.columns()
    finally:
        cc.close()


def test_pack_columns_matches_pack_docs_and_host():
    """Full-window equivalence: vectorized pack == per-op pack == host
    OpSet, over randomized multi-actor histories."""
    for seed in (1, 2, 3):
        site, history = _history(seed)
        caches = _caches_from_history(history)
        spec = [(cc.columns(), 0, INF) for cc in caches.values()]
        b_ref = pack_docs([history])
        b_new = pack_docs_columns([spec], device="cpu")
        assert b_new.n_ops.tolist() == b_ref.n_ops.tolist()
        assert _patch_doc(b_ref, 0) == _patch_doc(b_new, 0) == plainify(
            site.doc
        )
        # the reference's batches and patch for the same history
        rb_ref = ref_columnar.pack_docs([to_reference(history)])
        rb_new = _ref_pack_columns(history)
        assert_batch_equal(b_ref, rb_ref)
        assert_batch_equal(b_new, rb_new)
        assert _ref_patch_doc(rb_new, 0) == _patch_doc(b_new, 0)


def test_pack_columns_multi_doc_batch():
    sites, specs, hists = [], [], []
    for seed in (10, 11, 12, 13):
        site, history = _history(seed, n_mut=25)
        caches = _caches_from_history(history)
        specs.append([(cc.columns(), 0, INF) for cc in caches.values()])
        hists.append(history)
        sites.append(site)
    b_ref = pack_docs(hists)
    b_new = pack_docs_columns(specs, device="cpu")
    for d, site in enumerate(sites):
        assert _patch_doc(b_ref, d) == _patch_doc(b_new, d) == plainify(
            site.doc
        )
    rb_new = ref_columnar.pack_docs_columns([
        [(cc.columns(), 0, INF) for cc in _ref_caches_from_history(h).values()]
        for h in hists
    ])
    assert_batch_equal(b_new, rb_new)
    assert_batch_equal(b_ref, ref_columnar.pack_docs(
        [to_reference(h) for h in hists]))
    for d in range(len(hists)):
        assert _ref_patch_doc(rb_new, d) == _patch_doc(b_new, d)


def test_pack_columns_partial_window():
    """Cursor windows (start, end] slice the same changes the host
    Actor.changes_in_window serves."""
    site, history = _history(7)
    caches = _caches_from_history(history)
    # cut each actor's window at half its changes
    spec = []
    sliced = []
    for actor, cc in caches.items():
        fc = cc.columns()
        end = max(1, fc.n_changes // 2)
        spec.append((fc, 0, end))
        sliced.extend(
            c for c in history if c.actor == actor and c.seq <= end
        )
    b_ref = pack_docs([sliced])
    b_new = pack_docs_columns([spec], device="cpu")
    assert _patch_doc(b_ref, 0) == _patch_doc(b_new, 0)
    rb_new = _ref_pack_columns(
        history, window=lambda _a, fc: max(1, fc.n_changes // 2))
    assert_batch_equal(b_new, rb_new)
    assert _ref_patch_doc(rb_new, 0) == _patch_doc(b_new, 0)


def test_pack_columns_drops_unresolvable_refs():
    """Ops whose container/element lies outside the packed window drop,
    cascading — same as _pack_one's row_of misses."""
    site, history = _history(5)
    caches = _caches_from_history(history)
    # skip the FIRST actor's feed entirely: ops referencing its objects
    # must drop on both paths
    actors = sorted(caches)
    keep = actors[1:]
    spec = [(caches[a].columns(), 0, INF) for a in keep]
    kept_hist = [c for c in history if c.actor in keep]
    b_ref = pack_docs([kept_hist])
    b_new = pack_docs_columns([spec], device="cpu")
    assert b_new.n_ops.tolist() == b_ref.n_ops.tolist()
    assert _patch_doc(b_ref, 0) == _patch_doc(b_new, 0)
    rb_new = _ref_pack_columns(history, keep=set(keep))
    assert_batch_equal(b_new, rb_new)
    assert_batch_equal(b_ref, ref_columnar.pack_docs([to_reference(kept_hist)]))
    assert _ref_patch_doc(rb_new, 0) == _patch_doc(b_new, 0)


def test_colcache_file_persistence_and_torn_tail(tmp_path):
    _site, history = _history(3, n_actors=1, n_mut=15)
    path = str(tmp_path / "feed.cols")
    cc = FeedColumnCache(FileColumnStorage(path), writer=history[0].actor)
    for c in history:
        cc.append_change(c)
    want = cc.columns()
    cc.close()

    # reopen: identical
    cc2 = FeedColumnCache(FileColumnStorage(path), writer=history[0].actor)
    got = cc2.columns()
    assert np.array_equal(got.rows, want.rows)
    assert np.array_equal(got.preds, want.preds)
    assert got.actors == want.actors
    assert got.n_changes == want.n_changes
    cc2.close()
    # the reference reads the port's directory to the same columns
    writer = history[0].actor
    _same_columns(_ref_read(ref_colcache.FileColumnStorage, path, writer,
                            tmp_path), want)

    # torn tail: appending garbage to rows.bin without a commit record
    # must be invisible after reopen
    with open(path + "/rows.bin", "ab") as fh:
        fh.write(b"\x01\x02\x03")
    cc3 = FeedColumnCache(FileColumnStorage(path), writer=history[0].actor)
    got3 = cc3.columns()
    assert np.array_equal(got3.rows, want.rows)
    assert got3.n_changes == want.n_changes
    # and the cache still appends cleanly after healing
    cc3.close()
    _same_columns(_ref_read(ref_colcache.FileColumnStorage, path, writer,
                            tmp_path / "healed"), got3)


def test_colcache_v2_persistence_and_torn_tail(tmp_path):
    """Single-file sidecar: reopen-identical, torn tails invisible, and
    appends keep working over a healed tail."""
    from hypermerge_tpu_torch.storage.colcache import FileColumnStorageV2

    _site, history = _history(4, n_actors=1, n_mut=15)
    path = str(tmp_path / "feed.cols2")
    writer = history[0].actor
    cc = FeedColumnCache(FileColumnStorageV2(path), writer=history[0].actor)
    for c in history[:-1]:
        cc.append_change(c)
    want = cc.columns()
    cc.close()

    cc2 = FeedColumnCache(FileColumnStorageV2(path), writer=history[0].actor)
    got = cc2.columns()
    assert np.array_equal(got.rows, want.rows)
    assert np.array_equal(got.preds, want.preds)
    assert got.actors == want.actors
    assert got.n_changes == want.n_changes
    cc2.close()
    # the reference writes the same bytes for the same changes
    ref_path = str(tmp_path / "ref.cols2")
    rcc = ref_colcache.FeedColumnCache(
        ref_colcache.FileColumnStorageV2(ref_path), writer=writer)
    for c in to_reference(history[:-1]):
        rcc.append_change(c)
    rcc.close()
    with open(path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()

    # torn tail: garbage after the last record must be invisible...
    with open(path, "ab") as fh:
        fh.write(b"\x07\x00\x00\x00torn")
    cc3 = FeedColumnCache(FileColumnStorageV2(path), writer=history[0].actor)
    got3 = cc3.columns()
    assert got3.n_changes == want.n_changes
    # ...and the next append overwrites it cleanly
    cc3.append_change(history[-1])
    cc3.close()
    cc4 = FeedColumnCache(FileColumnStorageV2(path), writer=history[0].actor)
    assert cc4.columns().n_changes == want.n_changes + 1
    healed = cc4.columns()
    cc4.close()
    _same_columns(_ref_read(ref_colcache.FileColumnStorageV2, path, writer,
                            tmp_path), healed)


def test_colcache_legacy_dir_still_loads(tmp_path):
    """Repos written by the 4-file layout keep loading (read compat)."""
    from hypermerge_tpu_torch.storage.colcache import (
        FileColumnStorage,
        file_column_storage_fn,
    )

    _site, history = _history(6, n_actors=1, n_mut=10)
    root = str(tmp_path)
    actor = history[0].actor
    legacy_path = f"{root}/{actor[:2]}/{actor}.cols"
    cc = FeedColumnCache(FileColumnStorage(legacy_path), writer=actor)
    for c in history:
        cc.append_change(c)
    want = cc.columns()
    cc.close()

    # the factory must route this feed to the legacy reader
    storage = file_column_storage_fn(root)(actor)
    assert isinstance(storage, FileColumnStorage)
    cc2 = FeedColumnCache(storage, writer=actor)
    got = cc2.columns()
    assert np.array_equal(got.rows, want.rows)
    assert got.n_changes == want.n_changes
    cc2.close()
    # the reference's factory routes the port's legacy dir the same way
    ref_storage = ref_colcache.file_column_storage_fn(root)(actor)
    assert isinstance(ref_storage, ref_colcache.FileColumnStorage)
    rcc = ref_colcache.FeedColumnCache(ref_storage, writer=actor)
    _same_columns(rcc.columns(), got)
    rcc.close()


def test_colcache_corrupt_block_clamps_prefix():
    _site, history = _history(9, n_actors=1, n_mut=12)
    cc = FeedColumnCache(MemoryColumnStorage(), writer=history[0].actor)
    n = len(history)
    cut = n // 2
    for c in history[:cut]:
        cc.append_change(c)
    cc.append_change(None)  # corrupt block placeholder
    for c in history[cut:]:
        cc.append_change(c)
    fc = cc.columns()
    assert fc.n_changes == n + 1
    assert fc.ok_prefix_len == cut
    # windows clamp to the ok prefix: the host OpSet can't apply past a
    # seq-continuity gap either
    lo, hi = fc.window(0, INF)
    assert hi == int(fc.row_ends[cut])
    assert fc.changes_in_window(0, INF) == cut
    # the reference's cache over the same blocks
    ref = to_reference(history)
    rcc = ref_colcache.FeedColumnCache(ref_colcache.MemoryColumnStorage(),
                                       writer=history[0].actor)
    for c in ref[:cut] + [None] + ref[cut:]:
        rcc.append_change(c)
    rfc = rcc.columns()
    assert (rfc.n_changes, rfc.ok_prefix_len) == (fc.n_changes,
                                                  fc.ok_prefix_len)
    assert rfc.window(0, INF) == (lo, hi)
    assert np.array_equal(rfc.ensure_rows(), fc.ensure_rows())


def test_bulk_load_is_lazy_then_reconstructs(pipeline_mode, live_mode):
    """After load_documents_bulk, docs serve clock/snapshot without a
    host OpSet; the first incremental change extends state exactly
    (HM_LIVE=0: by reconstructing the OpSet; HM_LIVE=1: through the
    live apply engine, no reconstruction)."""
    with tempfile.TemporaryDirectory() as tmp:
        repo = Repo(path=tmp)
        urls = []
        for i in range(4):
            url = repo.create({"i": i, "t": Text(f"doc{i}")})
            repo.change(url, lambda d: d["t"].insert(0, ">"))
            urls.append(url)
        want = {u: plainify(repo.doc(u)) for u in urls}
        clocks = {
            u: repo.back.docs[validate_doc_url(u)].clock for u in urls
        }
        hlens = {
            u: repo.back.docs[validate_doc_url(u)].history_len
            for u in urls
        }
        repo.close()

        repo2 = Repo(path=tmp)
        ids = [validate_doc_url(u) for u in urls]
        repo2.back.load_documents_bulk(ids)
        for u in urls:
            doc = repo2.back.docs[validate_doc_url(u)]
            assert doc.opset is None, "bulk load must not replay host-side"
            assert doc.clock == clocks[u]
            assert doc.history_len == hlens[u]
        # reads decode from the device batch
        for u in urls:
            assert plainify(repo2.doc(u)) == want[u]
            assert repo2.back.docs[validate_doc_url(u)].opset is None
        # first local change extends state. HM_LIVE=0 (this test pins
        # the host twin): the OpSet reconstructs exactly; HM_LIVE=1 is
        # pinned by tests/test_live.py (NO reconstruction happens).
        repo2.change(urls[0], lambda d: d.__setitem__("new", True))
        doc0 = repo2.back.docs[ids[0]]
        if live_mode == "0":
            assert doc0.opset is not None
        else:
            assert doc0.opset is None, "live path must not replay"
        got = plainify(repo2.doc(urls[0]))
        assert got["new"] is True
        assert got["t"] == want[urls[0]]["t"]
        final = [plainify(repo2.doc(u)) for u in urls]
        repo2.close()
        assert_reference_reads(tmp, urls, final)


def test_bulk_loaded_doc_applies_replicated_changes(pipeline_mode, live_mode):
    """A replicated block arriving after a bulk (lazy) load must reach
    the doc — host twin: by reconstructing the OpSet on demand; live
    path: through the tick engine, still no OpSet."""
    from hypermerge_tpu_torch.crdt.change import Action, Change, Op, ROOT
    from hypermerge_tpu_torch.storage import block as blockmod

    with tempfile.TemporaryDirectory() as tmp:
        repo = Repo(path=tmp)
        url = repo.create({"x": 1})
        repo.close()

        repo2 = Repo(path=tmp)
        doc_id = validate_doc_url(url)
        repo2.back.load_documents_bulk([doc_id])
        doc = repo2.back.docs[doc_id]
        assert doc.opset is None
        # craft the actor's next change and deliver it like replication
        actor = repo2.back.actors[doc_id]
        head = actor.seq_head
        prev = actor.changes_in_window(0, head)
        max_op = max(c.max_op for c in prev)
        change = Change(
            actor=doc_id,
            seq=head + 1,
            start_op=max_op + 1,
            deps={},
            ops=(Op(action=Action.SET, obj=ROOT, key="x", value=99),),
        )
        # replication appends beyond the cursor; expand it like a
        # CursorMessage would
        repo2.back.cursors.update(
            repo2.back.id, doc_id, {doc_id: head + 1}
        )
        actor.feed._append_raw(blockmod.pack(change.to_json()))
        # replicated-append syncs are debounced: wait for application
        wait_until(lambda: doc.clock.get(doc_id) == head + 1)
        if live_mode == "0":
            assert doc.opset is not None
        else:
            wait_until(lambda: repo2.doc(url)["x"] == 99)
            assert doc.opset is None, "live path must not replay"
        assert repo2.doc(url)["x"] == 99
        final = [plainify(repo2.doc(url))]
        repo2.close()
        assert_reference_reads(tmp, [url], final)


def test_bulk_load_slabs_split_dispatches(pipeline_mode):
    with tempfile.TemporaryDirectory() as tmp:
        repo = Repo(path=tmp)
        urls = [repo.create({"i": i}) for i in range(5)]
        repo.close()
        repo2 = Repo(path=tmp)
        ids = [validate_doc_url(u) for u in urls]
        repo2.back.load_documents_bulk(ids, slab=2)  # 3 dispatches
        for i, u in enumerate(urls):
            assert repo2.doc(u)["i"] == i
        repo2.close()
        assert_reference_reads(tmp, urls, [{"i": i} for i in range(5)])


def test_mixed_contiguity_bulk_load_stays_fast(tmp_path, pipeline_mode):
    """One gap-y doc in a 1000-doc bulk load must NOT drag the other 999
    onto the per-op host replay path — and the fallback count is
    surfaced."""
    from hypermerge_tpu_torch.crdt.change import Action, Change, Op, ROOT
    from hypermerge_tpu_torch.ops.corpus import make_corpus
    from hypermerge_tpu_torch.storage import block as blockmod

    urls = make_corpus(str(tmp_path), 999, 32, ops_per_change=8, threads=4)
    repo = Repo(path=str(tmp_path))
    gap_url = repo.create({"i": -1})
    # poison the created doc's feed with a seq GAP (skips head+1)
    gap_id = validate_doc_url(gap_url)
    actor = repo.back.actors[gap_id]
    head = actor.seq_head
    max_op = max(
        c.max_op for c in actor.changes_in_window(0, float("inf"))
    )
    change = Change(
        actor=gap_id,
        seq=head + 2,  # gap: head+1 never written
        start_op=max_op + 1,
        deps={},
        ops=(Op(action=Action.SET, obj=ROOT, key="late", value=1),),
    )
    actor.feed._append_raw(blockmod.pack(change.to_json()))
    repo.close()

    repo2 = Repo(path=str(tmp_path))
    ids = [validate_doc_url(u) for u in urls] + [gap_id]
    repo2.back.load_documents_bulk(ids)
    stats = repo2.back.last_bulk_stats
    assert stats["fallback"] == 1 and stats["fast"] == 999, stats
    # every contiguous doc stayed on the lazy fast path
    lazy = sum(
        1
        for u in urls
        if repo2.back.docs[validate_doc_url(u)].opset is None
    )
    assert lazy == 999, f"only {lazy}/999 docs stayed lazy"
    for u in urls[:: 100]:
        assert "t" in plainify(repo2.doc(u))
    # the gap doc host-replayed its applicable prefix
    gap_doc = plainify(repo2.doc(gap_url))
    assert gap_doc["i"] == -1 and "late" not in gap_doc
    sample = urls[::100] + [gap_url]
    final = [plainify(repo2.doc(u)) for u in sample]
    repo2.close()
    assert_reference_reads(tmp_path, sample, final)


def test_actor_columns_rebuild_from_blocks(tmp_path, pipeline_mode):
    """A feed written without a sidecar (or with a deleted one) rebuilds
    its columns from blocks on first access."""
    import shutil

    with tempfile.TemporaryDirectory() as tmp:
        repo = Repo(path=tmp)
        url = repo.create({"x": 1})
        repo.change(url, lambda d: d.__setitem__("y", 2))
        want = plainify(repo.doc(url))
        repo.close()

        # blow away every sidecar (slab, legacy dirs, and v2 files)
        import os

        for root, dirs, files in os.walk(os.path.join(tmp, "feeds")):
            for d in list(dirs):
                if d.endswith(".cols"):
                    shutil.rmtree(os.path.join(root, d))
            for f in files:
                if f.endswith(".cols2") or f.startswith("cols.slab"):
                    os.remove(os.path.join(root, f))
        repo2 = Repo(path=tmp)
        doc_id = validate_doc_url(url)
        repo2.back.load_documents_bulk([doc_id])
        assert plainify(repo2.doc(url)) == want
        repo2.close()
        assert_reference_reads(tmp, [url], [want])


def test_counter_docs_survive_bulk_and_fast_reopen(tmp_path, monkeypatch, pipeline_mode):
    """INC ops (counters) force the non-lean kernel path; both the bulk
    and single-doc fast opens must materialize accumulated totals."""
    from hypermerge_tpu_torch.models import Counter

    # small batch would normally take the host kernel: force the DEVICE
    # dispatch so the lean/non-lean gate is what's under test
    monkeypatch.setenv("HM_DEVICE_MIN_CELLS", "1")

    repo = Repo(path=str(tmp_path))
    urls = []
    for i in range(3):
        u = repo.create({"hits": Counter(0), "i": i})
        for k in range(4):
            repo.change(u, lambda d: d.increment("hits", 2))
        urls.append(u)
    want = {u: plainify(repo.doc(u)) for u in urls}
    assert want[urls[0]]["hits"] == ("__counter__", 8)
    repo.close()

    # bulk cold open
    repo2 = Repo(path=str(tmp_path))
    ids = [validate_doc_url(u) for u in urls]
    repo2.back.load_documents_bulk(ids)
    for u in urls:
        assert plainify(repo2.doc(u)) == want[u]
        assert repo2.back.docs[validate_doc_url(u)].opset is None
    repo2.close()

    # single-doc fast open
    repo3 = Repo(path=str(tmp_path))
    assert plainify(repo3.doc(urls[1])) == want[urls[1]]
    # and increments continue from the materialized total
    repo3.change(urls[1], lambda d: d.increment("hits", 1))
    assert plainify(repo3.doc(urls[1]))["hits"] == ("__counter__", 9)
    final = [plainify(repo3.doc(u)) for u in urls]
    repo3.close()
    assert_reference_reads(tmp_path, urls, final)


def test_fast_open_uses_sidecar_not_replay():
    """An ordinary cold `open` of a cached doc decodes via the numpy
    kernel twin — no host OpSet replay."""
    with tempfile.TemporaryDirectory() as tmp:
        repo = Repo(path=tmp)
        url = repo.create({"x": 1, "t": Text("hello")})
        repo.change(url, lambda d: d["t"].insert(5, "!"))
        want = plainify(repo.doc(url))
        repo.close()

        repo2 = Repo(path=tmp)
        h = repo2.open(url)
        doc = repo2.back.docs[validate_doc_url(url)]
        assert doc.opset is None, "fast open must not build an OpSet"
        assert plainify(h.value()) == want
        assert doc.opset is None
        # incremental change still works (lazy OpSet reconstruction)
        repo2.change(url, lambda d: d.__setitem__("y", 2))
        got = plainify(repo2.doc(url))
        assert got["y"] == 2 and got["t"] == want["t"]
        repo2.close()
        assert_reference_reads(tmp, [url], [got])


def test_interactive_churn_during_bulk_load(tmp_path, pipeline_mode):
    """Interactive creates/changes racing a bulk cold open must not
    deadlock (bulk mutex) or lose work (deferred actor syncs)."""
    import threading

    from hypermerge_tpu_torch.ops.corpus import make_corpus

    urls = make_corpus(str(tmp_path), 24, 64, threads=4)
    repo = Repo(path=str(tmp_path))
    made = []
    errors = []

    def churn():
        try:
            for i in range(15):
                u = repo.create({"i": i})
                repo.change(u, lambda d, i=i: d.__setitem__("sq", i * i))
                made.append((u, i))
        except Exception as e:  # pragma: no cover - failure capture
            errors.append(e)

    t = threading.Thread(target=churn)
    t.start()
    handles = repo.open_many(urls)
    t.join(timeout=60)
    assert not t.is_alive(), "churn thread deadlocked against bulk load"
    assert not errors, errors
    summ = repo.back.fetch_bulk_summaries()
    assert len(summ.doc_ids) == 24
    for u, i in made:
        got = plainify(repo.doc(u))
        assert got["i"] == i and got["sq"] == i * i
    for h in handles[::6]:
        v = plainify(h.value())
        assert v and "t" in v  # corpus docs carry their text field
    made_urls = [u for u, _ in made]
    final = [plainify(repo.doc(u)) for u in made_urls]
    bulk = {d: summ.doc(d) for d in summ.doc_ids}
    repo.close()
    # the reference on a copy: the churned docs' values, the corpus's
    # summaries
    assert_reference_reads(tmp_path, made_urls, final)
    assert_reference_summaries(tmp_path, urls, bulk)


def test_open_many_lazy_handles(pipeline_mode):
    """open_many: one bulk backend load, snapshots decoded only when a
    handle is actually read; change() on a lazy handle materializes
    first."""
    with tempfile.TemporaryDirectory() as tmp:
        repo = Repo(path=tmp)
        urls = [repo.create({"i": i}) for i in range(6)]
        want = {u: plainify(repo.doc(u)) for u in urls}
        repo.close()

        repo2 = Repo(path=tmp)
        handles = repo2.open_many(urls)
        # backend is ready, but no snapshot decoded yet for unread docs
        for u in urls:
            doc = repo2.back.docs[validate_doc_url(u)]
            assert doc._announced
            assert doc.opset is None
            assert doc._snapshot_cache is None, "decode must be lazy"
        # reading a handle decodes just that doc
        assert plainify(handles[2].value()) == want[urls[2]]
        assert (
            repo2.back.docs[validate_doc_url(urls[2])]._snapshot_cache
            is not None
        )
        assert (
            repo2.back.docs[validate_doc_url(urls[3])]._snapshot_cache
            is None
        )
        # change on an unread lazy handle sees the materialized doc
        handles[4].change(lambda d: d.__setitem__("j", 40))
        got = plainify(handles[4].value())
        assert got["i"] == 4 and got["j"] == 40
        # open_many over already-open docs still yields live handles
        handles2 = repo2.open_many(urls[:2])
        assert plainify(handles2[0].value()) == want[urls[0]]
        final = [plainify(repo2.doc(u)) for u in urls]
        repo2.close()
        assert_reference_reads(tmp, urls, final)


class TestV3Checkpoint:
    """v3 plane checkpoints (storage/colcache.py): one frombuffer load,
    v2 tail replay, auto-compaction, torn-write safety."""

    def _cc(self, tmp_path, name="feedX"):
        from hypermerge_tpu_torch.storage.colcache import FileColumnStorageV2

        return FeedColumnCache(
            FileColumnStorageV2(str(tmp_path / name)), writer="actor00"
        )

    def _ref_cc(self, tmp_path, name="feedX"):
        """The reference's cache over a copy of the port's file."""
        import shutil

        shutil.copyfile(tmp_path / name, tmp_path / f"ref-{name}")
        return ref_colcache.FeedColumnCache(
            ref_colcache.FileColumnStorageV2(str(tmp_path / f"ref-{name}")),
            writer="actor00",
        )

    def test_checkpoint_roundtrip_planes(self, tmp_path):
        _site, history = _history(3, n_actors=1, n_mut=20)
        cc = self._cc(tmp_path)
        for c in sorted(history, key=lambda c: (c.actor, c.seq)):
            cc.append_change(c)
        want = cc.columns()
        cc.compact()

        cc2 = self._cc(tmp_path)
        got = cc2.columns()
        assert got.planes is not None  # plane-backed load
        assert np.array_equal(got.ensure_rows(), want.ensure_rows())
        assert np.array_equal(got.preds, want.preds)
        assert got.actors == want.actors and got.keys == want.keys
        assert got.n_changes == want.n_changes
        assert np.array_equal(got.row_ends, want.row_ends)
        # the reference loads the port's checkpoint to the same planes,
        # and its compact of the same changes writes the same bytes
        rgot = self._ref_cc(tmp_path).columns()
        assert rgot.planes is not None
        _same_columns(rgot, got)
        rcc = ref_colcache.FeedColumnCache(ref_colcache.FileColumnStorageV2(
            str(tmp_path / "ref-own")), writer="actor00")
        for c in sorted(to_reference(history), key=lambda c: (c.actor, c.seq)):
            rcc.append_change(c)
        rcc.compact()
        assert (tmp_path / "ref-own").read_bytes() == \
            (tmp_path / "feedX").read_bytes()

    def test_tail_after_checkpoint_merges(self, tmp_path):
        _site, history = _history(4, n_actors=1, n_mut=30)
        history = sorted(history, key=lambda c: (c.actor, c.seq))
        half = len(history) // 2
        cc = self._cc(tmp_path)
        for c in history[:half]:
            cc.append_change(c)
        cc.compact()
        for c in history[half:]:
            cc.append_change(c)  # v2 records after the checkpoint

        ref = FeedColumnCache(MemoryColumnStorage(), writer="actor00")
        for c in history:
            ref.append_change(c)

        cc2 = self._cc(tmp_path)
        got, want = cc2.columns(), ref.columns()
        assert np.array_equal(got.ensure_rows(), want.ensure_rows())
        assert np.array_equal(got.preds, want.preds)
        assert got.n_changes == want.n_changes
        _same_columns(self._ref_cc(tmp_path).columns(), got)

    def test_auto_compaction_folds_long_tails(self, tmp_path, monkeypatch):
        from hypermerge_tpu_torch.storage.colcache import parse_v3_checkpoint

        monkeypatch.setenv("HM_CKPT_TAIL", "8")
        _site, history = _history(5, n_actors=1, n_mut=30)
        history = sorted(history, key=lambda c: (c.actor, c.seq))
        cc = self._cc(tmp_path)
        for c in history:
            cc.append_change(c)
        want_rows = cc.columns().ensure_rows().copy()
        assert len(history) >= 8

        cc2 = self._cc(tmp_path)  # load triggers auto-compact
        assert np.array_equal(cc2.columns().ensure_rows(), want_rows)
        raw = (tmp_path / "feedX").read_bytes()
        ck = parse_v3_checkpoint(raw)
        assert ck is not None and ck[5] == len(raw)  # no v2 tail left
        # the reference parses the folded file alike and reads its rows
        rck = ref_colcache.parse_v3_checkpoint(raw)
        assert rck is not None and rck[5] == ck[5]
        assert np.array_equal(
            self._ref_cc(tmp_path).columns().ensure_rows(), want_rows)

    def test_torn_checkpoint_falls_back(self, tmp_path):
        """A truncated checkpoint (crash mid-rewrite never leaves one —
        rename is atomic — but disk corruption might) must load as
        empty, not crash; blocks are the source of truth."""
        _site, history = _history(6, n_actors=1, n_mut=15)
        cc = self._cc(tmp_path)
        for c in sorted(history, key=lambda c: (c.actor, c.seq)):
            cc.append_change(c)
        cc.compact()
        raw = (tmp_path / "feedX").read_bytes()
        (tmp_path / "feedX").write_bytes(raw[: len(raw) // 2])

        cc2 = self._cc(tmp_path)
        got = cc2.columns()
        assert got.n_changes == 0 and got.n_rows == 0
        rgot = self._ref_cc(tmp_path).columns()
        assert rgot.n_changes == 0 and rgot.n_rows == 0

    def test_append_after_plane_load(self, tmp_path):
        """Live appends on a checkpoint-loaded cache fold planes into
        rows and keep going (the interactive-writer path)."""
        _site, history = _history(7, n_actors=1, n_mut=25)
        history = sorted(history, key=lambda c: (c.actor, c.seq))
        cc = self._cc(tmp_path)
        for c in history[:-3]:
            cc.append_change(c)
        cc.compact()
        cc2 = self._cc(tmp_path)
        assert cc2.columns().planes is not None
        for c in history[-3:]:
            cc2.append_change(c)
        ref = FeedColumnCache(MemoryColumnStorage(), writer="actor00")
        for c in history:
            ref.append_change(c)
        assert np.array_equal(
            cc2.columns().ensure_rows(), ref.columns().ensure_rows()
        )
        cc2.close()
        _same_columns(self._ref_cc(tmp_path).columns(), ref.columns())
