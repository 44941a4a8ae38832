"""Every case of tests/test_slab.py under its own name on the port's
corpus slab (hypermerge_tpu_torch/storage/slab.py, `compact` included)
and its column storage, histories from the port's Site
(tests/port_helpers.py), repos on `Repo(path, device="cpu")`. Each case
also holds what it checks against the reference package on the same
inputs: the reference's column storage reads every feed of a copy of
the port's directory to the same rows (`_ref_rows`), the reference
writing the same changes gives the same slab and index bytes
(`_ref_fill`), its slab parses the port's repaired index alike, and its
Repo reads a copy of the port's repo to the same docs; tolerance 0.

The twinned file's own docstring follows.

Corpus slab (storage/slab.py): one file of framed sidecar segments.

Pins the properties the cold-open IO path leans on: byte-identical
loads vs the per-feed layout, O(1) file opens, lazy migration of legacy
`.cols2` sidecars, torn-tail healing on both the slab and its index,
tombstones on destroy, and compaction reclaiming superseded bytes."""

import os
import random

import numpy as np
import pytest

from hypermerge_tpu.storage import colcache as ref_colcache
from hypermerge_tpu.storage import slab as ref_slab
from hypermerge_tpu_torch.storage.colcache import (
    FeedColumnCache,
    SlabColumnStorage,
    file_column_storage_fn,
)
from hypermerge_tpu_torch.storage.slab import (
    KIND_IMAGE,
    CorpusSlab,
)
from hypermerge_tpu_torch.utils.ids import validate_doc_url
from port_helpers import (
    Repo,
    Site,
    assert_reference_reads,
    env_vars,
    plainify,
    random_mutation,
    to_reference,
)

INF = float("inf")


def _history(seed, n_mut=15):
    r = random.Random(seed)
    site = Site("actor00")
    for _ in range(n_mut):
        random_mutation(site, r)
    return list(site.opset.history)


def _ref_rows(root, names):
    """{name: rows} the reference's column storage reads from a copy of
    the column directory `root`."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory(prefix="hm-ref-") as tmp:
        copy = os.path.join(tmp, "cols")
        shutil.copytree(str(root), copy)
        fn = ref_colcache.file_column_storage_fn(copy)
        out = {}
        for name in names:
            cc = ref_colcache.FeedColumnCache(fn(name), writer="actor00")
            out[name] = cc.columns().ensure_rows().copy()
            cc.close()
        if fn.slab is not None:
            fn.slab.close()
        return out


def _assert_ref_rows(root, want):
    got = _ref_rows(root, list(want))
    for name, rows in want.items():
        assert np.array_equal(got[name], rows), name


def _ref_fill(root, names=("feedA", "feedB"), seed=1):
    """_fill in the reference, on the same changes."""
    fn = ref_colcache.file_column_storage_fn(str(root))
    for i, name in enumerate(names):
        cc = ref_colcache.FeedColumnCache(fn(name), writer="actor00")
        for c in to_reference(_history(seed + i)):
            cc.append_change(c)
        cc.close()
    if fn.slab is not None:
        fn.slab.close()


def _fill(tmp_path, names=("feedA", "feedB"), seed=1):
    fn = file_column_storage_fn(str(tmp_path))
    want = {}
    for i, name in enumerate(names):
        cc = FeedColumnCache(fn(name), writer="actor00")
        for c in _history(seed + i):
            cc.append_change(c)
        want[name] = cc.columns().ensure_rows().copy()
        cc.close()
    if fn.slab is not None:
        fn.slab.close()
    return want


def test_slab_prefetch_is_advisory_and_safe(tmp_path):
    """prefetch() (the pipeline io stage's read-ahead hint) must be a
    pure no-op semantically: unknown names, empty slabs, and platforms
    without madvise all pass through; reads after a hint are
    byte-identical."""
    want = _fill(tmp_path)
    fn = file_column_storage_fn(str(tmp_path))
    slab = fn.slab
    assert slab is not None
    slab.prefetch(list(want) + ["no-such-feed"])
    for name, rows in want.items():
        cc = FeedColumnCache(fn(name), writer="actor00")
        assert np.array_equal(cc.columns().ensure_rows(), rows)
        cc.close()
    slab.close()
    # empty slab: nothing mapped, still fine
    empty = CorpusSlab(str(tmp_path / "none" / "cols.slab"))
    empty.prefetch(["whatever"])
    empty.close()
    _assert_ref_rows(tmp_path, want)


def test_slab_roundtrip_and_single_file(tmp_path):
    want = _fill(tmp_path)
    assert os.path.exists(tmp_path / "cols.slab")
    assert not list(tmp_path.glob("*/*.cols2"))
    fn = file_column_storage_fn(str(tmp_path))
    for name, rows in want.items():
        cc = FeedColumnCache(fn(name), writer="actor00")
        assert np.array_equal(cc.columns().ensure_rows(), rows)
        cc.close()
    fn.slab.close()
    _assert_ref_rows(tmp_path, want)
    # the reference writing the same changes: the same slab and index
    _ref_fill(tmp_path / "ref")
    for f in ("cols.slab", "cols.slab.idx"):
        assert (tmp_path / f).read_bytes() == (tmp_path / "ref" / f).read_bytes()


def test_slab_checkpoint_load_is_plane_backed(tmp_path):
    """Compacted feeds load as planes with plane_meta (what both the
    numpy and native bulk packs consume)."""
    fn = file_column_storage_fn(str(tmp_path))
    cc = FeedColumnCache(fn("feedX"), writer="actor00")
    for c in _history(7):
        cc.append_change(c)
    cc.compact()
    cc.close()
    fn.slab.close()

    fn2 = file_column_storage_fn(str(tmp_path))
    cc2 = FeedColumnCache(fn2("feedX"), writer="actor00")
    fc = cc2.columns()
    assert fc.planes is not None
    assert fc.plane_meta is not None
    rows = fc.ensure_rows().copy()
    cc2.close()
    fn2.slab.close()
    # the reference loads the port's checkpoint as planes too
    import shutil

    shutil.copytree(tmp_path, tmp_path.parent / f"{tmp_path.name}-ref")
    rfn = ref_colcache.file_column_storage_fn(
        str(tmp_path.parent / f"{tmp_path.name}-ref"))
    rcc = ref_colcache.FeedColumnCache(rfn("feedX"), writer="actor00")
    rfc = rcc.columns()
    assert rfc.planes is not None and rfc.plane_meta is not None
    assert np.array_equal(rfc.ensure_rows(), rows)
    rcc.close()
    rfn.slab.close()


def test_legacy_cols2_migrates_on_first_read(tmp_path, monkeypatch):
    """A per-feed `.cols2` sidecar written by an older version folds
    into the slab on first read and the legacy file is removed."""
    monkeypatch.setenv("HM_SLAB", "0")
    want = _fill(tmp_path, names=("feedL",), seed=3)["feedL"]
    legacy = tmp_path / "fe" / "feedL.cols2"
    assert legacy.exists()
    # the reference writes the same legacy sidecar for the same changes
    _ref_fill(tmp_path / "ref", names=("feedL",), seed=3)
    assert (tmp_path / "ref" / "fe" / "feedL.cols2").read_bytes() == \
        legacy.read_bytes()

    monkeypatch.setenv("HM_SLAB", "1")
    fn = file_column_storage_fn(str(tmp_path))
    storage = fn("feedL")
    assert isinstance(storage, SlabColumnStorage)
    cc = FeedColumnCache(storage, writer="actor00")
    assert np.array_equal(cc.columns().ensure_rows(), want)
    cc.close()
    assert not legacy.exists(), "legacy sidecar not migrated"
    assert fn.slab.feed_live("feedL")
    fn.slab.close()

    # second open: slab-only
    fn2 = file_column_storage_fn(str(tmp_path))
    cc2 = FeedColumnCache(fn2("feedL"), writer="actor00")
    assert np.array_equal(cc2.columns().ensure_rows(), want)
    cc2.close()
    fn2.slab.close()
    _assert_ref_rows(tmp_path, {"feedL": want})
    # the reference migrates its legacy sidecar into the same slab bytes
    rfn = ref_colcache.file_column_storage_fn(str(tmp_path / "ref"))
    rcc = ref_colcache.FeedColumnCache(rfn("feedL"), writer="actor00")
    assert np.array_equal(rcc.columns().ensure_rows(), want)
    rcc.close()
    rfn.slab.close()
    for f in ("cols.slab", "cols.slab.idx"):
        assert (tmp_path / f).read_bytes() == (tmp_path / "ref" / f).read_bytes()


def test_torn_slab_tail_healed(tmp_path):
    want = _fill(tmp_path)
    p = tmp_path / "cols.slab"
    with open(p, "ab") as fh:
        fh.write(b"\x01\x00\x04torn-segment-header-without-payload")
    # index is now BEHIND the garbage; loads must ignore the torn tail
    fn = file_column_storage_fn(str(tmp_path))
    for name, rows in want.items():
        cc = FeedColumnCache(fn(name), writer="actor00")
        assert np.array_equal(cc.columns().ensure_rows(), rows)
        cc.close()
    # and the next append lands cleanly over it
    cc = FeedColumnCache(fn("feedC"), writer="actor00")
    for c in _history(9, n_mut=4):
        cc.append_change(c)
    got = cc.columns().ensure_rows().copy()
    cc.close()
    fn.slab.close()
    fn2 = file_column_storage_fn(str(tmp_path))
    cc2 = FeedColumnCache(fn2("feedC"), writer="actor00")
    assert np.array_equal(cc2.columns().ensure_rows(), got)
    cc2.close()
    fn2.slab.close()
    _assert_ref_rows(tmp_path, dict(want, feedC=got))


def test_missing_or_torn_index_rebuilds(tmp_path):
    want = _fill(tmp_path)
    # interleave: a record for feedA lands AFTER feedB's image
    fni = file_column_storage_fn(str(tmp_path))
    cci = FeedColumnCache(fni("feedA"), writer="actor00")
    for c in _history(8, n_mut=3):
        cci.append_change(c)
    want["feedA"] = cci.columns().ensure_rows().copy()
    cci.close()
    fni.slab.close()

    os.remove(tmp_path / "cols.slab.idx")
    fn = file_column_storage_fn(str(tmp_path))
    for name, rows in want.items():
        cc = FeedColumnCache(fn(name), writer="actor00")
        assert np.array_equal(cc.columns().ensure_rows(), rows)
        cc.close()
    fn.slab.close()
    assert os.path.exists(tmp_path / "cols.slab.idx")  # rebuilt
    # ...and the rebuild is offset-ordered: the next open must accept it
    # (a feed-grouped dump would fail the monotonic check and force a
    # full slab scan on EVERY open)
    probe = CorpusSlab(str(tmp_path / "cols.slab"))
    entries, usable, torn_at = probe._read_index(
        os.path.getsize(tmp_path / "cols.slab")
    )
    assert usable and entries, "rebuilt index rejected on reopen"
    assert torn_at is None
    probe.close()

    # the reference parses the port's rebuilt index alike
    rprobe = ref_slab.CorpusSlab(str(tmp_path / "cols.slab"))
    assert rprobe._read_index(os.path.getsize(tmp_path / "cols.slab")) == (
        entries, usable, torn_at)
    rprobe.close()

    # torn index tail: truncate mid-entry
    raw = (tmp_path / "cols.slab.idx").read_bytes()
    (tmp_path / "cols.slab.idx").write_bytes(raw[: len(raw) - 7])
    _assert_ref_rows(tmp_path, want)
    fn2 = file_column_storage_fn(str(tmp_path))
    for name, rows in want.items():
        cc = FeedColumnCache(fn2(name), writer="actor00")
        assert np.array_equal(cc.columns().ensure_rows(), rows)
        cc.close()
    fn2.slab.close()


def test_index_repairs_forward_after_lost_entry(tmp_path):
    """A crash between the slab append and the index append leaves the
    index one entry short: open() must recover the segment by scanning
    forward from the last indexed extent."""
    want = _fill(tmp_path, names=("feedA",), seed=5)["feedA"]
    slab = CorpusSlab(str(tmp_path / "cols.slab"))
    idx_before = (tmp_path / "cols.slab.idx").read_bytes()
    slab.append(KIND_IMAGE, "feedZ", b"HMc3" + b"\x00" * 16)  # bogus-ish
    slab.close()
    (tmp_path / "cols.slab.idx").write_bytes(idx_before)

    slab2 = CorpusSlab(str(tmp_path / "cols.slab"))
    assert slab2.feed_live("feedZ"), "unindexed segment not recovered"
    assert slab2.feed_live("feedA")
    slab2.close()
    # feedA still loads
    fn = file_column_storage_fn(str(tmp_path))
    cc = FeedColumnCache(fn("feedA"), writer="actor00")
    assert np.array_equal(cc.columns().ensure_rows(), want)
    cc.close()
    fn.slab.close()
    _assert_ref_rows(tmp_path, {"feedA": want})


def test_index_repair_truncates_torn_fragment_first(tmp_path):
    """Crash model: the slab append landed, the index append tore
    mid-entry. Repair-forward must TRUNCATE the torn fragment before
    appending the recovered entries — otherwise every later open parses
    the fragment as a bogus entry, fails the monotonic check, and
    rescans the whole slab forever."""
    want = _fill(tmp_path, names=("feedA",), seed=5)["feedA"]
    slab = CorpusSlab(str(tmp_path / "cols.slab"))
    idx_before = (tmp_path / "cols.slab.idx").read_bytes()
    slab.append(KIND_IMAGE, "feedZ", b"HMc3" + b"\x00" * 16)
    slab.close()
    # torn idx: the old entries plus HALF of feedZ's entry bytes
    idx_after = (tmp_path / "cols.slab.idx").read_bytes()
    frag = idx_after[len(idx_before) : len(idx_before) + 9]
    (tmp_path / "cols.slab.idx").write_bytes(idx_before + frag)
    # the reference repairs a copy of the same torn index alike
    import shutil

    ref_dir = tmp_path.parent / f"{tmp_path.name}-ref"
    shutil.copytree(tmp_path, ref_dir)
    rslab = ref_slab.CorpusSlab(str(ref_dir / "cols.slab"))
    assert rslab.feed_live("feedZ") and rslab.feed_live("feedA")
    rslab.close()

    slab2 = CorpusSlab(str(tmp_path / "cols.slab"))
    assert slab2.feed_live("feedZ"), "unindexed segment not recovered"
    assert slab2.feed_live("feedA")
    slab2.close()

    # the healed index must parse CLEANLY on the next open — all
    # entries usable, no torn fragment, no full-slab rescan
    slab3 = CorpusSlab(str(tmp_path / "cols.slab"))
    entries, usable, torn_at = slab3._read_index(
        os.path.getsize(tmp_path / "cols.slab")
    )
    assert usable and torn_at is None
    assert {name for _k, name, _o, _l in entries} == {"feedA", "feedZ"}
    assert slab3.feed_live("feedZ") and slab3.feed_live("feedA")
    slab3.close()
    # both healed indexes hold the same bytes, and parse alike
    assert (tmp_path / "cols.slab.idx").read_bytes() == \
        (ref_dir / "cols.slab.idx").read_bytes()
    rslab3 = ref_slab.CorpusSlab(str(ref_dir / "cols.slab"))
    assert rslab3._read_index(os.path.getsize(ref_dir / "cols.slab")) == (
        entries, usable, torn_at)
    rslab3.close()


def test_tombstone_and_compaction_reclaim(tmp_path, monkeypatch):
    monkeypatch.setenv("HM_SLAB_SLACK", "0.01")
    fn = file_column_storage_fn(str(tmp_path))
    history = _history(11, n_mut=40)
    cc = FeedColumnCache(fn("feedA"), writer="actor00")
    for c in history:
        cc.append_change(c)
    for _ in range(4):  # superseded images pile up
        cc.compact()
    want = cc.columns().ensure_rows().copy()
    cc.close()
    cc2 = FeedColumnCache(fn("feedB"), writer="actor00")
    for c in _history(12, n_mut=20):
        cc2.append_change(c)
    cc2.destroy()  # tombstoned
    size_before = os.path.getsize(tmp_path / "cols.slab")
    fn.slab.close()  # compacts: dead images + tombstoned feed drop
    size_after = os.path.getsize(tmp_path / "cols.slab")
    assert size_after < size_before

    fn2 = file_column_storage_fn(str(tmp_path))
    assert not fn2.slab.feed_live("feedB")
    cc3 = FeedColumnCache(fn2("feedA"), writer="actor00")
    assert np.array_equal(cc3.columns().ensure_rows(), want)
    cc3.close()
    fn2.slab.close()
    _assert_ref_rows(tmp_path, {"feedA": want})
    rslab = ref_slab.CorpusSlab(str(tmp_path / "cols.slab"))
    assert not rslab.feed_live("feedB") and rslab.feed_live("feedA")
    rslab.close()

    # the reference's compaction of the same writes: the same slab bytes
    rfn = ref_colcache.file_column_storage_fn(str(tmp_path / "ref"))
    rcc = ref_colcache.FeedColumnCache(rfn("feedA"), writer="actor00")
    for c in to_reference(history):
        rcc.append_change(c)
    for _ in range(4):
        rcc.compact()
    rcc.close()
    rcc2 = ref_colcache.FeedColumnCache(rfn("feedB"), writer="actor00")
    for c in to_reference(_history(12, n_mut=20)):
        rcc2.append_change(c)
    rcc2.destroy()
    rfn.slab.close()
    assert os.path.getsize(tmp_path / "ref" / "cols.slab") == size_after
    assert (tmp_path / "ref" / "cols.slab").read_bytes() == \
        (tmp_path / "cols.slab").read_bytes()


def test_repo_end_to_end_uses_slab(tmp_path):
    """Interactive writes + reopen + bulk load, all through the slab."""
    path = str(tmp_path)
    repo = Repo(path=path)
    urls = [repo.create({"i": i}) for i in range(4)]
    for u in urls:
        repo.change(u, lambda d: d.__setitem__("y", 1))
    want = {u: plainify(repo.doc(u)) for u in urls}
    repo.close()
    assert os.path.exists(os.path.join(path, "feeds", "cols.slab"))
    assert not [
        f
        for _r, _d, fs in os.walk(os.path.join(path, "feeds"))
        for f in fs
        if f.endswith(".cols2")
    ]

    repo2 = Repo(path=path)
    ids = [validate_doc_url(u) for u in urls]
    repo2.back.load_documents_bulk(ids)
    for u in urls:
        assert plainify(repo2.doc(u)) == want[u]
    repo2.close()
    assert_reference_reads(path, urls, [want[u] for u in urls])


def test_slab_disabled_fallback(tmp_path, monkeypatch):
    """HM_SLAB=0 restores the per-feed `.cols2` layout end to end."""
    monkeypatch.setenv("HM_SLAB", "0")
    path = str(tmp_path)
    repo = Repo(path=path)
    url = repo.create({"x": 1})
    want = plainify(repo.doc(url))
    repo.close()
    assert not os.path.exists(os.path.join(path, "feeds", "cols.slab"))
    assert [
        f
        for _r, _d, fs in os.walk(os.path.join(path, "feeds"))
        for f in fs
        if f.endswith(".cols2")
    ]
    repo2 = Repo(path=path)
    assert plainify(repo2.doc(url)) == want
    repo2.close()
    # the reference reads the per-feed layout, with its slab off too
    assert_reference_reads(path, [url], [want], HM_SLAB="0")
