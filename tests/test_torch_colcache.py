"""The port's feed column sidecars (hypermerge_tpu_torch/storage/colcache.py)
against the JAX package's (hypermerge_tpu/storage/colcache.py).

The same change histories go into both packages' FeedColumnCaches — the
port's copies carried across with `convert.changes_from_reference`, as
JSON dicts — and must give equal FeedColumns (rows, planes with their
dtypes, preds, tables, commit bookkeeping) in memory and on disk, before
and after `compact`. The files themselves must be the same bytes, and a
sidecar written by either package is read by the other. Tolerance:
exact.

The helpers here (histories, and caches filled from them) are shared with
test_torch_pack.py and test_torch_slice.py.
"""

import os
import random

import numpy as np
import pytest

from helpers import Site, random_mutation, sync
from hypermerge_tpu.storage import colcache as ref_cc
from hypermerge_tpu_torch import convert
from hypermerge_tpu_torch.storage import colcache as port_cc

INF = float("inf")


def single_writer_history(seed, n_mut=30):
    """A fuzzed single-writer history, widened to every value lane:
    floats, bools, bigints and inline ints above int16."""
    r = random.Random(seed)
    site = Site(f"actor{seed % 7:02d}")
    for _ in range(n_mut):
        random_mutation(site, r)
    site.change(lambda d: d.__setitem__("f", 3.25 + seed))
    site.change(lambda d: d.__setitem__("b", True))
    site.change(lambda d: d.__setitem__("big", 2**40 + seed))
    site.change(lambda d: d.__setitem__("wide", 2**20 + seed))
    site.change(lambda d: d.__setitem__("neg", -(2**20) - seed))
    return list(site.opset.history)


def multi_actor_histories(seed, n_mut=30):
    """{actor: its changes, in seq order} of a three-site fuzz history."""
    r = random.Random(seed)
    sites = [Site(f"actor{i:02d}") for i in range(3)]
    for _ in range(n_mut):
        random_mutation(r.choice(sites), r)
        if r.random() < 0.3:
            sync(*sites)
    sync(*sites)
    feeds = {}
    for c in sorted(sites[0].opset.history, key=lambda c: (c.actor, c.seq)):
        feeds.setdefault(c.actor, []).append(c)
    return feeds


def to_port(history):
    return convert.changes_from_reference([c.to_json() for c in history])


def fill_caches(history, ref_storage, port_storage, writer=None):
    """(reference cache, port cache) holding the same history, each
    written by its own package."""
    writer = writer or history[0].actor
    rc = ref_cc.FeedColumnCache(ref_storage, writer=writer)
    pc = port_cc.FeedColumnCache(port_storage, writer=writer)
    ordered = sorted(history, key=lambda c: (c.actor, c.seq))
    for c, pcx in zip(ordered, to_port(ordered)):
        rc.append_change(c)
        pc.append_change(pcx)
    return rc, pc


def plane_caches(tmp_path, name, history):
    """(reference, port) caches reopened from compacted (v3) sidecar
    files that each package wrote: plane-backed, as a cold open finds
    them."""
    rp, pp = str(tmp_path / f"ref-{name}.cols2"), str(tmp_path / f"port-{name}.cols2")
    rc, pc = fill_caches(
        history, ref_cc.FileColumnStorageV2(rp), port_cc.FileColumnStorageV2(pp)
    )
    rc.compact()
    pc.compact()
    w = history[0].actor
    return (
        ref_cc.FeedColumnCache(ref_cc.FileColumnStorageV2(rp), writer=w),
        port_cc.FeedColumnCache(port_cc.FileColumnStorageV2(pp), writer=w),
    )


def assert_columns_equal(a, b):
    """Two FeedColumns (either package) hold the same data, dtypes too."""
    assert (a.rows is None) == (b.rows is None)
    assert (a.planes is None) == (b.planes is None)
    if a.rows is not None:
        assert a.rows.dtype == b.rows.dtype
        np.testing.assert_array_equal(a.rows, b.rows)
    if a.planes is not None:
        assert list(a.planes) == list(b.planes)
        for name in a.planes:
            assert a.planes[name].dtype == b.planes[name].dtype, name
            np.testing.assert_array_equal(a.planes[name], b.planes[name])
    np.testing.assert_array_equal(a.preds, b.preds)
    assert a.preds.dtype == b.preds.dtype
    np.testing.assert_array_equal(a.row_ends, b.row_ends)
    for f in ("actors", "keys", "strings", "floats", "bigints"):
        assert getattr(a, f) == getattr(b, f), f
    assert [type(x) for x in a.floats] == [type(x) for x in b.floats]
    assert a.n_changes == b.n_changes
    assert a.ok_prefix_len == b.ok_prefix_len
    assert a.n_rows == b.n_rows
    assert a.seqs_contiguous() == b.seqs_contiguous()
    for lo_hi in ((0, INF), (1, 3), (0, a.n_changes // 2)):
        assert a.window(*lo_hi) == b.window(*lo_hi)


HISTORIES = {
    "single_writer": lambda: {"w": single_writer_history(5)},
    "multi_actor": lambda: multi_actor_histories(21),
}


def _storages(kind, tmp_path, name):
    if kind == "memory":
        return port_cc.MemoryColumnStorage(), ref_cc.MemoryColumnStorage()
    return (
        port_cc.FileColumnStorageV2(str(tmp_path / f"p-{name}.cols2")),
        ref_cc.FileColumnStorageV2(str(tmp_path / f"r-{name}.cols2")),
    )


@pytest.mark.parametrize("history", list(HISTORIES))
@pytest.mark.parametrize("storage", ["memory", "file", "file_compacted"])
def test_feed_columns_equal(tmp_path, history, storage):
    for i, (actor, hist) in enumerate(HISTORIES[history]().items()):
        ps, rs = _storages(storage, tmp_path, str(i))
        rc, pc = fill_caches(hist, rs, ps, writer=hist[0].actor)
        if storage == "file_compacted":
            rc.compact()
            pc.compact()
        assert_columns_equal(rc.columns(), pc.columns())
        if storage != "memory":
            # reopened from disk: the same again
            w = hist[0].actor
            rc2 = ref_cc.FeedColumnCache(ref_cc.FileColumnStorageV2(rs.path), w)
            pc2 = port_cc.FeedColumnCache(port_cc.FileColumnStorageV2(ps.path), w)
            assert_columns_equal(rc2.columns(), pc2.columns())
            # the port's reload holds what the reference wrote out
            np.testing.assert_array_equal(
                pc2.columns().ensure_rows(), rc.columns().ensure_rows()
            )


@pytest.mark.parametrize("compacted", [False, True], ids=["v2", "v3"])
def test_sidecar_bytes_identical(tmp_path, compacted):
    """v2 records (and, after compact, the v3 checkpoint) are the same
    bytes from either package."""
    hist = single_writer_history(7)
    rp, pp = str(tmp_path / "r.cols2"), str(tmp_path / "p.cols2")
    rc, pc = fill_caches(
        hist, ref_cc.FileColumnStorageV2(rp), port_cc.FileColumnStorageV2(pp)
    )
    if compacted:
        rc.compact()
        pc.compact()
    with open(rp, "rb") as f:
        ref_bytes = f.read()
    with open(pp, "rb") as f:
        port_bytes = f.read()
    assert ref_bytes.startswith(b"HMc3") == compacted
    assert port_bytes == ref_bytes


def test_codecs_identical():
    """The plane and record codecs, called directly."""
    rc, pc = fill_caches(
        single_writer_history(9), ref_cc.MemoryColumnStorage(),
        port_cc.MemoryColumnStorage(),
    )
    rows = rc.columns().rows
    rp, pp = ref_cc.planes_from_rows(rows), port_cc.planes_from_rows(rows)
    for name in ref_cc.PLANE_NAMES:
        assert rp[name].dtype == pp[name].dtype
        np.testing.assert_array_equal(rp[name], pp[name])
    np.testing.assert_array_equal(port_cc.rows_from_planes(pp), rows)
    fc = rc.columns()
    flags = np.zeros(fc.n_changes, np.uint8)
    ends = fc.row_ends[1:]
    args = (rp, fc.preds, ends, flags, b'{"t":"a","v":"x"}\n')
    blob = port_cc.pack_v3_checkpoint(*args)
    assert blob == ref_cc.pack_v3_checkpoint(*args)
    got, want = port_cc.parse_v3_checkpoint(blob), ref_cc.parse_v3_checkpoint(blob)
    for name in ref_cc.PLANE_NAMES:
        np.testing.assert_array_equal(got[0][name], want[0][name])
    for i in (1, 2, 3, 4, 5):
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want[i]))
    assert port_cc.parse_v3_checkpoint(blob[:-3]) is None
    rec = (rows[:3], fc.preds[:2], ['{"t":"k","v":"a"}'], 0)
    assert port_cc.pack_v2_record(*rec) == ref_cc.pack_v2_record(*rec)
    assert port_cc.PLANE_NAMES == ref_cc.PLANE_NAMES
    for c in ("ROW_FIELDS", "PRED_FIELDS", "COMMIT_FIELDS", "OBJ_ROOT",
              "REF_HEAD", "REF_NONE", "VK_NONE", "VK_INT", "VK_FLOAT",
              "VK_STR", "VK_BOOL", "VK_BIGINT"):
        assert getattr(port_cc, c) == getattr(ref_cc, c), c


@pytest.mark.parametrize("writer_pkg", ["ref", "port"])
def test_cross_package_read(tmp_path, writer_pkg):
    """A v3 checkpoint plus a v2 tail (and a corrupt-block record) written
    by one package is read by the other, and both keep appending to it
    alike."""
    hist = single_writer_history(13)
    w = hist[0].actor
    path = str(tmp_path / "x.cols2")
    cc_w = ref_cc if writer_pkg == "ref" else port_cc
    cc_r = port_cc if writer_pkg == "ref" else ref_cc
    ordered = sorted(hist, key=lambda c: (c.actor, c.seq))
    changes = ordered if writer_pkg == "ref" else to_port(ordered)
    cut = len(changes) // 2
    wc = cc_w.FeedColumnCache(cc_w.FileColumnStorageV2(path), writer=w)
    for c in changes[:cut]:
        wc.append_change(c)
    wc.compact()
    for c in changes[cut:]:
        wc.append_change(c)
    wc.append_change(None)  # a corrupt block: a seq slot with no ops
    rc = cc_r.FeedColumnCache(cc_r.FileColumnStorageV2(path), writer=w)
    got, want = rc.columns(), wc.columns()
    assert_columns_equal(want, got)
    assert got.ok_prefix_len == len(changes) < got.n_changes


def test_torn_tail_and_auto_compaction(tmp_path, monkeypatch):
    """A torn record at the end is dropped by both readers; a v2 tail of
    HM_CKPT_TAIL records or more is folded into a checkpoint at load,
    into the same bytes."""
    hist = single_writer_history(17)
    w = hist[0].actor
    rp, pp = str(tmp_path / "r.cols2"), str(tmp_path / "p.cols2")
    fill_caches(hist, ref_cc.FileColumnStorageV2(rp), port_cc.FileColumnStorageV2(pp))
    for p in (rp, pp):
        with open(p, "ab") as f:
            f.write(b"\x05\x00\x00\x00\x01")  # half a record header
    a = ref_cc.FeedColumnCache(ref_cc.FileColumnStorageV2(rp), w).columns()
    b = port_cc.FeedColumnCache(port_cc.FileColumnStorageV2(pp), w).columns()
    assert_columns_equal(a, b)
    monkeypatch.setenv("HM_CKPT_TAIL", "4")
    a = ref_cc.FeedColumnCache(ref_cc.FileColumnStorageV2(rp), w).columns()
    b = port_cc.FeedColumnCache(port_cc.FileColumnStorageV2(pp), w).columns()
    assert_columns_equal(a, b)
    with open(rp, "rb") as f1, open(pp, "rb") as f2:
        raw = f2.read()
        assert raw.startswith(b"HMc3")
        assert raw == f1.read()


def test_reset_destroy_and_storage_fns(tmp_path):
    hist = single_writer_history(19)
    w = hist[0].actor
    fn = port_cc.file_column_storage_fn(str(tmp_path))
    st = fn("abcdef")
    assert st.path == os.path.join(str(tmp_path), "ab", "abcdef.cols2")
    _, pc = fill_caches(hist, ref_cc.MemoryColumnStorage(), st)
    assert os.path.exists(st.path)
    pc.reset()
    assert pc.n_changes == 0 and not os.path.exists(st.path)
    pc.append_change(to_port(hist[:1])[0])
    assert pc.columns().n_changes == 1 and pc.columns().actors == [w]
    pc.destroy()
    assert not os.path.exists(st.path)
    assert isinstance(port_cc.memory_column_storage_fn("x"), port_cc.MemoryColumnStorage)
    # layouts the port does not read yet raise instead of reading nothing
    os.makedirs(tmp_path / "cd" / "cdef.cols")
    with pytest.raises(NotImplementedError, match="four-file"):
        fn("cdef")
    (tmp_path / "cols.slab").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="slab"):
        port_cc.file_column_storage_fn(str(tmp_path))
