"""The port's disk-fault harness (hypermerge_tpu_torch/storage/faults.py)
against the JAX package's (hypermerge_tpu/storage/faults.py), on the CPU.

- `DiskFaultPlan`: the same seed draws the same `write_fate` /
  `fsync_fate` sequence per path in both packages, whatever the
  interleaving of paths; the `after` grace period and `path_filter`.
- The per-format crash matrices of tests/test_crash.py on the port's
  storage under the port's `CrashRecorder`: the feed log (also torn
  inside a write), the corpus slab and the columnar sidecar's commits.
  Each matrix's workload also runs under the reference's recorder over
  the reference's storage: the two event logs are equal, and each
  package's `materialize` of every prefix (kill -9 and power cut) gives
  the same directory, byte for byte.
- ENOSPC, EIO, torn writes and fsync lies on the port's append paths,
  as tests/test_crash.py runs them on the reference's: in-memory state
  never runs ahead of the disk, the next append heals a torn tail, a lie
  shows only to the power-cut replay, a failed fsync surfaces, and the
  tier-1 barrier makes everything before it durable.

Tolerance: exact.
"""

import errno
import os

import numpy as np
import pytest

from hypermerge_tpu.storage import faults as RF
from hypermerge_tpu.storage.colcache import (
    FileColumnStorageV2 as RefColumnStorageV2,
)
from hypermerge_tpu.storage.feed import FileFeedStorage as RefFeedStorage
from hypermerge_tpu.storage.slab import CorpusSlab as RefCorpusSlab
from hypermerge_tpu_torch.storage import faults as F
from hypermerge_tpu_torch.storage.colcache import (
    PRED_FIELDS,
    ROW_FIELDS,
    FileColumnStorageV2,
)
from hypermerge_tpu_torch.storage.feed import FileFeedStorage
from hypermerge_tpu_torch.storage.slab import (
    KIND_IMAGE,
    KIND_RECORD,
    CorpusSlab,
)

PACKAGES = {
    "ref": (RF, RefFeedStorage, RefCorpusSlab, RefColumnStorageV2),
    "port": (F, FileFeedStorage, CorpusSlab, FileColumnStorageV2),
}


def _tree(root):
    """{relpath: bytes} of every file under root."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# fault-plan determinism, in both packages


PLANS = {
    "mixed": dict(write_error_p=0.2, torn_write_p=0.2, fsync_error_p=0.1,
                  fsync_lie_p=0.2),
    "after": dict(write_error_p=0.5, fsync_lie_p=0.5, after=5),
    "filter": dict(torn_write_p=0.6, fsync_error_p=0.3,
                   path_filter="wal.log"),
    "eio_only": dict(write_error_p=0.4, errnos=(errno.EIO,)),
}


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("plan", list(PLANS))
def test_fault_plan_fates_equal_across_packages(seed, plan):
    """The same seed, the same fates per path, in the same op order:
    paths interleave, sizes vary (the torn offset draws from them)."""
    paths = ["feeds/ab/abcd", "wal.log", "repo.db", "feeds/cols.slab"]

    def fates(mod):
        p = mod.DiskFaultPlan(seed=seed, **PLANS[plan])
        out = []
        for i in range(60):
            path = paths[(i * 7) % len(paths)]
            out.append(p.write_fate(path, 1 + (i * 13) % 97))
            out.append(p.fsync_fate(path))
        return out, p.stats

    got, got_stats = fates(F)
    want, want_stats = fates(RF)
    assert got == want
    assert got_stats == want_stats


def test_fault_plan_seed_and_streams():
    """The seed matters, and a path's fates do not depend on how other
    paths interleave (the port's plan, after tests/test_crash.py)."""
    def fates(seed):
        plan = F.DiskFaultPlan(
            seed=seed, write_error_p=0.2, torn_write_p=0.2,
            fsync_error_p=0.1, fsync_lie_p=0.2,
        )
        return [(plan.write_fate("a/log", 64 + i), plan.fsync_fate("a/log"))
                for i in range(40)]

    assert fates(7) == fates(7)
    assert fates(7) != fates(8)
    plan1 = F.DiskFaultPlan(seed=3, write_error_p=0.3)
    solo = [plan1.write_fate("x", 8) for _ in range(20)]
    plan2 = F.DiskFaultPlan(seed=3, write_error_p=0.3)
    mixed = []
    for _ in range(20):
        mixed.append(plan2.write_fate("x", 8))
        plan2.write_fate("y", 8)
    assert solo == mixed
    grace = F.DiskFaultPlan(seed=1, write_error_p=1.0, after=3)
    assert [grace.write_fate("p", 4)[0] for _ in range(4)] == [
        "ok", "ok", "ok", "error",
    ]


def test_one_harness_at_a_time():
    with F.activate(recorder=F.CrashRecorder("/nonexistent-root")):
        assert F.harness_gen() % 2 == 1
        with pytest.raises(RuntimeError, match="already active"):
            with F.activate():
                pass
    assert F.active_recorder() is None


# ---------------------------------------------------------------------------
# per-format crash matrices: the port's recorder over the port's storage,
# and the same workload's event log in both packages


def _feed_workload(mod, storage_cls, work, n=6, width=lambda i: i):
    rec = mod.CrashRecorder(str(work))
    acked = []
    with mod.activate(recorder=rec):
        s = storage_cls(str(work / "ab" / "feed"))
        for i in range(n):
            s.append(b"payload-%d-%s" % (i, b"x" * width(i)))
            acked.append((rec.n_points - 1, i + 1))
    return rec, acked


def _slab_workload(mod, slab_cls, work):
    rec = mod.CrashRecorder(str(work))
    payloads = {"feedA": [], "feedB": []}
    with mod.activate(recorder=rec):
        slab = slab_cls(str(work / "cols.slab"))
        for i in range(3):
            for name in ("feedA", "feedB"):
                kind = KIND_IMAGE if i == 0 else KIND_RECORD
                payload = b"%s-%d-%s" % (name.encode(), i, b"y" * 7)
                slab.append(kind, name, payload)
                if kind == KIND_IMAGE:
                    payloads[name] = [payload]
                else:
                    payloads[name].append(payload)
        slab.close()
    return rec, payloads


def _colcache_workload(mod, cols_cls, work):
    rec = mod.CrashRecorder(str(work))
    with mod.activate(recorder=rec):
        st = cols_cls(str(work / "ab" / "f.cols2"))
        for i in range(5):
            rows = np.full((2, ROW_FIELDS), i, np.int32)
            preds = np.zeros((1, PRED_FIELDS), np.int32)
            st.commit_change(rows, preds, ['{"t":"k","v":"k%d"}' % i], 0)
    return rec


@pytest.mark.parametrize("fmt", ["feed", "slab", "colcache"])
def test_event_logs_and_replays_equal_across_packages(tmp_path, fmt):
    """The port's storage under the port's recorder logs the events the
    reference's storage logs under the reference's recorder, and both
    recorders replay every prefix of that log (kill -9 and power cut)
    into the same bytes."""
    recs = {}
    for name, (mod, feed_cls, slab_cls, cols_cls) in PACKAGES.items():
        work = tmp_path / name / "work"
        if fmt == "feed":
            recs[name] = _feed_workload(mod, feed_cls, work)[0]
        elif fmt == "slab":
            recs[name] = _slab_workload(mod, slab_cls, work)[0]
        else:
            recs[name] = _colcache_workload(mod, cols_cls, work)
    assert recs["port"].events == recs["ref"].events
    for k in range(recs["port"].n_points):
        for powercut in (False, True):
            trees = {}
            for name, rec in recs.items():
                dst = tmp_path / f"{name}_{k}_{int(powercut)}"
                rec.materialize(str(dst), k, powercut=powercut)
                trees[name] = _tree(dst)
            assert trees["port"] == trees["ref"], (k, powercut)


def test_feed_crash_matrix(tmp_path):
    rec, acked = _feed_workload(F, FileFeedStorage, tmp_path / "work")
    for k in range(rec.n_points):
        dst = str(tmp_path / f"c{k}")
        rec.materialize(dst, k)
        s2 = FileFeedStorage(os.path.join(dst, "ab", "feed"))
        got = len(s2)  # reopen never raises
        full_acked = max((m for e, m in acked if e <= k), default=0)
        assert got <= full_acked + 1  # +1: the append being torn
        for i in range(got):
            assert s2.get(i) == b"payload-%d-%s" % (i, b"x" * i)
        s2.append(b"heal")  # the next append always heals the tail
        s3 = FileFeedStorage(os.path.join(dst, "ab", "feed"))
        assert len(s3) == got + 1
        assert s3.get(got) == b"heal"


def test_feed_crash_matrix_intra_write_tears(tmp_path):
    """Crashes inside a write (partial byte prefixes) heal as boundary
    crashes do; each package's replay of the same tear is the same."""
    rec = F.CrashRecorder(str(tmp_path / "work"))
    ref = RF.CrashRecorder(str(tmp_path / "rwork"))
    with F.activate(recorder=rec):
        s = FileFeedStorage(str(tmp_path / "work" / "ab" / "feed"))
        for i in range(3):
            s.append(b"0123456789abcdef-%d" % i)
    ref.events = list(rec.events)
    for k in range(rec.n_points - 1):
        for cut in (1, 3):
            dst = str(tmp_path / f"t{k}_{cut}")
            rec.materialize(dst, k, partial_last=cut)
            ref.materialize(str(tmp_path / f"r{k}_{cut}"), k,
                            partial_last=cut)
            assert _tree(dst) == _tree(tmp_path / f"r{k}_{cut}")
            s2 = FileFeedStorage(os.path.join(dst, "ab", "feed"))
            got = len(s2)
            for i in range(got):
                assert s2.get(i) == b"0123456789abcdef-%d" % i
            s2.append(b"heal")
            assert len(
                FileFeedStorage(os.path.join(dst, "ab", "feed"))
            ) == got + 1


def test_slab_crash_matrix(tmp_path):
    rec, payloads = _slab_workload(F, CorpusSlab, tmp_path / "work")
    for k in range(rec.n_points):
        dst = str(tmp_path / f"s{k}")
        rec.materialize(dst, k)
        s2 = CorpusSlab(os.path.join(dst, "cols.slab"))
        for name in s2.feed_names():  # loading IS the repair
            got = s2.image_bytes(name)
            # a concatenation of a prefix of that feed's segments
            acc, ok = b"", got == b""
            for p in payloads[name]:
                acc += p
                ok = ok or got == acc
            assert ok, (k, name, got)
        s2.append(KIND_RECORD, "feedA", b"heal")
        assert s2.image_bytes("feedA").endswith(b"heal")
        s2.close()


def test_colcache_commit_matrix(tmp_path):
    rec = _colcache_workload(F, FileColumnStorageV2, tmp_path / "work")
    for k in range(rec.n_points):
        dst = str(tmp_path / f"c{k}")
        rec.materialize(dst, k)
        st2 = FileColumnStorageV2(os.path.join(dst, "ab", "f.cols2"))
        rows, preds, tables, commits = st2.load()  # never raises
        m = len(commits)
        assert m <= 5
        # only complete commits count: rows, preds and tables agree
        assert len(rows) == 2 * m
        assert len(preds) == m
        assert len(tables) == m
        if m:
            assert int(rows[-1, 0]) == m - 1


# ---------------------------------------------------------------------------
# targeted ENOSPC / EIO / torn writes / fsync lies on the port's paths


def _mk_storage(root, name="feed"):
    return FileFeedStorage(os.path.join(str(root), "ab", name))


def test_feed_append_enospc_keeps_memory_consistent(tmp_path):
    s = _mk_storage(tmp_path)
    for i in range(3):
        s.append(b"block-%d" % i)
    with F.activate(plan=F.DiskFaultPlan(seed=0, write_error_p=1.0)):
        with pytest.raises(OSError):
            s.append(b"doomed")
    assert len(s) == 3  # in-memory state did not run ahead
    s.append(b"block-3")  # the next append heals the tail
    s2 = _mk_storage(tmp_path)
    assert [s2.get(i) for i in range(len(s2))] == [
        b"block-0", b"block-1", b"block-2", b"block-3",
    ]


def test_feed_append_torn_write_heals(tmp_path):
    s = _mk_storage(tmp_path)
    s.append(b"healthy")
    with F.activate(plan=F.DiskFaultPlan(seed=5, torn_write_p=1.0)):
        with pytest.raises(OSError):
            s.append(b"torn-block-payload")
    assert len(_mk_storage(tmp_path)) == 1
    s.append(b"after")
    s3 = _mk_storage(tmp_path)
    assert [s3.get(i) for i in range(2)] == [b"healthy", b"after"]


def test_actor_write_change_enospc_no_phantom(tmp_path):
    """A failed feed append leaves no phantom change in the actor."""
    from hypermerge_tpu_torch.backend.actor import Actor
    from hypermerge_tpu_torch.crdt.change import Change
    from hypermerge_tpu_torch.storage.feed import Feed
    from hypermerge_tpu_torch.utils import keys as keymod

    pair = keymod.create()
    feed = Feed(pair.public_key, _mk_storage(tmp_path), pair.secret_key)
    actor = Actor(feed, [].append)

    def change(seq):
        return Change(actor=pair.public_key, seq=seq, start_op=seq,
                      deps={}, ops=[], message="")

    actor.write_change(change(1))
    with F.activate(plan=F.DiskFaultPlan(seed=0, write_error_p=1.0)):
        with pytest.raises(OSError):
            actor.write_change(change(2))
    assert actor.seq_head == 1
    actor.write_change(change(2))  # the same seq retries cleanly
    assert actor.seq_head == 2
    assert feed.length == 2


def test_colcache_enospc_requeues_table_lines(tmp_path):
    """Interner table lines taken for a failed commit go back on the
    pending queue, or later commits would name undefined entries."""
    from hypermerge_tpu_torch.crdt.change import ROOT, Action, Change, Op
    from hypermerge_tpu_torch.storage.colcache import FeedColumnCache

    path = str(tmp_path / "ab" / "feed.cols2")
    cc = FeedColumnCache(FileColumnStorageV2(path), writer="w" * 16)

    def change(seq, key, val):
        return Change(actor="w" * 16, seq=seq, start_op=seq, deps={},
                      ops=[Op(Action.SET, ROOT, key=key, value=val)])

    cc.append_change(change(1, "a", "hello"))
    with F.activate(plan=F.DiskFaultPlan(seed=2, write_error_p=1.0)):
        with pytest.raises(OSError):
            cc.append_change(change(2, "b", "world"))
    cc.append_change(change(2, "b", "world"))
    fc = FeedColumnCache(FileColumnStorageV2(path), writer="w" * 16).columns()
    assert fc.n_changes == 2
    assert "world" in fc.strings


def test_powercut_drops_unfsynced_tail_kill9_does_not(tmp_path):
    rec = F.CrashRecorder(str(tmp_path / "work"))
    with F.activate(recorder=rec):
        s = FileFeedStorage(str(tmp_path / "work" / "ab" / "feed"))
        s.append(b"first")
        s.sync()  # honest fsync: durable from here
        s.append(b"second")  # flushed, never fsynced
    k = rec.n_points - 1
    rec.materialize(str(tmp_path / "kill9"), k)
    assert len(FileFeedStorage(str(tmp_path / "kill9/ab/feed"))) == 2
    rec.materialize(str(tmp_path / "cut"), k, powercut=True)
    s2 = FileFeedStorage(str(tmp_path / "cut/ab/feed"))
    assert len(s2) == 1 and s2.get(0) == b"first"


def test_fsync_tier2_makes_acked_appends_powercut_durable(
    tmp_path, monkeypatch
):
    monkeypatch.setenv("HM_FSYNC", "2")
    rec = F.CrashRecorder(str(tmp_path / "work"))
    marks = []
    with F.activate(recorder=rec):
        s = FileFeedStorage(str(tmp_path / "work" / "ab" / "feed"))
        for i in range(4):
            s.append(b"durable-%d" % i)
            marks.append((rec.n_points - 1, i + 1))
    for k, acked in marks:
        dst = str(tmp_path / f"p{k}")
        rec.materialize(dst, k, powercut=True)
        s2 = FileFeedStorage(os.path.join(dst, "ab", "feed"))
        assert len(s2) >= acked
        for i in range(acked):
            assert s2.get(i) == b"durable-%d" % i


def test_fsync_lie_is_visible_to_powercut_only(tmp_path, monkeypatch):
    monkeypatch.setenv("HM_FSYNC", "2")
    rec = F.CrashRecorder(str(tmp_path / "work"))
    plan = F.DiskFaultPlan(seed=0, fsync_lie_p=1.0)
    with F.activate(plan=plan, recorder=rec):
        s = FileFeedStorage(str(tmp_path / "work" / "ab" / "feed"))
        s.append(b"claimed-durable")  # the fsync LIED
    k = rec.n_points - 1
    rec.materialize(str(tmp_path / "kill9"), k)
    assert len(FileFeedStorage(str(tmp_path / "kill9/ab/feed"))) == 1
    rec.materialize(str(tmp_path / "cut"), k, powercut=True)
    s2 = FileFeedStorage(str(tmp_path / "cut/ab/feed"))
    assert len(s2) == 0  # the lie dropped the bytes at the cut
    s2.append(b"heal")
    assert len(s2) == 1
    assert plan.stats["fsync_lies"] >= 1


def test_fsync_eio_surfaces(tmp_path, monkeypatch):
    monkeypatch.setenv("HM_FSYNC", "2")
    s = _mk_storage(tmp_path)
    with F.activate(plan=F.DiskFaultPlan(seed=0, fsync_error_p=1.0)):
        with pytest.raises(OSError):
            s.append(b"x")


def test_group_fsync_tier1_barrier(tmp_path, monkeypatch):
    """Tier 1 without a journal: the barrier fsyncs every dirty log, so
    sqlite rows committed after it never describe unfsynced bytes."""
    from hypermerge_tpu_torch.storage.durability import DurabilityManager

    monkeypatch.setenv("HM_FSYNC", "1")
    rec = F.CrashRecorder(str(tmp_path / "work"))
    dm = DurabilityManager()
    with F.activate(recorder=rec):
        s = FileFeedStorage(str(tmp_path / "work" / "ab" / "feed"),
                            durability=dm)
        s.append(b"one")
        s.append(b"two")
        dm.barrier()
        mark = rec.n_points
        s.append(b"three")
    dm.close()
    rec.materialize(str(tmp_path / "cut"), mark, powercut=True)
    assert len(FileFeedStorage(str(tmp_path / "cut/ab/feed"))) == 2


def test_durability_barrier_raises_on_fsync_error(tmp_path, monkeypatch):
    from hypermerge_tpu_torch.storage.durability import DurabilityManager

    monkeypatch.setenv("HM_FSYNC", "1")
    dm = DurabilityManager()
    s = FileFeedStorage(str(tmp_path / "ab" / "feed"), durability=dm)
    s.append(b"one")
    with F.activate(plan=F.DiskFaultPlan(seed=0, fsync_error_p=1.0)):
        with pytest.raises(OSError):
            dm.barrier()
    # the storage stayed dirty: a barrier with the fault cleared syncs it
    assert dm.sync_now() >= 1
    dm.close()


def test_sqlite_statements_journal_one_batch_per_commit(tmp_path):
    """The port's SqlDatabase hands the recorder the statement batches
    the reference's hands its own, one per commit (a bulk window is one
    batch), so a replayed transaction stays atomic."""
    from hypermerge_tpu.storage.sql import SqlDatabase as RefSqlDatabase
    from hypermerge_tpu_torch.storage.sql import SqlDatabase

    recs = {}
    for name, mod, db_cls in (("ref", RF, RefSqlDatabase),
                              ("port", F, SqlDatabase)):
        work = tmp_path / name
        os.makedirs(work)
        rec = mod.CrashRecorder(str(work))
        with mod.activate(recorder=rec):
            db = db_cls(str(work / "repo.db"))
            db.execute("INSERT INTO keys VALUES (?, ?, ?)", ("a", "pa", None))
            with db.bulk():
                db.executemany(
                    "INSERT INTO clocks VALUES (?, ?, ?, ?)",
                    (("r", f"d{i}", "x", i) for i in range(3)),
                )
                db.execute("DELETE FROM clocks WHERE doc_id = ?", ("d0",))
            db.close()
        recs[name] = rec
    assert recs["port"].events == recs["ref"].events
    kinds = [len(ev[2]) for ev in recs["port"].events if ev[0] == F.DB_COMMIT]
    assert kinds == [1, 1, 2]  # schema, one insert, the bulk window
    dst = tmp_path / "cut"
    recs["port"].materialize(str(dst), len(recs["port"].events) - 1)
    db = SqlDatabase(str(dst / "repo.db"))
    try:
        # the cut fell before the bulk window's commit: none of it landed
        assert db.execute("SELECT COUNT(*) FROM clocks").fetchone()[0] == 0
        assert db.execute("SELECT COUNT(*) FROM keys").fetchone()[0] == 1
    finally:
        db.close()
