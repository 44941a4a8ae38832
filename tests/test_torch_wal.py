"""The port's write-ahead journal (hypermerge_tpu_torch/storage/wal.py) and
its bounded recovery, against the JAX package's, on the CPU.

- Format: each package's `read_journal` reads the other's journals
  identically, torn at every byte of their tail; for one sequence of
  `note_dirty` / `append` / `commit` / `checkpoint` / `close` the two
  packages write the same journal bytes once the header's session id is
  substituted (the ids are random per session).
- Group commit: a tier-1 window is one journal fsync however many feeds
  it dirtied (the recorder's events and the `storage.wal.fsyncs`
  counter), and concurrent tier-2 committers share the leader's fsync.
- Crashes of the port's `Repo` (device="cpu") under the port's
  `CrashRecorder` at HM_FSYNC=1: a power cut at each ack replays the
  acked blocks from the journal (acked_lost == 0, `storage.wal.replayed`
  above 0), a torn journal tail and a lying journal fsync leave a gapless
  prefix, and crashes bracketing the checkpoint's rotation recover.
  These sample fewer prefixes than tests/test_wal.py (4 to 6 a matrix,
  around the first rotations), which keeps the full matrices.
- The generation stamp: the repo.dirty marker carries the journal's
  session; recovery opens exactly the crashed session's dirty ledger, a
  stale marker after a clean close opens no feed, and a mismatched stamp
  opens every feed. HM_RECOVER=0 keeps the crashed marker and journal,
  runs journal-less, and its first write invalidates the stamp.
- The journal's failure paths (a checkpoint whose sync fails, a commit
  after a failed close, a dry run over a journal with a gap, a replay
  whose fsync fails).

Tolerance: exact.
"""

import os
import threading

import pytest

from hypermerge_tpu.storage import wal as ref_wal
from hypermerge_tpu_torch import telemetry
from hypermerge_tpu_torch.repo import Repo
from hypermerge_tpu_torch.storage import faults as F
from hypermerge_tpu_torch.storage import wal as walmod
from hypermerge_tpu_torch.storage.durability import DurabilityManager
from hypermerge_tpu_torch.storage.feed import FileFeedStorage
from hypermerge_tpu_torch.storage.wal import WriteAheadLog, read_journal
from hypermerge_tpu_torch.utils.ids import validate_doc_url

from helpers import wait_until

WALS = {"ref": ref_wal, "port": walmod}


def _fsyncs(rec, start=0):
    """Honest FSYNC events per path since event index `start`."""
    out = {}
    for ev in rec.events[start:]:
        if ev[0] == F.FSYNC and not ev[2]:
            out[ev[1]] = out.get(ev[1], 0) + 1
    return out


def _counter(name):
    return telemetry.snapshot().get(name, 0)


def _settle(repo, durable=False):
    """Settle the repo's flushers (with `durable`, the durability flusher
    too: the ack of HM_FSYNC >= 1). A flush that has not finished within
    its time fails the test: an ack counted before its flush finished
    would count an edit the disk may not hold."""
    flushers = [repo.back._stores, repo.back._cache_syncs]
    if repo.back.live is not None:
        flushers.insert(0, repo.back.live)
    if durable:
        flushers.append(repo.back.durability)
    for f in flushers:
        assert f.flush_now(60), f


def _edits(repo, url):
    return list((repo.doc(url) or {}).get("edits", []))


# ---------------------------------------------------------------------------
# the journal format, across packages


class _Probe:
    """A checkpoint-pending storage: counts syncs, optionally fails."""

    def __init__(self, fail=False):
        self.fail = fail
        self.synced = 0

    def sync(self):
        if self.fail:
            raise OSError("EIO")
        self.synced += 1


def _journal_script(mod, path):
    """One sequence of journal calls; the file's bytes after each step."""
    wal = mod.WriteAheadLog(path, tier=1)
    probe = _Probe()
    snaps = []

    def snap():
        with open(path, "rb") as fh:
            snaps.append(fh.read())

    snap()
    wal.note_dirty("feedZ")
    end = wal.append("feedB", 0, b"b" * 33, storage=probe)
    wal.append("feedA", 0, b"", storage=probe)
    wal.append("feedA", 1, bytes(range(256)), storage=probe)
    wal.commit(end)
    snap()
    wal.note_dirty("feedB")  # already in the ledger: no record
    wal.checkpoint()
    snap()
    wal.append("feedC", 7, b"after the rotation", storage=probe)
    wal.sync()
    snap()
    assert wal.close()
    snap()
    return wal.session, snaps


def test_journals_byte_equal_across_packages(tmp_path):
    ref_session, want = _journal_script(ref_wal, str(tmp_path / "r.log"))
    session, got = _journal_script(walmod, str(tmp_path / "p.log"))
    assert len(session) == len(ref_session) == 16
    swapped = [s.replace(ref_session.encode(), session.encode())
               for s in want]
    assert got == swapped
    assert all(s.startswith(b"HMWAL1 ") for s in got)


@pytest.mark.parametrize("writer", list(WALS))
def test_read_journal_cross_package_torn_tails(tmp_path, writer):
    """Every prefix of a journal one package wrote parses the same in
    both packages: header, ledger, records and torn bytes."""
    path = str(tmp_path / "wal.log")
    wal = WALS[writer].WriteAheadLog(path, tier=2)
    wal.note_dirty("ledger-only")
    for i in range(4):
        wal.append(f"feed{i % 2}", i // 2, b"x" * (5 * i + 1))
    wal.sync()
    with open(path, "rb") as fh:
        raw = fh.read()
    full = None
    for cut in range(len(raw) + 1):
        cut_path = str(tmp_path / f"cut{cut}.log")  # a new file a cut
        with open(cut_path, "wb") as fh:
            fh.write(raw[:cut])
        got = walmod.read_journal(cut_path)
        assert got == ref_wal.read_journal(cut_path), cut
        full = got
    header, dirty, records, torn = full
    assert header == {"session": wal.session, "tier": 2}
    assert dirty == {"ledger-only", "feed0", "feed1"}
    assert [(n, i) for n, i, _ in records] == [
        ("feed0", 0), ("feed1", 0), ("feed0", 1), ("feed1", 1),
    ]
    assert torn == 0
    # garbage after the last record: end of journal, in both packages
    with open(cut_path, "ab") as fh:
        fh.write(os.urandom(64))
    got = walmod.read_journal(cut_path)
    assert got == ref_wal.read_journal(cut_path)
    assert got[2] == records and got[3] > 0
    wal.close()


def test_checkpoint_preserves_dirty_ledger_and_carries_tail(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = WriteAheadLog(path, tier=1)
    s = _Probe()
    wal.append("feedA", 0, b"a" * 100, storage=s)
    wal.append("feedB", 0, b"b" * 100, storage=s)
    assert wal.checkpoint()["synced_feeds"] == 2
    header, dirty, records, torn = read_journal(path)
    assert records == [] and torn == 0
    assert dirty == {"feedA", "feedB"}
    assert header["session"] == wal.session
    wal.append("feedC", 0, b"c", storage=s)
    _h, dirty2, records2, _t = read_journal(path)
    assert ("feedC", 0, b"c") in records2
    assert dirty2 == {"feedA", "feedB", "feedC"}
    wal.close()


# ---------------------------------------------------------------------------
# O(1) fsyncs per commit window


@pytest.mark.parametrize("n_feeds", [2, 8])
def test_tier1_window_is_one_journal_fsync(tmp_path, monkeypatch, n_feeds):
    monkeypatch.setenv("HM_FSYNC", "1")
    monkeypatch.setenv("HM_FSYNC_MS", "10000")  # the test drives the flush
    work = tmp_path / "work"
    rec = F.CrashRecorder(str(work))
    with F.activate(recorder=rec):
        os.makedirs(str(work))
        dm = DurabilityManager()
        dm.attach_wal(WriteAheadLog(str(work / "wal.log"), tier=1))
        stores = [
            FileFeedStorage(str(work / "feeds" / "ab" / f"feed{i}"),
                            durability=dm)
            for i in range(n_feeds)
        ]
        mark = len(rec.events)
        appends0 = _counter("storage.wal.appends")
        fsyncs0 = _counter("storage.wal.fsyncs")
        for s in stores:
            s.append(b"block")  # journal-routed: no per-feed fsync
        assert dm.sync_now() >= 1  # one commit window
        counts = _fsyncs(rec, mark)
        assert counts.get("wal.log") == 1, counts
        assert not any(p.startswith("feeds/") for p in counts), counts
        assert _counter("storage.wal.appends") - appends0 == n_feeds
        assert _counter("storage.wal.fsyncs") - fsyncs0 == 1
        dm.close()


def test_tier2_concurrent_commits_share_leader_fsync(tmp_path, monkeypatch):
    monkeypatch.setenv("HM_FSYNC", "2")
    monkeypatch.setenv("HM_WAL_MS", "30")
    work = tmp_path / "work"
    rec = F.CrashRecorder(str(work))
    with F.activate(recorder=rec):
        os.makedirs(str(work))
        dm = DurabilityManager()
        dm.attach_wal(WriteAheadLog(str(work / "wal.log"), tier=2))
        stores = [
            FileFeedStorage(str(work / "feeds" / "ab" / f"feed{i}"),
                            durability=dm)
            for i in range(8)
        ]
        mark = len(rec.events)
        barrier = threading.Barrier(8)

        def commit_one(s):
            barrier.wait()
            s.append(b"durable-block")  # tier 2: blocks until durable

        ts = [threading.Thread(target=commit_one, args=(s,)) for s in stores]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        counts = _fsyncs(rec, mark)
        assert 1 <= counts.get("wal.log", 0) < 8, counts
        assert not any(p.startswith("feeds/") for p in counts), counts
        dm.close()


# ---------------------------------------------------------------------------
# the port's Repo crashed under the port's recorder


def _acked_repo_workload(work, monkeypatch, tier="1"):
    """A disk repo, 3 docs, interleaved edits, the ack after each round
    the durability flush; one unacked trailing edit. Returns (recorder,
    urls, [(event index, edits per doc acked)])."""
    monkeypatch.setenv("HM_FSYNC", tier)
    rec = F.CrashRecorder(str(work))
    acked = []
    with F.activate(recorder=rec):
        repo = Repo(path=str(work), device="cpu")
        urls = [repo.create({"edits": []}) for _ in range(3)]
        for i in range(4):
            for url in urls:
                repo.change(url, lambda d, i=i: d["edits"].append(i))
            _settle(repo, durable=True)  # the durable ack
            acked.append((len(rec.events), i + 1))
        repo.change(urls[0], lambda d: d["edits"].append(4))
        if repo.back.live is not None:
            repo.back.live.flush_now()
        # crash: no close
    return rec, repo, urls, acked


def _check_prefixes(tmp_path, rec, urls, acked, points, label):
    """Reopen each (point, powercut) replay: never raises, every doc a
    gapless prefix, nothing acked lost under a power cut. Returns the
    storage.wal.replayed count the reopens added."""
    replayed0 = _counter("storage.wal.replayed")
    for k, powercut in points:
        dst = str(tmp_path / f"{label}{k}_{int(powercut)}")
        rec.materialize(dst, k, powercut=powercut)
        repo2 = Repo(path=dst, device="cpu")  # never raises
        try:
            hi = max((m for e, m in acked if e <= k), default=0)
            assert repo2.back.recovery_report is not None, k
            for url in urls:
                if validate_doc_url(url) not in repo2.back.clocks.all_doc_ids(
                    repo2.back.id
                ):
                    assert not (powercut and hi), (k, url)
                    continue
                edits = _edits(repo2, url)
                assert edits == list(range(len(edits))), (k, edits)
                if powercut:
                    assert len(edits) >= hi, (k, len(edits), hi)
        finally:
            repo2.close()
    return _counter("storage.wal.replayed") - replayed0


def test_powercut_replays_acked_blocks_from_journal(tmp_path, monkeypatch):
    """At tier 1 the feed logs are page cache at the ack, so a power cut
    eats them; every acked edit comes back from the fsynced journal."""
    rec, _repo, urls, acked = _acked_repo_workload(
        tmp_path / "work", monkeypatch
    )
    points = [(k, True) for k, _ in (acked[0], acked[2], acked[3])]
    replayed = _check_prefixes(tmp_path, rec, urls, acked, points, "cut")
    assert replayed > 0


def test_powercut_matrix_sampled_prefixes(tmp_path, monkeypatch):
    rec, _repo, urls, acked = _acked_repo_workload(
        tmp_path / "work", monkeypatch
    )
    n = len(rec.events)
    ks = sorted({n // 4, n // 2, 3 * n // 4, n})
    points = [(k, pc) for k in ks for pc in (False, True)]
    _check_prefixes(tmp_path, rec, urls, acked, points, "m")


def test_torn_journal_tail_recovers_acked_prefix(tmp_path, monkeypatch):
    rec, _repo, urls, acked = _acked_repo_workload(
        tmp_path / "work", monkeypatch
    )
    k_ack, want = acked[-1]
    torn = next(
        i for i in range(k_ack, len(rec.events))
        if rec.events[i][0] in (F.APPEND, F.WRITE)
        and rec.events[i][1] == "wal.log"
    )
    dst = str(tmp_path / "torn")
    rec.materialize(dst, torn, partial_last=3)  # 3 bytes of the record
    repo2 = Repo(path=dst, device="cpu")
    try:
        rep = repo2.back.recovery_report
        assert rep is not None and rep["wal"]["torn_bytes"] == 3, rep["wal"]
        for url in urls:
            edits = _edits(repo2, url)
            assert edits[:want] == list(range(want)), (want, edits)
    finally:
        repo2.close()


def test_crash_mid_checkpoint_recovers(tmp_path, monkeypatch):
    """HM_WAL_MAX_BYTES small enough that the workload checkpoints: a
    crash around a rotation replays the old journal idempotently or finds
    the logs durable under the new one."""
    monkeypatch.setenv("HM_WAL_MAX_BYTES", "2048")
    rec, _repo, urls, acked = _acked_repo_workload(
        tmp_path / "work", monkeypatch
    )
    replaces = [i for i, ev in enumerate(rec.events)
                if ev[0] == F.REPLACE and ev[2] == "wal.log"]
    assert replaces, "the workload never checkpointed"
    r = replaces[0]
    points = [(k, pc) for k in (r - 1, r, r + 1) for pc in (False, True)]
    _check_prefixes(tmp_path, rec, urls, acked, points, "ck")


def test_fsync_lie_on_journal_loses_only_unacked(tmp_path, monkeypatch):
    """A lying journal fsync is data loss the power cut shows; recovery
    still never raises and the doc stays a gapless prefix."""
    monkeypatch.setenv("HM_FSYNC", "1")
    work = tmp_path / "work"
    rec = F.CrashRecorder(str(work))
    plan = F.DiskFaultPlan(seed=11, fsync_lie_p=1.0, path_filter="wal.log",
                           after=1)
    with F.activate(plan=plan, recorder=rec):
        repo = Repo(path=str(work), device="cpu")
        url = repo.create({"edits": []})
        for i in range(4):
            repo.change(url, lambda d, i=i: d["edits"].append(i))
        _settle(repo, durable=True)
        k = len(rec.events)
    assert plan.stats["fsync_lies"] >= 1
    dst = str(tmp_path / "cut")
    rec.materialize(dst, k, powercut=True)
    repo2 = Repo(path=dst, device="cpu")
    try:
        edits = _edits(repo2, url)
        assert edits == list(range(len(edits)))
    finally:
        repo2.close()


def test_ack_durable_echo_is_powercut_durable(tmp_path, monkeypatch):
    """HM_ACK_DURABLE=1 at tier 1: the LocalPatch echo is the durable
    ack — every echoed edit survives a power cut with no explicit
    flush."""
    monkeypatch.setenv("HM_FSYNC", "1")
    monkeypatch.setenv("HM_ACK_DURABLE", "1")
    work = tmp_path / "work"
    rec = F.CrashRecorder(str(work))
    with F.activate(recorder=rec):
        repo = Repo(path=str(work), device="cpu")
        url = repo.create({"edits": []})
        done = []
        h = repo.watch(url, lambda d, _i: done.append(len(d.get("edits", []))))
        for i in range(5):
            repo.change(url, lambda d, i=i: d["edits"].append(i))
        if repo.back.live is not None:
            repo.back.live.flush_now()
        wait_until(lambda: done and max(done) == 5)
        repo.back._stores.flush_now()
        h.close()
        k = len(rec.events)
    dst = str(tmp_path / "cut")
    rec.materialize(dst, k, powercut=True)
    repo2 = Repo(path=dst, device="cpu")
    try:
        assert _edits(repo2, url) == list(range(5))
    finally:
        repo2.close()


# ---------------------------------------------------------------------------
# the generation stamp bounds recovery


def _count_recovery_stores(monkeypatch):
    """The feed names the next recovery opens a storage for."""
    from hypermerge_tpu_torch.storage import scrub

    opened = []
    real = scrub._recover_repo

    def counting(back, repair):
        fn = back.feeds._storage_fn

        def wrapped(name):
            opened.append(name)
            return fn(name)

        monkeypatch.setattr(back.feeds, "_storage_fn", wrapped)
        try:
            return real(back, repair)
        finally:
            monkeypatch.setattr(back.feeds, "_storage_fn", fn)

    monkeypatch.setattr(scrub, "_recover_repo", counting)
    return opened


def test_bounded_recovery_opens_only_session_dirty_feeds(tmp_path,
                                                         monkeypatch):
    """Session 1 creates 20 docs and closes clean; session 2 edits one
    and crashes. Recovery opens exactly the crashed session's ledger."""
    monkeypatch.setenv("HM_FSYNC", "1")
    path = str(tmp_path / "r")
    repo = Repo(path=path, device="cpu")
    urls = [repo.create({"n": i}) for i in range(20)]
    _settle(repo)
    repo.close()

    repo2 = Repo(path=path, device="cpu")
    with open(os.path.join(path, "repo.dirty"), "rb") as fh:
        assert fh.read() == repo2.back.durability.wal.session.encode()
    repo2.change(urls[0], lambda d: d.__setitem__("n", 99))
    _settle(repo2, durable=True)
    del repo2  # crash: the marker and the journal stay

    opened = _count_recovery_stores(monkeypatch)
    repo3 = Repo(path=path, device="cpu")
    try:
        rep = repo3.back.recovery_report
        assert rep is not None
        assert rep["wal"]["session_match"] == 1, rep["wal"]
        assert rep["wal"]["bounded"] == 1, rep["wal"]
        ledger = set(rep["wal"]["dirty"])
        assert set(opened) == ledger and 0 < len(ledger) <= 3, opened
        n_feeds = len(repo3.back.feed_info.all_public_ids())
        assert rep["feeds_skipped"] == n_feeds - len(ledger), rep
        assert rep["feeds"] == len(ledger)
        assert (repo3.doc(urls[0]) or {}).get("n") == 99
    finally:
        repo3.close()


def test_stale_marker_after_clean_shutdown_scans_nothing(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("HM_FSYNC", "1")
    path = str(tmp_path / "r")
    repo = Repo(path=path, device="cpu")
    urls = [repo.create({"n": i}) for i in range(10)]
    _settle(repo)
    repo.close()
    header, dirty, records, torn = read_journal(os.path.join(path, "wal.log"))
    assert header is not None and not dirty and not records and not torn
    # the marker a close that failed after its final checkpoint leaves
    with open(os.path.join(path, "repo.dirty"), "wb") as fh:
        fh.write(str(header["session"]).encode())

    opened = _count_recovery_stores(monkeypatch)
    repo2 = Repo(path=path, device="cpu")
    try:
        rep = repo2.back.recovery_report
        assert rep is not None and rep["wal"]["bounded"] == 1, rep
        assert rep["feeds_skipped"] >= 10, rep
        assert opened == [], opened
        for i, url in enumerate(urls):
            assert (repo2.doc(url) or {}).get("n") == i
    finally:
        repo2.close()


def test_unbounded_when_marker_mismatches_journal(tmp_path, monkeypatch):
    monkeypatch.setenv("HM_FSYNC", "1")
    path = str(tmp_path / "r")
    repo = Repo(path=path, device="cpu")
    for i in range(4):
        repo.create({"n": i})
    _settle(repo, durable=True)
    n_feeds = len(repo.back.feed_info.all_public_ids())
    del repo  # crash
    with open(os.path.join(path, "repo.dirty"), "wb") as fh:
        fh.write(b"some-other-session")
    opened = _count_recovery_stores(monkeypatch)
    repo2 = Repo(path=path, device="cpu")
    try:
        rep = repo2.back.recovery_report
        assert rep["wal"]["session_match"] == 0, rep["wal"]
        assert rep["wal"]["bounded"] == 0, rep["wal"]
        assert rep.get("feeds_skipped", 0) == 0, rep
        assert len(set(opened)) == n_feeds == rep["feeds"], opened
    finally:
        repo2.close()


def test_journalless_session_write_invalidates_stale_stamp(tmp_path,
                                                           monkeypatch):
    """HM_RECOVER=0 keeps the crashed marker and journal and runs
    journal-less; its first write breaks the stamp, so a crash of that
    session recovers with the full scan."""
    monkeypatch.setenv("HM_FSYNC", "1")
    path = str(tmp_path / "r")
    repo = Repo(path=path, device="cpu")
    url = repo.create({"n": 1})
    _settle(repo, durable=True)
    del repo  # crash A

    monkeypatch.setenv("HM_RECOVER", "0")
    with open(os.path.join(path, "wal.log"), "rb") as fh:
        journal_a = fh.read()
    repo2 = Repo(path=path, device="cpu")
    assert repo2.back.recovery_report is None
    assert repo2.back.durability.wal is None
    with open(os.path.join(path, "repo.dirty"), "rb") as fh:
        stamp_before = fh.read()
    with open(os.path.join(path, "wal.log"), "rb") as fh:
        assert fh.read() == journal_a  # kept for a manual recovery
    repo2.change(url, lambda d: d.__setitem__("n", 2))
    _settle(repo2, durable=True)
    with open(os.path.join(path, "repo.dirty"), "rb") as fh:
        assert fh.read() == stamp_before + b"+journalless"
    del repo2  # crash B: its feeds are not in A's ledger

    monkeypatch.setenv("HM_RECOVER", "1")
    repo3 = Repo(path=path, device="cpu")
    try:
        rep = repo3.back.recovery_report
        assert rep is not None
        assert rep["wal"]["session_match"] == 0, rep["wal"]
        assert rep["wal"]["bounded"] == 0, rep["wal"]
        assert rep.get("feeds_skipped", 0) == 0, rep
        assert (repo3.doc(url) or {}).get("n") == 2
    finally:
        repo3.close()


def test_wal_off_session_runs_journal_less(tmp_path, monkeypatch):
    """HM_WAL=0: no journal, an empty stamp, and a crash recovers with
    the full scan."""
    monkeypatch.setenv("HM_WAL", "0")
    path = str(tmp_path / "r")
    repo = Repo(path=path, device="cpu")
    assert repo.back.durability.wal is None
    assert not os.path.exists(os.path.join(path, "wal.log"))
    with open(os.path.join(path, "repo.dirty"), "rb") as fh:
        assert fh.read() == b""
    url = repo.create({"n": 1})
    _settle(repo)
    del repo
    repo2 = Repo(path=path, device="cpu")
    try:
        rep = repo2.back.recovery_report
        assert rep["wal"]["present"] == 0 and rep["wal"]["bounded"] == 0
        assert (repo2.doc(url) or {}).get("n") == 1
    finally:
        repo2.close()


# ---------------------------------------------------------------------------
# the journal's failure paths


def test_checkpoint_sync_failure_keeps_all_remaining_pending(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.log"), tier=1)
    a, b, c = _Probe(), _Probe(fail=True), _Probe()
    for name, probe in (("aa", a), ("bb", b), ("cc", c)):
        assert wal.append(name, 0, b"x", probe) is not None
    assert wal.checkpoint()["synced_feeds"] == 1
    assert a.synced == 1 and c.synced == 0
    assert set(wal._ckpt_pending) == {"bb", "cc"}
    _h, _dirty, records, _t = read_journal(str(tmp_path / "wal.log"))
    assert {n for n, _i, _d in records} == {"aa", "bb", "cc"}
    b.fail = False
    assert wal.checkpoint()["synced_feeds"] == 2 and not wal._ckpt_pending


def test_commit_after_failed_close_raises_not_acks(tmp_path, monkeypatch):
    wal = WriteAheadLog(str(tmp_path / "wal.log"), tier=2)
    wal.commit(wal.append("aa", 0, b"x"))
    end2 = wal.append("aa", 1, b"y")

    def broken_fsync(_fh):
        raise OSError("EIO")

    monkeypatch.setattr(walmod, "io_fsync", broken_fsync)
    assert wal.close() is False
    with pytest.raises(OSError):
        wal.commit(end2)


def _bare_back(work, storage_fn):
    from types import SimpleNamespace

    return SimpleNamespace(
        path=str(work),
        feeds=SimpleNamespace(_storage_fn=storage_fn),
        durability=SimpleNamespace(),
    )


def test_dry_run_replay_preview_matches_repair_on_gap(tmp_path):
    work = tmp_path / "w"
    os.makedirs(str(work / "feeds" / "aa"))
    st = FileFeedStorage(str(work / "feeds" / "aa" / "aafeed"))
    st.append(b"b0")
    st.close()
    wal = WriteAheadLog(str(work / "wal.log"), tier=1)
    assert wal.append("aafeed", 1, b"b1") is not None  # contiguous
    assert wal.append("aafeed", 3, b"b3") is not None  # a gap: no 2
    wal.sync()

    def fn(name):
        return FileFeedStorage(str(work / "feeds" / "aa" / name))

    dry = walmod.recover(_bare_back(work, fn), repair=False)
    real = walmod.recover(_bare_back(work, fn), repair=True)
    assert dry["replay_would"] == 1, dry
    assert real["replayed"] == 1 and real["skipped"] == 1, real


def test_replay_sync_failure_preserves_journal(tmp_path):
    work = tmp_path / "w"
    os.makedirs(str(work / "feeds" / "aa"))
    wal = WriteAheadLog(str(work / "wal.log"), tier=1)
    assert wal.append("aafeed", 0, b"b0") is not None
    wal.sync()

    class _FailingSyncStorage(FileFeedStorage):
        def sync(self):
            raise OSError("EIO")

    def failing_fn(name):
        return _FailingSyncStorage(str(work / "feeds" / "aa" / name))

    def ok_fn(name):
        return FileFeedStorage(str(work / "feeds" / "aa" / name))

    rep = walmod.recover(_bare_back(work, failing_fn), repair=True)
    assert rep["replayed"] == 1 and rep.get("replay_sync_failed") == 1
    assert os.path.exists(str(work / "wal.log"))  # not consumed
    rep2 = walmod.recover(_bare_back(work, ok_fn), repair=True)
    assert rep2["skipped"] == 1 and "replay_sync_failed" not in rep2
    assert not os.path.exists(str(work / "wal.log"))


def test_reference_recover_replays_the_port_journal(tmp_path):
    """A journal the port wrote replays through the reference's
    `recover`, and the reverse, into the same feed bytes."""
    logs = {}
    for writer, reader in (("port", ref_wal), ("ref", walmod)):
        work = tmp_path / writer
        os.makedirs(str(work / "feeds" / "aa"))
        wal = WALS[writer].WriteAheadLog(str(work / "wal.log"), tier=1)
        for i in range(3):
            wal.append("aafeed", i, b"block-%d" % i)
        wal.sync()

        def fn(name, work=work):
            return FileFeedStorage(str(work / "feeds" / "aa" / name))

        rep = reader.recover(_bare_back(work, fn), repair=True)
        assert rep["replayed"] == 3, rep
        with open(work / "feeds" / "aa" / "aafeed", "rb") as fh:
            logs[writer] = fh.read()
    assert logs["port"] == logs["ref"]
