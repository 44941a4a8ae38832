"""The cases of tests/test_wal.py not already twinned elsewhere, under
their own names on the port's write-ahead journal
(hypermerge_tpu_torch/storage/wal.py, durability.py, feed.py) and the
recovery on open of a port `Repo(path, device="cpu")`, beside
tests/test_torch_wal.py. Each value a case checks is also held against
the reference package: its `Repo` reopening a copy of each crash prefix
the port reopened reads the same edits, its `read_journal` parses the
port's journal to the same records, and its durability manager fsyncs
the same paths at the ack; tolerance 0.

The twinned file's own docstring follows.

Group-commit WAL (storage/wal.py): counters, crash matrix, bounded
recovery.

The seeded crash matrix of tests/test_crash.py extended to the shared
journal — every byte the WAL writes goes through the storage/faults.py
io seam, so kill -9 / power-cut replays cover journal writes, the
group-commit fsync, fsync LIES, and the checkpoint tmp+rename.
"""

import os
import shutil

from hypermerge_tpu.storage import faults as RF
from hypermerge_tpu.storage import wal as ref_wal
from hypermerge_tpu_torch.storage import faults as F
from hypermerge_tpu_torch.storage.durability import DurabilityManager
from hypermerge_tpu_torch.storage.feed import FileFeedStorage
from hypermerge_tpu_torch.storage.wal import WriteAheadLog, read_journal
from port_helpers import REF_SWITCHES, Repo, env_vars


def _acked_repo_workload(work, monkeypatch, tier="1"):
    """Disk repo, 3 docs, interleaved edits; ack point = durability
    flush. Returns (recorder, repo, url_list, acked list of
    (event_index, edits_per_doc))."""
    monkeypatch.setenv("HM_FSYNC", tier)
    rec = F.CrashRecorder(str(work))
    acked = []
    with F.activate(recorder=rec):
        repo = Repo(path=str(work))
        urls = [repo.create({"edits": []}) for _ in range(3)]
        for i in range(4):
            for url in urls:
                repo.change(url, lambda d, i=i: d["edits"].append(i))
            if repo.back.live is not None:
                repo.back.live.flush_now()
            repo.back._stores.flush_now()
            repo.back._cache_syncs.flush_now()
            repo.back.durability.flush_now()  # the durable ack
            acked.append((len(rec.events), i + 1))
        # one UN-acked trailing edit: a journal append after the last
        # ack to tear into
        repo.change(urls[0], lambda d: d["edits"].append(4))
        if repo.back.live is not None:
            repo.back.live.flush_now()
        # crash: no close
    return rec, repo, urls, acked


def _ref_state(path, urls):
    """{url: edits or None} of the reference Repo on a copy of `path`."""
    from hypermerge_tpu.repo import Repo as RefRepo
    from hypermerge_tpu.utils.ids import validate_doc_url

    copy = f"{path}-ref"
    shutil.copytree(path, copy)
    with env_vars(**{**REF_SWITCHES, "HM_FSYNC": "1"}):
        r = RefRepo(path=copy)
        try:
            have = r.back.clocks.all_doc_ids(r.back.id)
            return {
                u: (list((r.doc(u) or {}).get("edits", []))
                    if validate_doc_url(u) in have else None)
                for u in urls
            }
        finally:
            r.close()


def test_powercut_matrix_every_prefix_never_raises(
    tmp_path, monkeypatch
):
    """Kill/power-cut at EVERY sampled journal-era prefix: reopen
    (journal replay included) never raises and each doc reads back a
    gapless prefix of its acked edits — the same edits the reference
    reads on a copy of the prefix."""
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    work = tmp_path / "work"
    rec, _repo, urls, acked = _acked_repo_workload(
        work, monkeypatch, tier="1"
    )
    n = len(rec.events)
    step = max(1, n // 12)
    for k in range(0, n + 1, step):
        for powercut in (False, True):
            dst = str(tmp_path / f"c{k}_{int(powercut)}")
            rec.materialize(dst, k, powercut=powercut)
            ref_dst = str(tmp_path / f"r{k}_{int(powercut)}")
            shutil.copytree(dst, ref_dst)
            repo2 = Repo(path=dst)  # never raises
            got = {}
            try:
                hi = max((m for e, m in acked if e <= k), default=0)
                for url in urls:
                    doc_id = validate_doc_url(url)
                    if doc_id not in repo2.back.clocks.all_doc_ids(
                        repo2.back.id
                    ):
                        # crashed before this doc's first commit; the
                        # acked_lost gate still applies (hi == 0 then)
                        assert not (powercut and hi), (k, doc_id)
                        got[url] = None
                        continue
                    v = repo2.doc(url)
                    edits = list((v or {}).get("edits", []))
                    assert edits == list(range(len(edits))), (k, edits)
                    if powercut:
                        # acked_lost == 0: everything flushed before
                        # the cut survived it
                        assert len(edits) >= hi, (k, len(edits), hi)
                    got[url] = edits
            finally:
                repo2.close()
            assert _ref_state(ref_dst, urls) == got, (k, powercut)


def test_read_journal_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = WriteAheadLog(path, tier=1)
    wal.append("feedA", 0, b"alpha")
    wal.append("feedB", 0, b"beta")
    wal.append("feedA", 1, b"gamma")
    header, dirty, records, torn = read_journal(path)
    assert header is not None and header["tier"] == 1
    assert header["session"] == wal.session
    assert dirty == {"feedA", "feedB"}
    assert records == [
        ("feedA", 0, b"alpha"),
        ("feedB", 0, b"beta"),
        ("feedA", 1, b"gamma"),
    ]
    assert torn == 0
    assert ref_wal.read_journal(path) == (header, dirty, records, torn)
    # tear the tail mid-record: the parse stops cleanly before it
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size - 4)
    h2, dirty2, records2, torn2 = read_journal(path)
    assert records2 == records[:2]
    assert torn2 > 0
    assert "feedA" in dirty2 and "feedB" in dirty2
    assert ref_wal.read_journal(path) == (h2, dirty2, records2, torn2)
    # garbage instead of a record header: also end-of-journal
    with open(path, "ab") as fh:
        fh.write(os.urandom(64))
    h3, d3, records3, torn3 = read_journal(path)
    assert records3 == records[:2] and torn3 > 0
    assert ref_wal.read_journal(path) == (h3, d3, records3, torn3)
    wal.close()


def test_concurrent_append_and_sync_share_write_handles(tmp_path):
    """The cached write handles are shared between the appender and
    the WAL checkpoint thread's sync(): interleaved use must leave a
    consistent .len sidecar, which the reference's storage reads too."""
    import threading

    from hypermerge_tpu.storage.feed import FileFeedStorage as RefStorage

    st = FileFeedStorage(str(tmp_path / "ab" / "feed"))
    stop = threading.Event()
    errs = []

    def syncer():
        while not stop.is_set():
            try:
                st.sync()
            except Exception as e:  # noqa: BLE001 - any escape fails
                errs.append(e)
                return

    t = threading.Thread(target=syncer)
    t.start()
    try:
        for i in range(400):
            st.append(b"b" * (i % 17 + 1))
    finally:
        stop.set()
        t.join(10)
    assert not errs, errs
    st.close()
    fresh = FileFeedStorage(st.path)
    assert fresh._try_count_shortcut(), ".len torn or stale"
    assert len(fresh) == 400
    fresh.close()
    shutil.copytree(tmp_path / "ab", tmp_path / "ref" / "ab")
    ref = RefStorage(str(tmp_path / "ref" / "ab" / "feed"))
    assert ref._try_count_shortcut(), "the reference rejects the .len"
    assert len(ref) == 400
    assert [ref.get(i) for i in (0, 16, 399)] == [
        b"b" * (i % 17 + 1) for i in (0, 16, 399)]
    ref.close()


def test_commit_ack_covers_unjournaled_legacy_appends(
    tmp_path, monkeypatch
):
    """HM_ACK_DURABLE: commit_ack's journal fsync only vouches for
    blocks the journal holds. An append that fell back to the legacy
    path (broken journal) was mark_dirty'd instead — commit_ack must
    drain the legacy barrier too. The reference's manager, driven the
    same way, fsyncs the same paths at its ack."""
    from hypermerge_tpu.storage.durability import (
        DurabilityManager as RefDurability,
    )
    from hypermerge_tpu.storage.feed import FileFeedStorage as RefStorage

    monkeypatch.setenv("HM_FSYNC", "1")
    monkeypatch.setenv("HM_FSYNC_MS", "10000")  # no background flush
    fsynced = []
    for faults, dm_cls, wal_cls, st_cls, name in (
        (F, DurabilityManager, WriteAheadLog, FileFeedStorage, "port"),
        (RF, RefDurability, ref_wal.WriteAheadLog, RefStorage, "ref"),
    ):
        work = tmp_path / name
        rec = faults.CrashRecorder(str(work))
        with faults.activate(recorder=rec):
            os.makedirs(str(work))
            dm = dm_cls()
            wal = wal_cls(str(work / "wal.log"), tier=1)
            dm.attach_wal(wal)
            st = st_cls(
                str(work / "feeds" / "ab" / "feed0"), durability=dm
            )
            # break the journal mid-session: appends now fall back to
            # the legacy per-feed path (mark_dirty)
            with wal._cv:
                wal._closed = True
            st.append(b"block")
            mark = len(rec.events)
            dm.commit_ack()  # the durable ack point
            counts = {ev[1] for ev in rec.events[mark:]
                      if ev[0] == faults.FSYNC and not ev[2]}
            assert any(
                p.startswith("feeds/") for p in counts
            ), f"legacy append not fsynced at ack ({name}): {counts}"
            fsynced.append(sorted(counts))
            dm.close()
    assert fsynced[0] == fsynced[1]
