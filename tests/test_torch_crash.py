"""Recovery on open: the port's `Repo(path)` reopening a crashed directory
(hypermerge_tpu_torch/storage/scrub.py, wal.py and the backend's open)
against the JAX package's on a copy of the same directory, on the CPU.

- Recovery parity. The reference's `CrashRecorder` records the
  reference `Repo`'s mixed workload (two docs, edits acked round by
  round, as tests/test_crash.py `test_whole_repo_kill_anywhere` does)
  with HM_LIVE 1 and 0, and under HM_FSYNC=1 with the journal, replayed
  as a power cut. Each sampled prefix is materialized twice; the
  reference reopens one copy and the port the other, and then: the
  recovery reports are equal but for `t_recover_ms`; every file under
  `feeds/` (block logs, .len, .sig, the corpus slab) is the same bytes;
  the sqlite clock rows are equal; `open_many` + `fetch_bulk_summaries`
  give byte-equal summaries; the doc values are equal. The reference
  matrix samples 5 prefixes a case where tests/test_crash.py samples
  15.
- The port's own workload under the port's recorder: every sampled
  prefix reopens with the port to a gapless prefix of the acked edits,
  bounded by the acks, and stays writable; the reference opens a copy
  of the same prefix to the same state.
- The repo-level recovery cases of tests/test_crash.py on the port:
  clock rows ahead of the feeds clamped (and the columnar sidecar that
  ran ahead of its log reset, with the summaries equal to the
  reference's), a clean close skipping recovery, actor keys kept across
  a reopen, an unsigned tail sealed, the marker surviving a power cut,
  a dry run reporting what a repair would do, and the per-doc verdicts.

The crash cases that need the network: `test_crash_recover_reconverges_
with_clean_twin` runs on the port in tests/test_torch_net.py; the two
anti-entropy cases and the worker-process kill
`test_worker_sigkill_midburst_acked_lost_zero` wait for net/faults.py
and the hub (ROADMAP.md Queue 1 items 1(b) and 1(d)). Tolerance: exact.
"""

import os
import shutil
import sqlite3

import pytest

from hypermerge_tpu.models import Text as RefText
from hypermerge_tpu.repo import Repo as RefRepo
from hypermerge_tpu.storage import faults as RF
from hypermerge_tpu_torch import telemetry
from hypermerge_tpu_torch.models import Text
from hypermerge_tpu_torch.repo import Repo
from hypermerge_tpu_torch.storage import faults as F
from hypermerge_tpu_torch.storage.feed import FileFeedStorage
from hypermerge_tpu_torch.storage.scrub import (
    doc_status,
    last_report,
    recover_repo,
    wal_status,
)
from hypermerge_tpu_torch.utils.ids import validate_doc_url

from helpers import wait_until
from test_torch_faults import _tree
from test_torch_repo import _assert_rows_equal, _summary_rows, plain
from test_torch_wal import _settle

# both packages' switches the port runs off; the port's bulk open serial
# like the reference's, so the two open the same slabs
OFF = {"HM_SERVICE": "0", "HM_PIPELINE": "0"}


def _sample_points(n, want=4):
    step = max(1, n // want)
    return sorted(set(range(0, n, step)) | {n})


def _materialize_twice(rec, tmp_path, k, powercut):
    """Two copies of the crash after event k (copied, never linked:
    recovery writes through the files)."""
    a, b = tmp_path / f"ref{k}", tmp_path / f"port{k}"
    rec.materialize(str(a), k, powercut=powercut)
    shutil.copytree(a, b)
    return a, b


def _clock_rows(path):
    conn = sqlite3.connect(os.path.join(path, "repo.db"))
    try:
        return conn.execute(
            "SELECT repo_id, doc_id, actor_id, seq FROM clocks ORDER BY "
            "repo_id, doc_id, actor_id"
        ).fetchall()
    finally:
        conn.close()


def _report(r):
    rep = r.back.recovery_report
    if rep is None:
        return None
    return {k: v for k, v in rep.items() if k != "t_recover_ms"}


def _workload(mod, repo_cls, text_cls, work, rounds=5, durable=False):
    """Two docs — a list of edits and a doc with text and a map — edited
    round by round, each round acked once its flushers settled. Returns
    (recorder, urls, [(event index, rounds acked)], last event index)."""
    rec = mod.CrashRecorder(str(work))
    acked = []
    with mod.activate(recorder=rec):
        repo = repo_cls(path=str(work))
        urls = [repo.create({"edits": []}),
                repo.create({"t": text_cls("seed"), "m": {}})]
        for i in range(rounds):
            repo.change(urls[0], lambda d, i=i: d["edits"].append(i))
            repo.change(urls[1], lambda d, i=i: d["t"].insert(0, "ab"[i % 2]))
            repo.change(urls[1], lambda d, i=i: d["m"].__setitem__(f"k{i}", i))
            _settle(repo, durable)
            acked.append((rec.n_points - 1, i + 1))
        k_max = rec.n_points - 1
        if durable:
            return rec, urls, acked, k_max  # crash: no close
        repo.close()
    return rec, urls, acked, k_max


def _open_both(ref_dir, port_dir):
    ref = RefRepo(path=str(ref_dir))
    try:
        port = Repo(path=str(port_dir), device="cpu")
    except BaseException:
        ref.close()
        raise
    return ref, port


def _hold_equal(ref, port, ref_dir, port_dir, urls):
    """The two reopened copies hold the same state; returns the doc ids
    the crash left. The flushers settle first: a seal's .len sidecar is
    rewritten by the durability flusher after the open returns."""
    for r in (ref, port):
        _settle(r, durable=True)
    assert _report(port) == _report(ref)
    assert _tree(port_dir / "feeds") == _tree(ref_dir / "feeds")
    assert _clock_rows(str(port_dir)) == _clock_rows(str(ref_dir))
    present = set(ref.back.clocks.all_doc_ids(ref.back.id))
    assert set(port.back.clocks.all_doc_ids(port.back.id)) == present
    live = [u for u in urls if validate_doc_url(u) in present]
    if live:
        ids = [validate_doc_url(u) for u in live]
        for r in (ref, port):
            r.open_many(live)
        want = _summary_rows(ref.back.fetch_bulk_summaries(), ids)
        got = _summary_rows(port.back.fetch_bulk_summaries(), ids)
        _assert_rows_equal(got, want)
        for u in live:
            assert plain(port.doc(u)) == plain(ref.doc(u)), u
    return present


def _check_acked(repo, urls, present, hi, durable):
    """The list doc holds a gapless prefix bounded by the acks (and
    covering them when the acks were durable)."""
    if validate_doc_url(urls[0]) not in present:
        assert not (durable and hi), hi
        return
    edits = list((repo.doc(urls[0]) or {}).get("edits", []))
    assert edits == list(range(len(edits))), edits
    assert len(edits) <= hi + 1, (len(edits), hi)
    if durable:
        assert len(edits) >= hi, (len(edits), hi)


# ---------------------------------------------------------------------------
# recovery parity over the reference's crashes


CASES = {
    "live1": dict(HM_LIVE="1"),
    "live0": dict(HM_LIVE="0"),
    "fsync1_powercut": dict(HM_LIVE="1", HM_FSYNC="1"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_recovery_parity_reference_crash(tmp_path, monkeypatch, case):
    for k, v in dict(OFF, **CASES[case]).items():
        monkeypatch.setenv(k, v)
    durable = "HM_FSYNC" in CASES[case]
    rec, urls, acked, k_max = _workload(
        RF, RefRepo, RefText, tmp_path / "work", durable=durable
    )
    replayed = 0
    for k in _sample_points(k_max):
        a, b = _materialize_twice(rec, tmp_path, k, durable)
        ref, port = _open_both(a, b)
        try:
            present = _hold_equal(ref, port, a, b, urls)
            hi = max((m for e, m in acked if e <= k), default=0)
            _check_acked(port, urls, present, hi, durable)
            rep = port.back.recovery_report
            if rep is not None:
                replayed += rep["wal"]["replayed"]
        finally:
            ref.close()
            port.close()
    if durable:
        # the power cut dropped acked log bytes the port replayed from
        # the reference's journal
        assert replayed > 0


# ---------------------------------------------------------------------------
# the port's own crashes


@pytest.mark.parametrize("case", list(CASES))
def test_port_crash_invariants_and_reference_reopen(tmp_path, monkeypatch,
                                                    case):
    for k, v in dict(OFF, **CASES[case]).items():
        monkeypatch.setenv(k, v)
    durable = "HM_FSYNC" in CASES[case]

    class PortRepo(Repo):
        def __init__(self, path):
            super().__init__(path=path, device="cpu")

    rec, urls, acked, k_max = _workload(
        F, PortRepo, Text, tmp_path / "work", durable=durable
    )
    for k in _sample_points(k_max):
        a, b = _materialize_twice(rec, tmp_path, k, durable)
        ref, port = _open_both(a, b)
        try:
            present = _hold_equal(ref, port, a, b, urls)
            hi = max((m for e, m in acked if e <= k), default=0)
            _check_acked(port, urls, present, hi, durable)
            if validate_doc_url(urls[0]) in present:
                # the recovered repo stays writable
                port.change(urls[0], lambda d: d["edits"].append(777))
                wait_until(lambda: 777 in (port.doc(urls[0]) or {}).get(
                    "edits", []))
        finally:
            ref.close()
            port.close()


# ---------------------------------------------------------------------------
# repo-level recovery cases


def _mk_repo_with_doc(path, n_edits=5):
    repo = Repo(path=str(path), device="cpu")
    url = repo.create({"edits": []})
    for i in range(n_edits):
        repo.change(url, lambda d, i=i: d["edits"].append(i))
    if repo.back.live is not None:
        repo.back.live.flush_now()
    return repo, url


def test_clocks_ahead_of_feeds_reconciled_on_open(tmp_path, monkeypatch):
    """The feed loses its last two blocks out of band (the direction a
    power cut can produce) under a sidecar that already holds them: the
    reopen clamps the clock row, resets the sidecar that ran ahead of its
    log, and the summaries equal the reference's recovery of a copy."""
    for k, v in OFF.items():
        monkeypatch.setenv(k, v)
    repo, url = _mk_repo_with_doc(tmp_path / "r")
    doc_id = validate_doc_url(url)
    actor = max(repo.back.docs[doc_id].clock.items(), key=lambda kv: kv[1])[0]
    repo.close()
    s = FileFeedStorage(str(tmp_path / "r" / "feeds" / actor[:2] / actor))
    n = len(s)
    s.truncate_to(n - 2)
    s.close()
    open(str(tmp_path / "r" / "repo.dirty"), "wb").close()
    shutil.copytree(tmp_path / "r", tmp_path / "ref")
    ref, port = _open_both(tmp_path / "ref", tmp_path / "r")
    try:
        rep = port.back.recovery_report
        assert rep["clock_rows_clamped"] >= 1, rep
        assert rep["colcache_reset"] >= 1, rep
        assert port.back.clocks.get(port.back.id, doc_id)[actor] == n - 2
        _hold_equal(ref, port, tmp_path / "ref", tmp_path / "r", [url])
        edits = list(port.doc(url).get("edits", []))
        assert edits == list(range(len(edits))) and len(edits) == n - 3
        assert last_report(str(tmp_path / "r")) is not None
        assert doc_status(port.back, doc_id, rep) == "recovered"
        assert wal_status(rep, [actor]) == "clean"
    finally:
        ref.close()
        port.close()


def test_clean_close_skips_recovery(tmp_path):
    repo, url = _mk_repo_with_doc(tmp_path / "r")
    repo.close()
    assert not os.path.exists(str(tmp_path / "r" / "repo.dirty"))
    repo2 = Repo(path=str(tmp_path / "r"), device="cpu")
    try:
        assert repo2.back.recovery_report is None
        assert os.path.exists(str(tmp_path / "r" / "repo.dirty"))
    finally:
        repo2.close()


def test_actor_keys_persist_across_reopen(tmp_path):
    repo, url = _mk_repo_with_doc(tmp_path / "r", n_edits=3)
    doc_id = validate_doc_url(url)
    before = set(repo.back.cursors.get(repo.back.id, doc_id))
    repo.close()
    repo2 = Repo(path=str(tmp_path / "r"), device="cpu")
    try:
        assert repo2.open(url).value(timeout=30) is not None
        repo2.change(url, lambda d: d["edits"].append(99))
        if repo2.back.live is not None:
            repo2.back.live.flush_now()
        doc = repo2.back.docs[doc_id]
        wait_until(lambda: sum(doc.clock.values()) >= 5)
        # the reopened session wrote through an existing actor
        assert set(repo2.back.cursors.get(repo2.back.id, doc_id)) == before
    finally:
        repo2.close()


def test_scrub_seals_unsigned_tail_on_writable_feed(tmp_path):
    from hypermerge_tpu_torch.storage.integrity import AUDIT_OK

    repo, url = _mk_repo_with_doc(tmp_path / "r", n_edits=4)
    repo.back._stores.flush_now()
    repo.back._cache_syncs.flush_now()
    del repo  # crash: writable feeds keep their unsigned tails
    repo2 = Repo(path=str(tmp_path / "r"), device="cpu")
    try:
        rep = repo2.back.recovery_report
        assert rep["unsigned_tails_sealed"] >= 1, rep
        for pk in repo2.back.feed_info.all_public_ids():
            feed = repo2.back.feeds.open_feed(pk)
            if feed.length:
                assert feed.audit_status() == AUDIT_OK, pk
    finally:
        repo2.close()


def test_dirty_marker_survives_powercut(tmp_path):
    work = tmp_path / "work"
    rec = F.CrashRecorder(str(work))
    with F.activate(recorder=rec):
        repo = Repo(path=str(work), device="cpu")
        repo.create({"n": 1})
        _settle(repo)
        k_max = rec.n_points - 1
    dst = str(tmp_path / "cut")
    rec.materialize(dst, k_max, powercut=True)
    assert os.path.exists(os.path.join(dst, "repo.dirty"))
    recoveries0 = telemetry.snapshot().get("storage.recoveries", 0)
    repo2 = Repo(path=dst, device="cpu")
    try:
        assert repo2.back.recovery_report is not None
        assert telemetry.snapshot()["storage.recoveries"] == recoveries0 + 1
    finally:
        repo2.close()


def test_dry_run_reports_would_do_repairs(tmp_path, monkeypatch):
    from hypermerge_tpu_torch.backend.repo_backend import RepoBackend

    repo, url = _mk_repo_with_doc(tmp_path / "r", n_edits=4)
    repo.back._stores.flush_now()
    repo.back._cache_syncs.flush_now()
    del repo  # crash: unsigned tails remain
    monkeypatch.setenv("HM_RECOVER", "0")
    back = RepoBackend(path=str(tmp_path / "r"), device="cpu")
    try:
        assert back.recovery_report is None
        dry = recover_repo(back, repair=False)
        assert dry["unsigned_tails_sealed"] >= 1 and dry["per_feed"], dry
        again = recover_repo(back, repair=False)
        assert again["unsigned_tails_sealed"] == dry["unsigned_tails_sealed"]
        assert recover_repo(back, repair=True)["unsigned_tails_sealed"] >= 1
        after = recover_repo(back, repair=False)
        assert after["unsigned_tails_sealed"] == 0, after
    finally:
        back.close()
