"""The cases of tests/test_crash.py not already twinned elsewhere, under
their own names on the port's crash-consistent storage
(hypermerge_tpu_torch/storage/faults.py and the recovery on open of a
port `Repo(path, device="cpu")`), beside tests/test_torch_crash.py and
tests/test_torch_faults.py. Each value a case checks is also held
against the reference package: its `DiskFaultPlan` gives the same fates
for the same seed, and its `Repo` reopening a copy of each sampled crash
prefix the port reopened reads the same edits; tolerance 0.

`test_multi_cycle_crash_recover_soak` keeps the reference's `slow` mark.

The twinned file's own docstring follows.

Crash-consistent storage: seeded disk faults + kill-anywhere matrix.

The storage twin of tests/test_chaos.py. A CrashRecorder
(storage/faults.py) records the write/fsync/commit schedule of a
workload; every prefix replays as a simulated crash and the recovery
invariants are asserted on reopen:

  - reopen never raises (whatever boundary the crash landed on);
  - recovered state is a gapless PREFIX of acknowledged state;
  - anything acknowledged under the durable tier (HM_FSYNC) survives
    a simulated power cut;
  - a crashed-then-recovered repo reconverges bit-identically to a
    clean twin after resync (HM_LIVE=1/0 both).

Plus deterministic fault-plan units (same seed = same schedule) and
targeted ENOSPC/EIO injection on the append paths.
"""

import os
import shutil

import pytest

from hypermerge_tpu.storage import faults as RF
from hypermerge_tpu_torch.storage import faults as F
from port_helpers import Repo, env_vars, REF_SWITCHES, wait_until


def _ref_edits(path, url, **env):
    """The reference Repo's `edits` of url on a copy of the repo
    directory `path` (None when the doc is not in its clock store)."""
    from hypermerge_tpu.repo import Repo as RefRepo
    from hypermerge_tpu.utils.ids import validate_doc_url

    copy = f"{path}-ref"
    shutil.copytree(path, copy)
    with env_vars(**{**REF_SWITCHES, **env}):
        r = RefRepo(path=copy)
        try:
            if validate_doc_url(url) not in r.back.clocks.all_doc_ids(
                    r.back.id):
                return None
            v = r.open(url).value(timeout=30)
            return list(v.get("edits", []))
        finally:
            r.close()


# ---------------------------------------------------------------------------
# fault-plan determinism


def test_fault_plan_same_seed_same_schedule():
    def fates(mod, seed):
        plan = mod.DiskFaultPlan(
            seed=seed, write_error_p=0.2, torn_write_p=0.2,
            fsync_error_p=0.1, fsync_lie_p=0.2,
        )
        out = []
        for i in range(40):
            out.append(plan.write_fate("a/log", 64 + i))
            out.append(plan.fsync_fate("a/log"))
        return out

    assert fates(F, 7) == fates(F, 7)
    assert fates(F, 7) != fates(F, 8)  # and the seed actually matters
    assert fates(F, 7) == fates(RF, 7) and fates(F, 8) == fates(RF, 8)


def test_fault_plan_per_path_streams_independent():
    """Which op of a path faults must not depend on how OTHER paths
    interleave (the per-direction-stream property of net FaultPlan)."""
    solos = []
    for mod in (F, RF):
        plan1 = mod.DiskFaultPlan(seed=3, write_error_p=0.3)
        solo = [plan1.write_fate("x", 8) for _ in range(20)]
        plan2 = mod.DiskFaultPlan(seed=3, write_error_p=0.3)
        mixed = []
        for _ in range(20):
            mixed.append(plan2.write_fate("x", 8))
            plan2.write_fate("y", 8)  # interleaved traffic on another path
        assert solo == mixed
        solos.append(solo)
    assert solos[0] == solos[1]  # the port's fates == the reference's


def test_fault_plan_after_grace_period():
    for mod in (F, RF):
        plan = mod.DiskFaultPlan(seed=1, write_error_p=1.0, after=3)
        for _ in range(3):
            assert plan.write_fate("p", 4)[0] == "ok"
        assert plan.write_fate("p", 4)[0] == "error"


# ---------------------------------------------------------------------------
# whole-repo kill-anywhere matrix


def _sample_points(n, want=14):
    step = max(1, n // want)
    return sorted(set(range(0, n, step)) | {n})


@pytest.mark.parametrize("live", ["1", "0"])
def test_whole_repo_kill_anywhere(tmp_path, monkeypatch, live):
    """Mixed workload under a CrashRecorder; every sampled prefix
    reopens with zero recovery-invariant violations: reopen (incl.
    recovery) never raises, the doc reads back a gapless prefix of the
    acked edits, and the repo stays writable. The reference reopens a
    copy of each prefix to the same edits."""
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    monkeypatch.setenv("HM_LIVE", live)
    work = tmp_path / "work"
    rec = F.CrashRecorder(str(work))
    acked = []
    with F.activate(recorder=rec):
        repo = Repo(path=str(work))
        url = repo.create({"edits": []})
        for i in range(8):
            repo.change(url, lambda d, i=i: d["edits"].append(i))
            if repo.back.live is not None:
                repo.back.live.flush_now()
            repo.back._stores.flush_now()
            repo.back._cache_syncs.flush_now()
            acked.append((rec.n_points - 1, i + 1))
        k_max = rec.n_points - 1
        repo.close()
    doc_id = validate_doc_url(url)
    for k in _sample_points(k_max):
        dst = str(tmp_path / f"c{k}")
        rec.materialize(dst, k)
        ref_dst = str(tmp_path / f"r{k}")
        shutil.copytree(dst, ref_dst)
        repo2 = Repo(path=dst)  # reopen + recovery: must not raise
        try:
            if doc_id not in repo2.back.clocks.all_doc_ids(
                repo2.back.id
            ):
                assert _ref_edits(ref_dst, url) is None, k
                continue  # crashed before the doc's first commit
            h = repo2.open(url)
            v = h.value(timeout=30)
            edits = list(v.get("edits", []))
            # gapless prefix of acknowledged state, bounded by the
            # crash point's ack level (+1 for the in-flight edit)
            assert edits == list(range(len(edits))), (k, edits)
            hi = max((m for e, m in acked if e <= k), default=0)
            assert len(edits) <= hi + 1, (k, len(edits), hi)
            assert _ref_edits(ref_dst, url) == edits, k
            # the recovered repo stays writable
            repo2.change(url, lambda d: d["edits"].append(777))
            wait_until(
                lambda: 777 in (repo2.doc(url) or {}).get("edits", [])
            )
        finally:
            repo2.close()


def test_durable_tier_repo_acked_edits_survive_powercut(
    tmp_path, monkeypatch
):
    """HM_FSYNC=2 end to end: every edit acked (change + engine/store
    flush) before the cut is present after a POWER-CUT replay, in the
    port and in the reference reopening a copy."""
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    monkeypatch.setenv("HM_FSYNC", "2")
    work = tmp_path / "work"
    rec = F.CrashRecorder(str(work))
    acked = []
    with F.activate(recorder=rec):
        repo = Repo(path=str(work))
        url = repo.create({"edits": []})
        for i in range(5):
            repo.change(url, lambda d, i=i: d["edits"].append(i))
            if repo.back.live is not None:
                repo.back.live.flush_now()
            repo.back._stores.flush_now()
            repo.back._cache_syncs.flush_now()
            repo.back.durability.flush_now()
            acked.append((rec.n_points - 1, i + 1))
        k_max = rec.n_points - 1
    doc_id = validate_doc_url(url)
    for k, want in [acked[1], acked[3], (k_max, 5)]:
        dst = str(tmp_path / f"p{k}")
        rec.materialize(dst, k, powercut=True)
        ref_dst = str(tmp_path / f"rp{k}")
        shutil.copytree(dst, ref_dst)
        repo2 = Repo(path=dst)
        try:
            assert doc_id in repo2.back.clocks.all_doc_ids(
                repo2.back.id
            ), k
            h = repo2.open(url)
            v = h.value(timeout=30)
            edits = list(v.get("edits", []))
            assert edits[:want] == list(range(want)), (k, want, edits)
            assert _ref_edits(ref_dst, url, HM_FSYNC="2") == edits, k
        finally:
            repo2.close()


@pytest.mark.slow
@pytest.mark.parametrize("live", ["1", "0"])
def test_multi_cycle_crash_recover_soak(tmp_path, monkeypatch, live):
    """Crash -> recover -> keep editing -> crash again, several cycles:
    recovery must compose with itself (a recovered repo is a normal
    repo), and the doc stays a gapless prefix throughout; the reference
    reads the last cycle's directory alike."""
    import random

    monkeypatch.setenv("HM_LIVE", live)
    path = tmp_path / "r0"
    url = None
    next_val = 0
    for cycle in range(4):
        # snapshot the pre-workload state: cycle N's replay overlays
        # its events onto what cycle N-1's recovery produced
        base = None
        if os.path.exists(str(path)):
            base = str(tmp_path / f"base{cycle}")
            shutil.copytree(str(path), base)
        rec = F.CrashRecorder(str(path))
        with F.activate(recorder=rec):
            repo = Repo(path=str(path))
            if url is None:
                url = repo.create({"edits": []})
            else:
                h = repo.open(url)
                v = h.value(timeout=30)
                edits = list(v.get("edits", []))
                assert edits == list(range(len(edits))), (cycle, edits)
                next_val = len(edits)
            for i in range(5):
                repo.change(
                    url,
                    lambda d, v=next_val + i: d["edits"].append(v),
                )
            if repo.back.live is not None:
                repo.back.live.flush_now()
            repo.back._stores.flush_now()
            repo.back._cache_syncs.flush_now()
            k_max = rec.n_points - 1
            repo.close()
        # crash at a seeded mid-workload boundary; the recovered dir
        # REPLACES the repo for the next cycle
        k = random.Random(cycle).randrange(k_max // 2, k_max + 1)
        nxt = tmp_path / f"r{cycle + 1}"
        rec.materialize(str(nxt), k, base=base)
        path = nxt
    ref_path = str(tmp_path / "last-ref")
    shutil.copytree(str(path), ref_path)
    repo = Repo(path=str(path))
    try:
        h = repo.open(url)
        v = h.value(timeout=30)
        edits = list(v.get("edits", []))
        assert edits == list(range(len(edits)))
        assert _ref_edits(ref_path, url) == edits
        repo.change(url, lambda d: d["edits"].append(999))
        wait_until(
            lambda: 999 in (repo.doc(url) or {}).get("edits", [])
        )
    finally:
        repo.close()
