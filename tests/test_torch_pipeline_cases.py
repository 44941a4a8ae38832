"""Every case of tests/test_pipeline.py under its own name on the port's
streaming slab pipeline (hypermerge_tpu_torch/backend/pipeline.py), the
corpora written by the port's `Repo(path, device="cpu")`, beside the
port's own pipeline tests in tests/test_torch_pipeline.py. The
reference's multi-device cases run over virtual CPU ranks
(`parallel.mesh.visible_devices` monkeypatched to 8 CPU devices: the
reference's virtual mesh has 8). Each case's summaries and documents
are also held against the reference package's `Repo` on a copy of the
same corpus (HM_PIPELINE=1 there, its other switches off as the port's
are); tolerance 0 (byte-equal summary arrays).

`test_pipeline_pack_pool_large_shape` keeps the reference's `slow` mark.

The twinned file's own docstring follows.

Streaming slab pipeline (backend/pipeline.py): equivalence with the
serial twin, failure-path hygiene, and round-robin device dispatch.

The pipeline restructures the bulk cold open from sum(stages) to
~max(stage) by overlapping IO, pack, dispatch, and fetch across slabs
— but it must be a pure SCHEDULING change: `HM_PIPELINE=1` and
`HM_PIPELINE=0` must produce byte-identical summary arrays, identical
summary-memo contents, and identical doc/fast/fallback accounting. A
stage failure must fail the whole load as a unit: no hung worker
threads, no pending device refs, queues drained.
"""

import random
import shutil

import pytest
import torch

from hypermerge_tpu_torch.backend.pipeline import PipelineError
from hypermerge_tpu_torch.models import Counter, Text
from hypermerge_tpu_torch.parallel import mesh as meshmod
from hypermerge_tpu_torch.utils.ids import validate_doc_url
from port_helpers import REF_SWITCHES, Repo, env_vars, plainify, ref_docs
from test_pipeline import (
    _assert_pipe_threads_drained,
    _call_with_timeout,
    _doc_summary_bytes,
    _memo_snapshot,
)

CPU = torch.device("cpu")
# the reference's virtual mesh (tests/conftest.py: 8 host devices)
RANKS = 8


def _make_corpus(path, n_docs=14, seed=7):
    """Single-writer docs of varied size/shape (maps, text, counters)
    so slabs bucket at different [D, N] shapes and every value lane is
    exercised."""
    r = random.Random(seed)
    repo = Repo(path=str(path))
    urls = []
    for i in range(n_docs):
        u = repo.create({"i": i, "t": Text(f"doc{i}:"), "hits": Counter(0)})
        for k in range(r.randrange(1, 9)):
            kind = r.randrange(3)
            if kind == 0:
                repo.change(
                    u, lambda d, k=k: d.__setitem__(f"k{k}", k * 3)
                )
            elif kind == 1:
                repo.change(
                    u, lambda d, k=k: d["t"].insert(0, f"<{k}>")
                )
            else:
                repo.change(u, lambda d: d.increment("hits", 2))
        urls.append(u)
    want = {u: plainify(repo.doc(u)) for u in urls}
    repo.close()
    return urls, want


def _add_gap_doc(path):
    """One doc with a seq gap in its feed: must fall back to host
    replay in BOTH modes (fallback accounting equivalence)."""
    from hypermerge_tpu_torch.crdt.change import Action, Change, Op, ROOT
    from hypermerge_tpu_torch.storage import block as blockmod

    repo = Repo(path=str(path))
    url = repo.create({"gap": True})
    doc_id = validate_doc_url(url)
    actor = repo.back.actors[doc_id]
    head = actor.seq_head
    max_op = max(
        c.max_op for c in actor.changes_in_window(0, float("inf"))
    )
    actor.feed._append_raw(
        blockmod.pack(
            Change(
                actor=doc_id,
                seq=head + 2,  # head+1 never written
                start_op=max_op + 1,
                deps={},
                ops=(Op(action=Action.SET, obj=ROOT, key="late", value=1),),
            ).to_json()
        )
    )
    repo.close()
    return url


def _ref_summaries(path, ids, slab):
    """Per-doc summary bytes of the reference's pipelined bulk load on a
    copy of the corpus at `path`."""
    from hypermerge_tpu.repo import Repo as RefRepo

    copy = f"{path}-ref"
    shutil.copytree(path, copy)
    with env_vars(**dict(REF_SWITCHES, HM_PIPELINE="1")):
        repo = RefRepo(path=copy)
        try:
            repo.back.load_documents_bulk(ids, slab=slab)
            summ = repo.back.fetch_bulk_summaries()
            return {d: _doc_summary_bytes(summ, d) for d in summ.doc_ids}
        finally:
            repo.close()


def _assert_reference_docs(path, urls, want):
    """The reference reads a copy of the corpus to the same docs."""
    copy = f"{path}-refdocs"
    shutil.copytree(path, copy)
    assert ref_docs(copy, urls) == [want[u] for u in urls]


def _load_twice(path, ids, mode, monkeypatch, slab):
    """Two bulk loads in one backend (the second is all memo hits);
    returns per-doc summary bytes for both, the memo snapshot, and the
    stats of each load."""
    monkeypatch.setenv("HM_PIPELINE", mode)
    monkeypatch.setenv("HM_DEVICE_MIN_CELLS", "1")  # force device path
    repo = Repo(path=str(path))
    back = repo.back
    back.load_documents_bulk(ids, slab=slab)
    stats1 = dict(back.last_bulk_stats)
    s1 = back.fetch_bulk_summaries()
    first = {d: _doc_summary_bytes(s1, d) for d in s1.doc_ids}
    memo = _memo_snapshot(back)
    for doc_id in ids:
        back.close_doc(doc_id)
    back.load_documents_bulk(ids, slab=slab)
    stats2 = dict(back.last_bulk_stats)
    s2 = back.fetch_bulk_summaries()
    second = {d: _doc_summary_bytes(s2, d) for d in s2.doc_ids}
    repo.close()
    counts = [
        {k: st[k] for k in ("docs", "fast", "memo", "fallback")}
        for st in (stats1, stats2)
    ]
    return first, second, memo, counts


def test_pipeline_serial_equivalence_fuzz(tmp_path, monkeypatch):
    """Fuzzed docs across >=3 slab boundaries: HM_PIPELINE=1 and =0
    produce byte-identical summary arrays, identical memo contents, and
    identical doc/fast/fallback counts — on the first (packed +
    dispatched) AND second (memo-served) loads — and the reference's
    pipelined load of the same corpus gives the same summaries."""
    src = tmp_path / "src"
    urls, want = _make_corpus(src, n_docs=14)
    gap_url = _add_gap_doc(src)
    ids = [validate_doc_url(u) for u in urls] + [validate_doc_url(gap_url)]
    ref = _ref_summaries(str(src), ids, slab=4)

    results = {}
    for mode in ("0", "1"):
        copy = tmp_path / f"repo{mode}"
        shutil.copytree(src, copy)
        results[mode] = _load_twice(
            copy, ids, mode, monkeypatch, slab=4
        )  # 14 fast docs / slab 4 -> 4 slabs (3+ boundaries)

    first0, second0, memo0, counts0 = results["0"]
    first1, second1, memo1, counts1 = results["1"]
    assert counts0 == counts1
    assert counts0[0]["fallback"] == 1
    assert counts0[1]["memo"] == counts0[1]["fast"]  # 2nd load: all memo
    assert set(first0) == set(first1) and len(first0) == 14
    for d in first0:
        assert first0[d] == first1[d], f"first-load summary differs: {d}"
    for d in second0:
        assert second0[d] == second1[d], f"memo-load summary differs: {d}"
    assert memo0 == memo1
    assert first1 == ref


def test_pipeline_matches_interactive_state(tmp_path, monkeypatch):
    """Pipelined bulk loads materialize the same doc values the writer
    saw (end-to-end through handles, not just summary arrays)."""
    monkeypatch.setenv("HM_PIPELINE", "1")
    urls, want = _make_corpus(tmp_path / "r", n_docs=9, seed=3)
    _assert_reference_docs(tmp_path / "r", urls, want)
    repo = Repo(path=str(tmp_path / "r"))
    ids = [validate_doc_url(u) for u in urls]
    repo.back.load_documents_bulk(ids, slab=2)
    summ = repo.back.fetch_bulk_summaries()
    assert len(summ.doc_ids) == 9
    for u in urls:
        assert plainify(repo.doc(u)) == want[u]
    got = {d: _doc_summary_bytes(summ, d) for d in summ.doc_ids}
    repo.close()
    assert got == _ref_summaries(str(tmp_path / "r"), ids, slab=2)


def test_pipeline_pack_failure_fails_load_cleanly(tmp_path, monkeypatch):
    """A slab whose pack raises must fail the bulk load as a unit: the
    error propagates, every worker drains, and no device refs linger in
    the pending list."""
    import hypermerge_tpu_torch.ops.columnar as columnar

    urls, _want = _make_corpus(tmp_path / "r", n_docs=12, seed=11)
    ids = [validate_doc_url(u) for u in urls]
    monkeypatch.setenv("HM_PIPELINE", "1")

    real = columnar.pack_docs_columns
    calls = {"n": 0}

    def boom(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("boom-pack")
        return real(*a, **kw)

    monkeypatch.setattr(columnar, "pack_docs_columns", boom)
    repo = Repo(path=str(tmp_path / "r"))
    with pytest.raises(PipelineError) as ei:
        _call_with_timeout(
            lambda: repo.back.load_documents_bulk(ids, slab=4)
        )
    assert "boom-pack" in repr(ei.value.__cause__)
    _assert_pipe_threads_drained()
    assert repo.back._pending_summaries == []
    assert repo.back._fetch_ctx is None
    repo.close()

    # the corpus itself is intact: a fresh backend loads it fine
    monkeypatch.setattr(columnar, "pack_docs_columns", real)
    repo2 = Repo(path=str(tmp_path / "r"))
    repo2.back.load_documents_bulk(ids, slab=4)
    summ = repo2.back.fetch_bulk_summaries()
    assert len(summ.doc_ids) == 12
    got = {d: _doc_summary_bytes(summ, d) for d in summ.doc_ids}
    repo2.close()
    assert got == _ref_summaries(str(tmp_path / "r"), ids, slab=4)


def test_pipeline_fetch_failure_fails_cleanly(tmp_path, monkeypatch):
    """A slab whose summary fetch raises must surface the error (at the
    load or at the barrier, wherever the overlap window puts it) and
    leave no hung workers or pending refs."""
    from hypermerge_tpu_torch.backend.repo_backend import RepoBackend

    urls, _want = _make_corpus(tmp_path / "r", n_docs=10, seed=13)
    ids = [validate_doc_url(u) for u in urls]
    monkeypatch.setenv("HM_PIPELINE", "1")
    monkeypatch.setenv("HM_DEVICE_MIN_CELLS", "1")  # real device fetches

    real = RepoBackend._fetch_slab
    calls = {"n": 0}

    def boom(self, entry):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("boom-fetch")
        return real(self, entry)

    monkeypatch.setattr(RepoBackend, "_fetch_slab", boom)
    repo = Repo(path=str(tmp_path / "r"))

    def load_and_barrier():
        repo.back.load_documents_bulk(ids, slab=4)
        repo.back.fetch_bulk_summaries()

    with pytest.raises(PipelineError) as ei:
        _call_with_timeout(load_and_barrier)
    assert "boom-fetch" in repr(ei.value.__cause__)
    _assert_pipe_threads_drained()
    assert repo.back._pending_summaries == []
    assert repo.back._fetch_ctx is None
    repo.close()


def test_round_robin_slabs_across_devices(tmp_path, monkeypatch):
    """With >1 visible device and the pipeline on, successive slabs
    land whole on successive devices (rr_slabs accounting), with
    results identical to the interactive state."""
    monkeypatch.setattr(meshmod, "visible_devices", lambda: [CPU] * RANKS)
    monkeypatch.setenv("HM_PIPELINE", "1")
    monkeypatch.setenv("HM_DEVICE_MIN_CELLS", "1")
    urls, want = _make_corpus(tmp_path / "r", n_docs=6, seed=5)
    repo = Repo(path=str(tmp_path / "r"))
    ids = [validate_doc_url(u) for u in urls]
    repo.back.load_documents_bulk(ids, slab=2)
    summ = repo.back.fetch_bulk_summaries()
    stats = repo.back.last_bulk_stats
    assert stats.get("rr_slabs") == 3, stats
    assert stats.get("rr_devices") == RANKS, stats
    assert stats.get("sharded_slabs") is None
    assert len(summ.doc_ids) == 6
    for u in urls:
        assert plainify(repo.doc(u)) == want[u]
    got = {d: _doc_summary_bytes(summ, d) for d in summ.doc_ids}
    repo.close()
    assert got == _ref_summaries(str(tmp_path / "r"), ids, slab=2)
    _assert_reference_docs(tmp_path / "r", urls, want)


def test_pipeline_per_chip_stats(tmp_path, monkeypatch):
    """Mesh-aware stats: the pipelined bulk load reports per-chip
    dispatch/fetch busy times and slab placement alongside the stage
    totals."""
    monkeypatch.setattr(meshmod, "visible_devices", lambda: [CPU] * RANKS)
    monkeypatch.setenv("HM_PIPELINE", "1")
    monkeypatch.setenv("HM_DEVICE_MIN_CELLS", "1")
    urls, want = _make_corpus(tmp_path / "r", n_docs=6, seed=7)
    repo = Repo(path=str(tmp_path / "r"))
    ids = [validate_doc_url(u) for u in urls]
    repo.back.load_documents_bulk(ids, slab=2)
    repo.back.fetch_bulk_summaries()
    stats = repo.back.last_bulk_stats
    n = RANKS
    assert len(stats["t_dispatch_chips"]) == n, stats
    assert len(stats["slabs_per_chip"]) == n
    assert sum(stats["slabs_per_chip"]) == stats["rr_slabs"] == 3
    # every dispatched slab's busy time is attributed to its chip
    assert sum(
        1 for t in stats["t_dispatch_chips"] if t > 0
    ) == sum(1 for s in stats["slabs_per_chip"] if s > 0)
    assert len(stats.get("t_fetch_chips", [])) == n, stats
    assert sum(stats["t_fetch_chips"]) > 0
    # the PRODUCT scheduler never tracks collective-reduction refs:
    # nothing may pin slab wires beyond the barrier
    rr = repo.back._rr_value
    if hasattr(rr, "track_resident"):
        assert rr.track_resident is False
        assert all(not q for q in rr._resident_wires.values())
        assert all(not q for q in rr._resident_clocks.values())
    for u in urls:
        assert plainify(repo.doc(u)) == want[u]
    repo.close()
    _assert_reference_docs(tmp_path / "r", urls, want)


def _load_once(path, ids, monkeypatch, slab, workers, device_pack, order):
    """One pipelined bulk load under a given pack-plane config; env vars
    are set in the given order (the routing must not care)."""
    monkeypatch.setenv("HM_PIPELINE", "1")
    monkeypatch.setenv("HM_DEVICE_MIN_CELLS", "1")
    pair = (("HM_PACK_WORKERS", workers), ("HM_DEVICE_PACK", device_pack))
    for var, val in pair if order == 0 else pair[::-1]:
        monkeypatch.setenv(var, val)
    repo = Repo(path=str(path))
    back = repo.back
    back.load_documents_bulk(ids, slab=slab)
    stats = dict(back.last_bulk_stats)
    summ = back.fetch_bulk_summaries()
    out = {d: _doc_summary_bytes(summ, d) for d in summ.doc_ids}
    repo.close()
    _assert_pipe_threads_drained()
    return out, stats


@pytest.mark.slow
def test_pipeline_pack_pool_large_shape(tmp_path, monkeypatch):
    """Largest-shape tier: a wider corpus across many slabs with the
    full pool (4 workers) and the device route — still byte-identical
    to the serial twin and to the reference, pool accounting intact."""
    src = tmp_path / "src"
    urls, _want = _make_corpus(src, n_docs=42, seed=23)
    ids = [validate_doc_url(u) for u in urls]

    copy0 = tmp_path / "serial"
    shutil.copytree(src, copy0)
    base, _ = _load_once(copy0, ids, monkeypatch, 8, "1", "0", order=0)

    copy1 = tmp_path / "pool"
    shutil.copytree(src, copy1)
    out, stats = _load_once(copy1, ids, monkeypatch, 8, "4", "1", order=1)
    assert stats["pack_workers"] == 4
    assert len(stats["t_pack_busy_per_worker"]) == 4
    assert set(out) == set(base) and len(out) == 42
    for d in base:
        assert out[d] == base[d], d
    assert base == _ref_summaries(str(src), ids, slab=8)


def test_pipeline_stats_report_busy_and_critical_path(tmp_path, monkeypatch):
    """Pipeline mode reports per-stage busy time (t_*_busy) and the
    overlapped wall critical path alongside the canonical keys."""
    monkeypatch.setenv("HM_PIPELINE", "1")
    urls, _want = _make_corpus(tmp_path / "r", n_docs=5, seed=2)
    repo = Repo(path=str(tmp_path / "r"))
    ids = [validate_doc_url(u) for u in urls]
    repo.back.load_documents_bulk(ids, slab=2)
    summ = repo.back.fetch_bulk_summaries()
    stats = repo.back.last_bulk_stats
    assert stats["pipeline"] == 1
    for k in ("t_io_busy", "t_pack_busy", "t_dispatch_busy"):
        assert k in stats
    assert stats["wall_critical_path"] >= 0.0
    assert "t_fetch" in stats and "t_fetch_busy" in stats
    got = {d: _doc_summary_bytes(summ, d) for d in summ.doc_ids}
    repo.close()
    assert got == _ref_summaries(str(tmp_path / "r"), ids, slab=2)
