"""The port's streaming slab pipeline (backend/pipeline.py,
`RepoBackend._load_slabs_pipelined`, `_slab_rr`) on the CPU, case for
case after tests/test_pipeline.py, against its serial twin and the JAX
package's pipelined open.

The pipeline is a scheduling change only: the port's
`Repo(path, device="cpu")` under HM_PIPELINE=1 and =0 and the reference's
`Repo` under HM_PIPELINE=1, each on a copy of one corpus (fuzzed docs
written by the reference, a doc with a seq gap, slabs of 4 docs: four
slabs), give byte-equal per-doc summaries (`map_winner`, `elem_live`,
`elem_order`, counts, clock), the same summary memo and the same
docs/fast/memo/fallback counts, on the first load and on the memo-served
second. Also held:

- the HM_PACK_WORKERS {0, 1, 4} x HM_DEVICE_PACK {0, 1} matrix (each
  route really ran) against the serial twin;
- a pack, dispatch or fetch stage that raises failing the load as one
  PipelineError, with no `hm-pipe-*` thread left and no pending refs;
- round-robin over 4 and 3 virtual CPU ranks (`visible_devices`
  monkeypatched): `rr_slabs`, `slabs_per_chip` summing to it, per-rank
  times, nothing tracked resident, summaries equal to the sharded serial
  route on the same ranks;
- `SlabRoundRobin` cycling, bounding in-flight slabs, `device_index`,
  and its dispatch reading no host plane (`HostPlanes.wait` made to
  raise) and counting only the bytes `run_batch_full` uploaded;
- the stats keys and the reference's gate (unset HM_PIPELINE: on where
  the native pack loads, off under HM_NATIVE_PACK=0 unless forced);
- on the pipelined route, no host plane read before the barrier
  (`test_torch_pack_handoff.py`'s guard), then documents equal the
  reference's;
- kernels/_build.py `load` under concurrent first use (a stand-in
  compiler: N threads, one build) and the launch counter under
  contention.

Tolerance: exact.
"""

import os
import shutil
import stat
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hypermerge_tpu.ops.corpus import make_corpus as ref_make_corpus
from hypermerge_tpu.repo import Repo as RefRepo
from hypermerge_tpu.utils.ids import validate_doc_url
from hypermerge_tpu_torch.backend import pipeline
from hypermerge_tpu_torch.backend.pipeline import PipelineError
from hypermerge_tpu_torch.backend.repo_backend import RepoBackend
from hypermerge_tpu_torch.kernels import _build
from hypermerge_tpu_torch.ops import columnar as port_columnar
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops import pack_kernels as pk
from hypermerge_tpu_torch.parallel import mesh as meshmod
from hypermerge_tpu_torch.parallel import sharded
from hypermerge_tpu_torch.repo import Repo
from test_pipeline import (
    _add_gap_doc,
    _assert_pipe_threads_drained,
    _call_with_timeout,
    _doc_summary_bytes,
    _make_corpus,
    _memo_snapshot,
)
from test_torch_pack import CASES as PACK_CASES
from test_torch_pack_handoff import _Barrier

CPU = torch.device("cpu")
SLAB = 4
# the switches the port has no counterpart of, off in both packages
OFF = {"HM_LIVE": "0", "HM_WAL": "0", "HM_SERVICE": "0"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(directory, doc ids): 14 fuzzed single-writer docs (maps, text,
    counters) and one doc whose feed has a seq gap, written by the
    reference."""
    src = tmp_path_factory.mktemp("pipe") / "src"
    urls, _want = _make_corpus(src, n_docs=14)
    gap_url = _add_gap_doc(src)
    return src, [validate_doc_url(u) for u in urls + [gap_url]]


@pytest.fixture(scope="module")
def plane_corpus(tmp_path_factory):
    """(directory, doc ids): 14 bench-shaped docs (ops/corpus.py
    make_corpus, 4 templates) whose sidecars are v3 checkpoints, so the
    host route packs them with the native entries."""
    src = tmp_path_factory.mktemp("pipe") / "planes"
    urls = ref_make_corpus(str(src), 14, 64, distinct=4, sign=False)
    return src, [validate_doc_url(u) for u in urls]


@pytest.fixture
def env(monkeypatch):
    for k, v in OFF.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def _copy(corpus, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(corpus[0], dst)
    return str(dst)


def _load_twice(make_repo, path, ids):
    """Two bulk loads in one backend (the second all memo hits): per-doc
    summary bytes of each, the memo, the counts and the first stats."""
    repo = make_repo(path)
    try:
        back = repo.back
        back.load_documents_bulk(ids, slab=SLAB)
        stats1 = dict(back.last_bulk_stats)
        s1 = back.fetch_bulk_summaries()
        first = {d: _doc_summary_bytes(s1, d) for d in s1.doc_ids}
        memo = _memo_snapshot(back)
        patches = {d: back.docs[d].snapshot_patch().to_json()
                   for d in s1.doc_ids}
        for doc_id in ids:
            back.close_doc(doc_id)
        back.load_documents_bulk(ids, slab=SLAB)
        stats2 = dict(back.last_bulk_stats)
        s2 = back.fetch_bulk_summaries()
        second = {d: _doc_summary_bytes(s2, d) for d in s2.doc_ids}
    finally:
        repo.close()
    _assert_pipe_threads_drained()
    counts = [{k: st[k] for k in ("docs", "fast", "memo", "fallback")}
              for st in (stats1, stats2)]
    return first, second, memo, counts, patches, stats1


def _port(path):
    return Repo(path=path, device="cpu")


def test_pipeline_serial_and_reference_equivalence_fuzz(corpus, tmp_path,
                                                        env):
    results = {}
    for name, mode, make in (("serial", "0", _port), ("pipe", "1", _port),
                             ("ref", "1", RefRepo)):
        env.setenv("HM_PIPELINE", mode)
        results[name] = _load_twice(make, _copy(corpus, tmp_path, name),
                                    corpus[1])
    serial, pipe, ref = results["serial"], results["pipe"], results["ref"]
    assert serial[5]["pipeline"] == 0 and pipe[5]["pipeline"] == 1
    assert ref[5]["pipeline"] == 1
    counts = serial[3]
    assert counts[0]["fallback"] == 1 and counts[0]["fast"] == 14
    assert counts[1]["memo"] == counts[1]["fast"]  # 2nd load: all memo
    assert len(serial[0]) == 14
    for other in (pipe, ref):
        assert other[3] == counts
        for k in range(3):  # first load, memo load, memo contents
            assert other[k] == serial[k]
        assert other[4] == serial[4]  # every doc's snapshot patch


def _route_spies(monkeypatch):
    """Count device-route packs (pack_prefix) and host-route packs
    (_native_pack_prefix) made on any thread."""
    counts = {"device": 0, "host": 0}
    lock = threading.Lock()
    for key, mod, name in (("device", pk, "pack_prefix"),
                           ("host", port_columnar, "_native_pack_prefix")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _key=key, **k):
            with lock:
                counts[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return counts


def _summaries(path, ids):
    repo = _port(path)
    try:
        repo.back.load_documents_bulk(ids, slab=SLAB)
        stats = dict(repo.back.last_bulk_stats)
        summ = repo.back.fetch_bulk_summaries()
        return {d: _doc_summary_bytes(summ, d) for d in summ.doc_ids}, stats
    finally:
        repo.close()


@pytest.mark.parametrize("kind", ["fuzz", "planes"])
def test_pipeline_pack_worker_matrix(request, tmp_path, env, kind):
    """HM_PACK_WORKERS {0, 1, 4} x HM_DEVICE_PACK {0, 1}, the variables
    set in both orders: each pack route runs once a slab (the host route
    natively on checkpoint planes, plainly on the fuzz corpus' row-backed
    sidecars), every config equals the serial twin, and the pool reports
    its shape."""
    corpus = request.getfixturevalue(
        "corpus" if kind == "fuzz" else "plane_corpus")
    host = "host" if kind == "planes" else "device"
    env.setenv("HM_PIPELINE", "0")
    base, _ = _summaries(_copy(corpus, tmp_path, "serial"), corpus[1])
    env.setenv("HM_PIPELINE", "1")
    matrix = [("1", "0"), ("0", "0"), ("4", "0"),
              ("1", "1"), ("4", "1"), ("0", "1")]
    for i, (workers, device) in enumerate(matrix):
        pair = (("HM_PACK_WORKERS", workers), ("HM_DEVICE_PACK", device))
        for var, val in pair if i % 2 == 0 else pair[::-1]:
            env.setenv(var, val)
        with pytest.MonkeyPatch.context() as mp:
            routes = _route_spies(mp)
            out, stats = _summaries(_copy(corpus, tmp_path, f"m{i}"),
                                    corpus[1])
        want = {"device": 0, "host": 0}
        want["device" if device == "1" else host] = 4
        assert routes == want, (workers, device)
        assert stats["pipeline"] == 1
        pool = pipeline.pack_worker_count()
        assert stats["pack_workers"] == pool
        if workers != "0":
            assert pool == int(workers)
        assert len(stats["t_pack_busy_per_worker"]) == pool
        assert stats["t_pack_wall"] >= 0.0
        assert out == base and len(out) == 14, (workers, device)
        assert list(out) == list(base)  # the slabs' order, too
        _assert_pipe_threads_drained()


@pytest.mark.parametrize("stage", ["pack", "dispatch", "fetch"])
def test_pipeline_stage_failure_fails_cleanly(corpus, tmp_path, env, stage):
    """A slab whose pack, dispatch or fetch raises fails the load as a
    unit (at the load, or at the barrier for a fetch): one PipelineError
    carrying the cause, every worker drained, no pending refs. The corpus
    is intact: a fresh backend then loads it."""
    env.setenv("HM_PIPELINE", "1")
    path = _copy(corpus, tmp_path, "r")
    target, name = {
        "pack": (port_columnar, "pack_docs_columns"),
        "dispatch": (RepoBackend, "_dispatch_slab"),
        "fetch": (RepoBackend, "_fetch_slab"),
    }[stage]
    real = getattr(target, name)
    calls = {"n": 0}

    def boom(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError(f"boom-{stage}")
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(target, name, boom)
        repo = _port(path)
        try:
            def load_and_barrier():
                repo.back.load_documents_bulk(corpus[1], slab=SLAB)
                repo.back.fetch_bulk_summaries()

            with pytest.raises(PipelineError) as ei:
                _call_with_timeout(load_and_barrier)
            assert f"boom-{stage}" in repr(ei.value.__cause__)
            _assert_pipe_threads_drained()
            assert repo.back._pending_summaries == []
            assert repo.back._fetch_ctx is None
        finally:
            repo.close()
    out, _ = _summaries(path, corpus[1])
    assert len(out) == 14


def test_late_fetch_failure_raises_at_the_barrier(corpus, tmp_path, env):
    """A fetch worker that fails after the load returned: the load
    succeeds, the barrier joins the workers and raises PipelineError with
    the cause; no worker is left."""
    env.setenv("HM_PIPELINE", "1")
    real = RepoBackend._fetch_slab
    go = threading.Event()
    calls = {"n": 0}

    def late(self, entry):
        if threading.current_thread().name.startswith("hm-pipe-fetch"):
            calls["n"] += 1
            if calls["n"] == 4:  # the last slab
                assert go.wait(30)
                raise RuntimeError("boom-late")
        return real(self, entry)

    env.setattr(RepoBackend, "_fetch_slab", late)
    repo = _port(_copy(corpus, tmp_path, "r"))
    try:
        _call_with_timeout(
            lambda: repo.back.load_documents_bulk(corpus[1], slab=SLAB))
        assert repo.back._fetch_ctx is not None
        go.set()
        with pytest.raises(PipelineError) as ei:
            _call_with_timeout(repo.back.fetch_bulk_summaries)
        assert "boom-late" in repr(ei.value.__cause__)
        _assert_pipe_threads_drained()
        assert repo.back._fetch_ctx is None
    finally:
        go.set()
        repo.close()


@pytest.mark.parametrize("ranks", [4, 3])
def test_round_robin_over_virtual_ranks(corpus, tmp_path, env, ranks):
    """Pipelined over n CPU ranks: whole slabs round-robin (rr_slabs,
    per-rank slabs and times), the scheduler tracks nothing resident, and
    the summaries equal the serial twin's sharded route on the same
    ranks."""
    env.setattr(meshmod, "visible_devices", lambda: [CPU] * ranks)
    env.setenv("HM_PIPELINE", "0")
    base, st0 = _summaries(_copy(corpus, tmp_path, "sharded"), corpus[1])
    assert st0["sharded_slabs"] >= 1 and "rr_slabs" not in st0
    env.setenv("HM_PIPELINE", "1")
    repo = _port(_copy(corpus, tmp_path, "rr"))
    try:
        back = repo.back
        back.load_documents_bulk(corpus[1], slab=SLAB)
        summ = back.fetch_bulk_summaries()
        stats = back.last_bulk_stats
        assert stats["rr_slabs"] == 4 and stats["rr_devices"] == ranks
        assert "sharded_slabs" not in stats
        assert sum(stats["slabs_per_chip"]) == stats["rr_slabs"]
        assert stats["slabs_per_chip"] == [
            sum(1 for s in range(4) if s % ranks == r) for r in range(ranks)]
        assert len(stats["t_dispatch_chips"]) == ranks
        assert len(stats["t_fetch_chips"]) == ranks
        assert sum(1 for t in stats["t_fetch_chips"] if t > 0) == min(
            4, ranks)
        rr = back._rr_value
        assert isinstance(rr, sharded.MeshBulkScheduler)
        assert rr.track_resident is False
        assert all(not q for q in rr._resident_wires.values())
        assert all(not q for q in rr._inflight.values())
        got = {d: _doc_summary_bytes(summ, d) for d in summ.doc_ids}
    finally:
        repo.close()
    assert got == base


def _packed_batch(tmp_path, n):
    """A device-route batch on the CPU (its host planes a HostPlanes)."""
    _, specs, kw, _ = PACK_CASES["fuzz"](tmp_path)
    return port_columnar.pack_docs_columns(specs[:n], device="cpu", **kw)


def test_slab_round_robin_cycles_and_bounds_inflight(tmp_path):
    devices = [CPU] * 2
    rr = sharded.SlabRoundRobin(devices, depth=1)
    wires = []
    for n in (1, 2, 3, 4, 5):
        _out, wire = rr.dispatch(_packed_batch(tmp_path / str(n), n))
        wires.append(wire)
        for q in rr._inflight.values():
            assert len(q) <= 1
    assert rr._next == 5 % 2 and rr.slabs_per_chip == [3, 2]
    rr.drain()
    assert all(not q for q in rr._inflight.values())
    assert [w.shape[0] for w in wires] == [1, 2, 3, 4, 5]
    assert rr.device_index(CPU) == 0
    assert rr.device_index(torch.device("cuda", 3)) is None
    mixed = sharded.SlabRoundRobin([torch.device("cuda", 0), CPU])
    assert mixed.device_index(CPU) == 1


def test_round_robin_dispatch_reads_no_host_plane(tmp_path, monkeypatch):
    """The dispatch counts the bytes run_batch_full uploaded (the pred
    edges and actor map of a hand-off) and never waits for the host
    planes."""
    batch = _packed_batch(tmp_path, 6)
    assert isinstance(batch.cols, pk.HostPlanes)

    def no_wait(_planes):
        raise AssertionError("the dispatch read a host plane")

    monkeypatch.setattr(pk.HostPlanes, "wait", no_wait)
    mesh0, slab0 = sharded._M_H2D.value(), ck._SLAB_H2D.value()
    sharded.SlabRoundRobin([CPU] * 2).dispatch(batch, lean=False)
    da, _A, _K = ck.bucket_doc_actors(batch)
    N = batch.n_rows
    want = (ck._narrow(batch.psrc, -1, N - 1).nbytes
            + ck._narrow(batch.ptgt, -1, N - 1).nbytes
            + np.ascontiguousarray(da, np.int32).nbytes)
    assert ck._SLAB_H2D.value() - slab0 == want
    assert sharded._M_H2D.value() - mesh0 == want


def test_pipeline_gate_and_stats(corpus, tmp_path, env):
    """Unset HM_PIPELINE follows the reference's gate (on where the
    native pack loads and drops the GIL; HM_NATIVE_PACK=0 turns it off
    unless forced), and a pipelined load reports its stage busy times,
    pool lanes and critical path."""
    env.delenv("HM_PIPELINE", raising=False)
    env.delenv("HM_NATIVE_PACK", raising=False)
    assert pipeline.pipeline_enabled()
    _out, stats = _summaries(_copy(corpus, tmp_path, "r"), corpus[1])
    assert stats["pipeline"] == 1
    for k in ("t_io_busy", "t_spec_busy", "t_pack_busy", "t_dispatch_busy",
              "t_pack_wall", "wall_critical_path"):
        assert stats[k] >= 0.0, k
    assert len(stats["t_pack_busy_per_worker"]) == stats["pack_workers"]
    assert stats["pack_workers"] == min(4, os.cpu_count() or 1)
    repo = _port(_copy(corpus, tmp_path, "s"))
    try:
        repo.back.load_documents_bulk(corpus[1], slab=SLAB)
        repo.back.fetch_bulk_summaries()
        stats = repo.back.last_bulk_stats
        assert "t_fetch" in stats and stats["t_fetch_busy"] > 0.0
    finally:
        repo.close()
    env.setenv("HM_NATIVE_PACK", "0")
    assert not pipeline.pipeline_enabled()
    env.setenv("HM_PIPELINE", "1")
    assert pipeline.pipeline_enabled()
    env.setenv("HM_PIPELINE", "0")
    assert not pipeline.pipeline_enabled()
    env.setenv("HM_PIPELINE_DEPTH", "0")
    assert pipeline.queue_depth() == 1


def test_pipelined_open_reads_no_host_plane_before_the_barrier(
        corpus, tmp_path, env):
    """The pipelined open packs, dispatches and fetches every slab without
    a host plane read (the fetch workers read the wire alone);
    fetch_bulk_summaries is the barrier; the documents then equal the
    reference's pipelined open."""
    env.setenv("HM_PIPELINE", "1")
    env.setenv("HM_DEVICE_PACK", "1")
    barrier = _Barrier(env)
    fetch = RepoBackend.fetch_bulk_summaries

    def barrier_fetch(back):
        barrier.open()
        return fetch(back)

    env.setattr(RepoBackend, "fetch_bulk_summaries", barrier_fetch)
    ref = RefRepo(path=_copy(corpus, tmp_path, "ref"))
    port = _port(_copy(corpus, tmp_path, "port"))
    try:
        ids = corpus[1]
        ref.back.load_documents_bulk(ids, slab=SLAB)
        ref.back.fetch_bulk_summaries()
        port.back.load_documents_bulk(ids, slab=SLAB)
        port.back._fetch_ctx.join()  # every slab fetched: still no read
        assert not barrier.opened
        port.back.fetch_bulk_summaries()
        assert port.back.last_bulk_stats["pipeline"] == 1
        assert port.back.last_bulk_stats["fast"] == 14
        for d in ids:
            assert (port.back.docs[d].snapshot_patch().to_json()
                    == ref.back.docs[d].snapshot_patch().to_json())
    finally:
        ref.close()
        port.close()


# ---------------------------------------------------------------------------
# concurrent first use of a kernel, and the launch counter under contention


def _stand_in_compiler(tmp_path):
    """A script taking nvcc's arguments that sleeps, counts its runs and
    copies a prebuilt shared library to its -o path."""
    c = tmp_path / "k.c"
    c.write_text("int hm_stand_in(void) { return 7; }\n")
    so = tmp_path / "k.so"
    assert os.system(f"gcc -shared -fPIC -o {so} {c}") == 0
    count = tmp_path / "runs"
    count.write_text("")
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys, time\n"
        f"open({str(count)!r}, 'a').write('x')\n"
        "time.sleep(0.3)\n"
        f"shutil.copy({str(so)!r}, sys.argv[sys.argv.index('-o') + 1])\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script, count


def test_build_load_concurrent_first_use(tmp_path, monkeypatch):
    script, count = _stand_in_compiler(tmp_path)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "stand_in.cu").write_text("// a kernel source\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(_build, "_libs", {})
    n = 8
    start = threading.Barrier(n)
    libs, errors = [], []

    def first_use():
        start.wait()
        try:
            libs.append(_build.load("stand_in"))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(libs) == n and all(lib is libs[0] for lib in libs)
    assert libs[0].hm_stand_in() == 7
    assert count.read_text() == "x"  # one compile
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_launch_count_exact_under_contention():
    """Pack workers count their launches from several threads: no count
    is lost (16 threads, a tiny switch interval)."""
    before = ck.launches["pack_prefix"]
    n, per = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(
                target=lambda: [ck._launched("pack_prefix", 0)
                                for _ in range(per)])
            for _ in range(n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ck.launches["pack_prefix"] - before == n * per
    ck.launches["pack_prefix"] = before
