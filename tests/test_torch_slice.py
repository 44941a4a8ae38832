"""The port's materialize slice end to end on the CPU, against the JAX
package and its host OpSet.

The same change histories (fuzz sites from tests/helpers and the
reference's synth_changes) go through hypermerge_tpu and through
hypermerge_tpu_torch with device="cpu": the packed arrays, the decoded
documents, the patches, the columnar summaries and the per-doc summary
dicts must all be identical. The histories reach the port as JSON
(`Change.to_json` -> the port's `Change.from_json`), as they would cross
a process boundary.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from helpers import Site, random_mutation, sync
from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu.ops import crdt_kernels as ref_k
from hypermerge_tpu.ops import materialize as ref_mat
from hypermerge_tpu.ops import synth as ref_synth
from hypermerge_tpu_torch import convert
from hypermerge_tpu_torch.crdt.change import Action as PortAction
from hypermerge_tpu_torch.crdt.change import Change as PortChange
from hypermerge_tpu_torch.ops import columnar as port_columnar
from hypermerge_tpu_torch.ops import crdt_kernels as port_k
from hypermerge_tpu_torch.ops import materialize as port_mat
from test_torch_colcache import plane_caches, single_writer_history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(v):
    """Python values with the model types (either package's) tagged by
    class name, so the two packages' documents compare directly."""
    kind = type(v).__name__
    if kind == "Text":
        return ("__text__", str(v))
    if kind == "Table":
        return ("__table__", {k: _plain(v.by_id(k)) for k in v.ids})
    if kind == "Counter":
        return ("__counter__", int(v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


def _to_port(history):
    return [PortChange.from_json(c.to_json()) for c in history]


def _fuzz_sites(seed):
    import random

    r = random.Random(seed)
    sites = [Site(a) for a in ("alice", "bob", "carol")]
    for _ in range(5):
        for s in sites:
            for _ in range(r.randint(1, 3)):
                random_mutation(s, r)
        if r.random() < 0.6:
            donor, receiver = r.sample(sites, 2)
            receiver.receive(list(donor.opset.history))
    sync(*sites)
    return sites


_corpus = {}


def _corpus_for(seed):
    """(sites, reference histories) for one fuzz seed; one doc per site,
    plus one synth_changes history."""
    if seed not in _corpus:
        sites = _fuzz_sites(seed)
        hists = [list(s.opset.history) for s in sites]
        hists.append(ref_synth.synth_changes(150, seed=seed, text_frac=0.5))
        _corpus[seed] = (sites, hists)
    return _corpus[seed]


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_docs_identical_and_convert_round_trips(seed):
    _, hists = _corpus_for(seed)
    ref = ref_columnar.pack_docs(hists)
    port = port_columnar.pack_docs([_to_port(h) for h in hists])
    fields = convert.batch_to_numpy(ref)
    got = convert.batch_to_numpy(port)
    for name in ("psrc", "ptgt", "n_ops", "doc_actors"):
        np.testing.assert_array_equal(got[name], fields[name], err_msg=name)
    for name in ("actors", "keys", "strings", "floats", "bigints"):
        assert got[name] == fields[name], name
    for c in ref.cols:
        assert port.cols[c].dtype == ref.cols[c].dtype
        np.testing.assert_array_equal(port.cols[c], ref.cols[c], err_msg=c)
    # reference fields -> port batch -> numpy fields: unchanged
    back = convert.batch_to_numpy(convert.batch_from_numpy(**fields))
    for name, v in fields.items():
        if name == "cols":
            for c in v:
                np.testing.assert_array_equal(back["cols"][c], v[c])
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(back[name], v, err_msg=name)
        else:
            assert back[name] == v, name


@pytest.mark.parametrize("seed", SEEDS)
def test_materialize_docs_match_reference_and_host_opset(seed):
    sites, hists = _corpus_for(seed)
    port_docs = port_mat.materialize_docs(
        port_mat.materialize_batch([_to_port(h) for h in hists], device="cpu")
    )
    ref_docs = ref_mat.materialize_docs(ref_mat.materialize_batch(hists))
    assert [_plain(d) for d in port_docs] == [_plain(d) for d in ref_docs]
    for site, doc in zip(sites, port_docs):
        assert _plain(doc) == _plain(site.opset.materialize())


@pytest.mark.parametrize("seed", SEEDS)
def test_decode_patch_and_text_join_identical(seed):
    _, hists = _corpus_for(seed)
    ref_dec = ref_mat.materialize_batch(hists)
    port_dec = port_mat.materialize_batch(
        [_to_port(h) for h in hists], device="cpu"
    )
    for d in range(len(hists)):
        want = ref_mat.decode_patch(ref_dec, d).to_json()
        assert port_mat.decode_patch(port_dec, d).to_json() == want
        text_rows = np.nonzero(ref_dec.cols["action"][d] == 2)[0]
        for row in text_rows.tolist():
            assert port_mat.text_join(port_dec, d, row) == ref_mat.text_join(
                ref_dec, d, row
            )


@pytest.mark.parametrize("seed", SEEDS)
def test_summaries_identical(seed):
    _, hists = _corpus_for(seed)
    ref = ref_columnar.pack_docs(hists)
    port = port_columnar.pack_docs([_to_port(h) for h in hists])
    want = ref_mat.summarize_columnar(ref)
    got = port_mat.summarize_columnar(port, device="cpu")
    host = port_mat.decode_columnar(
        port_mat.DecodedBatch(port, port_k.run_batch(port, device="cpu"))
    )
    assert got.keys() == want.keys() == host.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(host[k], got[k], err_msg=k)


@pytest.mark.parametrize("lean", [False, True])
def test_bulk_summaries_doc_identical(lean):
    _, hists = _corpus_for(0)
    ids = [f"doc{i}" for i in range(len(hists))]
    ref = ref_columnar.pack_docs(hists)
    port = port_columnar.pack_docs([_to_port(h) for h in hists])
    clocks = None
    if lean:
        # lean runs carry authoritative host clocks from the caller
        clocks = [
            {port.actors[int(a)]: 3 + j for j, a in enumerate(row) if a >= 0}
            for row in port_k.ensure_doc_actors(port)
        ]
    ra, A, K = ref_k.host_args(ref, lean=lean)
    if lean:
        f, s, c, _q, o, k, r, _v, ps, pt, da = ra
        ref_out, ref_wire = ref_k.materialize_full_lean_device(
            f, s, c, o, k, r, ps, pt, da, A=A, K=K
        )
    else:
        ref_out, ref_wire = ref_k.materialize_full_device(*ra, A=A, K=K)
    port_out, port_wire = port_k.run_batch_full(port, lean=lean, device="cpu")
    want = ref_mat.BulkSummaries(
        [(ids, ref, ref_mat.DecodedBatch(ref, ref_out, clocks), ref_wire, lean)]
    )
    got = port_mat.BulkSummaries(
        [(ids, port, port_mat.DecodedBatch(port, port_out, clocks),
          port_wire, lean)]
    )
    assert got.doc_ids == want.doc_ids
    for i in ids:
        assert got.doc(i) == want.doc(i)
        ga, gj = got.arrays(i)
        wa, wj = want.arrays(i)
        assert gj == wj
        np.testing.assert_array_equal(ga["clock"], wa["clock"])


def test_port_imports_no_jax_and_requires_a_device():
    """In a fresh interpreter with jax made unimportable, every module of
    the port imports, no hypermerge_tpu module is loaded, and an entry
    called without `device=` raises when CUDA is absent: `run_batch`,
    `pack_docs_columns` on both of its paths, `DeviceClockMirror`,
    `pack_clocks`, `ClockStore`, `Repo` (whose `repo`, `serve` and
    `backend.live` modules import without jax too; it reads on the CPU,
    with its live engine and, under HM_SERVICE=1, its service plane's
    controller on, and
    recovers a crashed directory on open
    through the port's storage/faults.py, wal.py and scrub.py, and shares
    a doc with a second Repo over the port's TcpSwarm: net/ and its
    crypto), its hyperfiles (files/) and the package's `Repo` re-export,
    its concurrency analysis (analysis/: lockdep, hierarchy, guards,
    envvars, linter, suppressions; the lint CLI),
    `telemetry.snapshot_repo`, the command-line tools (tools/: cat, cp,
    ls, meta, scrub, serve, top, watch, profile_trace), the examples
    (examples/: simple, chat),
    and `make_mesh` (parallel/, which reduces over CPU ranks). Every module of the port's bench (`bench_torch/`)
    and its harness hook (`graft_entry`) imports without jax as well."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        import importlib, pkgutil
        import hypermerge_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        # the port's bench and its harness hook import without jax too
        import bench_torch
        for m in pkgutil.walk_packages(bench_torch.__path__, "bench_torch."):
            if m.name != "bench_torch.__main__":
                importlib.import_module(m.name)
        import hypermerge_tpu_torch.graft_entry
        # durability: the fault harness, the journal and recovery
        for name in ("faults", "wal", "scrub"):
            assert f"hypermerge_tpu_torch.storage.{name}" in sys.modules, name
        # the network: transport, crypto, replication, fault injection,
        # the shared-loop transport, the DHT and the hub daemon
        for name in ("net", "net.duplex", "net.connection", "net.peer",
                     "net.secure", "net.swarm", "net.resilience",
                     "net.discovery", "net.discovery.gossip",
                     "net.replication", "net.network", "net.tcp",
                     "net.faults", "net.aio", "net.discovery.dht",
                     "net.discovery.swarm", "net.ipc", "utils.mapset",
                     "utils.chacha"):
            assert f"hypermerge_tpu_torch.{name}" in sys.modules, name
        # hyperfiles: the store, its HTTP server and client
        for name in ("files", "files.stream_logic", "files.file_store",
                     "files.file_server", "files.file_client"):
            assert f"hypermerge_tpu_torch.{name}" in sys.modules, name
        # the concurrency analysis: manifests, checkers, the lint CLI
        for name in ("analysis", "analysis.lockdep", "analysis.hierarchy",
                     "analysis.guards", "analysis.envvars",
                     "analysis.linter", "analysis.suppressions",
                     "tools", "tools.lint"):
            assert f"hypermerge_tpu_torch.{name}" in sys.modules, name
        # the command-line tools, the trace replayer and the examples
        for name in ("tools.cat", "tools.cp", "tools.ls", "tools.meta",
                     "tools.scrub", "tools.serve", "tools.top",
                     "tools.watch", "tools.profile_trace", "examples",
                     "examples.simple", "examples.chat"):
            assert f"hypermerge_tpu_torch.{name}" in sys.modules, name
        from hypermerge_tpu_torch.analysis import (
            install_racedep, lockdep_enabled, make_lock)
        from hypermerge_tpu_torch.telemetry import snapshot_repo
        # the package's re-exports, as the reference's __init__ has them
        from hypermerge_tpu_torch import Repo as PkgRepo, __version__
        from hypermerge_tpu_torch.repo import Repo as ModRepo
        assert PkgRepo is ModRepo and __version__ == "0.1.0"
        bad = [m for m in sys.modules
               if m == "hypermerge_tpu" or m.startswith("hypermerge_tpu.")]
        assert not bad, bad
        import torch
        from hypermerge_tpu_torch.ops import crdt_kernels, synth
        batch = synth.synth_batch(2, 16)
        if torch.cuda.is_available():
            print("cuda-present")
        else:
            try:
                crdt_kernels.run_batch(batch)
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
                print("raised")
            else:
                raise AssertionError("run_batch ran without a device")
        crdt_kernels.run_batch(batch, device="cpu")
        # the sidecar pack resolves its device before it routes: the
        # single-writer fast path and the multi-actor general path alike
        from hypermerge_tpu_torch.ops.columnar import pack_docs_columns
        from hypermerge_tpu_torch.storage.colcache import (
            FeedColumnCache, MemoryColumnStorage,
        )
        feeds = {}
        for c in synth.synth_changes(64, n_actors=2, ops_per_change=8):
            feeds.setdefault(c.actor, FeedColumnCache(
                MemoryColumnStorage(), writer=c.actor)).append_change(c)
        inf = float("inf")
        fast = [[(fc.columns(), 0, inf)] for fc in feeds.values()]
        general = [[(fc.columns(), 0, inf) for fc in feeds.values()]]
        for specs in (fast, general):
            if not torch.cuda.is_available():
                try:
                    pack_docs_columns(specs)
                except RuntimeError as e:
                    assert "device='cpu'" in str(e), e
                else:
                    raise AssertionError("pack_docs_columns ran without a device")
            pack_docs_columns(specs, device="cpu")
        # the clock plane: the mirror, the store and pack_clocks resolve
        # their device at the call
        from hypermerge_tpu_torch.ops.clock_kernels import pack_clocks
        from hypermerge_tpu_torch.ops.clock_mirror import DeviceClockMirror
        from hypermerge_tpu_torch.storage.sql import SqlDatabase
        from hypermerge_tpu_torch.storage.stores import ClockStore
        clock_entries = [
            lambda **kw: DeviceClockMirror(**kw),
            lambda **kw: pack_clocks([[1, 2]], **kw),
            lambda **kw: ClockStore(SqlDatabase(), **kw),
        ]
        for entry in clock_entries:
            if not torch.cuda.is_available():
                try:
                    entry()
                except RuntimeError as e:
                    assert "device='cpu'" in str(e), e
                else:
                    raise AssertionError("a clock entry ran without a device")
            entry(device="cpu")
        m = DeviceClockMirror(device="cpu")
        m.update("d", {"a": 3})
        assert m.union() == {"a": 3}
        # the multi-device plane: the mesh is built from the visible cards
        # (none here), or from ranks the caller names
        from hypermerge_tpu_torch.parallel import mesh, ring, sharded
        if not torch.cuda.is_available():
            assert mesh.visible_devices() == []
            try:
                mesh.make_mesh()
            except ValueError:
                pass
            else:
                raise AssertionError("make_mesh ran without a device")
        cpu4 = mesh.make_mesh(devices=[torch.device("cpu")] * 4)
        assert sharded.sharded_clock_union([[1, 5], [4, 2]], cpu4).cpu().tolist() == [4, 5]
        # the Repo facade and its serving tier: the backend resolves its
        # device before it builds a store
        import hypermerge_tpu_torch.repo
        import hypermerge_tpu_torch.serve
        from hypermerge_tpu_torch.repo import Repo
        from hypermerge_tpu_torch.serve import ServeTier
        if not torch.cuda.is_available():
            try:
                Repo(memory=True)
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
            else:
                raise AssertionError("Repo opened without a device")
        import os
        os.environ["HM_SERVICE"] = "1"  # the port's default is off
        r = Repo(memory=True, device="cpu")
        try:
            assert isinstance(r.back.serve, ServeTier)
            from hypermerge_tpu_torch.backend.live import LiveApplyEngine
            assert isinstance(r.back.live, LiveApplyEngine)
            # the service plane: the backend builds its controller
            assert "hypermerge_tpu_torch.serve.overload" in sys.modules
            from hypermerge_tpu_torch.serve.overload import OverloadController
            assert isinstance(r.back.overload, OverloadController)
            url = r.create({"a": 1})
            assert r.read(url, {"kind": "lookup", "path": ["a"]}) == 1
        finally:
            r.close()
        # a crashed file-backed repo recovers on open with the port alone
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            r = Repo(path=d, device="cpu")
            url = r.create({"a": 1})
            r.back.live.flush_now()
            r.back._stores.flush_now()
            del r  # no close: the marker and the journal stay
            r = Repo(path=d, device="cpu")
            try:
                assert r.back.recovery_report is not None
                assert r.doc(url) == {"a": 1}
            finally:
                r.close()
        # two repos share a doc over encrypted, authenticated TCP
        from hypermerge_tpu_torch.net.tcp import TcpSwarm
        ra, rb = Repo(memory=True, device="cpu"), Repo(memory=True, device="cpu")
        sa, sb = TcpSwarm(), TcpSwarm()
        try:
            ra.set_swarm(sa)
            rb.set_swarm(sb)
            sb.connect(sa.address)
            url = ra.create({"net": 1})
            assert rb.open(url).value(timeout=30) == {"net": 1}
        finally:
            ra.close()
            rb.close()
            sa.destroy()
            sb.destroy()
        assert "hypermerge_tpu" not in sys.modules
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split()
    assert lines[-1] == "ok"
    assert lines[-2] in ("raised", "cuda-present")


# ---------------------------------------------------------------------------
# the sidecar slice: feed column sidecars on disk -> pack -> kernels ->
# summary wire -> decoded patches, against the JAX package's same path


def _sidecar_corpus(tmp_path, corpus):
    """(reference histories, doc -> history index, row bucket)."""
    if corpus == "synth":
        hists = [
            ref_synth.synth_changes(64, n_actors=1, ops_per_change=16, seed=t)
            for t in range(3)
        ]
        return hists, [0, 1, 2, 0, 1], 64
    from hypermerge_tpu.models import Counter, Text

    site = Site("actor05")  # counter increments: the dispatch is not lean
    site.change(lambda d: d.__setitem__("n", Counter(2)))
    site.change(lambda d: d.increment("n", 5))
    site.change(lambda d: d.__setitem__("t", Text("hey")))
    site.change(lambda d: d["t"].insert(3, "!"))
    hists = [single_writer_history(40, n_mut=12), list(site.opset.history)]
    return hists, [0, 1, 1], 128


def _reopened_caches(tmp_path, hists):
    """Each history's sidecar, written and compacted by each package,
    then reopened (plane-backed): ([reference FeedColumns], [port's])."""
    ref_fcs, port_fcs = [], []
    for i, h in enumerate(hists):
        rc, pc = plane_caches(tmp_path, f"slice{i}", h)
        ref_fcs.append(rc.columns())
        port_fcs.append(pc.columns())
    return ref_fcs, port_fcs


@pytest.mark.parametrize("corpus", ["synth", "fuzz"])
def test_sidecar_slice_end_to_end(tmp_path, monkeypatch, corpus):
    hists, doc_hist, N = _sidecar_corpus(tmp_path, corpus)
    ref_fcs, port_fcs = _reopened_caches(tmp_path, hists)
    inf = float("inf")
    n_docs = port_columnar.round_up_pow2(len(doc_hist))
    monkeypatch.setenv("HM_NATIVE_PACK", "0")
    ref_b = ref_columnar.pack_docs_columns(
        [[(ref_fcs[h], 0, inf)] for h in doc_hist], n_docs=n_docs, n_rows=N
    )
    port_b = port_columnar.pack_docs_columns(
        [[(port_fcs[h], 0, inf)] for h in doc_hist], n_docs=n_docs, n_rows=N,
        device="cpu",
    )
    # lean as the bulk loader picks it: no INC ops -> host clocks
    lean = not bool(np.any(port_b.cols["action"] == int(PortAction.INC)))
    assert lean == (corpus == "synth")
    clocks = [
        {hists[h][0].actor: len(hists[h])} for h in doc_hist
    ] + [{}] * (n_docs - len(doc_hist))
    ref_out, ref_wire = ref_k.run_batch_full(ref_b, lean=lean)
    port_out, port_wire = port_k.run_batch_full(port_b, lean=lean, device="cpu")
    np.testing.assert_array_equal(port_wire.numpy(), np.asarray(ref_wire))
    want = ref_mat.fetch_summary(ref_wire, ref_b, lean=lean)
    got = port_mat.fetch_summary(port_wire, port_b, lean=lean)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    host_clocks = clocks if lean else None
    ref_dec = ref_mat.DecodedBatch(ref_b, ref_out, host_clocks=host_clocks)
    port_dec = port_mat.DecodedBatch(port_b, port_out, host_clocks=host_clocks)
    for d, h in enumerate(doc_hist):
        patch = port_mat.decode_patch(port_dec, d).to_json()
        assert patch == ref_mat.decode_patch(ref_dec, d).to_json()
        # the port's own first-slice path over the same history agrees
        one = port_mat.materialize_batch([_to_port(hists[h])], device="cpu")
        assert patch == port_mat.decode_patch(one, 0).to_json()


@pytest.mark.parametrize("n_docs", [2048, 10240])
@pytest.mark.parametrize("slab", [None, "512", "4096"])
def test_bulk_buckets_read_hm_bulk_slab(monkeypatch, slab, n_docs):
    """`bulk_buckets(n)` and so `warmup_bulk` warm the buckets the bulk
    loader launches: both read HM_BULK_SLAB, as the reference does."""
    from hypermerge_tpu.ops import warmup as ref_warmup
    from hypermerge_tpu_torch.ops import warmup

    if slab is None:
        monkeypatch.delenv("HM_BULK_SLAB", raising=False)
    else:
        monkeypatch.setenv("HM_BULK_SLAB", slab)
    got = warmup.bulk_buckets(n_docs)
    assert got == ref_warmup.bulk_buckets(n_docs)
    if slab == "512":
        assert got == [512]


def test_warmup_drives_the_slab_path(monkeypatch):
    from hypermerge_tpu.ops import warmup as ref_warmup
    from hypermerge_tpu_torch.ops import warmup

    for n, slab in ((10, 4), (4096, 4096), (9000, 4096), (1, 8)):
        assert warmup.bulk_buckets(n, slab) == ref_warmup.bulk_buckets(n, slab)
    # the port's default slab is the reference's default
    monkeypatch.delenv("HM_BULK_SLAB", raising=False)
    assert warmup.bulk_buckets(9000) == ref_warmup.bulk_buckets(9000)
    calls = []
    orig = warmup.run_batch_full

    def spy(batch, lean=False, device=None):
        calls.append((batch.shape, lean))
        return orig(batch, lean=lean, device=device)

    monkeypatch.setattr(warmup, "run_batch_full", spy)
    assert warmup.warmup_bulk(
        40, 48, slab=16, distinct=2, background=False, device="cpu"
    ) is None
    # 40 docs in slabs of 16 -> buckets 16 and 8; the port dispatches
    # every bucket on the device, so every bucket warms
    assert calls == [((16, 64), True), ((8, 64), True)]
    th = warmup.warmup_bulk(40, 48, slab=16, distinct=2, device="cpu")
    th.join(60)
    assert not th.is_alive() and len(calls) == 4
