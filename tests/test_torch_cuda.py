"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA Hopper GPU and nvcc, and skips
without one. The file imports only the port, so it runs on a machine
without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact (bool, int32 and uint8 outputs).
"""

import numpy as np
import pytest
import torch

from hypermerge_tpu_torch.ops import clock_kernels as ckk
from hypermerge_tpu_torch.ops import columnar
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops.clock_mirror import DeviceClockMirror
from hypermerge_tpu_torch.ops import pack_kernels as pk
from hypermerge_tpu_torch.ops import synth
from hypermerge_tpu_torch.serve import kernels as sk
from hypermerge_tpu_torch.storage import colcache

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(batch, lean=False):
    np_args, A, K = ck.host_args(batch, lean=lean)
    return (
        tuple(None if a is None else torch.from_numpy(a).cuda() for a in np_args),
        A,
        K,
    )


SHAPES = {
    # n_docs, n_ops, synth kwargs
    "tiny": (7, 3, dict(n_actors=2, text_frac=0.5)),
    "multi_actor": (33, 1000, dict(n_actors=3, text_frac=0.5)),
    "int32_counts": (2, 40000, dict(n_actors=1)),  # N = 2^16: 4-byte counts
    "text_trace": (1, 262144, dict(n_actors=1, text_frac=0.99)),
}


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("lean", [False, True])
def test_kernels_equal_plain(cuda, name, lean):
    D, n_ops, kw = SHAPES[name]
    batch = synth.synth_batch(D, n_ops, **kw)
    args, A, K = _args(batch, lean=lean)
    got = ck.materialize_cuda(*args, A=A, K=K)
    want = ck.doc_kernel_plain(*ck.widen_plain(*args[:10]), args[10], A=A, K=K)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    N = batch.n_rows
    assert torch.equal(
        ck.summary_wire_cuda(want, N, A, lean),
        ck.summarize_wire_plain(want, N, A, lean),
    )


def test_dispatch_launches_kernels(cuda):
    batch = synth.synth_batch(4, 100)
    before = dict(ck.launches)
    out, wire = ck.run_batch_full(batch)
    torch.cuda.synchronize()
    assert wire.is_cuda and out.rank.is_cuda
    assert ck.launches["materialize"] == before["materialize"] + 1
    assert ck.launches["summary_wire"] == before["summary_wire"] + 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    batch = synth.synth_batch(2, 64)
    args, A, K = _args(batch)
    bad_flags = (args[0].to(torch.int32),) + args[1:]
    with pytest.raises(ValueError, match="flags"):
        ck.materialize_cuda(*bad_flags, A=A, K=K)
    odd = tuple(None if a is None else a[:, :48].contiguous() for a in args[:8])
    with pytest.raises(ValueError, match="power of two"):
        ck.materialize_cuda(*odd, *args[8:], A=A, K=K)
    out = ck.materialize_cuda(*args, A=A, K=K)
    strided = out._replace(rank=out.rank.t().contiguous().t())
    with pytest.raises(ValueError, match="rank"):
        ck.summary_wire_cuda(strided, batch.n_rows, A, False)


def _sidecar_feeds(tmp_path, n_ops_list):
    """Plane-backed single-writer feeds (compacted sidecar files) of
    synth histories, one per entry of `n_ops_list`."""
    fcs = []
    for t, n_ops in enumerate(n_ops_list):
        path = str(tmp_path / f"f{t}.cols2")
        cc = colcache.FeedColumnCache(colcache.FileColumnStorageV2(path), "actor00")
        for c in synth.synth_changes(n_ops, n_actors=1, ops_per_change=16, seed=t):
            cc.append_change(c)
        cc.compact()
        fc = colcache.FeedColumnCache(
            colcache.FileColumnStorageV2(path), "actor00"
        ).columns()
        assert fc.planes is not None
        fcs.append(fc)
    return fcs


@pytest.mark.parametrize("shape", ["ragged", "i16_false"])
def test_pack_kernel_equals_plain(cuda, tmp_path, monkeypatch, shape):
    """The pack on the card (pack_prefix.cu) against the same pack with
    the plain version on the CPU, and the kernel against the plain
    version on the card's own inputs."""
    inf = float("inf")
    if shape == "ragged":
        fcs = _sidecar_feeds(tmp_path, [300, 1000])
        specs = [[(fcs[0], 0, inf)], [(fcs[1], 0, 20)], [(fcs[0], 0, inf)],
                 [(fcs[1], 0, 0)]]
        kw = dict(n_docs=8, n_rows=1024)
    else:
        fcs = _sidecar_feeds(tmp_path, [40000])
        specs = [[(fcs[0], 0, inf)]]
        kw = {}
    calls = []
    orig = pk.pack_prefix

    def spy(**k):
        calls.append(k)
        return orig(**k)

    monkeypatch.setattr(pk, "pack_prefix", spy)
    before = ck.launches["pack_prefix"]
    got = columnar.pack_docs_columns(specs, device="cuda", **kw)
    assert ck.launches["pack_prefix"] == before + 1
    want = columnar.pack_docs_columns(specs, device="cpu", **kw)
    for name in columnar.COLUMNS:
        assert got.cols[name].dtype == want.cols[name].dtype, name
        np.testing.assert_array_equal(got.cols[name], want.cols[name])
    if shape == "i16_false":
        assert got.cols["ctr"].dtype == np.int32
    k = calls[0]
    assert k["planes"][0].is_cuda
    outs, mm = pk.pack_prefix_cuda(**k)
    outs_plain, mm_plain = pk.pack_prefix_plain(**k)
    torch.cuda.synchronize()
    assert torch.equal(mm, mm_plain)
    for name, a, b in zip(columnar.COLUMNS, outs, outs_plain):
        assert a.dtype == b.dtype and torch.equal(a, b), name


# -- the clock kernels -------------------------------------------------------


def _clocks(seed, D, A, hi=1000):
    """[D, A] int32 clocks on the card with INT32_INF entries."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, hi, size=(D, A)).astype(np.int32)
    m[rng.random((D, A)) < 0.02] = ckk.INT32_INF
    return torch.from_numpy(m).cuda()


@pytest.mark.parametrize("A", [1, 3, 64, 1024])
def test_clock_kernels_equal_plain(cuda, A):
    """Each clock kernel against its plain version on the same card
    tensors (the plain versions are torch ops and run there too)."""
    D = 5000
    a, b = _clocks(A, D, A), _clocks(A + 1, D, A)
    b[::3] = a[::3]
    for op, plain in ckk._PLAIN_PAIR.items():
        for x, y in ((a, b), (b[7], a), (a, b[7])):
            assert torch.equal(ckk.pair_cuda(op, x, y), plain(x, y)), op
    neg = -1 - a.abs()
    for m in (a, neg, a[:1]):
        assert torch.equal(ckk.union_reduce_cuda(m), ckk.union_reduce_plain(m))
    rng = np.random.default_rng(A)
    n = 65536
    trip = [torch.from_numpy(rng.integers(0, hi, n).astype(np.int32)).cuda()
            for hi in (D, A, 5000)]
    trip[0][: n // 2] = 3  # one hot cell
    trip[1][: n // 2] = 0
    got = ckk.scatter_max_cuda_(a.clone(), *trip)
    assert torch.equal(got, ckk.scatter_max_plain_(a.clone(), *trip))
    q = torch.full((A,), 600, dtype=torch.int32, device="cuda")
    ties = a % 3
    ties[::11] = ckk.INT32_INF
    for m in (a, ties):
        for k in (1, 64, D):
            got = ckk.top_k_dominated_cuda(m, q, k)
            want = ckk.top_k_dominated_plain(m, q, k)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_clock_mirror_on_card_equals_cpu(cuda):
    """One seeded op sequence on a mirror on the card and one on the CPU:
    equal answers and matrices, and the card's queries launch the
    kernels."""
    rng = np.random.default_rng(0)
    seed = rng.integers(1, 1000, size=(3000, 16)).astype(np.int32)
    docs = [f"d{i}" for i in range(3000)]
    actors = [f"a{j}" for j in range(16)]
    gpu, cpu = DeviceClockMirror(device="cuda"), DeviceClockMirror(device="cpu")
    for m in (gpu, cpu):
        m.seed_bulk(docs, actors, seed)
    before = dict(ck.launches)
    for i in range(500):
        for m in (gpu, cpu):
            m.update(f"d{i * 7 % 3100}", {actors[i % 16]: 900 + i, f"x{i % 70}": i})
    assert gpu.union() == cpu.union()
    assert ck.launches["clock_scatter"] == before["clock_scatter"] + 1
    assert ck.launches["clock_union"] == before["clock_union"] + 1
    q = {a: 700 for a in actors}
    assert gpu.dominated(q) == cpu.dominated(q)
    assert gpu.top_k_dominated(q, 64) == cpu.top_k_dominated(q, 64)
    assert ck.launches["clock_pair"] == before["clock_pair"] + 1
    assert ck.launches["clock_topk"] == before["clock_topk"] + 1
    for m in (gpu, cpu):
        m.set("d5", {"a1": 3})
        m.delete_doc("d6")
    assert gpu.rows() == cpu.rows()
    assert torch.equal(gpu._mat().cpu(), cpu._mat())


SERVE_CALLS = {
    "lookup": (sk.map_lookup_cuda,
               lambda st, qo, qk: sk.map_lookup_plain(st, qo, qk)),
    "order": (lambda devs, qo, qk: sk.seq_order_cuda(devs, qo),
              lambda st, qo, qk: sk.seq_order_plain(st, qo)),
    "counts": (lambda devs, qo, qk: sk.counts_cuda(devs, qo),
               lambda st, qo, qk: sk.counts_plain(st, qo)),
}


@pytest.mark.parametrize("N", [64, 4096, 65536])
@pytest.mark.parametrize("scenario", synth.SERVE_SCENARIOS)
def test_serve_kernels_equal_plain(cuda, scenario, N):
    """The three read-serving kernels against their plain versions on the
    card, with a pad batch slot (entry 0 again, query NO_OBJ); N = 4096
    and 65536 sort in global scratch."""
    lanes, qobj, qkey = synth.synth_serve_lanes(5, N, scenario, seed=N)
    t = torch.from_numpy(lanes).cuda()
    devs = list(t.unbind(0)) + [t[0]]
    qobj = np.append(qobj, sk.NO_OBJ).astype(np.int32)
    qkey = np.append(qkey, -1).astype(np.int32)
    st = torch.stack(devs)
    for name, (kernel, plain) in SERVE_CALLS.items():
        before = sum(ck.launches[k] for k in ck.launches if k.startswith("serve"))
        got = kernel(devs, qobj, qkey)
        want = plain(st, torch.from_numpy(qobj).cuda(),
                     torch.from_numpy(qkey).cuda())
        for g, w in zip(got, want):
            w = w.cpu().numpy()
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        after = sum(ck.launches[k] for k in ck.launches if k.startswith("serve"))
        assert after == before + 1


def test_repo_reads_on_the_card(cuda):
    """Repo on its default device (the card): served reads equal the host
    twin and launch the serve kernels."""
    from hypermerge_tpu_torch.models import Text
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.serve import host_read
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    r = Repo(memory=True)
    try:
        assert r.back.device.type == "cuda"
        url = r.create({"a": 1, "t": Text("hello")})
        r.change(url, lambda d: d.__setitem__("l", [1, 2, 3]))
        before = dict(ck.launches)
        doc = r.back.docs[validate_doc_url(url)]
        for q in ({"kind": "lookup", "path": ["a"]},
                  {"kind": "text", "path": ["t"]},
                  {"kind": "index", "path": ["l"], "index": 2},
                  {"kind": "len", "path": []}):
            assert r.read(url, q) == host_read(doc, q)["value"]
        for k in ("serve_lookup", "serve_order", "serve_counts"):
            assert ck.launches[k] > before[k], k
    finally:
        r.close()


# -- the multi-device plane, on virtual ranks of one card ----------------------


def _virtual_mesh(n, sp=1):
    from hypermerge_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, sp=sp, devices=[torch.device("cuda", 0)] * n)


@pytest.mark.parametrize("n,rows,W", [(1, 3, 5), (2, 1, 1), (3, 7, 3),
                                      (4, 1024, 708), (8, 13, 1540)])
def test_ring_gather_equals_plain(cuda, n, rows, W):
    from hypermerge_tpu_torch.parallel import ring as ringmod

    mesh = _virtual_mesh(n)
    g = torch.Generator().manual_seed(n * W + rows)
    blocks = [torch.randint(0, 256, (rows, W), generator=g, dtype=torch.uint8)
              .cuda() for _ in range(n)]
    before = ck.launches["ring_gather"]
    for _ in range(2):  # the second call runs at the next epoch
        got = ringmod.ring_gather_cuda(blocks, mesh.ring())
        want = ringmod.ring_gather_plain(blocks, mesh.devices)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ck.launches["ring_gather"] == before + 2


def test_ring_gather_timeout_raises(cuda, monkeypatch):
    """A rank that never raises its flag (the C entry's test argument):
    the wrapper raises RuntimeError instead of returning data, and the
    ring works again on the next call."""
    from hypermerge_tpu_torch.parallel import ring as ringmod

    mesh = _virtual_mesh(4)
    blocks = [torch.full((2, 8), r, dtype=torch.uint8, device="cuda")
              for r in range(4)]
    monkeypatch.setattr(ringmod, "_SILENT_RANK", 1)
    monkeypatch.setattr(ringmod, "TIMEOUT_NS", 50_000_000)
    with pytest.raises(RuntimeError, match="timed out"):
        ringmod.ring_gather(blocks, mesh.ring())
    monkeypatch.setattr(ringmod, "_SILENT_RANK", -1)
    got = ringmod.ring_gather(blocks, mesh.ring())
    assert torch.equal(got[0], ringmod.ring_gather_plain(blocks, mesh.devices)[0])


def test_min_reduce_equals_plain(cuda):
    rng = np.random.default_rng(3)
    for shape in ((5, 3), (8, 131072), (300, 40)):
        m = torch.from_numpy(rng.integers(-50, 1000, shape).astype(np.int32)).cuda()
        assert torch.equal(ckk.min_reduce_cuda(m), ckk.min_reduce_plain(m))


@pytest.mark.parametrize("lean", [False, True])
def test_sharded_full_on_virtual_ranks(cuda, lean):
    """sharded_full on 2 virtual ranks: the wire equals run_batch_full's,
    and repeated calls build no kernel again."""
    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.parallel import sharded

    batch = synth.synth_batch(13, 200, n_actors=3, text_frac=0.5)
    mesh = _virtual_mesh(2)
    _o, want = ck.run_batch_full(batch, lean=lean)
    _out, wire = sharded.sharded_full(batch, mesh, lean=lean)
    log = dict(_build.build_log)
    for _ in range(2):
        _out, wire = sharded.sharded_full(batch, mesh, lean=lean)
        assert torch.equal(wire.cpu()[:13], want.cpu())
    assert _build.build_log == log


def test_mesh_reductions_on_virtual_ranks(cuda):
    """Clock union and dominated on (4, 1) and (2, 2): equal to one
    device, through ring_gather and both modes of clock_union."""
    from hypermerge_tpu_torch.parallel import sharded

    rng = np.random.default_rng(0)
    clocks = rng.integers(0, 1000, (1000, 13)).astype(np.int32)
    query = clocks[17]
    for sp in (1, 2):
        mesh = _virtual_mesh(4, sp=sp)
        before = dict(ck.launches)
        union = sharded.sharded_clock_union(clocks, mesh).cpu().numpy()
        dom = sharded.sharded_dominated(clocks, query, mesh).cpu().numpy()
        np.testing.assert_array_equal(union, clocks.max(axis=0))
        np.testing.assert_array_equal(dom, np.all(clocks <= query, axis=-1))
        assert ck.launches["ring_gather"] > before["ring_gather"]
        assert ck.launches["clock_union_min"] > before["clock_union_min"]


# -- peer ranks: one card each (skipped with fewer than two cards) -------------


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices (peer ranks)")
    return [torch.device("cuda", i)
            for i in range(min(torch.cuda.device_count(), 4))]


def test_ring_gather_peer_ranks_equal_plain(cards):
    from hypermerge_tpu_torch.parallel import ring as ringmod
    from hypermerge_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=cards)
    assert mesh.mode == "peer"
    g = torch.Generator().manual_seed(7)
    for rows, W in ((1, 1), (7, 3), (1024, 708), (512, 1556), (4096, 1540)):
        blocks = [torch.randint(0, 256, (rows, W), generator=g,
                                dtype=torch.uint8).to(d) for d in cards]
        before = ck.launches["ring_gather"]
        for _ in range(2):
            got = ringmod.ring_gather_cuda(blocks, mesh.ring())
            want = ringmod.ring_gather_plain(blocks, mesh.devices)
            for a, b, d in zip(got, want, cards):
                assert a.device == d and torch.equal(a, b), (rows, W, d)
        assert ck.launches["ring_gather"] == before + 2 * len(cards)


def test_ring_gather_peer_timeout_raises(cards, monkeypatch):
    from hypermerge_tpu_torch.parallel import ring as ringmod
    from hypermerge_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=cards)
    blocks = [torch.full((2, 8), r, dtype=torch.uint8, device=d)
              for r, d in enumerate(cards)]
    monkeypatch.setattr(ringmod, "_SILENT_RANK", 0)
    monkeypatch.setattr(ringmod, "TIMEOUT_NS", 50_000_000)
    with pytest.raises(RuntimeError, match="timed out"):
        ringmod.ring_gather(blocks, mesh.ring())
    monkeypatch.setattr(ringmod, "_SILENT_RANK", -1)
    got = ringmod.ring_gather(blocks, mesh.ring())
    want = ringmod.ring_gather_plain(blocks, mesh.devices)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_mesh_on_peer_ranks(cards):
    """sharded_full, step, the clock queries and the scheduler over one
    card per rank: equal to one card."""
    from hypermerge_tpu_torch.parallel import sharded
    from hypermerge_tpu_torch.parallel.mesh import make_mesh

    n = len(cards)
    meshes = [make_mesh(devices=cards)]
    if n % 2 == 0:
        meshes.append(make_mesh(sp=2, devices=cards))
    batch = synth.synth_batch(13, 200, n_actors=3, text_frac=0.5)
    single, want = ck.run_batch_full(batch, device=cards[0])
    da, _A, _K = ck.bucket_doc_actors(batch)
    clocks = np.random.default_rng(1).integers(0, 1000, (999, 13)).astype(np.int32)
    query = clocks[5]
    for mesh in meshes:
        _out, wire = sharded.sharded_full(batch, mesh)
        assert torch.equal(wire.cpu()[:13], want.cpu())
        out, union = sharded.step(batch, mesh)
        assert torch.equal(out.rank.cpu()[:13], single.rank.cpu())
        want_union = np.zeros(len(batch.actors) + 1, np.int64)
        dan = np.asarray(da)
        np.maximum.at(want_union, np.where(dan >= 0, dan, len(batch.actors)).ravel(),
                      np.where(dan >= 0, single.clock.cpu().numpy(), 0).ravel())
        assert union.cpu().tolist() == want_union[:-1].tolist()
        u = sharded.sharded_clock_union(clocks, mesh).cpu().numpy()
        d = sharded.sharded_dominated(clocks, query, mesh).cpu().numpy()
        np.testing.assert_array_equal(u, clocks.max(axis=0))
        np.testing.assert_array_equal(d, np.all(clocks <= query, axis=-1))
    sch = sharded.MeshBulkScheduler(meshes[0])
    wires = []
    for s in range(2 * n + 1):
        b = synth.synth_batch(5, 64, n_actors=2, seed=s)
        _o, w = sch.dispatch(b)
        wires.append(w.cpu().numpy())
    gathered = sch.gather_summaries()
    assert [g[0] for g in gathered] == list(range(len(wires)))
    for (_s, _n, host), w in zip(gathered, wires):
        np.testing.assert_array_equal(host, w)
    assert sch.collective_clock_union(2).shape == (2,)


LIVE_CASES = {
    # (docs, ops per doc, synth kwargs): the trace doc's bucket with A and
    # K at their floors, and the 8-doc group's with A = 8 and K = 64
    "1x262144": (1, 259_778, dict(n_actors=1, ops_per_change=1,
                                  text_frac=1.0)),
    "8x32768": (8, 30_000, dict(n_actors=5, n_keys=40, text_frac=0.5)),
}


@pytest.mark.parametrize("name", list(LIVE_CASES))
def test_live_kernel_equals_plain(cuda, name):
    """materialize_live_device on the card equals its plain version on
    the CPU on the padded tick batch of seeded live columns (a packed
    history plus a peer's INC ops, deletes, inserts and sets)."""
    from hypermerge_tpu_torch.backend import live

    D, n_ops, kw = LIVE_CASES[name]
    lvs = []
    for d in range(D):
        hist = synth.synth_changes(n_ops, seed=3 + d, **kw)
        lv = columnar.LiveColumns.from_batch(columnar.pack_docs([hist]), 0)
        lv.append_changes(synth.synth_live_edits(hist, 300, seed=d))
        lvs.append(lv)
    N = ck.live_bucket(max(lv.n for lv in lvs), ck.LIVE_MIN_ROWS)
    assert name == f"{D}x{N}"
    planes, A, K = live.tick_batch(lvs, N)
    args = [torch.from_numpy(a) for a in planes]
    before = ck.launches["materialize_live"]
    got = ck.materialize_live_device(*(a.cuda() for a in args), A=A, K=K)
    torch.cuda.synchronize()
    assert ck.launches["materialize_live"] == before + 1
    want = ck.materialize_live_device(*args, A=A, K=K)
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert not got.clock.any()


def test_live_tick_launches_on_the_card(cuda, tmp_path, monkeypatch):
    """A remote tick over the cutover on a bulk-loaded doc launches the
    live kernel on the backend's card and lands the same state as the
    numpy twin route."""
    from hypermerge_tpu_torch.ops.corpus import make_corpus
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    urls = make_corpus(str(tmp_path), 1, 2048, sign=False)
    doc_id = validate_doc_url(urls[0])
    hist = synth.synth_changes(2048, n_actors=1, ops_per_change=16)
    edits = synth.synth_live_edits(hist, 40, rename={"actor00": doc_id})
    monkeypatch.setenv("HM_LIVE_INC_BUDGET", "0")
    values = {}
    for cells in ("0", str(2**31 - 1)):
        monkeypatch.setenv("HM_DEVICE_MIN_CELLS", cells)
        repo = Repo(path=str(tmp_path))
        try:
            (h,) = repo.open_many(urls)
            assert h.value(timeout=60) is not None
            doc = repo.back.docs[doc_id]
            before = ck.launches["materialize_live"]
            doc.apply_remote_changes(edits[:1])
            doc.apply_remote_changes(edits[1:])
            assert repo.back.live.flush_now(60)
            launched = ck.launches["materialize_live"] - before
            assert (launched > 0) == (cells == "0"), launched
            values[cells] = (doc.snapshot_patch().to_json(), dict(doc.clock))
        finally:
            repo.close()
    assert values["0"] == values[str(2**31 - 1)]
