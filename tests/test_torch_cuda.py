"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA Hopper GPU and nvcc, and skips
without one. The file imports only the port, so it runs on a machine
without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact (bool, int32 and uint8 outputs).
"""

import ctypes
import dataclasses
import json

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
    """The slab dispatch is one launch: doc_kernel.cu's one-block route
    with the summary wire as its epilogue."""
    batch = synth.synth_batch(4, 100)
    before = dict(ck.launches)
    out, wire = ck.run_batch_full(batch)
    torch.cuda.synchronize()
    assert wire.is_cuda and out.rank.is_cuda
    assert ck.launches["materialize_wire"] == before["materialize_wire"] + 1
    assert ck.launches["materialize"] == before["materialize"]
    assert ck.launches["summary_wire"] == before["summary_wire"]


# (docs, ops per doc, synth kwargs) of the slab dispatch's shapes: the bulk
# slab, the multi-actor batch, a mesh rank's share of the slab
FUSED_SHAPES = {
    "slab": (4096, 1024, dict(n_actors=1)),
    "multi_actor": (1024, 512, dict(n_actors=3, text_frac=0.5)),
    "rank_slab": (1024, 1024, dict(n_actors=1)),
}


@pytest.mark.parametrize("name", list(FUSED_SHAPES))
@pytest.mark.parametrize("lean", [False, True])
def test_fused_dispatch_equals_plain(cuda, name, lean):
    """run_batch_full on the card: one launch (materialize_wire, nothing
    else), every lane and wire byte equal to the plain versions."""
    D, n_ops, kw = FUSED_SHAPES[name]
    batch = synth.synth_batch(D, n_ops, **kw)
    args, A, K = _args(batch, lean=lean)
    before = dict(ck.launches)
    out, wire = ck.run_batch_full(batch, lean=lean)
    torch.cuda.synchronize()
    launched = {k: ck.launches[k] - before[k] for k in ck.launches}
    assert launched == dict({k: 0 for k in ck.launches}, materialize_wire=1)
    want = ck.doc_kernel_plain(*ck.widen_plain(*args[:10]), args[10], A=A, K=K)
    for f in want._fields:
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    assert torch.equal(wire, ck.summarize_wire_plain(want, batch.n_rows, A, lean))


def test_fused_dispatch_too_large_for_shared_memory(cuda):
    """Docs of 16,384 rows do not fit a block's shared memory: the one
    launch keeps their scratch in global lanes, and is still exact; the
    entry's rule sends such docs there when there are enough of them."""
    assert ck.kernel_fn("doc_route")(200, 16384, ck.DOC_ROUTE_AUTO) == (
        ck.DOC_ROUTE_ONE_BLOCK_GLOBAL)
    batch = synth.synth_batch(2, 15000, n_actors=2, text_frac=0.7)
    args, A, K = _args(batch)
    assert ck.doc_route(2, 16384, args[0].device, ck.DOC_ROUTE_ONE_BLOCK) == (
        ck.DOC_ROUTE_ONE_BLOCK_GLOBAL)
    before = ck.launches["materialize_wire"]
    out, wire = ck.materialize_wire_cuda(*args, A=A, K=K, lean=False,
                                         route=ck.DOC_ROUTE_ONE_BLOCK)
    torch.cuda.synchronize()
    assert ck.launches["materialize_wire"] == before + 1
    want = ck.doc_kernel_plain(*ck.widen_plain(*args[:10]), args[10], A=A, K=K)
    for f in want._fields:
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    assert torch.equal(wire, ck.summarize_wire_plain(want, 16384, A, False))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    batch = synth.synth_batch(2, 64)
    args, A, K = _args(batch)
    bad_flags = (args[0].to(torch.int32),) + args[1:]
    with pytest.raises(ValueError, match="flags"):
        ck.materialize_cuda(*bad_flags, A=A, K=K)
    odd = tuple(None if a is None else a[:, :48].contiguous() for a in args[:8])
    with pytest.raises(ValueError, match="power of two"):
        ck.materialize_cuda(*odd, *args[8:], A=A, K=K)
    # a narrow lane goes to the kernel as it is: no copy makes it contiguous
    strided_ref = args[6].t().contiguous().t()
    with pytest.raises(ValueError, match="ref"):
        ck.materialize_cuda(*args[:6], strided_ref, *args[7:], A=A, K=K)
    with pytest.raises(ValueError, match="many-block"):
        ck.materialize_wire_cuda(*args, A=A, K=K, lean=False,
                                 route=ck.DOC_ROUTE_MANY_BLOCK)
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
    _hold_pack(pk.pack_prefix_cuda(**k), pk.pack_prefix_plain(**k))
    assert got.ranges == dict(zip(pk.RANGES, want.ranges.values()))
    assert got.lanes.flags.is_cuda and want.lanes.flags.device.type == "cpu"


def _hold_pack(got, want):
    """Every output of the pack: the wire planes, flags, slot, ranges."""
    torch.cuda.synchronize()
    assert got.ranges.tolist() == want.ranges.tolist()
    for name, a, b in zip((*columnar.COLUMNS, "flags", "slot"),
                          (*got.planes, got.flags, got.slot),
                          (*want.planes, want.flags, want.slot)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _slab_specs(tmp_path, n_docs=4096):
    """The sidecar slab: n_docs docs over 8 template feeds of 1,024 ops."""
    fcs = _sidecar_feeds(tmp_path, [1024] * 8)
    return [[(fcs[d % 8], 0, float("inf"))] for d in range(n_docs)]


def test_pack_kernel_equals_plain_at_the_slab(cuda, tmp_path, monkeypatch):
    """pack_prefix.cu at the sidecar slab [4096, 1024] against its plain
    version on the card's own inputs: planes, flags, slot and ranges."""
    calls = []
    orig = pk.pack_prefix

    def spy(**k):
        calls.append(k)
        return orig(**k)

    monkeypatch.setattr(pk, "pack_prefix", spy)
    columnar.pack_docs_columns(_slab_specs(tmp_path), n_docs=4096,
                               n_rows=1024, device="cuda")
    (k,) = calls
    _hold_pack(pk.pack_prefix_cuda(**k), pk.pack_prefix_plain(**k))


def test_host_cols_wait_for_their_copy(cuda, tmp_path):
    """Host columns read right after the pack, while the copy stream is
    held busy, equal the same pack's columns on the CPU: a read waits on
    the copy's event (a read that did not would see the pinned buffer
    before the copy wrote it)."""
    specs = _slab_specs(tmp_path, 512)
    want = columnar.pack_docs_columns(specs, n_docs=512, n_rows=1024,
                                      device="cpu")
    with torch.cuda.stream(pk._copy_stream(cuda)):
        torch.cuda._sleep(200_000_000)  # ~0.1 s ahead of the copy
    got = columnar.pack_docs_columns(specs, n_docs=512, n_rows=1024,
                                     device="cuda")
    assert got.cols.copying
    for name in columnar.COLUMNS:
        assert got.cols[name].dtype == want.cols[name].dtype, name
        np.testing.assert_array_equal(got.cols[name], want.cols[name])
    assert not got.cols.copying


@pytest.mark.parametrize("lean", [True, False])
def test_handoff_dispatch_equals_host_route(cuda, tmp_path, lean):
    """run_batch_full on the pack's device lanes: byte-equal to the same
    batch through host_args, and it uploads only the pred edges and the
    actor map."""
    batch = columnar.pack_docs_columns(_slab_specs(tmp_path, 1024),
                                       n_docs=1024, n_rows=1024, device="cuda")
    assert batch.lanes is not None and not batch.has_inc()
    counter = ck._SLAB_H2D
    before = counter.value()
    out, wire = ck.run_batch_full(batch, lean=lean)
    uploaded = counter.value() - before
    da, _A, _K = ck.bucket_doc_actors(batch)
    N = batch.n_rows
    assert uploaded == (ck._narrow(batch.psrc, -1, N - 1).nbytes
                        + ck._narrow(batch.ptgt, -1, N - 1).nbytes
                        + np.ascontiguousarray(da, np.int32).nbytes)
    host_route = dataclasses.replace(batch, lanes=None)
    out_h, wire_h = ck.run_batch_full(host_route, lean=lean)
    torch.cuda.synchronize()
    assert torch.equal(wire, wire_h)
    for f in out._fields:
        assert torch.equal(getattr(out, f), getattr(out_h, f)), f


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


@pytest.mark.parametrize("D,k,route", [
    (131072, 64, "select"), (131072 - 77, 64, "select"),
    (131072 - 77, ckk.TOPK_TILE + 1, "sort"), (131072, 131072, "sort"),
    (3000, 1000, "select"), (3000, 3000, "sort"), (70000, 700, "sort"),
])
def test_clock_topk_routes_equal_plain(cuda, D, k, route):
    """clock_topk.cu on both routes against the plain version: mass ties
    straddling every tile boundary, INT32_INF rows, a row count that is
    not a multiple of the tile, k = tile + 1 and k = D."""
    assert ckk.topk_plan(D, k)[0] == route
    T = ckk.TOPK_TILE
    m = _clocks(D, D, 64) % 3
    for b in range(T, D, T):
        m[b - 5 : b + 5] = 2  # equal rows on both sides of each boundary
    m[::997] = ckk.INT32_INF
    q = torch.full((64,), ckk.INT32_INF, dtype=torch.int32, device="cuda")
    for qq in (q, torch.full_like(q, 1)):
        got = ckk.top_k_dominated_cuda(m, qq, k)
        want = ckk.top_k_dominated_plain(m, qq, k)
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


@pytest.mark.parametrize("n", [0, 1, 1024, 2049, 5000])
def test_clock_scatter_params_equal_plain(cuda, n):
    """clock_scatter.cu's parameter route (host triples in the launch
    parameters, the mirror's flush) against the plain version and the
    device-triple route: one hot cell, triples outside the matrix, and
    batches above one launch's cap, each launch counted."""
    m = _clocks(5, 3000, 64)
    rng = np.random.default_rng(n)
    rows, cols, vals = (rng.integers(0, hi, n).astype(np.int32)
                        for hi in (3000, 64, 5000))
    rows[: n // 3], cols[: n // 3] = 7, 3
    if n > 4:
        rows[-1], cols[-2] = 3000, -1  # dropped
    before = ck.launches["clock_scatter"]
    got = ckk.scatter_max_params_cuda_(m.clone(), rows, cols, vals)
    cap = ck.launch_cap("clock_scatter")
    assert cap == 2048
    assert ck.launches["clock_scatter"] == before + -(-n // cap)
    trip = [torch.from_numpy(a).cuda() for a in (rows, cols, vals)]
    want = ckk.scatter_max_plain_(m.clone(), *trip)
    assert torch.equal(got, want)
    assert torch.equal(ckk.scatter_max_cuda_(m.clone(), *trip), want)


@pytest.mark.parametrize("op", list(ckk._PLAIN_PAIR))
def test_clock_pair_routes_at_config5(cuda, op):
    """clock_pair.cu at config 5's resident [131072, 64] on every route:
    the wrapper's row-and-matrix path (the row on either side, from the
    device), the by-value query on either side with the result on the
    card and through the pinned buffer, each == the plain version and
    each one launch."""
    plain = ckk._PLAIN_PAIR[op]
    m = _clocks(25, 131072, 64)
    q = m[17].clone()
    q[::5] = 990
    qh = q.cpu().numpy()
    for side in (0, 1):
        want = plain(q, m) if side == 0 else plain(m, q)
        before = ck.launches["clock_pair"]
        got = ckk.pair_cuda(op, q, m) if side == 0 else ckk.pair_cuda(op, m, q)
        assert torch.equal(got, want), side
        assert torch.equal(ckk.pair_query_cuda(op, qh, m, side), want), side
        host = ckk.pair_query_cuda(op, qh, m, side, to_host=True)
        assert isinstance(host, np.ndarray)
        assert np.array_equal(host, want.cpu().numpy()), side
        assert ck.launches["clock_pair"] == before + 3
    assert np.array_equal(ckk.gte_host(qh, m), ckk.gte_plain(q, m).cpu().numpy())
    assert torch.equal(ckk.gte_row(qh, m), ckk.gte_plain(q, m))


def test_clock_pair_pinned_route_from_two_threads(cuda):
    """Two threads calling gte_host at once, each on its own query and
    matrix, each holding its own answer: the pinned buffers are the
    thread's own."""
    import threading

    mats = [_clocks(30 + t, 20000 + 999 * t, 64) for t in range(2)]
    queries = [np.full(64, 500 + 300 * t, np.int32) for t in range(2)]
    wants = [ckk.gte_plain(torch.from_numpy(q).cuda(), m).cpu().numpy()
             for q, m in zip(queries, mats)]
    bad = []

    def run(t):
        for _ in range(200):
            got = ckk.gte_host(queries[t], mats[t])
            if not np.array_equal(got, wants[t]):
                bad.append(t)
                return

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not bad


def test_clock_pair_entry_errors_raise(cuda, monkeypatch):
    """An error code from the entry raises in the wrapper, counts no
    launch, and takes no other route: the entry's own refusal (a query
    wider than its parameters hold, passed by value), and a CUDA error
    code as the entry would return one."""
    m = _clocks(40, 16, 8192)
    q = np.zeros(8192, np.int32)
    out = torch.empty(16, dtype=torch.bool, device="cuda")
    before = ck.launches["clock_pair"]
    with pytest.raises(RuntimeError, match="clock_pair"):
        ckk._launch_pair(ckk._GTE, None, m.data_ptr(), 0, 8192, 16, 8192,
                         q.ctypes.data, 0, out, None, m.device)
    assert ckk.gte_host(q, m).shape == (16,)  # above the cap: uploaded
    real = ck.kernel_fn("clock_pair")
    monkeypatch.setitem(ck._fns, "clock_pair", lambda *a: 700)
    for call in (lambda: ckk.gte_host(q[:64], m[:, :64].contiguous()),
                 lambda: ckk.pair_cuda(ckk._GTE, m[0], m)):
        with pytest.raises(RuntimeError, match="error 700"):
            call()
    monkeypatch.setitem(ck._fns, "clock_pair", real)
    assert ck.launches["clock_pair"] == before + 1


def test_clock_scatter_wrappers_reject_what_they_do_not_take(cuda):
    m = _clocks(6, 16, 8)
    rows = np.zeros(4, np.int32)
    for bad in (rows.astype(np.int64), np.zeros(8, np.int32)[::2],
                torch.zeros(4, dtype=torch.int32)):
        with pytest.raises(ValueError, match="rows"):
            ckk.scatter_max_params_cuda_(m, bad, rows, rows)
    with pytest.raises(ValueError, match="int32 matrix"):
        ckk.scatter_max_params_cuda_(m.t(), rows, rows, rows)
    dev = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="cols"):
        ckk.scatter_max_cuda_(m, dev, dev.cpu(), dev)


def _order_dispatch(case, B, N, seed):
    """(lane tensors on the card with a pad slot when B > 1, qobj) of a
    serve_order dispatch over synth_order_lanes."""
    lanes, qobj = synth.synth_order_lanes(case, B, N, seed=seed)
    devs = list(torch.from_numpy(lanes).cuda().unbind(0))
    if B > 1:
        devs[-1], qobj[-1] = devs[0], sk.NO_OBJ
    return devs, qobj


@pytest.mark.parametrize("B,N", [(1, 1024), (8, 1024), (2050, 64), (3, 65536)])
@pytest.mark.parametrize("case", synth.ORDER_CASES)
def test_serve_order_equals_plain(cuda, case, B, N):
    """serve_order.cu's packed-key head sort and straight tail against the
    plain version: the read mix's shape, a batch above one launch's
    entries (two launches, one output), and a 65,536-row bucket whose
    keys live in global scratch ("all_live" runs the global route)."""
    devs, qobj = _order_dispatch(case, B, N, seed=B + N)
    before = ck.launches["serve_order"]
    got = sk.seq_order_cuda(devs, qobj)
    assert ck.launch_cap("serve_order", 0) == 2048
    assert ck.launches["serve_order"] == before + -(-B // 2048)
    want = sk.seq_order_plain(torch.stack(devs), torch.from_numpy(qobj).cuda())
    for g, w in zip(got, want):
        w = w.cpu().numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_serve_order_threads_keep_their_own_buffers(cuda):
    """Dispatches from several threads at once, each on its own inputs,
    each through its thread's pinned buffer: every answer its own."""
    import threading

    work = [_order_dispatch(synth.ORDER_CASES[i % 4], 1 + i % 3, 256 << (i % 3),
                            seed=i) for i in range(8)]
    want = [tuple(x.cpu().numpy() for x in sk.seq_order_plain(
        torch.stack(d), torch.from_numpy(q).cuda())) for d, q in work]
    bad = []

    def run(i):
        for _ in range(20):
            got = sk.seq_order_cuda(*work[i])
            if not all(np.array_equal(g, w) for g, w in zip(got, want[i])):
                bad.append(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not bad


def _counts_dispatch(scenario, B, N, seed):
    """(lane tensors on the card with a pad slot when B > 1, qobj) of a
    serve_counts dispatch over synth_serve_lanes."""
    lanes, qobj, _qkey = synth.synth_serve_lanes(B, N, scenario, seed=seed)
    devs = list(torch.from_numpy(lanes).cuda().unbind(0))
    if B > 1:
        devs[-1], qobj[-1] = devs[0], sk.NO_OBJ
    return devs, qobj.astype(np.int32)


def _counts_plain(devs, qobj):
    return tuple(x.cpu().numpy() for x in sk.counts_plain(
        torch.stack(devs), torch.from_numpy(qobj).cuda()))


@pytest.mark.parametrize("B,N", [(1, 2), (1, 1024), (1, 65536), (8, 2),
                                 (8, 1024), (8, 65536), (512, 2), (512, 1024),
                                 (2050, 64), (2050, 1024)])
def test_serve_counts_equal_plain(cuda, B, N):
    """serve_counts.cu (arguments by value, the result through the
    thread's pinned buffer) against the plain version; 2,050 entries take
    two launches into one output."""
    assert ck.launch_cap("serve_counts", 0) == 2048
    for i, scenario in enumerate(synth.SERVE_SCENARIOS):
        devs, qobj = _counts_dispatch(scenario, B, N, seed=B + N + i)
        before = ck.launches["serve_counts"]
        got = sk.counts_cuda(devs, qobj)
        assert ck.launches["serve_counts"] == before + -(-B // 2048)
        for g, w in zip(got, _counts_plain(devs, qobj)):
            assert g.dtype == w.dtype and np.array_equal(g, w), scenario


def test_serve_counts_threads_keep_their_own_buffers(cuda):
    """Two threads dispatching counts at once, each on its own inputs,
    each through its own pinned buffer: every answer its own."""
    import threading

    work = [_counts_dispatch(synth.SERVE_SCENARIOS[i], 8 << (2 * i), 1024,
                             seed=i) for i in range(2)]
    want = [_counts_plain(*w) for w in work]
    bad = []

    def run(i):
        for _ in range(50):
            got = sk.counts_cuda(*work[i])
            if not all(np.array_equal(g, w) for g, w in zip(got, want[i])):
                bad.append(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not bad


def test_serve_order_and_counts_share_a_thread_buffer(cuda):
    """seq_order and counts dispatches of different sizes in turn on one
    thread, through its one pinned buffer: each equal to its plain
    version, and no answer a view of the buffer."""
    order_work = [_order_dispatch(synth.ORDER_CASES[i % 4], B, N, seed=i)
                  for i, (B, N) in enumerate([(1, 1024), (8, 4096), (2, 64)])]
    counts_work = [_counts_dispatch(synth.SERVE_SCENARIOS[i], B, N, seed=i)
                   for i, (B, N) in enumerate([(512, 1024), (1, 2), (8, 1024)])]
    order_want = [tuple(x.cpu().numpy() for x in sk.seq_order_plain(
        torch.stack(d), torch.from_numpy(q).cuda())) for d, q in order_work]
    counts_want = [_counts_plain(*w) for w in counts_work]
    kept = []
    for _ in range(3):
        for i in range(3):
            got = sk.seq_order_cuda(*order_work[i])
            kept.append((got, order_want[i]))
            got = sk.counts_cuda(*counts_work[i])
            kept.append((got, counts_want[i]))
    for got, want in kept:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_serve_counts_dispatch_copies_once(cuda):
    """One counts dispatch under torch.profiler: no host-to-device copy,
    one device-to-host copy, into pinned memory, beside the kernel."""
    from torch.profiler import ProfilerActivity, profile

    devs, qobj = _counts_dispatch("random", 8, 1024, seed=4)
    sk.counts_cuda(devs, qobj)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sk.counts_cuda(devs, qobj)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("counts_kernel" in n for n in names):
            break
    else:
        pytest.fail("the profiler delivered no record of counts_kernel")
    copies = [n for n in names if "Memcpy" in n or "memcpy" in n]
    assert not [n for n in copies if "HtoD" in n], copies
    dtoh = [n for n in copies if "DtoH" in n]
    assert len(dtoh) == 1 and "Pinned" in dtoh[0], copies


def _lookup_dispatch(scenario, B, N, seed):
    """(lane tensors on the card with a pad slot when B > 1, qobj, qkey)
    of a serve_lookup dispatch over synth_serve_lanes."""
    lanes, qobj, qkey = synth.synth_serve_lanes(B, N, scenario, seed=seed)
    devs = list(torch.from_numpy(lanes).cuda().unbind(0))
    if B > 1:
        devs[-1], qobj[-1], qkey[-1] = devs[0], sk.NO_OBJ, -1
    return devs, qobj.astype(np.int32), qkey.astype(np.int32)


def _lookup_plain(devs, qobj, qkey):
    return tuple(x.cpu().numpy() for x in sk.map_lookup_plain(
        torch.stack(devs), torch.from_numpy(qobj).cuda(),
        torch.from_numpy(qkey).cuda()))


@pytest.mark.parametrize("B,N", [(1, 64), (1, 1024), (8, 65536), (64, 1024),
                                 (512, 1024), (1026, 64)])
def test_serve_lookup_equal_plain(cuda, B, N):
    """serve_lookup.cu (arguments by value, the result through the
    thread's pinned buffer) against the plain version; 1,026 entries take
    two launches into one output."""
    assert ck.launch_cap("serve_lookup", 0) == 1024
    for i, scenario in enumerate(synth.SERVE_SCENARIOS):
        devs, qobj, qkey = _lookup_dispatch(scenario, B, N, seed=B + N + i)
        before = ck.launches["serve_lookup"]
        got = sk.map_lookup_cuda(devs, qobj, qkey)
        assert ck.launches["serve_lookup"] == before + -(-B // 1024)
        for g, w in zip(got, _lookup_plain(devs, qobj, qkey)):
            assert g.dtype == w.dtype and np.array_equal(g, w), scenario


def test_serve_lookup_threads_keep_their_own_buffers(cuda):
    """Two threads dispatching lookups at once, each on its own inputs,
    each through its own pinned buffer: every answer its own."""
    import threading

    work = [_lookup_dispatch(synth.SERVE_SCENARIOS[i], 8 << (2 * i), 1024,
                             seed=i) for i in range(2)]
    want = [_lookup_plain(*w) for w in work]
    bad = []

    def run(i):
        for _ in range(50):
            got = sk.map_lookup_cuda(*work[i])
            if not all(np.array_equal(g, w) for g, w in zip(got, want[i])):
                bad.append(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not bad


def test_serve_lookup_dispatch_copies_once(cuda):
    """One lookup dispatch under torch.profiler: no host-to-device copy,
    one device-to-host copy, into pinned memory, beside the kernel."""
    from torch.profiler import ProfilerActivity, profile

    devs, qobj, qkey = _lookup_dispatch("random", 1, 1024, seed=4)
    sk.map_lookup_cuda(devs, qobj, qkey)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sk.map_lookup_cuda(devs, qobj, qkey)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("lookup_kernel" in n for n in names):
            break
    else:
        pytest.fail("the profiler delivered no record of lookup_kernel")
    copies = [n for n in names if "Memcpy" in n or "memcpy" in n]
    assert not [n for n in copies if "HtoD" in n], copies
    dtoh = [n for n in copies if "DtoH" in n]
    assert len(dtoh) == 1 and "Pinned" in dtoh[0], copies


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


def test_service_plane_on_the_card(cuda, monkeypatch):
    """A card Repo under HM_SERVICE_FORCE=brownout answers a cold doc's
    read from the host path and defers its install, while a resident doc's
    read still launches serve_counts; under shed a read past the quota is
    a typed Overload."""
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.serve.overload import Overload

    query = {"kind": "len", "path": ["l"]}
    monkeypatch.setenv("HM_SERVICE", "1")
    monkeypatch.setenv("HM_SERVICE_FORCE", "healthy")
    r = Repo(memory=True)
    try:
        back = r.back
        assert back.device.type == "cuda"
        hot = r.create({"l": [1, 2, 3]})
        cold = r.create({"l": [4, 5]})
        assert r.read(hot, query) == 3  # installs the hot doc
        resident = set(back.serve.residency_report()["resident"])
        # the ladder pinned at brownout: the backend's controller rebuilt
        monkeypatch.setenv("HM_SERVICE_FORCE", "brownout")
        back.overload.close()
        back._start_service()
        before = ck.launches["serve_counts"]
        assert r.read(hot, query) == 3
        assert ck.launches["serve_counts"] == before + 1
        assert r.read(cold, query) == 2
        assert ck.launches["serve_counts"] == before + 1
        svc = back.telemetry_payload()["service"]
        assert svc["deferred_installs"] == 1 and svc["brownout_reads"] == 1
        assert set(back.serve.residency_report()["resident"]) == resident
    finally:
        r.close()
    monkeypatch.setenv("HM_SERVICE_FORCE", "shed")
    monkeypatch.setenv("HM_QUOTA_READS_S", "0")
    monkeypatch.setenv("HM_QUOTA_BURST", "1")
    r = Repo(memory=True)
    try:
        url = r.create({"l": [1]})
        assert r.read(url, query) == 1
        with pytest.raises(Overload) as exc:
            r.read(url, query)
        assert exc.value.state == "shed" and exc.value.retry_after_s >= 0.1
        assert r.back.telemetry_payload()["service"]["shed_reads"] == 1
    finally:
        r.close()


# -- the multi-device plane, on virtual ranks of one card ----------------------


def _virtual_mesh(n, sp=1):
    from hypermerge_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, sp=sp, devices=[torch.device("cuda", 0)] * n)


@pytest.mark.parametrize("n,rows,W", [(1, 3, 5), (2, 1, 1), (3, 7, 3),
                                      (4, 1024, 708), (8, 13, 1540),
                                      (4, 4096, 1540), (4, 512, 1556)])
def test_ring_gather_equals_plain(cuda, n, rows, W):
    """The virtual route (one push launch into one concatenation that
    every rank shares, no flags, no error-word read) and the flagged
    launch over the same virtual ranks."""
    from hypermerge_tpu_torch.parallel import ring as ringmod

    mesh = _virtual_mesh(n)
    g = torch.Generator().manual_seed(n * W + rows)
    blocks = [torch.randint(0, 256, (rows, W), generator=g, dtype=torch.uint8)
              .cuda() for _ in range(n)]
    protocol = ringmod.Ring(mesh.devices, "protocol")
    before = ck.launches["ring_gather"]
    for ring in (mesh.ring(), protocol):
        for _ in range(2):  # the second call runs at the next epoch
            got = ringmod.ring_gather_cuda(blocks, ring)
            want = ringmod.ring_gather_plain(blocks, mesh.devices)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), ring.mode
    assert ck.launches["ring_gather"] == before + 4
    got = ringmod.ring_gather_cuda(blocks, mesh.ring())
    assert all(g is got[0] for g in got)
    # the virtual route never made (or read) a flag row
    assert mesh.ring().mode == "virtual"
    assert mesh.ring()._table is None and mesh.ring()._flags == []
    assert protocol._table is not None and protocol.epoch == 2


def _ring_hooks(monkeypatch, ringmod):
    """ring.py's kernel entry swapped for a build of ring_gather.cu with
    HM_RING_TEST_HOOKS; returns the build's hook setter (silent rank, late
    rank, late ns; -1, -1, 0 for none), which each test sets first."""
    from hypermerge_tpu_torch.kernels import _build

    lib = _build.load("ring_gather", ("HM_RING_TEST_HOOKS",))
    symbol, argtypes = ck._SIGNATURES["ring_gather"]
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    hooks = lib.hm_ring_test_hooks
    hooks.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    hooks.restype = None
    monkeypatch.setattr(ringmod, "kernel_fn", lambda stem: fn)
    return hooks


def test_ring_gather_timeout_raises(cuda, monkeypatch):
    """The flagged launch over virtual ranks with a rank that never raises
    its flag (the test build's hook): the wrapper raises RuntimeError
    instead of returning data, and the ring works again on the next
    call."""
    from hypermerge_tpu_torch.parallel import ring as ringmod

    mesh = _virtual_mesh(4)
    ring = ringmod.Ring(mesh.devices, "protocol")
    blocks = [torch.full((2, 8), r, dtype=torch.uint8, device="cuda")
              for r in range(4)]
    hooks = _ring_hooks(monkeypatch, ringmod)
    hooks(1, -1, 0)
    monkeypatch.setattr(ringmod, "TIMEOUT_NS", 50_000_000)
    with pytest.raises(RuntimeError, match="timed out"):
        ringmod.ring_gather(blocks, ring)
    hooks(-1, -1, 0)
    got = ringmod.ring_gather(blocks, ring)
    assert torch.equal(got[0], ringmod.ring_gather_plain(blocks, mesh.devices)[0])


def test_ring_gather_protocol_waits_for_a_late_rank(cuda, monkeypatch):
    """The flagged launch over virtual ranks with a rank whose pushes
    start 20 ms late (the test build's hook): every rank waits for its
    flag, and the result is whole."""
    from hypermerge_tpu_torch.parallel import ring as ringmod

    mesh = _virtual_mesh(4)
    ring = ringmod.Ring(mesh.devices, "protocol")
    g = torch.Generator().manual_seed(9)
    blocks = [torch.randint(0, 256, (512, 1556), generator=g,
                            dtype=torch.uint8).cuda() for _ in range(4)]
    hooks = _ring_hooks(monkeypatch, ringmod)
    hooks(-1, 3, 20_000_000)
    try:
        got = ringmod.ring_gather(blocks, ring)
    finally:
        hooks(-1, -1, 0)
    want = ringmod.ring_gather_plain(blocks, mesh.devices)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_min_reduce_equals_plain(cuda):
    rng = np.random.default_rng(3)
    for shape in ((5, 3), (8, 131072), (300, 40)):
        m = torch.from_numpy(rng.integers(-50, 1000, shape).astype(np.int32)).cuda()
        assert torch.equal(ckk.min_reduce_cuda(m), ckk.min_reduce_plain(m))


def _offset_view(m):
    """m copied into a flat card buffer one int in: a contiguous matrix
    whose base sits 4 bytes past an aligned address."""
    flat = torch.empty(m.numel() + 1, dtype=m.dtype, device=m.device)
    flat[1:] = m.flatten()
    return flat[1:].view(m.shape)


def _kernel_names(fn):
    """The device kernels one call of fn launched, by torch.profiler;
    None when the profiler delivered no kernel record in three windows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return None


# (D, A, base 4 bytes off alignment): the pmin's fold, a short matrix,
# both sides of the route boundary (D = 64 and 65), an A that is not a
# multiple of 4, an offset base
UNION_SHAPES = [(2, 50000, False), (4, 64, False), (64, 1000, False),
                (65, 1000, False), (2, 4099, False), (3, 4096, True)]


@pytest.mark.parametrize("D,A,offset", UNION_SHAPES)
@pytest.mark.parametrize("mode", ["max", "min"])
def test_column_reduce_routes_equal_plain(cuda, mode, D, A, offset):
    """Both modes of clock_union.cu against their plain versions on
    clocks, negative values and the int32 ends; a matrix of at most 64
    rows runs the columns route, one launch of one kernel (no fill)."""
    kernel, plain, name = ((ckk.union_reduce_cuda, ckk.union_reduce_plain,
                            "clock_union") if mode == "max" else
                           (ckk.min_reduce_cuda, ckk.min_reduce_plain,
                            "clock_union_min"))
    rng = np.random.default_rng(D * A)
    i32 = np.iinfo(np.int32)
    ends = rng.choice([i32.min, i32.min + 1, -1, 0, 1, i32.max - 1, i32.max],
                      (D, A)).astype(np.int32)
    for m in (_clocks(D + A, D, A), -1 - _clocks(D, D, A).abs(),
              torch.from_numpy(ends).cuda()):
        if offset:
            m = _offset_view(m)
            assert m.data_ptr() % 16 == 4
        before = ck.launches[name]
        assert torch.equal(kernel(m), plain(m))
        assert ck.launches[name] == before + 1
    names = _kernel_names(lambda: kernel(m))
    if names is not None:
        if D <= 64:
            assert len(names) == 1 and "columns_kernel" in names[0], names
        else:
            assert any("fill_kernel" in n for n in names), names


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
    hooks = _ring_hooks(monkeypatch, ringmod)
    hooks(0, -1, 0)
    monkeypatch.setattr(ringmod, "TIMEOUT_NS", 50_000_000)
    with pytest.raises(RuntimeError, match="timed out"):
        ringmod.ring_gather(blocks, mesh.ring())
    hooks(-1, -1, 0)
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
    history plus a peer's INC ops, deletes, inserts and sets). Both
    shapes take doc_kernel.cu's many-block route, and each dispatch
    counts exactly one launch."""
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


# (docs, ops per doc, synth kwargs) of live ticks that take
# doc_kernel.cu's many-block route by default; [3, 16384] cuts the padded
# batch (D bucketed to 4) to an odd D
ROUTE_CASES = {
    "1x65536": (1, 60_000, dict(n_actors=1, ops_per_change=1, text_frac=1.0)),
    "3x16384": (3, 15_000, dict(n_actors=3, n_keys=40, text_frac=0.6)),
    "8x32768": (8, 30_000, dict(n_actors=5, n_keys=40, text_frac=0.5)),
}


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_doc_kernel_routes_equal_plain(cuda, name):
    """doc_kernel.cu's one-block and many-block routes, each forced, on
    the padded tick batch of seeded live columns: both equal to the plain
    version on the CPU, so the two are byte-equal; one counted launch a
    dispatch whatever the route launches."""
    from hypermerge_tpu_torch.backend import live

    D, n_ops, kw = ROUTE_CASES[name]
    lvs = []
    for d in range(D):
        hist = synth.synth_changes(n_ops, seed=11 + d, **kw)
        lv = columnar.LiveColumns.from_batch(columnar.pack_docs([hist]), 0)
        lv.append_changes(synth.synth_live_edits(hist, 300, seed=d))
        lvs.append(lv)
    N = ck.live_bucket(max(lv.n for lv in lvs), ck.LIVE_MIN_ROWS)
    planes, A, K = live.tick_batch(lvs, N)
    flags, slot, ctr, obj, key, ref, value, psrc, ptgt = (
        torch.from_numpy(a[:D]) for a in planes)
    assert name == f"{D}x{N}"
    da = torch.zeros(D, A, dtype=torch.int32)
    args = (flags, slot, ctr, None, obj, key, ref, value, psrc, ptgt, da)
    want = ck.materialize_device(*args, A=A, K=K)
    dev = tuple(None if a is None else a.cuda() for a in args)
    for route in (ck.DOC_ROUTE_ONE_BLOCK, ck.DOC_ROUTE_MANY_BLOCK):
        before = ck.launches["materialize_live"]
        got = ck.materialize_cuda(*dev, A=A, K=K, counter="materialize_live",
                                  route=route)
        torch.cuda.synchronize()
        assert ck.launches["materialize_live"] == before + 1
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), (
                route, f)


def test_doc_route_follows_the_card(cuda):
    """doc_kernel.cu's route rule reads this card's SM count and shared
    memory: docs whose scratch fits a block's shared memory (8,192 rows on
    an H100) run one block a doc; longer docs take the many-block route
    while they leave half the SMs idle or more, and one block a doc with
    global scratch above."""
    half = torch.cuda.get_device_properties(0).multi_processor_count // 2
    pick = ck.kernel_fn("doc_route")

    def route(D, N):
        return pick(D, N, ck.DOC_ROUTE_AUTO)

    one, many = ck.DOC_ROUTE_ONE_BLOCK, ck.DOC_ROUTE_MANY_BLOCK
    assert route(1, 262144) == route(half, 16384) == route(1, 16384) == many
    assert route(half + 1, 4096) == route(4096, 1024) == one
    assert route(1, 4096) == route(1, 8192) == route(8, 8192) == one
    assert route(half + 1, 16384) == ck.DOC_ROUTE_ONE_BLOCK_GLOBAL


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


def test_recovered_copy_opens_on_the_card(cuda, tmp_path, monkeypatch):
    """A writer killed mid-session leaves its marker and journal in a
    corpus of single-writer docs (every doc on the pack's prefix route);
    a copy recovered and opened on the card gives the recovery report and
    the summaries of a copy recovered and opened on the CPU, through the
    pack and slab kernels."""
    import shutil

    from hypermerge_tpu_torch.ops.corpus import make_corpus
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    monkeypatch.setenv("HM_FSYNC", "1")
    src = tmp_path / "src"
    urls = make_corpus(str(src), 16, 256, sign=False)
    writer = Repo(path=str(src), device="cpu")
    url = writer.create({"edits": []})
    for i in range(12):
        writer.change(url, lambda d, i=i: d["edits"].append(i))
    writer.back.live.flush_now()
    writer.back._stores.flush_now()
    writer.back._cache_syncs.flush_now()
    writer.back.durability.flush_now()
    del writer  # a crash: the marker and the journal stay behind
    urls.append(url)
    ids = [validate_doc_url(u) for u in urls]
    rows = {}
    for name, device in (("cpu", "cpu"), ("cuda", None)):
        shutil.copytree(src, tmp_path / name)  # a copy: recovery writes
        before = dict(ck.launches)
        repo = Repo(path=str(tmp_path / name), device=device)
        try:
            rep = dict(repo.back.recovery_report)
            assert rep.pop("t_recover_ms") >= 0
            assert rep["wal"]["bounded"] == 1, rep["wal"]
            assert rep["feeds_skipped"] >= 16, rep
            repo.open_many(urls)
            summ = repo.back.fetch_bulk_summaries()
            got = {}
            for d in ids:
                arrays, j = summ.arrays(d)
                got[d] = {k: np.asarray(v[j]).tobytes()
                          for k, v in arrays.items()}
                got[d]["doc"] = summ.doc(d)
            rows[name] = (rep, got, repo.doc(url))
            if name == "cuda":
                for k in ("pack_prefix", "materialize_wire"):
                    assert ck.launches[k] > before[k], k
        finally:
            repo.close()
    assert rows["cuda"] == rows["cpu"]
    assert rows["cuda"][2] == {"edits": list(range(12))}


def test_two_repos_converge_over_loopback_on_the_card(cuda, monkeypatch):
    """Two port repos on the card share 3 docs over LoopbackSwarm, both
    writing. Each of A's changes carries 12 ops, and with the live
    cutovers at 0 (HM_LIVE_INC_BUDGET, HM_DEVICE_MIN_CELLS) every tick of
    more than 8 ops goes to the kernel: B applies A's changes through
    materialize_live on its card. Both sides converge to equal values
    holding every edit once."""
    import time

    from hypermerge_tpu_torch.net.swarm import LoopbackHub, LoopbackSwarm
    from hypermerge_tpu_torch.repo import Repo

    monkeypatch.setenv("HM_LIVE_INC_BUDGET", "0")
    monkeypatch.setenv("HM_DEVICE_MIN_CELLS", "0")
    hub = LoopbackHub()
    ra, rb = Repo(memory=True), Repo(memory=True)
    try:
        assert ra.back.device.type == rb.back.device.type == "cuda"
        ra.set_swarm(LoopbackSwarm(hub))
        rb.set_swarm(LoopbackSwarm(hub))
        urls = [ra.create({"edits": []}) for _ in range(3)]
        handles = [rb.open(u) for u in urls]
        for h in handles:
            assert h.value(timeout=60) is not None
        before = ck.launches["materialize_live"]
        want = {u: [] for u in urls}
        for r in range(4):
            for u in urls:
                vals = [100 * r + j for j in range(12)]
                ra.change(u, lambda d, vals=vals: [
                    d["edits"].append(v) for v in vals])
                want[u] += vals
            u = urls[r % 3]
            handles[r % 3].change(lambda d, r=r: d["edits"].append(-1 - r))
            want[u].append(-1 - r)

        def converged():
            for u in urls:
                a, b = ra.doc(u), rb.doc(u)
                if a != b or sorted(b["edits"]) != sorted(want[u]):
                    return False
            return True

        deadline = time.monotonic() + 60
        while not converged():
            assert time.monotonic() < deadline, "no convergence in 60 s"
            time.sleep(0.02)
        assert ck.launches["materialize_live"] > before
        assert rb.back.live.stats["device_dispatches"] > 0
    finally:
        ra.close()
        rb.close()


def test_two_repos_reconverge_through_kill_and_heal_on_the_card(
        cuda, monkeypatch):
    """Two port repos on the card over the shared-loop transport
    (HM_NET_ASYNC=1), B's swarm wrapped in a seeded FaultSwarm whose plan
    kills the link mid-burst and heals it. With the live cutovers at 0
    every remote tick of more than 8 ops goes to the kernel. The
    supervised redial resyncs B, and both sides converge to the state an
    unfaulted LoopbackSwarm pair reaches on the same edits, with
    materialize_live launched on the card."""
    import time

    from hypermerge_tpu_torch.net.faults import FaultPlan, FaultSwarm
    from hypermerge_tpu_torch.net.swarm import LoopbackHub, LoopbackSwarm
    from hypermerge_tpu_torch.net.tcp import TcpSwarm
    from hypermerge_tpu_torch.repo import Repo

    for k, v in (("HM_LIVE_INC_BUDGET", "0"), ("HM_DEVICE_MIN_CELLS", "0"),
                 ("HM_LIVE_TICK_MS", "500"), ("HM_NET_ASYNC", "1"),
                 ("HM_REDIAL_BASE_MS", "20"), ("HM_REDIAL_MAX_S", "0.25")):
        monkeypatch.setenv(k, v)

    def script(ra, rb, url, lo, hi):
        for i in range(lo, hi):
            vals = [100 * i + j for j in range(12)]
            ra.change(url, lambda d, vals=vals: [
                d["a"].append(v) for v in vals])
            rb.change(url, lambda d, i=i: d["b"].append(i))

    def wait(fn, what):
        deadline = time.monotonic() + 60
        while not fn():
            assert time.monotonic() < deadline, f"{what} not in 60 s"
            time.sleep(0.02)

    hub = LoopbackHub()
    twin = [Repo(memory=True), Repo(memory=True)]
    try:
        for r in twin:
            r.set_swarm(LoopbackSwarm(hub))
        url = twin[0].create({"a": [], "b": []})
        assert twin[1].open(url).value(timeout=60) is not None
        script(*twin, url, 0, 12)
        wait(lambda: len(twin[0].doc(url)["b"]) == 12
             and twin[0].doc(url) == twin[1].doc(url), "the twin")
        want = twin[0].doc(url)
    finally:
        for r in twin:
            r.close()

    plan = FaultPlan(seed=11, events=[(1, "kill"), (2, "heal")])
    ra, rb = Repo(memory=True), Repo(memory=True)
    sa, fb = TcpSwarm(), FaultSwarm(TcpSwarm(), plan)
    try:
        assert ra.back.device.type == rb.back.device.type == "cuda"
        assert sa._async and fb.inner._async
        ra.set_swarm(sa)
        rb.set_swarm(fb)
        fb.connect(sa.address)
        url = ra.create({"a": [], "b": []})
        assert rb.open(url).value(timeout=60) is not None
        before = ck.launches["materialize_live"]
        script(ra, rb, url, 0, 4)
        fb.tick()  # kill
        wait(lambda: plan.down, "the kill")
        script(ra, rb, url, 4, 8)
        fb.tick()  # heal: the supervised redial goes through
        script(ra, rb, url, 8, 12)
        wait(lambda: ra.doc(url) == want and rb.doc(url) == want,
             "convergence")
        assert rb.back.network.replication.stats["resyncs"] >= 1
        assert ck.launches["materialize_live"] > before
    finally:
        ra.close()
        rb.close()
        sa.destroy()
        fb.destroy()


def test_hub_workers_on_the_card_converge_a_paste(cuda, tmp_path):
    """A hub daemon with two workers (`python -m hypermerge_tpu_torch.net.ipc
    ... --hub`, HM_WORKERS=2, no --device: the card) under durable acks: a
    writer's paste of 16 keys reaches an observer connection, and each
    worker is the port's module started with `--device cuda`, with the
    CUDA driver (libcuda) mapped."""
    import os
    import signal
    import subprocess
    import sys
    import threading
    import time

    from hypermerge_tpu_torch.net.ipc import connect_frontend

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sock = str(tmp_path / "hub.sock")
    env = dict(os.environ, PYTHONPATH=root, HM_WORKERS="2", HM_FSYNC="1",
               HM_ACK_DURABLE="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "hypermerge_tpu_torch.net.ipc",
         str(tmp_path / "repo"), sock, "--hub"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=root,
        start_new_session=True,
    )
    lines = []
    threading.Thread(target=lambda: lines.extend(
        iter(proc.stdout.readline, "")), daemon=True).start()

    def wait(fn, what, timeout=120):
        deadline = time.monotonic() + timeout
        while not fn():
            assert proc.poll() is None, "the hub exited"
            assert time.monotonic() < deadline, f"{what} not in {timeout} s"
            time.sleep(0.02)

    def value(h):
        try:
            return h.value(timeout=0.2)
        except TimeoutError:
            return None

    closers = []
    try:
        wait(lambda: sum(ln.startswith("worker") for ln in lines) == 2,
             "the workers")
        for ln in lines[1:3]:
            pid = int(ln.split()[3])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode().split("\0")
            assert "hypermerge_tpu_torch.net.ipc" in argv, argv
            assert argv[argv.index("--device") + 1] == "cuda", argv
        front, close = connect_frontend(sock)
        closers.append(close)
        obs, close_obs = connect_frontend(sock)
        closers.append(close_obs)
        url = front.create({"n": 0})
        want = {"n": 0, **{f"p{k}": k for k in range(16)}}

        def paste(d):
            for k in range(16):
                d[f"p{k}"] = k

        front.change(url, paste)
        h = obs.open(url)
        wait(lambda: value(h) == want, "the paste at the observer")
        for ln in lines[1:3]:
            with open(f"/proc/{int(ln.split()[3])}/maps") as f:
                assert "libcuda" in f.read()
    finally:
        for close in closers:
            close()
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)


_WARM_CHILD = r"""
import json, sys
sys.path.insert(0, {repo!r})
from hypermerge_tpu_torch.kernels import _build
from hypermerge_tpu_torch.ops.warmup import warmup_bulk


class _NoCompiler:
    def __init__(self, cmd, *a, **kw):
        raise AssertionError("nvcc ran: " + " ".join(map(str, cmd)))


_build.subprocess.Popen = _NoCompiler
warmup_bulk(8, 64, slab=8, background=False)
print(json.dumps(sorted(stem for stem, _d in _build._libs)))
"""


def test_second_process_hits_persistent_cache(cuda, tmp_path):
    """The port's counterpart of the reference's persistent compile
    cache: kernels/_build.py keeps each built library under its source
    hash, so a second process that warms the bulk path loads the
    libraries this process built, and starts no nvcc."""
    import os
    import subprocess
    import sys

    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.ops.warmup import warmup_bulk

    warmup_bulk(8, 64, slab=8, background=False)
    built = set(os.listdir(_build.BUILD_DIR))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, "-c", _WARM_CHILD.format(repo=repo)],
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = json.loads(p.stdout.strip().splitlines()[-1])
    # the slab's device pack and its one launch
    assert {"pack_prefix", "doc_kernel"} <= set(loaded), loaded
    assert set(os.listdir(_build.BUILD_DIR)) == built, "the child built"
