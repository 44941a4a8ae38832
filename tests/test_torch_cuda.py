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
