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

from hypermerge_tpu_torch.ops import columnar
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops import pack_kernels as pk
from hypermerge_tpu_torch.ops import synth
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
