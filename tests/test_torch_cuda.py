"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA Hopper GPU and nvcc, and skips
without one. The file imports only the port, so it runs on a machine
without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact (bool, int32 and uint8 outputs).
"""

import pytest
import torch

from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops import synth

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
