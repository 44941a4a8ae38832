"""The port's bulk cold-open warmup (hypermerge_tpu_torch/ops/warmup.py),
on the CPU: the cases of tests/test_warmup.py under their names.

- `bulk_buckets` predicts the reference's doc-axis buckets (and equals
  the reference's function on the same inputs).
- Warmup then open: the reference asserts that the bulk open compiles
  no program warmup did not compile. The port's counterpart of a
  compiled program is a slab launch shape — (doc bucket, rows, lean) of
  `run_batch_full` — and a kernel library built at first use: after
  `warmup_bulk`, the corpus open dispatches only shapes warmup already
  dispatched, and builds nothing (on the CPU the plain versions run, so
  no library is ever built; the card's counterpart, a second process
  that loads the built libraries and runs no nvcc, is
  tests/test_torch_cuda.py::test_second_process_hits_persistent_cache).

Tolerance: exact.
"""

import pytest

from hypermerge_tpu_torch.kernels import _build
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops import warmup


def test_bulk_buckets():
    from hypermerge_tpu.ops.warmup import bulk_buckets as ref_buckets

    from hypermerge_tpu_torch.ops.warmup import bulk_buckets

    assert bulk_buckets(10240, 4096) == [4096, 2048]
    assert bulk_buckets(4096, 4096) == [4096]
    assert bulk_buckets(8192, 4096) == [4096]
    assert bulk_buckets(100, 4096) == [128]
    assert bulk_buckets(1, 4096) == [1]
    for n in (1, 3, 100, 4095, 4097, 10240, 20000):
        for slab in (16, 512, 4096):
            assert bulk_buckets(n, slab) == ref_buckets(n, slab), (n, slab)


def test_warmup_precompiles_bulk_executables(monkeypatch, tmp_path):
    """After warmup_bulk, the real corpus open dispatches only slab
    shapes warmup already dispatched, and builds no kernel library."""
    monkeypatch.setenv("HM_DEVICE_MIN_CELLS", "0")
    monkeypatch.setenv("HM_MESH", "0")  # one device
    monkeypatch.setenv("HM_BULK_SLAB", "16")

    from hypermerge_tpu_torch.ops.corpus import make_corpus
    from hypermerge_tpu_torch.repo import Repo

    shapes = []
    real = ck.run_batch_full

    def spy(batch, lean=False, device=None):
        shapes.append((batch.n_docs, batch.n_rows, lean))
        return real(batch, lean=lean, device=device)

    def no_build(*a, **kw):
        raise AssertionError("a kernel library was built")

    monkeypatch.setattr(ck, "run_batch_full", spy)
    monkeypatch.setattr(warmup, "run_batch_full", spy)
    monkeypatch.setattr(_build, "_build", no_build)

    warmup.warmup_bulk(24, 64, slab=16, background=False, device="cpu")
    warm = set(shapes)
    assert {s[0] for s in warm} == {16, 8}  # [16, 64] + [8, 64] buckets

    urls = make_corpus(str(tmp_path), 24, 64, threads=2)
    shapes.clear()
    repo = Repo(path=str(tmp_path), device="cpu")
    try:
        repo.open_many(urls)
        s = repo.back.fetch_bulk_summaries()
        assert len(s.doc_ids) == 24
        assert repo.back.last_bulk_stats["fallback"] == 0
        assert shapes, "the open dispatched no slab"
        assert set(shapes) <= warm, (
            f"bulk open dispatched {set(shapes) - warm}, which warmup "
            "did not")
    finally:
        repo.close()
