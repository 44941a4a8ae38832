"""The prefix pack's hand-off to the slab launch, on the CPU, against the
dispatch's host route and the JAX package.

The port's fast pack (`pack_docs_columns`, single-writer whole-prefix
windows) leaves the slab launch's lanes where its kernel wrote them
(`batch.lanes`, here CPU tensors from the plain version) with the ranges
it folded (`batch.ranges`), and brings its wire planes to the host behind
the call (`pack_kernels.HostPlanes`). These tests hold:

- the hand-off lanes and ranges equal to what `host_args` derives from
  the host planes, value for value, on every pack case of
  tests/test_torch_pack.py;
- `run_batch_full` on the hand-off byte-identical to the same batch on
  the host route, and to the JAX package's `run_batch_full`
  (`materialize_full_device` / `_lean_device`) on the same sidecars,
  uploading only the pred edges and the actor map;
- the slab path (`pack_docs_columns` -> `run_batch_full` ->
  `fetch_summary`, and a `Repo`'s `open_many`) reading no host plane
  before the barrier: `HostPlanes.wait` raises until then, and
  `host_args` must not run. Decoded patches after the barrier equal the
  reference's.

Tolerance: exact.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from hypermerge_tpu.ops import crdt_kernels as ref_k
from hypermerge_tpu.ops import materialize as ref_mat
from hypermerge_tpu.ops.columnar import pack_docs_columns as ref_pack_columns
from hypermerge_tpu.repo import Repo as RefRepo
from hypermerge_tpu_torch.backend.repo_backend import RepoBackend
from hypermerge_tpu_torch.crdt.change import Action
from hypermerge_tpu_torch.ops import columnar as port_columnar
from hypermerge_tpu_torch.ops import crdt_kernels as port_k
from hypermerge_tpu_torch.ops import materialize as port_mat
from hypermerge_tpu_torch.ops import pack_kernels as pk
from hypermerge_tpu_torch.ops.corpus import make_corpus
from hypermerge_tpu_torch.repo import Repo
from hypermerge_tpu_torch.utils.ids import validate_doc_url
from test_torch_pack import CASES as PACK_CASES
from test_torch_pack import port_pack
from test_torch_repo import plain, ref_env  # noqa: F401 (a fixture)
from test_torch_slice import _reopened_caches, _sidecar_corpus

CPU = torch.device("cpu")
PREFIX_CASES = [c for c in PACK_CASES if c != "multi_actor_general"]
INF = float("inf")


@pytest.mark.parametrize("case", PREFIX_CASES)
def test_handoff_lanes_equal_host_args(tmp_path, monkeypatch, case):
    _, port_specs, kw, _ = PACK_CASES[case](tmp_path)
    batch, calls = port_pack(monkeypatch, port_specs, **kw)
    assert len(calls) == 1 and batch.lanes is not None
    (flags, slot, ctr, seq, obj, key, ref, value, _ps, _pt, _da), _A, _K = (
        port_k.host_args(batch, lean=False))
    lanes = batch.lanes
    assert lanes.flags.dtype == torch.uint8 and lanes.slot.dtype == torch.int8
    for name, got, want in (
        ("flags", lanes.flags, flags), ("slot", lanes.slot, slot),
        ("ctr", lanes.ctr, ctr), ("seq", lanes.seq, seq),
        ("obj", lanes.obj, obj), ("key", lanes.key, key),
        ("ref", lanes.ref, ref), ("value", lanes.value, value),
    ):
        assert got.device == CPU and got.shape == batch.shape, name
        np.testing.assert_array_equal(
            got.numpy().astype(np.int64), want.astype(np.int64), err_msg=name)
    c = batch.cols
    assert batch.ranges == {
        "vmin": int(c["value"].min(initial=0)),
        "vmax": int(c["value"].max(initial=0)),
        "ctr_max": int(c["ctr"].max(initial=0)),
        "seq_max": int(c["seq"].max(initial=0)),
        "n_inc": int((c["action"] == int(Action.INC)).sum()),
    }
    assert batch.has_inc() == bool(np.any(c["action"] == int(Action.INC)))


def _sidecar_batches(tmp_path, monkeypatch, corpus):
    """(reference batch, port batch, doc -> history, histories, n_docs)
    of the same sidecars, packed by each package."""
    hists, doc_hist, N = _sidecar_corpus(tmp_path, corpus)
    ref_fcs, port_fcs = _reopened_caches(tmp_path, hists)
    n_docs = port_columnar.round_up_pow2(len(doc_hist))
    monkeypatch.setenv("HM_NATIVE_PACK", "0")
    ref_b = ref_pack_columns(
        [[(ref_fcs[h], 0, INF)] for h in doc_hist], n_docs=n_docs, n_rows=N)
    port_b = port_columnar.pack_docs_columns(
        [[(port_fcs[h], 0, INF)] for h in doc_hist], n_docs=n_docs,
        n_rows=N, device="cpu")
    return ref_b, port_b, doc_hist, hists, n_docs


@pytest.mark.parametrize("corpus", ["synth", "fuzz"])
def test_handoff_dispatch_identical(tmp_path, monkeypatch, corpus):
    """The hand-off dispatch == the host route == the JAX package, lane
    for lane and wire byte for byte; it uploads the pred edges and the
    actor map alone."""
    ref_b, port_b, _, _, _ = _sidecar_batches(tmp_path, monkeypatch, corpus)
    lean = not port_b.has_inc()
    assert lean == (corpus == "synth")
    before = port_k._SLAB_H2D.value()
    out, wire = port_k.run_batch_full(port_b, lean=lean, device="cpu")
    da, _A, _K = port_k.bucket_doc_actors(port_b)
    N = port_b.n_rows
    assert port_k._SLAB_H2D.value() - before == (
        port_k._narrow(port_b.psrc, -1, N - 1).nbytes
        + port_k._narrow(port_b.ptgt, -1, N - 1).nbytes
        + np.ascontiguousarray(da, np.int32).nbytes)
    host_out, host_wire = port_k.run_batch_full(
        dataclasses.replace(port_b, lanes=None), lean=lean, device="cpu")
    ref_out, ref_wire = ref_k.run_batch_full(ref_b, lean=lean)
    assert wire.numpy().tobytes() == host_wire.numpy().tobytes()
    np.testing.assert_array_equal(wire.numpy(), np.asarray(ref_wire))
    for f in out._fields:
        got = getattr(out, f).numpy()
        assert got.tobytes() == getattr(host_out, f).numpy().tobytes(), f
        np.testing.assert_array_equal(got, np.asarray(getattr(ref_out, f)),
                                      err_msg=f)


class _Barrier:
    """Makes every HostPlanes read raise until `open()`, and host_args
    raise always: a slab path that reads a host plane (or narrows the
    lanes on the host) before its barrier fails."""

    def __init__(self, monkeypatch) -> None:
        self.opened = False
        wait = pk.HostPlanes.wait

        def guarded(planes):
            if not self.opened:
                raise AssertionError("a host plane was read before the barrier")
            return wait(planes)

        def no_host_args(*a, **k):
            raise AssertionError("host_args ran on the hand-off slab")

        monkeypatch.setattr(pk.HostPlanes, "wait", guarded)
        monkeypatch.setattr(port_k, "host_args", no_host_args)

    def open(self) -> None:
        self.opened = True


@pytest.mark.parametrize("corpus", ["synth", "fuzz"])
def test_slab_path_reads_no_host_plane_before_the_barrier(
        tmp_path, monkeypatch, corpus):
    ref_b, _, doc_hist, hists, n_docs = _sidecar_batches(
        tmp_path, monkeypatch, corpus)
    _, port_fcs = _reopened_caches(tmp_path / "port", hists)
    barrier = _Barrier(monkeypatch)
    batch = port_columnar.pack_docs_columns(
        [[(port_fcs[h], 0, INF)] for h in doc_hist], n_docs=n_docs,
        n_rows=ref_b.shape[1], device="cpu")
    lean = not batch.has_inc()
    out, wire = port_k.run_batch_full(batch, lean=lean, device="cpu")
    clocks = [{hists[h][0].actor: len(hists[h])} for h in doc_hist] + [
        {}] * (n_docs - len(doc_hist))
    host_clocks = clocks if lean else None
    dec = port_mat.DecodedBatch(batch, out, host_clocks=host_clocks)
    arrays = port_mat.fetch_summary(wire, batch, lean=lean)
    with pytest.raises(AssertionError, match="before the barrier"):
        batch.cols["action"]
    barrier.open()
    ref_out, ref_wire = ref_k.run_batch_full(ref_b, lean=lean)
    want = ref_mat.fetch_summary(ref_wire, ref_b, lean=lean)
    for k in want:
        np.testing.assert_array_equal(arrays[k], np.asarray(want[k]), err_msg=k)
    ref_dec = ref_mat.DecodedBatch(ref_b, ref_out, host_clocks=host_clocks)
    for d in range(len(doc_hist)):
        assert (port_mat.decode_patch(dec, d).to_json()
                == ref_mat.decode_patch(ref_dec, d).to_json())


def test_bulk_open_reads_no_host_plane_before_the_barrier(
        tmp_path, ref_env, monkeypatch):  # noqa: F811
    """A Repo's open_many packs and dispatches every slab without a host
    plane read; fetch_bulk_summaries is the barrier; the documents then
    equal the reference's on the same corpus."""
    src = tmp_path / "src"
    urls = make_corpus(str(src), 12, 64, distinct=3)
    a, b = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    barrier = _Barrier(monkeypatch)
    fetch = RepoBackend.fetch_bulk_summaries

    def barrier_fetch(back):
        barrier.open()
        return fetch(back)

    monkeypatch.setattr(RepoBackend, "fetch_bulk_summaries", barrier_fetch)
    ref, port = RefRepo(path=str(a)), Repo(path=str(b), device="cpu")
    try:
        ref.open_many(urls)
        ref.back.fetch_bulk_summaries()
        port.open_many(urls)
        assert not barrier.opened
        port.back.fetch_bulk_summaries()
        assert port.back.last_bulk_stats["fast"] == len(urls)
        for u in urls:
            d = validate_doc_url(u)
            assert (port.back.docs[d].snapshot_patch().to_json()
                    == ref.back.docs[d].snapshot_patch().to_json())
            assert plain(port.doc(u)) == plain(ref.doc(u))
    finally:
        ref.close()
        port.close()
