"""Every case of tests/test_summary_wire.py under its own name on the port
(hypermerge_tpu_torch): the wire's bit packing, its spec, the wire
against the host reference summary (`device="cpu"`: summary_wire.cu's
plain version), and the backend's summary memo on a port `Repo(path,
device="cpu")`. Each value checked is also held against the reference
package's answer on the same inputs (its `_pack_uint` bytes, its spec,
its wire's decode, its `Repo`'s summaries on a copy of the corpus);
tolerance 0.

The twinned file's own docstring follows.

Fused summary wire + dirty-doc summary memo.

The materialization barrier transfers ONE uint8 buffer per slab — masks
bit-packed, element order at ceil(log2 N) bits per entry, narrow counts,
no clock section on lean runs. These tests pin the bit packing against
its host decoder across widths, the wire against the host reference
summary, and the backend memo that lets clean docs (clock unchanged
since their last fetch) skip pack/dispatch/transfer entirely."""

import numpy as np
import pytest
import torch

from hypermerge_tpu.ops import crdt_kernels as ref_ck
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.utils.ids import validate_doc_url
from port_helpers import Repo, copy_repo, plainify, ref_bulk_summaries


def test_pack_unpack_uint_roundtrip_across_widths():
    rng = np.random.default_rng(7)
    for bits in (1, 2, 3, 7, 8, 10, 15, 16, 17, 18, 20):
        for N in (1, 5, 8, 33, 1024):
            vals = rng.integers(0, 1 << bits, size=(3, N), dtype=np.int64)
            packed = ck._pack_uint(torch.from_numpy(vals), bits).numpy()
            assert packed.shape == (3, (N * bits + 7) // 8)
            got = ck._unpack_uint(packed, N, bits)
            assert np.array_equal(got, vals), (bits, N)
            # the reference's bytes for the same values
            want = np.asarray(ref_ck._pack_uint(vals, bits))
            assert packed.dtype == want.dtype
            assert np.array_equal(packed, want), (bits, N)
            assert np.array_equal(ref_ck._unpack_uint(packed, N, bits), got)


def test_wire_spec_totals():
    spec = ck.summary_wire_spec(1024, 4, lean=True)
    # masks 2x128 + order 10 bits x 1024 / 8 + two int16 counts
    assert spec["total"] == 128 + 128 + 1280 + 2 + 2
    assert spec == ref_ck.summary_wire_spec(1024, 4, lean=True)
    spec = ck.summary_wire_spec(1024, 4, lean=False)
    assert spec["total"] == 128 + 128 + 1280 + 2 + 2 + 16
    assert spec == ref_ck.summary_wire_spec(1024, 4, lean=False)


def test_wire_spec_rejects_untruncatable_order_bits():
    """_unpack_uint gathers at most 4 bytes per entry: order entries
    wider than 25 bits (N > 2^25 rows) would decode silently truncated
    — the spec must reject them loudly, exactly at the boundary."""
    # the largest legal bucket: order_bits == 25
    spec = ck.summary_wire_spec(2**25, 4, lean=True)
    assert spec["order_bits"] == 25
    assert spec == ref_ck.summary_wire_spec(2**25, 4, lean=True)
    with pytest.raises(ValueError, match="2\\^25"):
        ck.summary_wire_spec(2**25 + 1, 4, lean=True)
    with pytest.raises(ValueError, match="2\\^25"):
        ref_ck.summary_wire_spec(2**25 + 1, 4, lean=True)


def test_wire_matches_host_reference_summary():
    """Wire -> parse == decode_columnar on the same batch (incl. clocks
    on the non-lean wire), and the wire's bytes == the reference's."""
    from hypermerge_tpu.ops.columnar import pack_docs as ref_pack_docs
    from hypermerge_tpu.ops.synth import synth_changes as ref_synth_changes
    from hypermerge_tpu_torch.ops.columnar import pack_docs
    from hypermerge_tpu_torch.ops.crdt_kernels import run_batch, run_batch_summary
    from hypermerge_tpu_torch.ops.materialize import (
        DecodedBatch,
        decode_columnar,
        fetch_summary,
    )
    from hypermerge_tpu_torch.ops.synth import synth_changes

    histories = [
        synth_changes(96, n_actors=3, ops_per_change=8, seed=s)
        for s in range(4)
    ]
    batch = pack_docs(histories)
    want = decode_columnar(DecodedBatch(batch, run_batch(batch, device="cpu")))
    wire = run_batch_summary(batch, device="cpu")
    got = fetch_summary(wire, batch)
    for key in ("map_winner", "elem_live", "elem_order"):
        assert np.array_equal(got[key], want[key]), key
    for key in ("n_live_elems", "n_map_entries"):
        assert np.array_equal(
            np.asarray(got[key]), np.asarray(want[key])
        ), key
    assert np.array_equal(np.asarray(got["clock"]), np.asarray(want["clock"]))
    # the reference's wire on the same histories, byte for byte
    ref_batch = ref_pack_docs([
        ref_synth_changes(96, n_actors=3, ops_per_change=8, seed=s)
        for s in range(4)
    ])
    ref_wire = np.asarray(ref_ck.run_batch_summary(ref_batch))
    np.testing.assert_array_equal(wire.numpy(), ref_wire)


def _corpus_repo(tmp_path, n_docs=10, n_ops=48):
    from hypermerge_tpu_torch.ops.corpus import make_corpus

    urls = make_corpus(str(tmp_path / "repo"), n_docs, n_ops, threads=2)
    # the reference opens a copy of the same corpus
    copy_repo(tmp_path / "repo", tmp_path / "ref")
    return Repo(path=str(tmp_path / "repo")), urls


def test_summary_memo_serves_clean_docs(tmp_path):
    repo, urls = _corpus_repo(tmp_path)
    ids = [validate_doc_url(u) for u in urls]
    repo.open_many(urls)
    s1 = repo.back.fetch_bulk_summaries()
    want = {d: s1.doc(d) for d in ids}
    assert repo.back.last_bulk_stats["memo"] == 0
    assert want == ref_bulk_summaries(tmp_path / "ref", urls)

    for u in urls:
        repo.close_doc(u)
    handles = repo.open_many(urls)
    stats = repo.back.last_bulk_stats
    assert stats["memo"] == len(urls), stats
    assert stats["fast"] == len(urls)
    assert stats["t_pack"] == 0.0, "clean docs must not re-pack"
    s2 = repo.back.fetch_bulk_summaries()
    assert sorted(s2.doc_ids) == sorted(ids)
    for d in ids:
        assert s2.doc(d) == want[d]
    # memo-served docs still render (lazy one-doc snapshot decode)
    v = plainify(handles[0].value())
    assert v and "t" in v
    repo.close()


def test_summary_memo_dirty_doc_refetches(tmp_path):
    repo, urls = _corpus_repo(tmp_path, n_docs=6)
    ids = [validate_doc_url(u) for u in urls]
    repo.open_many(urls)
    repo.back.fetch_bulk_summaries()

    # dirty ONE doc (its clock advances), keep the rest clean
    repo.change(urls[0], lambda d: d.__setitem__("extra", 1))
    for u in urls:
        repo.close_doc(u)
    repo.open_many(urls)
    stats = repo.back.last_bulk_stats
    assert stats["memo"] == len(urls) - 1, stats
    s2 = repo.back.fetch_bulk_summaries()
    d0 = s2.doc(ids[0])
    assert d0["clock"][ids[0]] == max(
        s2.doc(d)["clock"][d] for d in ids
    )
    assert plainify(repo.doc(urls[0]))["extra"] == 1
    got = {d: s2.doc(d) for d in ids}
    repo.close()
    # the reference on a copy of the port's repo after the edit
    copy_repo(tmp_path / "repo", tmp_path / "ref-after")
    assert got == ref_bulk_summaries(tmp_path / "ref-after", urls)


def test_summary_memo_disabled(tmp_path, monkeypatch):
    monkeypatch.setenv("HM_SUMMARY_MEMO_MB", "0")
    repo, urls = _corpus_repo(tmp_path, n_docs=4)
    repo.open_many(urls)
    repo.back.fetch_bulk_summaries()
    for u in urls:
        repo.close_doc(u)
    repo.open_many(urls)
    assert repo.back.last_bulk_stats["memo"] == 0
    s = repo.back.fetch_bulk_summaries()
    assert len(s.doc_ids) == len(urls)
    got = {validate_doc_url(u): s.doc(validate_doc_url(u)) for u in urls}
    repo.close()
    assert got == ref_bulk_summaries(tmp_path / "ref", urls)
