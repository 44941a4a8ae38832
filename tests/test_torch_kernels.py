"""The port's plain kernels against the JAX reference, on the CPU.

hypermerge_tpu_torch.ops.crdt_kernels holds a plain PyTorch version of
each CUDA kernel: `doc_kernel_plain` (the reference `_doc_kernel` +
`_widen`) and `summarize_wire_plain` (the reference `_summarize_wire`).
Here the same inputs, made with numpy from a seed, go through the JAX
reference (jax on the CPU) and through the port with tensors on the CPU.

Tolerance: exact. Every output is a bool mask, an int32 lane or a uint8
wire byte, so any difference is a fault.

Inputs: the reference's `synth_batch` (bench-shaped text/map histories)
and fuzz histories from tests/helpers.random_mutation, which carry INC
counters, concurrent inserts and several list/text objects per doc, so
rank ties across objects and the stability of both sorts are exercised.
"""

import random

import numpy as np
import pytest
import torch

from helpers import Site, random_mutation, sync
from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu.ops import crdt_kernels as ref_k
from hypermerge_tpu.ops import synth as ref_synth
from hypermerge_tpu_torch import convert
from hypermerge_tpu_torch.ops import crdt_kernels as pk


def _fuzz_histories(seed, n_sites=3, rounds=6):
    r = random.Random(seed)
    sites = [Site(a) for a in ("alice", "bob", "carol")[:n_sites]]
    for _ in range(rounds):
        for s in sites:
            for _ in range(r.randint(1, 3)):
                random_mutation(s, r)
        if r.random() < 0.6:
            donor, receiver = r.sample(sites, 2)
            receiver.receive(list(donor.opset.history))
    sync(*sites)
    # each site's own (diverged-then-merged) history is one doc
    return [list(s.opset.history) for s in sites]


def _fuzz_batch():
    hists = []
    for seed in range(4):
        hists += _fuzz_histories(seed)
    return ref_columnar.pack_docs(hists)


CASES = {
    "synth_1actor": lambda: ref_synth.synth_batch(6, 200, n_actors=1),
    "synth_3actor_text": lambda: ref_synth.synth_batch(
        5, 100, n_actors=3, text_frac=0.5, seed=3
    ),
    "synth_tiny": lambda: ref_synth.synth_batch(3, 5, n_actors=2),
    "fuzz": _fuzz_batch,
}
_cache = {}


def _batches(name):
    """(reference batch, port batch) for one case, built once."""
    if name not in _cache:
        ref = CASES[name]()
        port = convert.batch_from_numpy(**convert.batch_to_numpy(ref))
        _cache[name] = (ref, port)
    return _cache[name]


def _torch_args(np_args):
    return tuple(None if a is None else torch.from_numpy(a) for a in np_args)


def _assert_lanes_equal(ref_out, port_out):
    lanes = convert.out_to_numpy(port_out)
    assert tuple(lanes) == ref_out._fields
    for f in ref_out._fields:
        want = np.asarray(getattr(ref_out, f))
        got = lanes[f]
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_fuzz_corpus_exercises_counters_and_many_sequences():
    ref, _ = _batches("fuzz")
    act, ins = ref.cols["action"], ref.cols["insert"]
    assert (act == 6).any(), "no INC rows"
    seq_objs = ((act == 1) | (act == 2)).sum(axis=1)
    assert seq_objs.max() >= 2, "no doc with two list/text objects"
    # concurrent inserts: two INS rows of one doc after the same element
    d = int(np.argmax(seq_objs))
    refs = ref.cols["ref"][d][ins[d] == 1]
    assert len(refs) > len(np.unique(refs))


@pytest.mark.parametrize("name", list(CASES))
def test_host_args_match_reference(name):
    ref, port = _batches(name)
    for lean in (False, True):
        ra, rA, rK = ref_k.host_args(ref, lean=lean)
        pa, pA, pK = pk.host_args(port, lean=lean)
        assert (pA, pK) == (rA, rK)
        for a, b in zip(ra, pa):
            if a is None:
                assert b is None
                continue
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_materialize_equals_reference(name):
    ref, port = _batches(name)
    ra, A, K = ref_k.host_args(ref)
    want = ref_k.materialize_device(*ra, A=A, K=K)
    pa, _, _ = pk.host_args(port)
    got = pk.materialize_device(*_torch_args(pa), A=A, K=K)
    _assert_lanes_equal(want, got)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_full_wire_equals_reference_bytes(name):
    ref, port = _batches(name)
    ra, A, K = ref_k.host_args(ref)
    want_out, want_wire = ref_k.materialize_full_device(*ra, A=A, K=K)
    got_out, got_wire = pk.run_batch_full(port, device="cpu")
    _assert_lanes_equal(want_out, got_out)
    assert got_wire.dtype == torch.uint8
    np.testing.assert_array_equal(got_wire.numpy(), np.asarray(want_wire))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_lean_wire_equals_reference_bytes(name):
    ref, port = _batches(name)
    (flags, slot, ctr, _s, obj, key, rf, _v, psrc, ptgt, da), A, K = (
        ref_k.host_args(ref, lean=True)
    )
    want_out, want_wire = ref_k.materialize_full_lean_device(
        flags, slot, ctr, obj, key, rf, psrc, ptgt, da, A=A, K=K
    )
    got_out, got_wire = pk.run_batch_full(port, lean=True, device="cpu")
    _assert_lanes_equal(want_out, got_out)
    np.testing.assert_array_equal(got_wire.numpy(), np.asarray(want_wire))


@pytest.mark.parametrize("lean", [False, True])
def test_parse_summary_wire_matches_reference(lean):
    ref, port = _batches("fuzz")
    _, wire = pk.run_batch_full(port, lean=lean, device="cpu")
    _, A, _ = pk.bucket_doc_actors(port)
    N = port.n_rows
    want = ref_k.parse_summary_wire(wire.numpy(), N, A, lean)
    got = pk.parse_summary_wire(wire.numpy(), N, A, lean)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("bits", [1, 3, 10, 17, 18, 25])
def test_unpack_uint_matches_reference(bits):
    """The host decode of the wire's packed order entries at every width
    up to the spec's 25 bits (a value straddling 4 bytes from 18 on),
    on random bytes and on all-ones rows, against the reference's."""
    rng = np.random.default_rng(bits)
    N = 1000
    OB = (N * bits + 7) // 8
    packed = rng.integers(0, 256, (5, OB), dtype=np.uint8)
    packed[0] = 255
    want = ref_k._unpack_uint(packed, N, bits)
    got = pk._unpack_uint(packed, N, bits)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N", [1, 7, 64, 1000, 2**15, 2**20])
def test_summary_wire_spec_matches_reference(N):
    for lean in (False, True):
        assert pk.summary_wire_spec(N, 8, lean) == ref_k.summary_wire_spec(
            N, 8, lean
        )


def test_wire_spec_rejects_oversized_bucket():
    with pytest.raises(ValueError):
        pk.summary_wire_spec(2**26, 4, False)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes the
    plain version itself, and a CPU tensor is not a kernel input."""
    _, port = _batches("synth_tiny")
    args, A, K = pk.device_args(port, device="cpu")
    before = dict(pk.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pk.materialize_cuda(*args, A=A, K=K)
    out = pk.materialize_device(*args, A=A, K=K)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pk.summary_wire_cuda(out, port.n_rows, A, False)
    assert pk.launches == before


def test_entries_refuse_unknown_devices():
    _, port = _batches("synth_tiny")
    with pytest.raises(ValueError):
        pk.run_batch(port, device="meta")
