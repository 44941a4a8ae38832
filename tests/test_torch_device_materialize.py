"""Every case of tests/test_device_materialize.py under its own name on
the port (hypermerge_tpu_torch), kernels on the CPU (`device="cpu"`: the
plain versions of doc_kernel.cu and summary_wire.cu). Each case runs as
the reference runs it, with the port's Site (tests/port_helpers.py), and
holds what it checks against the reference package's answer on the same
history too (the port's changes carried over by their JSON form);
tolerance 0.

The twinned file's own docstring follows.

Device batched materialization == host OpSet, for arbitrary histories.

This is the core correctness contract of the framework (SURVEY.md §7.3.6:
determinism across backends — both paths must produce identical state from
the same feeds)."""

import random

import numpy as np
import pytest

from helpers import plainify as ref_plainify
from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu.ops import materialize as ref_mat
from hypermerge_tpu_torch.models import Counter, Text
from hypermerge_tpu_torch.ops import columnar
from hypermerge_tpu_torch.ops.materialize import (
    decode_columnar,
    decode_patch,
    materialize_batch,
    materialize_docs,
    text_join,
)
from port_helpers import Site, plainify, random_mutation, sync, to_reference


def device_docs(*histories):
    dec = materialize_batch([list(h) for h in histories], device="cpu")
    docs = materialize_docs(dec)
    # the reference package on the same histories
    ref_dec = ref_mat.materialize_batch([to_reference(h) for h in histories])
    ref_docs = ref_mat.materialize_docs(ref_dec)
    assert [plainify(d) for d in docs] == [ref_plainify(d) for d in ref_docs]
    for d in range(len(histories)):
        assert dec.clock_dict(d) == ref_dec.clock_dict(d)
    want = ref_mat.decode_columnar(ref_dec)
    got = decode_columnar(dec)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(
            np.asarray(got[k]), np.asarray(want[k]), err_msg=k
        )
    return dec, docs


def _patch_key(p):
    return [
        (d.obj, d.key, d.type, d.value, [c.op_id for c in d.conflicts])
        for d in p.diffs
    ]


def test_single_doc_map():
    s = Site("alice")
    s.change(lambda d: d.__setitem__("x", 1))
    s.change(lambda d: d.__setitem__("y", "hello"))
    s.change(lambda d: d.__delitem__("x"))
    dec, docs = device_docs(s.opset.history)
    assert plainify(docs[0]) == plainify(s.opset.materialize())
    assert dec.clock_dict(0) == s.opset.clock


def test_nested_and_lists():
    s = Site("alice")
    s.change(
        lambda d: d.__setitem__(
            "cfg", {"deep": {"list": [1, 2, 3]}, "t": Text("hey")}
        )
    )
    s.change(lambda d: d["cfg"]["deep"]["list"].insert(1, 99))
    s.change(lambda d: d["cfg"]["deep"]["list"].__delitem__(0))
    s.change(lambda d: d["cfg"]["t"].insert(3, "!"))
    _, docs = device_docs(s.opset.history)
    assert plainify(docs[0]) == plainify(s.opset.materialize())


def test_concurrent_conflicts_match_host():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("x", 0))
    b.receive(a.opset.history)
    a.change(lambda d: d.__setitem__("x", "A"))
    b.change(lambda d: d.__setitem__("x", "B"))
    sync(a, b)
    dec, docs = device_docs(a.opset.history)
    assert plainify(docs[0]) == plainify(a.opset.materialize())
    # conflicts survive the device path identically to the host snapshot
    host_patch = a.opset.snapshot_patch()
    dev_patch = decode_patch(dec, 0)
    host_x = [d for d in host_patch.diffs if d.key == "x"][0]
    dev_x = [d for d in dev_patch.diffs if d.key == "x"][0]
    assert host_x.value == dev_x.value
    assert [c.op_id for c in host_x.conflicts] == [
        c.op_id for c in dev_x.conflicts
    ]
    # and the reference's device patch on the same history
    ref_dec = ref_mat.materialize_batch([to_reference(a.opset.history)])
    ref_x = [d for d in ref_mat.decode_patch(ref_dec, 0).diffs
             if d.key == "x"][0]
    assert ref_x.value == dev_x.value
    assert [str(c.op_id) for c in ref_x.conflicts] == [
        str(c.op_id) for c in dev_x.conflicts
    ]


def test_counters_and_incs():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("n", Counter(10)))
    b.receive(a.opset.history)
    a.change(lambda d: d.increment("n", 5))
    b.change(lambda d: d.increment("n", 7))
    sync(a, b)
    _, docs = device_docs(a.opset.history)
    assert plainify(docs[0]) == plainify(a.opset.materialize())
    assert int(docs[0]["n"]) == 22


def test_rga_concurrent_inserts_match_host():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("l", ["x"]))
    b.receive(a.opset.history)
    for i in range(4):
        a.change(lambda d: d["l"].insert(1, f"a{i}"))
        b.change(lambda d: d["l"].insert(1, f"b{i}"))
    sync(a, b)
    assert plainify(a.doc) == plainify(b.doc)
    _, docs = device_docs(a.opset.history)
    assert plainify(docs[0]) == plainify(a.opset.materialize())


def test_batch_many_docs():
    sites = []
    for i in range(7):
        s = Site(f"actor{i}")
        s.change(lambda d: d.__setitem__("id", i))
        s.change(lambda d: d.__setitem__("l", list(range(i))))
        sites.append(s)
    dec, docs = device_docs(*[s.opset.history for s in sites])
    for s, doc in zip(sites, docs):
        assert plainify(doc) == plainify(s.opset.materialize())
    cols = decode_columnar(dec)
    assert cols["clock"].shape[0] == 7


def test_device_summary_equals_host_decode():
    # summarize_columnar (fused summary, bit-packed transfer) must agree
    # exactly with decode_columnar (host numpy reference)
    from hypermerge_tpu_torch.ops.materialize import summarize_columnar

    rng = random.Random(7)
    sites = [Site(f"s{i}") for i in range(5)]
    for _ in range(60):
        random_mutation(rng.choice(sites), rng)
    for i in range(len(sites) - 1):
        sync(sites[i], sites[i + 1])
    histories = [list(s.opset.history) for s in sites]
    batch = columnar.pack_docs(histories)
    dec = materialize_batch(histories, device="cpu")
    host = decode_columnar(dec)
    dev = summarize_columnar(batch, device="cpu")
    ref = ref_mat.summarize_columnar(
        ref_columnar.pack_docs([to_reference(h) for h in histories])
    )
    assert sorted(host) == sorted(ref)
    for k in host:
        np.testing.assert_array_equal(
            np.asarray(host[k]), np.asarray(dev[k]), err_msg=k
        )
        np.testing.assert_array_equal(
            np.asarray(dev[k]), np.asarray(ref[k]), err_msg=k
        )


def test_text_join_fast_path():
    s = Site("alice")
    s.change(lambda d: d.__setitem__("t", Text("hello")))
    s.change(lambda d: d["t"].insert(5, " world"))
    s.change(lambda d: d["t"].delete(0, 1))
    dec, _ = device_docs(s.opset.history)
    # find the text object's row: the MAKE_TEXT op
    act = dec.cols["action"][0]
    row = int(np.nonzero(act == 2)[0][0])
    assert text_join(dec, 0, row) == "ello world"
    assert str(s.opset.materialize()["t"]) == "ello world"
    ref_dec = ref_mat.materialize_batch([to_reference(s.opset.history)])
    assert ref_mat.text_join(ref_dec, 0, row) == "ello world"


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_fuzz_device_equals_host(seed):
    r = random.Random(seed)
    actors = ["alice", "bob", "carol"]
    sites = [Site(a) for a in actors]
    for _ in range(5):
        for s in sites:
            for _ in range(r.randint(1, 3)):
                random_mutation(s, r)
        if r.random() < 0.6:
            donor, receiver = r.sample(sites, 2)
            receiver.receive(list(donor.opset.history))
    sync(*sites)
    assert plainify(sites[0].doc) == plainify(sites[1].doc)
    _, docs = device_docs(sites[0].opset.history)
    assert plainify(docs[0]) == plainify(sites[0].opset.materialize())


def test_causal_sort_is_valid_linear_extension():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("x", 1))
    b.receive(a.opset.history)
    b.change(lambda d: d.__setitem__("y", 2))
    a.receive(b.opset.history)
    a.change(lambda d: d.__setitem__("z", 3))
    shuffled = list(a.opset.history)
    random.Random(0).shuffle(shuffled)
    ordered = columnar.causal_sort(shuffled)
    seen_clock = {}
    for c in ordered:
        for dep_actor, dep_seq in c.deps.items():
            assert seen_clock.get(dep_actor, 0) >= dep_seq
        assert seen_clock.get(c.actor, 0) == c.seq - 1
        seen_clock[c.actor] = c.seq
    # the reference's order of the same shuffled changes
    want = ref_columnar.causal_sort(to_reference(shuffled))
    assert [(c.actor, c.seq) for c in ordered] == [
        (c.actor, c.seq) for c in want
    ]


def test_pack_roundtrip_values():
    s = Site("alice")
    s.change(
        lambda d: (
            d.__setitem__("i", 42),
            d.__setitem__("big", 2**40),
            d.__setitem__("f", 3.14159),
            d.__setitem__("b", True),
            d.__setitem__("none_later", 1),
            d.__setitem__("s", "string"),
        )
    )
    s.change(lambda d: d.__setitem__("none_later", None))
    _, docs = device_docs(s.opset.history)
    assert plainify(docs[0]) == plainify(s.opset.materialize())
    assert docs[0]["big"] == 2**40
    assert docs[0]["f"] == 3.14159
    assert docs[0]["none_later"] is None
    assert type(docs[0]["b"]) is bool and docs[0]["b"] is True


def test_host_kernel_matches_device():
    """ops/host_kernel.py is a bit-exact numpy twin of the kernel (the
    interactive single-doc open path must agree with bulk slabs); both
    equal the reference's kernel on the same batch."""
    from hypermerge_tpu.ops.crdt_kernels import run_batch as ref_run_batch
    from hypermerge_tpu.ops.synth import synth_batch as ref_synth_batch
    from hypermerge_tpu.ops.synth import synth_changes as ref_synth_changes
    from hypermerge_tpu_torch import convert
    from hypermerge_tpu_torch.ops.columnar import pack_docs
    from hypermerge_tpu_torch.ops.crdt_kernels import run_batch
    from hypermerge_tpu_torch.ops.host_kernel import run_batch_host
    from hypermerge_tpu_torch.ops.synth import synth_batch, synth_changes

    histories = [synth_changes(257, seed=s) for s in range(3)]
    ref_histories = [ref_synth_changes(257, seed=s) for s in range(3)]
    for h, rh in zip(histories, ref_histories):
        assert [c.to_json() for c in h] == [c.to_json() for c in rh]
    pairs = (
        (pack_docs(histories), ref_columnar.pack_docs(ref_histories)),
        (synth_batch(5, 192), ref_synth_batch(5, 192)),
    )
    for batch, ref_batch in pairs:
        dev = run_batch(batch, device="cpu")
        host = run_batch_host(batch)
        want = ref_run_batch(ref_batch)
        got = convert.out_to_numpy(dev)
        for f in host._fields:
            np.testing.assert_array_equal(got[f], getattr(host, f),
                                          err_msg=f)
            np.testing.assert_array_equal(
                getattr(host, f), np.asarray(getattr(want, f)), err_msg=f
            )
