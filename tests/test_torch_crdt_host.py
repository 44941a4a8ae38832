"""Every case of tests/test_crdt_host.py under its own name on the port
(hypermerge_tpu_torch.crdt: FrontendDoc, OpSet, Change), with the port's
Site (tests/port_helpers.py). Each case ends by holding every site it
made against the reference package on the same history: a reference
OpSet applies the site's changes (carried over by their JSON form) and
must give the same materialized doc, clock, snapshot patch JSON and
frontend doc (`assert_reference_agrees`); tolerance 0.

The twinned file's own docstring follows.

Host CRDT path: OpSet (backend) + FrontendDoc (frontend) semantics.

Scenario shapes mirror the reference's repo.test.ts suites (create/change/
merge/materialize) plus property-style convergence fuzzing the reference
lacks (SURVEY.md §4 gaps)."""

import random

import pytest

from hypermerge_tpu_torch.crdt.change import Change
from hypermerge_tpu_torch.crdt.frontend_state import FrontendDoc
from hypermerge_tpu_torch.models import Counter, Table, Text

from port_helpers import Site, assert_reference_agrees, plainify as _plainify, sync


def test_map_set_and_preview():
    s = Site("alice")
    change, preview = s.change(lambda d: d.__setitem__("title", "hello"))
    assert preview == {"title": "hello"}
    assert s.doc == {"title": "hello"}
    assert change.seq == 1 and len(change.ops) == 1
    s.assert_consistent()
    # the reference package on the same histories
    assert_reference_agrees(s)


def test_nested_deep_assign():
    s = Site("alice")

    def init(d):
        d["config"] = {"theme": {"color": "red"}, "tags": ["a", "b"]}

    s.change(init)
    assert s.doc == {"config": {"theme": {"color": "red"}, "tags": ["a", "b"]}}
    s.assert_consistent()

    def update(d):
        d["config"]["theme"]["color"] = "blue"
        d["config"]["tags"].append("c")

    s.change(update)
    assert s.doc["config"]["theme"]["color"] == "blue"
    assert s.doc["config"]["tags"] == ["a", "b", "c"]
    s.assert_consistent()
    # the reference package on the same histories
    assert_reference_agrees(s)


def test_delete_key():
    s = Site("alice")
    s.change(lambda d: d.__setitem__("x", 1))
    s.change(lambda d: d.__delitem__("x"))
    assert s.doc == {}
    s.assert_consistent()
    # the reference package on the same histories
    assert_reference_agrees(s)


def test_lww_concurrent_set_conflict():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("x", 0))
    b.receive(a.opset.history)
    a.change(lambda d: d.__setitem__("x", "from-a"))
    b.change(lambda d: d.__setitem__("x", "from-b"))
    sync(a, b)
    # same winner everywhere: max OpId -> same ctr, 'bob' > 'alice'
    assert a.doc == b.doc == {"x": "from-b"}
    a.assert_consistent()
    b.assert_consistent()
    # the loser surfaces as a conflict on the root cell
    root = a.front.objs["0@_root"]
    assert len(root.data["x"].conflicts) == 1
    assert root.data["x"].conflicts[0].value == "from-a"
    # the reference package on the same histories
    assert_reference_agrees(a, b)


def test_concurrent_set_vs_delete_preserves_set():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("x", 0))
    b.receive(a.opset.history)
    a.change(lambda d: d.__delitem__("x"))  # deletes only what alice saw
    b.change(lambda d: d.__setitem__("x", 9))  # concurrent new value
    sync(a, b)
    assert a.doc == b.doc == {"x": 9}
    # the reference package on the same histories
    assert_reference_agrees(a, b)


def test_list_concurrent_inserts_converge():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("l", ["x"]))
    b.receive(a.opset.history)
    a.change(lambda d: d["l"].append("a1"))
    a.change(lambda d: d["l"].append("a2"))
    b.change(lambda d: d["l"].append("b1"))
    b.change(lambda d: d["l"].append("b2"))
    sync(a, b)
    assert a.doc == b.doc
    vals = a.doc["l"]
    assert vals[0] == "x"
    assert sorted(vals[1:]) == ["a1", "a2", "b1", "b2"]
    # each writer's run stays contiguous and ordered (RGA no-interleave for
    # same-position inserts is not guaranteed in general, but relative order
    # within one actor must hold)
    assert vals.index("a1") < vals.index("a2")
    assert vals.index("b1") < vals.index("b2")
    # the reference package on the same histories
    assert_reference_agrees(a, b)


def test_list_set_and_delete():
    s = Site("alice")
    s.change(lambda d: d.__setitem__("l", [1, 2, 3]))
    s.change(lambda d: d["l"].__setitem__(1, 20))
    assert s.doc["l"] == [1, 20, 3]
    s.change(lambda d: d["l"].__delitem__(0))
    assert s.doc["l"] == [20, 3]
    s.assert_consistent()
    # the reference package on the same histories
    assert_reference_agrees(s)


def test_text_editing():
    s = Site("alice")

    def init(d):
        d["t"] = Text("helo")

    s.change(init)
    assert str(s.doc["t"]) == "helo"

    def fix(d):
        d["t"].insert(2, "l")

    s.change(fix)
    assert str(s.doc["t"]) == "hello"

    def shout(d):
        d["t"].delete(0, 1)
        d["t"].insert(0, "H")
        d["t"].insert(5, " world")

    s.change(shout)
    assert str(s.doc["t"]) == "Hello world"
    s.assert_consistent()
    # the reference package on the same histories
    assert_reference_agrees(s)


def test_concurrent_text_converges():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("t", Text("ac")))
    b.receive(a.opset.history)
    a.change(lambda d: d["t"].insert(1, "b"))  # a: "abc"
    b.change(lambda d: d["t"].insert(2, "d"))  # b: "acd"
    sync(a, b)
    assert str(a.doc["t"]) == str(b.doc["t"]) == "abcd"
    # the reference package on the same histories
    assert_reference_agrees(a, b)


def test_counter_concurrent_increments_add():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("n", Counter(10)))
    b.receive(a.opset.history)
    a.change(lambda d: d.increment("n", 5))
    b.change(lambda d: d.increment("n", 7))
    sync(a, b)
    assert int(a.doc["n"]) == int(b.doc["n"]) == 22
    assert isinstance(a.doc["n"], Counter)
    # the reference package on the same histories
    assert_reference_agrees(a, b)


def test_counter_set_discards_concurrent_increments():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("n", Counter(10)))
    b.receive(a.opset.history)
    a.change(lambda d: d.__setitem__("n", Counter(100)))  # replace counter
    b.change(lambda d: d.increment("n", 7))  # inc on the old counter op
    sync(a, b)
    assert int(a.doc["n"]) == int(b.doc["n"]) == 100
    # the reference package on the same histories
    assert_reference_agrees(a, b)


def test_table_rows():
    s = Site("alice")

    def init(d):
        d["t"] = Table({"r1": {"name": "ada"}})

    s.change(init)

    def add(d):
        d["t"].add("r2", {"name": "bob"})

    s.change(add)
    t = s.doc["t"]
    assert t.count == 2 and t.by_id("r2") == {"name": "bob"}

    def remove(d):
        d["t"].remove("r1")

    s.change(remove)
    assert s.doc["t"].ids == ["r2"]
    s.assert_consistent()
    # the reference package on the same histories
    assert_reference_agrees(s)


def test_out_of_order_delivery_queues():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("x", 1))
    a.change(lambda d: d.__setitem__("x", 2))
    a.change(lambda d: d.__setitem__("x", 3))
    h = list(a.opset.history)
    b.receive([h[2]])  # future change parks
    assert b.doc == {}
    assert b.opset.missing_deps() == {"alice": 2}
    b.receive([h[0]])
    assert b.doc == {"x": 1}
    b.receive([h[1]])  # unblocks the parked change too
    assert b.doc == {"x": 3}
    assert not b.opset._pending
    # the reference package on the same histories
    assert_reference_agrees(a, b)


def test_duplicate_changes_ignored():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("x", 1))
    b.receive(a.opset.history)
    b.receive(a.opset.history)
    assert b.doc == {"x": 1}
    assert len(b.opset.history) == 1
    # the reference package on the same histories
    assert_reference_agrees(a, b)


def test_change_serialization_roundtrip():
    s = Site("alice")
    change, _ = s.change(lambda d: d.__setitem__("k", {"deep": [1, Text("ab")]}))
    wire = change.to_json()
    assert Change.from_json(wire) == change
    from hypermerge_tpu.crdt.change import Change as RefChange

    assert RefChange.from_json(wire).to_json() == wire
    # the reference package on the same histories
    assert_reference_agrees(s)


def test_time_travel_materialize_at():
    s = Site("alice")
    s.change(lambda d: d.__setitem__("x", 1))
    s.change(lambda d: d.__setitem__("x", 2))
    s.change(lambda d: d.__delitem__("x"))
    assert s.opset.materialize_at(0) == {}
    assert s.opset.materialize_at(1) == {"x": 1}
    assert s.opset.materialize_at(2) == {"x": 2}
    assert s.opset.materialize_at(3) == {}
    # the reference package on the same histories
    assert_reference_agrees(s)


def test_snapshot_patch_rebuilds_fresh_frontend():
    s = Site("alice")
    s.change(
        lambda d: d.__setitem__(
            "doc", {"list": [1, {"n": 2}], "txt": Text("hi"), "c": Counter(4)}
        )
    )
    s.change(lambda d: d["doc"].increment("c", 1))
    fresh = FrontendDoc()
    fresh.apply_patch(s.opset.snapshot_patch())
    assert _plainify(fresh.materialize()) == _plainify(s.doc)
    # the reference package on the same histories
    assert_reference_agrees(s)


def test_three_way_fuzz_convergence(rng):
    actors = ["alice", "bob", "carol"]
    sites = [Site(a) for a in actors]

    def random_mutation(site, r):
        def fn(d):
            choice = r.random()
            if choice < 0.3:
                d[r.choice("abc")] = r.randint(0, 99)
            elif choice < 0.45:
                if "l" not in d:
                    d["l"] = []
                lst = d["l"]
                lst.insert(r.randint(0, len(lst)), r.randint(0, 9))
            elif choice < 0.55:
                if "l" in d and len(d["l"]) > 0:
                    del d["l"][r.randint(0, len(d["l"]) - 1)]
            elif choice < 0.7:
                if "t" not in d:
                    d["t"] = Text("")
                d["t"].insert(r.randint(0, len(d["t"])), r.choice("xyz"))
            elif choice < 0.8:
                if "n" not in d or not isinstance(d.get("n"), Counter):
                    d["n"] = Counter(0)
                else:
                    d.increment("n", r.randint(1, 3))
            elif choice < 0.9:
                k = r.choice("abc")
                if k in d:
                    del d[k]
            else:
                d[r.choice("mn")] = {"v": [r.randint(0, 9)]}

        site.change(fn)

    for round_ in range(6):
        for s in sites:
            for _ in range(rng.randint(1, 4)):
                random_mutation(s, rng)
        if rng.random() < 0.5:  # partial gossip mid-run, shuffled delivery
            donor, receiver = rng.sample(sites, 2)
            h = list(donor.opset.history)
            rng.shuffle(h)
            receiver.receive(h)

    # final full sync with shuffled delivery order
    for receiver in sites:
        combined = [
            c
            for donor in sites
            if donor is not receiver
            for c in donor.opset.history
        ]
        rng.shuffle(combined)
        receiver.receive(combined)

    docs = [_plainify(s.doc) for s in sites]
    assert docs[0] == docs[1] == docs[2]
    for s in sites:
        s.assert_consistent()
        assert not s.opset._pending
    # the reference package on the same histories
    assert_reference_agrees(*sites)


def test_concurrent_list_set_vs_delete_resurrects_consistently():
    """A deleted elem resurrected by a concurrent set must reach the
    frontend as an *insert* (it already removed the elem)."""
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("l", ["x", "y", "z"]))
    b.receive(a.opset.history)
    a.change(lambda d: d["l"].__delitem__(1))
    b.change(lambda d: d["l"].__setitem__(1, "Y"))
    sync(a, b)
    assert a.doc["l"] == b.doc["l"] == ["x", "Y", "z"]
    a.assert_consistent()
    b.assert_consistent()
    # the reference package on the same histories
    assert_reference_agrees(a, b)


def test_failed_intent_does_not_alias_temp_id():
    from hypermerge_tpu.crdt.change import Action, ChangeRequest, OpIntent

    s = Site("alice")
    s.change(lambda d: d.__setitem__("l", []))
    # handcrafted request: first MAKE targets an out-of-range list index
    # (fails to resolve); second MAKE succeeds; the SET addressed to the
    # FAILED temp id must go nowhere — not into the second object
    list_obj = next(
        str(o) for o, st in s.opset.objects.items() if st.type == "list"
    )
    req = ChangeRequest(
        "alice",
        s.seq,
        0,
        "",
        (
            OpIntent(Action.MAKE_MAP, list_obj, index=99, insert=True,
                     temp_id="tmp:0"),
            OpIntent(Action.MAKE_MAP, "_root", key="ok", temp_id="tmp:1"),
            OpIntent(Action.SET, "tmp:0", key="leak", value="bad"),
        ),
    )
    s.opset.apply_local_request(req)
    assert s.opset.materialize()["ok"] == {}  # no leak into the wrong obj
    # the reference package on the same histories
    assert_reference_agrees(s)


def test_snapshot_includes_elem_conflicts():
    a, b = Site("alice"), Site("bob")
    a.change(lambda d: d.__setitem__("l", ["x"]))
    b.receive(a.opset.history)
    a.change(lambda d: d["l"].__setitem__(0, "A"))
    b.change(lambda d: d["l"].__setitem__(0, "B"))
    sync(a, b)
    snap = a.opset.snapshot_patch()
    ins = [d for d in snap.diffs if d.action == "insert"][0]
    assert len(ins.conflicts) == 1 and ins.conflicts[0].value == "A"
    # the reference package on the same histories
    assert_reference_agrees(a, b)
