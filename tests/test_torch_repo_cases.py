"""Every case of tests/test_repo.py not already in tests/test_torch_repo.py,
under its own name on the port's Repo (hypermerge_tpu_torch/repo.py,
`device="cpu"`). Each doc value a case checks is also held against the
reference package's answer on the same inputs: a reference OpSet applied
to the doc's history as the port's feeds hold it
(`assert_repo_doc_reference`), the reference Repo reading a copy of the
port's repo directory, or a reference `Repo(memory=True)` (under HM_LIVE=0
HM_PIPELINE=0 HM_WAL=0 HM_SERVICE=0) driven through the same calls;
tolerance 0.

The twinned file's own docstring follows.

Repo runtime end-to-end: create/change/watch/merge/fork/materialize/
meta/persistence — the repo.test.ts-shaped suite (reference
tests/repo.test.ts scenarios, SURVEY.md §4)."""

import tempfile

import pytest

from hypermerge_tpu_torch.models import Counter, Text
from hypermerge_tpu_torch.utils.ids import validate_doc_url
from port_helpers import (  # noqa: F401 (ref_repo: a fixture)
    Repo,
    assert_reference_reads,
    assert_repo_doc_reference,
    plainify,
    ref_plain,
    ref_repo,
    repo_history,
)


@pytest.fixture
def repo():
    r = Repo(memory=True)
    yield r
    r.close()


def test_create_with_init(repo):
    url = repo.create({"a": 1, "nested": {"b": [1, 2]}})
    assert repo.doc(url) == {"a": 1, "nested": {"b": [1, 2]}}
    assert_repo_doc_reference(repo, url)


def test_open_twice_same_doc(repo):
    url = repo.create({"x": 1})
    h1 = repo.open(url)
    h2 = repo.open(url)
    assert h1.value() == h2.value() == {"x": 1}
    assert_repo_doc_reference(repo, url, h1.value())
    h1.close()
    h2.close()


def test_merge(repo):
    """Merge adopts the target's actors into the url's cursor (reference
    tests/repo.test.ts:47-101)."""
    a = repo.create({"a": 1})
    b = repo.create({"b": 2})
    repo.merge(a, b)
    assert repo.doc(a) == {"a": 1, "b": 2}
    # cursor now includes b's root actor
    a_id, b_id = validate_doc_url(a), validate_doc_url(b)
    cursor = repo.back.cursors.get(repo.back.id, a_id)
    assert b_id in cursor
    # the reference on a's merged history: both roots' changes
    assert {c.actor for c in repo_history(repo, a)} == {a_id, b_id}
    assert_repo_doc_reference(repo, a)


def test_merge_against_pending_target_times_out(repo):
    """Merging with an unknown (never-replicated) target must not dangle
    silently forever: the pending merge expires, the handle is released,
    and the source doc is untouched."""
    import time

    from hypermerge_tpu_torch.utils import keys as keymod
    from hypermerge_tpu_torch.utils.ids import to_doc_url

    a = repo.create({"a": 1})
    bogus = to_doc_url(keymod.create().public_key)
    repo.front.merge(a, bogus, timeout=0.05)
    time.sleep(0.3)
    assert repo.doc(a) == {"a": 1}  # no merge happened, no crash
    a_id = validate_doc_url(a)
    cursor = repo.back.cursors.get(repo.back.id, a_id)
    assert validate_doc_url(bogus) not in cursor
    assert_repo_doc_reference(repo, a)


def test_fork(repo):
    """Fork: changes to the fork don't affect the original (reference
    tests/repo.test.ts:103-127)."""
    url = repo.create({"x": 1})
    fork = repo.fork(url)
    repo.change(fork, lambda d: d.__setitem__("y", 2))
    assert repo.doc(fork) == {"x": 1, "y": 2}
    assert repo.doc(url) == {"x": 1}
    assert_repo_doc_reference(repo, fork)
    assert_repo_doc_reference(repo, url)


def test_materialize_time_travel(repo):
    """(reference tests/repo.test.ts:129-164)."""
    url = repo.create({"x": 1})
    repo.change(url, lambda d: d.__setitem__("x", 2))
    repo.change(url, lambda d: d.__setitem__("x", 3))
    out = []
    repo.materialize(url, 2, out.append)
    assert out == [{"x": 2}]
    repo.materialize(url, 1, out.append)
    assert out[-1] == {"x": 1}
    # the reference's time travel over the same history
    ref = assert_repo_doc_reference(repo, url)
    assert [ref_plain(ref.materialize_at(k)) for k in (2, 1)] == out


def test_meta(repo):
    """(reference tests/repo.test.ts:166-197)."""
    url = repo.create({"x": 1})
    repo.change(url, lambda d: d.__setitem__("y", 2))
    out = []
    repo.meta(url, out.append)
    meta = out[0]
    assert meta["type"] == "Document"
    assert meta["history"] == 2
    doc_id = validate_doc_url(url)
    assert any(s.startswith(doc_id) for s in meta["clock"])
    # the reference's clock strings for the same history
    from hypermerge_tpu.crdt import clock as ref_clock

    ref = assert_repo_doc_reference(repo, url)
    assert sorted(meta["clock"]) == sorted(ref_clock.clock_to_strs(ref.clock))
    assert meta["history"] == len(ref.history)


def test_rich_types_through_runtime(repo):
    url = repo.create()
    repo.change(url, lambda d: d.__setitem__("t", Text("abc")))
    repo.change(url, lambda d: d.__setitem__("n", Counter(5)))
    repo.change(url, lambda d: d["t"].insert(3, "!"))
    repo.change(url, lambda d: d.increment("n", 3))
    doc = repo.doc(url)
    assert str(doc["t"]) == "abc!"
    assert int(doc["n"]) == 8
    assert_repo_doc_reference(repo, url)


def test_change_before_ready_queues(repo):
    # an Open'd doc is pending until the backend loads it; changes queue
    url = repo.create({"x": 1})
    doc_id = validate_doc_url(url)
    # simulate a fresh frontend state by closing and reopening the doc
    repo.close_doc(url)
    h = repo.open(url)
    h.change(lambda d: d.__setitem__("y", 2))
    assert h.value() == {"x": 1, "y": 2}
    assert_repo_doc_reference(repo, url, h.value())
    h.close()


def test_destroy(repo):
    url = repo.create({"x": 1})
    doc_id = validate_doc_url(url)
    repo.destroy(url)
    assert doc_id not in repo.back.docs
    assert repo.back.clocks.get(repo.back.id, doc_id) == {}


def test_destroy_reference_twin(repo, ref_repo):
    """test_destroy's calls on a reference Repo: the same store state."""
    for r in (repo, ref_repo):
        url = r.create({"x": 1})
        doc_id = url.split("/")[-1]
        r.destroy(url)
        assert doc_id not in r.back.docs
        assert r.back.clocks.get(r.back.id, doc_id) == {}


def test_persistence_across_restart():
    with tempfile.TemporaryDirectory() as tmp:
        repo = Repo(path=tmp)
        url = repo.create({"x": 1})
        repo.change(url, lambda d: d.__setitem__("t", Text("persist")))
        repo.change(url, lambda d: d["t"].insert(7, "!"))
        repo_id = repo.id
        repo.close()

        repo2 = Repo(path=tmp)
        assert repo2.id == repo_id  # same self.repo keypair
        doc = repo2.doc(url)
        assert str(doc["t"]) == "persist!"
        assert doc["x"] == 1
        # and the doc is still writable after restart
        repo2.change(url, lambda d: d.__setitem__("again", True))
        assert repo2.doc(url)["again"] is True
        final = plainify(repo2.doc(url))
        assert_repo_doc_reference(repo2, url)
        repo2.close()
        assert_reference_reads(tmp, [url], [final])


def test_bulk_cold_start_matches_incremental():
    with tempfile.TemporaryDirectory() as tmp:
        repo = Repo(path=tmp)
        urls = []
        for i in range(5):
            url = repo.create({"i": i, "t": Text(f"doc{i}")})
            repo.change(url, lambda d: d["t"].insert(0, ">"))
            urls.append(url)
        repo.close()

        repo2 = Repo(path=tmp)
        ids = [validate_doc_url(u) for u in urls]
        repo2.back.load_documents_bulk(ids)
        for i, url in enumerate(urls):
            doc = repo2.doc(url)
            assert doc["i"] == i
            assert str(doc["t"]) == f">doc{i}"
        final = [plainify(repo2.doc(u)) for u in urls]
        repo2.close()
        assert_reference_reads(tmp, urls, final)


def test_clockstore_updates(repo):
    """ClockStore mirrors doc clocks after changes (reference
    tests/repo.test.ts:215-248 ClockStore consistency)."""
    url = repo.create({"x": 1})
    repo.change(url, lambda d: d.__setitem__("x", 2))
    doc_id = validate_doc_url(url)
    # clock rows flush debounced (one executemany per burst): settle it
    repo.back._stores.flush_now()
    stored = repo.back.clocks.get(repo.back.id, doc_id)
    assert stored == {doc_id: 2}
    assert stored == dict(assert_repo_doc_reference(repo, url).clock)


def test_store_debounce_off_writes_cursor_rows_synchronously():
    """HM_STORE_DEBOUNCE=0 is the correctness twin for the store
    coalescing: BOTH clock and cursor rows must land synchronously,
    with nothing left inside the debouncer — otherwise bisecting a
    store-coalescing bug with the knob off doesn't reproduce the
    pre-debounce behavior."""
    import os

    os.environ["HM_STORE_DEBOUNCE"] = "0"
    try:
        repo = Repo(memory=True)
        back = repo.back
        marks = []
        orig_mark = back._stores.mark
        back._stores.mark = lambda *a, **kw: (
            marks.append(a), orig_mark(*a, **kw)
        )
        url = repo.create({"x": 1})
        repo.change(url, lambda d: d.__setitem__("x", 2))
        doc_id = validate_doc_url(url)
        # neither clock ("c") nor cursor ("u") rows went through the
        # debouncer...
        assert marks == []
        # ...and the rows are already durable, no flush needed
        assert back.clocks.get(back.id, doc_id) == {doc_id: 2}
        assert_repo_doc_reference(repo, url)
        repo.close()
    finally:
        del os.environ["HM_STORE_DEBOUNCE"]


def test_debug_info(repo, ref_repo):
    url = repo.create({"x": 1})
    info = repo.debug(url)
    assert info["mode"] == "write"
    assert info["seq"] == 2
    # the reference's debug of the same calls: the same keys and values
    # but the doc's own ids
    rinfo = ref_repo.debug(ref_repo.create({"x": 1}))
    assert sorted(info) == sorted(rinfo)
    assert (info["mode"], info["seq"]) == (rinfo["mode"], rinfo["seq"])


def test_open_unknown_doc_stays_pending(repo):
    """Opening a doc we have no history for must NOT render an empty doc —
    it waits for replication (minimumClock gate)."""
    from hypermerge_tpu_torch.utils import keys

    ghost_url = "hypermerge:/" + keys.create().public_key
    h = repo.open(ghost_url)
    with pytest.raises(TimeoutError):
        h.value(timeout=0.2)
    h.close()
    assert repo_history(repo, ghost_url) == []


def test_handle_fork_and_merge_conveniences():
    """Handle.fork()/merge() (reference src/Handle.ts:21-36)."""
    repo = Repo(memory=True)
    h = repo.open(repo.create({"a": 1}))
    h2 = repo.open(h.fork())
    assert h2.value() == {"a": 1}
    h2.change(lambda d: d.__setitem__("b", 2))
    h.merge(h2)
    import time as _t

    deadline = _t.time() + 10
    while _t.time() < deadline and h.value().get("b") != 2:
        _t.sleep(0.02)
    assert h.value() == {"a": 1, "b": 2}
    assert_repo_doc_reference(repo, h.url, h.value())
    repo.close()


def test_actor_backfill_callbacks_out_of_order(repo):
    """Replicated blocks whose per-block append callbacks arrive out of
    order — or never — must still become visible. Feed.append_verified
    fires its listeners OUTSIDE the feed lock, so two concurrent
    backfill batches (multi-source repair after churn) can interleave
    their _on_append fan-outs. Regression: the actor's slot list grew
    exactly one slot per callback, so an out-of-order index raised
    IndexError mid-fan-out and left the list short forever — seq_head
    and changes_in_window clamped to the stale head and the doc never
    converged (50-peer churn soak). The feed's block log is
    authoritative; the slot list must re-size from it on every read."""
    from hypermerge_tpu_torch.crdt.change import Action, Change, Op, ROOT
    from hypermerge_tpu_torch.storage import block as blockmod

    url = repo.create({"edits": []})
    doc_id = validate_doc_url(url)
    repo.change(url, lambda d: d["edits"].append(0))
    actor = repo.back.actors[doc_id]
    feed = actor.feed
    head = actor.seq_head
    max_op = max(
        c.max_op for c in actor.changes_in_window(0, float("inf"))
    )
    blocks = [
        blockmod.pack_change(
            Change(
                actor=doc_id,
                seq=head + 1 + k,
                start_op=max_op + 1 + k,
                deps={},
                ops=(
                    Op(action=Action.SET, obj=ROOT, key=f"k{k}", value=k),
                ),
            ).to_json()
        )
        for k in range(3)
    ]
    # the batch lands in the block log first (as append_verified does
    # under the feed lock); the per-block callbacks race in afterwards
    with feed._lock:
        for b in blocks:
            feed._storage.append(b)
    # callbacks arrive newest-first; the third never arrives at all
    # (a concurrent fan-out died mid-batch)
    actor._on_append(head + 1, blocks[1])
    actor._on_append(head, blocks[0])
    assert actor.seq_head == head + 3
    window = actor.changes_in_window(head, float("inf"))
    assert [c.seq for c in window] == [head + 1, head + 2, head + 3]
    # the never-delivered block self-healed via the lazy feed decode
    assert window[-1].ops[0].key == "k2"
    # the reference's OpSet over the healed feed's whole history
    from port_helpers import ref_opset

    ref = ref_opset(actor.changes_in_window(0, float("inf")))
    assert ref_plain(ref.materialize())["k2"] == 2
    assert dict(ref.clock) == {doc_id: head + 3}
