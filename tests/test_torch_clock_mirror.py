"""Every case of tests/test_clock_mirror.py under its own name on the
port's DeviceClockMirror (hypermerge_tpu_torch/ops/clock_mirror.py, on
the CPU: `device="cpu"`, so its scatter, union and top-k run the plain
versions of clock_scatter.cu, clock_union.cu, clock_pair.cu and
clock_topk.cu) and the port's ClockStore on `SqlDatabase(":memory:")`.
Every case drives a reference mirror (and store) through the same calls
(`Both`), and each answer is held equal to the reference's; tolerance 0.

The twinned file's own docstring follows.

DeviceClockMirror — the ClockStore's device-resident query twin
(bulk clock queries must not re-upload the matrix).

Consistency is pinned against the sqlite rows through the attach_mirror
write path: every ClockStore mutation (update/update_many/set/delete)
must leave mirror.rows() equal to a host fold of the raw table.
"""

import random

import numpy as np

from hypermerge_tpu.ops import clock_mirror as ref_mirror
from hypermerge_tpu.storage import sql as ref_sql
from hypermerge_tpu.storage import stores as ref_stores
from hypermerge_tpu_torch.ops import clock_mirror as port_mirror
from hypermerge_tpu_torch.ops.clock_mirror import INT32_INF
from hypermerge_tpu_torch.storage import sql as port_sql
from hypermerge_tpu_torch.storage import stores as port_stores


class Both:
    """A port object and a reference object driven by the same calls:
    each call returns the port's answer after asserting it equals the
    reference's (lists compared as given: both order them alike)."""

    def __init__(self, port, ref):
        self._port, self._ref = port, ref

    def __getattr__(self, name):
        p, r = getattr(self._port, name), getattr(self._ref, name)
        if not callable(p):
            return p

        def call(*args, **kw):
            args_r = tuple(a._ref if isinstance(a, Both) else a for a in args)
            args_p = tuple(a._port if isinstance(a, Both) else a
                           for a in args)
            try:
                got = p(*args_p, **kw)
            except Exception as e:
                try:
                    r(*args_r, **kw)
                except type(e):
                    raise e
                raise AssertionError(f"{name}: only the port raised {e!r}")
            want = r(*args_r, **kw)
            if isinstance(got, (dict, list, str, int, type(None))):
                assert got == want, (name, got, want)
            return got

        return call


def DeviceClockMirror(**kw):
    return Both(port_mirror.DeviceClockMirror(device="cpu", **kw),
                ref_mirror.DeviceClockMirror(**kw))


def SqlDatabase(path):
    return Both(port_sql.SqlDatabase(path), ref_sql.SqlDatabase(path))


def ClockStore(db):
    return Both(port_stores.ClockStore(db._port, device="cpu"),
                ref_stores.ClockStore(db._ref))


def _host_rows(store, repo_id):
    if isinstance(store, Both):
        want = _host_rows(store._ref, repo_id)
        assert _host_rows(store._port, repo_id) == want
        return want
    rows = store.db.query(
        "SELECT doc_id, actor_id, seq FROM clocks WHERE repo_id=?",
        (repo_id,),
    )
    out = {}
    for doc_id, actor, seq in rows:
        out.setdefault(doc_id, {})[actor] = min(seq, INT32_INF)
    return out


class TestMirrorAlgebra:
    def test_update_union_dominated(self):
        m = DeviceClockMirror(capacity_docs=4, capacity_actors=4)
        m.update("d1", {"a": 3, "b": 1})
        m.update("d2", {"a": 1, "c": 5})
        m.update("d1", {"a": 2, "b": 4})  # monotonic: a stays 3
        assert m.union() == {"a": 3, "b": 4, "c": 5}
        assert set(m.dominated({"a": 3, "b": 4, "c": 5})) == {"d1", "d2"}
        assert m.dominated({"a": 3, "b": 4}) == ["d1"]
        assert m.dominated({"a": 1}) == []

    def test_set_overwrites_and_delete_clears(self):
        m = DeviceClockMirror(capacity_docs=2, capacity_actors=2)
        m.update("d1", {"a": 9})
        m.set("d1", {"b": 2})
        assert m.rows() == {"d1": {"b": 2}}
        m.delete_doc("d1")
        assert m.rows() == {}
        assert m.union() == {}

    def test_growth_past_capacity(self):
        m = DeviceClockMirror(capacity_docs=2, capacity_actors=2)
        for i in range(40):
            m.update(f"d{i}", {f"actor{i}": i + 1})
        rows = m.rows()
        assert len(rows) == 40
        assert rows["d39"] == {"actor39": 40}
        assert m.union()["actor7"] == 8

    def test_top_k_dominated(self):
        m = DeviceClockMirror(capacity_docs=8, capacity_actors=4)
        for i in range(6):
            m.update(f"d{i}", {"a": i + 1})
        got = m.top_k_dominated({"a": 4}, k=8)
        # docs with a<=4, highest clock first
        assert got == ["d3", "d2", "d1", "d0"]

    def test_infinity_clamps(self):
        m = DeviceClockMirror(capacity_docs=2, capacity_actors=2)
        m.update("d", {"a": 2**60})
        assert m.rows()["d"]["a"] == INT32_INF


class TestStoreConsistency:
    def test_mirror_tracks_every_store_write(self):
        db = SqlDatabase(":memory:")
        store = ClockStore(db)
        rng = random.Random(7)
        # pre-existing rows are seeded at attach time
        store.update("r", "pre", {"a0": 5})
        m = DeviceClockMirror(capacity_docs=4, capacity_actors=4)
        store.attach_mirror("r", m)
        assert m.rows() == _host_rows(store, "r")

        docs = [f"doc{i}" for i in range(12)]
        actors = [f"actor{i}" for i in range(6)]
        for step in range(120):
            op = rng.random()
            doc = rng.choice(docs)
            clock = {
                rng.choice(actors): rng.randrange(1, 100)
                for _ in range(rng.randrange(1, 4))
            }
            if op < 0.6:
                store.update("r", doc, clock)
            elif op < 0.8:
                store.update_many(
                    "r", {rng.choice(docs): clock for _ in range(3)}
                )
            elif op < 0.9:
                store.set("r", doc, clock)
            else:
                store.delete_doc(doc)
        assert m.rows() == _host_rows(store, "r")

    def test_union_matches_host_fold(self):
        db = SqlDatabase(":memory:")
        store = ClockStore(db)
        m = DeviceClockMirror()
        store.attach_mirror("r", m)
        rng = np.random.default_rng(3)
        for i in range(200):
            store.update(
                "r",
                f"d{i}",
                {f"a{j}": int(rng.integers(1, 1000)) for j in range(8)},
            )
        want = {}
        for clock in _host_rows(store, "r").values():
            for a, s in clock.items():
                want[a] = max(want.get(a, 0), s)
        assert m.union() == want

    def test_mirror_is_repo_scoped(self):
        """Writes for OTHER repo ids sharing the database never touch
        the mirror (set() is a hard per-repo overwrite)."""
        db = SqlDatabase(":memory:")
        store = ClockStore(db)
        store.update("A", "D", {"a1": 7})
        store.update("B", "D", {"a2": 9})
        m = DeviceClockMirror()
        store.attach_mirror("A", m)
        assert m.rows() == {"D": {"a1": 7}}
        store.set("B", "D", {"a2": 1})  # must not erase A's view
        store.update("B", "D2", {"a3": 3})
        assert m.rows() == {"D": {"a1": 7}}
        store.update("A", "D", {"a1": 8})
        assert m.rows() == {"D": {"a1": 8}}

    def test_union_query_routes_through_mirror(self):
        db = SqlDatabase(":memory:")
        store = ClockStore(db)
        m = DeviceClockMirror()
        store.attach_mirror("r", m)
        store.update("r", "d1", {"a": 3})
        store.update("r", "d2", {"b": 5})
        assert store.union_query("r") == {"a": 3, "b": 5}
        assert set(store.dominated_query("r", {"a": 3, "b": 5})) == {
            "d1", "d2",
        }
        assert store.dominated_query("r", {"a": 3}) == ["d1"]
        # doc-subset queries still answer from sqlite (mirror bypassed)
        assert store.union_query("r", ["d1"]) == {"a": 3}


class TestSeedBulk:
    def test_seed_bulk_then_grow(self):
        clocks = np.arange(12, dtype=np.int32).reshape(4, 3) + 1
        m = DeviceClockMirror(capacity_docs=2, capacity_actors=2)
        m.seed_bulk([f"d{i}" for i in range(4)], ["a", "b", "c"], clocks)
        assert m.rows()["d3"] == {"a": 10, "b": 11, "c": 12}
        assert m.union() == {"a": 10, "b": 11, "c": 12}
        # growth after seeding: new doc past the padded capacity
        for i in range(4, 40):
            m.update(f"d{i}", {"z": i})
        assert m.rows()["d39"] == {"z": 39}
        assert m.union()["z"] == 39

    def test_seed_bulk_refuses_non_empty(self):
        import pytest

        # the port and the reference both refuse (Both re-raises the
        # port's error only when the reference raised the same type)
        m = DeviceClockMirror()
        m.update("d", {"a": 1})
        with pytest.raises(RuntimeError):
            m.seed_bulk(["x"], ["a"], np.ones((1, 1), np.int32))


class TestDominatedRoute:
    """The dominated scan's answers (the query row by value, the verdicts
    through the host route) against the reference's on seeded inputs:
    the same doc ids in the same order, from the mirror and from the
    store's routes with and without one."""

    def test_mirror_dominated_equals_reference(self):
        rng = np.random.default_rng(25)
        n, A = 300, 20
        docs = [f"d{i}" for i in range(n)]
        actors = [f"a{j}" for j in range(A)]
        m = DeviceClockMirror(capacity_docs=64, capacity_actors=8)
        m.seed_bulk(docs, actors, rng.integers(1, 50, size=(n, A)))
        for i in range(200):
            doc = f"d{int(rng.integers(0, n + 40))}"
            m.update(doc, {f"a{int(rng.integers(0, A + 3))}":
                           int(rng.integers(1, 60))})
        m.delete_doc("d7")
        m.set("d8", {"a1": 2**40})
        for _ in range(6):
            q = {a: int(rng.integers(30, 70)) for a in actors}
            q["unknown"] = 5
            got = m.dominated(q)
            assert got  # both answered, equal in order (Both)
        assert m.dominated({a: INT32_INF for a in actors + ["a20"]})

    def test_store_dominated_query_equals_reference(self):
        rng = random.Random(25)
        db = SqlDatabase(":memory:")
        store = ClockStore(db)
        actors = [f"actor{j}" for j in range(9)]
        rows = {f"doc{i}": {a: rng.randrange(1, 40) for a in actors}
                for i in range(120)}
        store.update_many("r", rows)
        subset = [f"doc{i}" for i in range(0, 120, 3)]
        queries = [{a: 30 for a in actors}, {a: 39 for a in actors[:8]},
                   {a: 2**62 for a in actors}]
        for q in queries:  # without a mirror: the store's own route
            store.dominated_query("r", q)
            store.dominated_query("r", q, subset)
        store.attach_mirror("r", DeviceClockMirror())
        store.update("r", "doc5", {"actor2": 99})
        for q in queries:  # the mirror's route, and the subset's
            store.dominated_query("r", q)
            store.dominated_query("r", q, subset)
