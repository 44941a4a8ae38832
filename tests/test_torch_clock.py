"""The port's clock plane against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the reference
(hypermerge_tpu.crdt.clock, ops/clock_kernels.py and ops/clock_mirror.py
on CPU jax, storage/stores.py on sqlite) and through the port
(hypermerge_tpu_torch, tensors on the CPU, so the plain version of each
kernel runs):

- the host algebra of crdt/clock.py, including the cmp truth table of
  tests/test_clock.py and the INFINITY_SEQ cases;
- each clock program (gte, cmp, union, intersection, satisfied,
  cursor_window, union_reduce, top_k_dominated) on full, broadcast and
  INT32_INF inputs;
- the mirror's scatter-max and scatter-max-union against the reference's
  `_jits()`, with duplicate cells;
- DeviceClockMirror(device="cpu") against the reference mirror over one
  seeded op sequence (growth, seed_bulk, set, delete_doc), answer by
  answer, top-k indices in the same order;
- ClockStore / CursorStore on SqlDatabase(":memory:") against the
  reference stores, both query routes;
- convert.clock_mirror_from_reference.

Tolerance: exact. Every output is an int32 clock, a bool or a doc list.
"""

import math
import random

import numpy as np
import pytest
import torch

from hypermerge_tpu.crdt import clock as RC
from hypermerge_tpu.ops import clock_kernels as RK
from hypermerge_tpu.ops import clock_mirror as RM
from hypermerge_tpu.storage import sql as rsql
from hypermerge_tpu.storage import stores as rstores
from hypermerge_tpu_torch import convert
from hypermerge_tpu_torch.crdt import clock as PC
from hypermerge_tpu_torch.ops import clock_kernels as PK
from hypermerge_tpu_torch.ops import clock_mirror as PM
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.storage import sql as psql
from hypermerge_tpu_torch.storage import stores as pstores

INF = PK.INT32_INF


def _random_clocks(seed, n=24, n_actors=5, p=0.6, hi=9):
    rnd = random.Random(seed)
    actors = [f"actor{i}" for i in range(n_actors)]
    return [
        {a: rnd.randint(1, hi) for a in actors if rnd.random() < p}
        for _ in range(n)
    ]


def _t(a) -> torch.Tensor:
    """An int32 CPU tensor holding a copy of `a`."""
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _same(ref, port) -> None:
    r = np.asarray(ref)
    p = port.numpy()
    assert r.dtype == p.dtype, (r.dtype, p.dtype)
    assert r.shape == p.shape, (r.shape, p.shape)
    np.testing.assert_array_equal(r, p)


# ---------------------------------------------------------------------------
# crdt/clock.py: the host algebra


TRUTH_TABLE = [
    ({}, {}, "EQ"),
    ({"a": 1}, {"a": 1}, "EQ"),
    ({"a": 2}, {"a": 1}, "GT"),
    ({"a": 1}, {"a": 2}, "LT"),
    ({"a": 1}, {}, "GT"),
    ({}, {"a": 1}, "LT"),
    ({"a": 1}, {"b": 1}, "CONCUR"),
    ({"a": 2, "b": 1}, {"a": 1, "b": 2}, "CONCUR"),
    ({"a": 2, "b": 2}, {"a": 1, "b": 2}, "GT"),
    ({"a": 1, "b": 1}, {"a": 1, "b": 1, "c": 1}, "LT"),
    ({"x": math.inf}, {"x": PC.INFINITY_SEQ}, "EQ"),
    ({"x": math.inf, "y": 1}, {"x": 7}, "GT"),
]


@pytest.mark.parametrize("i", range(len(TRUTH_TABLE)))
def test_cmp_truth_table(i):
    a, b, want = TRUTH_TABLE[i]
    assert PC.cmp(a, b).value == want == RC.cmp(a, b).value
    assert PC.gte(a, b) == RC.gte(a, b)
    assert PC.equivalent(a, b) == RC.equivalent(a, b)


def _host_cases():
    clocks = _random_clocks(1) + [{}, {"actor0": math.inf},
                                  {"actor1": PC.INFINITY_SEQ, "actor2": 3}]
    return [(a, b) for a in clocks[:12] for b in clocks[-15:]]


HOST_FNS = {
    "union": lambda M, a, b: M.union(a, b),
    "intersection": lambda M, a, b: M.intersection(a, b),
    "add_to": lambda M, a, b: (lambda acc: (M.add_to(acc, b), acc)[1])(dict(a)),
    "strs_roundtrip": lambda M, a, b: (
        M.clock_to_strs(a), M.strs_to_clock(M.clock_to_strs(a))
    ),
    "pack_unpack": lambda M, a, b: (
        lambda actors: (actors, M.pack([a, b], actors),
                        M.unpack(M.pack([a, b], actors), actors))
    )(M.actor_axis([a, b])),
}


@pytest.mark.parametrize("name", list(HOST_FNS))
def test_host_algebra_identical(name):
    fn = HOST_FNS[name]
    for a, b in _host_cases():
        assert fn(PC, a, b) == fn(RC, a, b), (a, b)


# ---------------------------------------------------------------------------
# ops/clock_kernels.py: each plain program against the JAX function


def _pair_inputs(case):
    """(a, b) numpy int32 operands of one shape case."""
    rng = np.random.default_rng(len(case))
    if case == "all_pairs":
        # every pair of 24 clocks over 5 actors (tests/test_clock.py:75-102)
        clocks = _random_clocks(7)
        actors = RC.actor_axis(clocks)
        rows = np.asarray(RC.pack(clocks, actors), np.int32)
        n = len(rows)
        return np.repeat(rows, n, axis=0), np.tile(rows, (n, 1))
    if case == "inf":
        a = rng.integers(0, 4, (40, 3)).astype(np.int32)
        b = rng.integers(0, 4, (40, 3)).astype(np.int32)
        a[rng.random(a.shape) < 0.3] = INF
        b[rng.random(b.shape) < 0.3] = INF
        a[::5] = -3  # negatives: cursor_window's difference wraps
        return a, b
    a = rng.integers(0, 5, (33, 64)).astype(np.int32)
    b = rng.integers(0, 5, (33, 64)).astype(np.int32)
    if case == "broadcast_a":
        return a[4], b
    if case == "broadcast_b":
        return a, b[4]
    if case == "wide":
        return rng.integers(0, 3, (6, 1024)).astype(np.int32), b[0].repeat(16)
    return a, b


PAIR_PROGRAMS = ["gte", "cmp", "union", "intersection", "satisfied",
                 "cursor_window"]
PAIR_CASES = ["all_pairs", "inf", "full", "broadcast_a", "broadcast_b", "wide"]


@pytest.mark.parametrize("case", PAIR_CASES)
@pytest.mark.parametrize("name", PAIR_PROGRAMS)
def test_pair_programs_identical(name, case):
    a, b = _pair_inputs(case)
    _same(getattr(RK, name)(a, b), getattr(PK, name)(_t(a), _t(b)))


def test_pair_programs_match_host_algebra():
    """All pairs of random clocks: port codes, unions and intersections
    against crdt/clock.py (the reference's randomized equivalence)."""
    clocks = _random_clocks(9)
    actors = PC.actor_axis(clocks)
    rows = PK.pack_clocks(PC.pack(clocks, actors), device="cpu")
    n = len(clocks)
    a, b = rows.repeat_interleave(n, dim=0), rows.repeat(n, 1)
    codes = PK.cmp(a, b).tolist()
    unions = PK.union(a, b).tolist()
    inters = PK.intersection(a, b).tolist()
    names = {PK.EQ: "EQ", PK.GT: "GT", PK.LT: "LT", PK.CONCUR: "CONCUR"}
    for i in range(n):
        for j in range(n):
            k = i * n + j
            assert names[codes[k]] == PC.cmp(clocks[i], clocks[j]).value
            assert unions[k] == PC.pack([PC.union(clocks[i], clocks[j])], actors)[0]
            assert inters[k] == PC.pack(
                [PC.intersection(clocks[i], clocks[j])], actors
            )[0]


@pytest.mark.parametrize("shape", [(1, 1), (50, 4), (300, 7), (5, 3)])
def test_union_reduce_identical(shape):
    rng = np.random.default_rng(shape[0])
    m = rng.integers(-50, 50, shape).astype(np.int32)
    m[rng.random(shape) < 0.1] = INF
    if shape == (5, 3):
        m = -1 - np.abs(m)  # all negative: the max is below 0
    _same(RK.union_reduce(m), PK.union_reduce(_t(m)))


def _topk_inputs(case):
    rng = np.random.default_rng(11)
    if case == "inf_rows":  # tests/test_clock.py:139-146
        return np.array([[INF, INF], [1, 1], [9, 9]], np.int32), np.array(
            [INF, INF], np.int32
        )
    m = rng.integers(0, 3, (60, 4)).astype(np.int32)
    m[[5, 17, 40]] = INF
    q = np.array([2, INF, 2, INF], np.int32)
    if case == "none":
        q = np.zeros(4, np.int32)
    return m, q


TOPK_CASES = [("ties", 1), ("ties", 8), ("ties", 60), ("inf_rows", 3),
              ("none", 5)]


@pytest.mark.parametrize("case,k", TOPK_CASES)
def test_top_k_dominated_identical(case, k):
    m, q = _topk_inputs(case)
    rs, ri = RK.top_k_dominated(m, q, k)
    ps, pi = PK.top_k_dominated(_t(m), _t(q), k)
    _same(rs, ps)
    _same(ri, pi)
    if case == "inf_rows":
        assert int(pi[0]) == 0 and int(ps[0]) > 0


def test_pack_clocks_clamps_like_the_reference():
    rows = RC.pack([{"a": RC.INFINITY_SEQ, "b": 3}, {"a": math.inf}], ["a", "b"])
    _same(RK.pack_clocks(rows), PK.pack_clocks(rows, device="cpu"))
    assert PK.pack_clocks(rows, device="cpu")[0, 0] == INF


def test_cpu_tensors_never_launch():
    before = dict(ck.launches)
    m = _t(np.ones((4, 3)))
    PK.gte(m, m[0])
    PK.union_reduce(m)
    PK.scatter_max_(m, _t([0]), _t([0]), _t([5]))
    PK.top_k_dominated(m, m[0], 2)
    assert ck.launches == before


# ---------------------------------------------------------------------------
# ops/clock_mirror.py: the two device programs and the mirror


def _triples(seed, n, cap_d=32, cap_a=8):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 40, (cap_d, cap_a)).astype(np.int32)
    r = rng.integers(0, cap_d, n).astype(np.int32)
    c = rng.integers(0, cap_a, n).astype(np.int32)
    v = rng.integers(0, 100, n).astype(np.int32)
    r[: n // 2], c[: n // 2] = 3, 1  # duplicates on one cell
    return m, r, c, v


@pytest.mark.parametrize("n", [1, 64, 1000])
def test_scatter_max_identical(n):
    scatter, scatter_union = RM._jits()
    m, r, c, v = _triples(n, n)
    got = PK.scatter_max_(_t(m), _t(r), _t(c), _t(v))
    _same(scatter(m, r, c, v), got)
    ref_m, ref_u = scatter_union(m, r, c, v)
    _same(ref_m, got)
    _same(ref_u, PK.union_reduce(got))


def _mirror_ops(seed, n_steps=6):
    """Batches of mirror calls: (method, args), growing past both
    capacities, with sets and deletes between queries."""
    rnd = random.Random(seed)
    docs = [f"doc{i}" for i in range(40)]
    actors = [f"actor{i}" for i in range(12)]
    steps = []
    for step in range(n_steps):
        batch = []
        for _ in range(25):
            op = rnd.random()
            doc = docs[rnd.randrange(min(len(docs), 8 + 7 * step))]
            clock = {
                actors[rnd.randrange(min(len(actors), 3 + 2 * step))]:
                    rnd.choice([rnd.randrange(1, 60), 2**40, INF])
                for _ in range(rnd.randrange(1, 4))
            }
            if op < 0.65:
                batch.append(("update", (doc, clock)))
            elif op < 0.75:
                batch.append(("update_many", ({doc: clock, docs[0]: clock},)))
            elif op < 0.9:
                batch.append(("set", (doc, clock)))
            else:
                batch.append(("delete_doc", (doc,)))
        steps.append(batch)
    return steps


def _queries(seed):
    rnd = random.Random(seed)
    return [
        {f"actor{j}": rnd.choice([rnd.randrange(10, 80), INF])
         for j in range(12) if rnd.random() < 0.8}
        for _ in range(3)
    ] + [{}]


def _assert_mirrors_agree(pm, rm, queries):
    assert pm.rows() == rm.rows()
    assert pm.union() == rm.union()
    for q in queries:
        assert pm.dominated(q) == rm.dominated(q)
        for k in (1, min(4, pm._cap_d), pm._cap_d):
            assert pm.top_k_dominated(q, k) == rm.top_k_dominated(q, k)
    np.testing.assert_array_equal(pm._mat().numpy(), np.asarray(rm._mat()))
    assert pm._docs == rm._docs and pm.doc_index == rm.doc_index
    assert pm._actors == rm._actors


@pytest.mark.parametrize("caps,seed", [((2, 2), 0), ((4, 16), 1), ((64, 64), 2)])
def test_mirror_sequence_identical(caps, seed):
    pm = PM.DeviceClockMirror(*caps, device="cpu")
    rm = RM.DeviceClockMirror(*caps)
    for batch in _mirror_ops(seed):
        for name, args in batch:
            getattr(pm, name)(*args)
            getattr(rm, name)(*args)
        _assert_mirrors_agree(pm, rm, _queries(seed))


@pytest.mark.parametrize("with_updates", [False, True])
def test_mirror_seed_bulk_identical(with_updates):
    rng = np.random.default_rng(0)
    clocks = rng.integers(1, 1000, size=(100, 16), dtype=np.int32)
    docs = [f"d{i}" for i in range(100)]
    actors = [f"a{j}" for j in range(16)]
    pm = PM.DeviceClockMirror(8, 4, device="cpu")
    rm = RM.DeviceClockMirror(8, 4)
    for m in (pm, rm):
        m.seed_bulk(docs, actors, clocks)
        if with_updates:  # the config-5 hot query: fresh writes, union
            for i in range(300):
                m.update(f"d{i % 130}", {actors[i % 16]: 2000 + i, "z": i})
    _assert_mirrors_agree(pm, rm, [{a: 500 for a in actors}, {"a0": 999}])


def test_mirror_is_lazy_and_refuses_non_empty_seed():
    m = PM.DeviceClockMirror(device="cpu")
    m.update("d", {"a": 3})
    assert m._matrix is None  # construction and update allocate nothing
    assert m.union() == {"a": 3}
    assert m._matrix is not None
    with pytest.raises(RuntimeError):
        m.seed_bulk(["x"], ["a"], np.ones((1, 1), np.int32))


def test_mirror_reference_cases():
    """tests/test_clock_mirror.py's algebra cases on the port's mirror."""
    m = PM.DeviceClockMirror(capacity_docs=4, capacity_actors=4, device="cpu")
    m.update("d1", {"a": 3, "b": 1})
    m.update("d2", {"a": 1, "c": 5})
    m.update("d1", {"a": 2, "b": 4})
    assert m.union() == {"a": 3, "b": 4, "c": 5}
    assert set(m.dominated({"a": 3, "b": 4, "c": 5})) == {"d1", "d2"}
    assert m.dominated({"a": 3, "b": 4}) == ["d1"]
    m = PM.DeviceClockMirror(capacity_docs=8, capacity_actors=4, device="cpu")
    for i in range(6):
        m.update(f"d{i}", {"a": i + 1})
    assert m.top_k_dominated({"a": 4}, k=8) == ["d3", "d2", "d1", "d0"]
    m.update("big", {"a": 2**60})
    assert m.rows()["big"]["a"] == INF


# ---------------------------------------------------------------------------
# storage/stores.py: ClockStore and CursorStore


def _host_rows(store, repo_id):
    rows = store.db.query(
        "SELECT doc_id, actor_id, seq FROM clocks WHERE repo_id=?",
        (repo_id,),
    )
    out = {}
    for doc_id, actor, seq in rows:
        out.setdefault(doc_id, {})[actor] = min(seq, INF)
    return out


def _store_pair(mirror_caps=(4, 4)):
    ref = rstores.ClockStore(rsql.SqlDatabase(":memory:"))
    port = pstores.ClockStore(psql.SqlDatabase(":memory:"), device="cpu")
    for s in (ref, port):
        s.update("r", "pre", {"a0": 5})
        s.update("other", "pre", {"a9": 1})
    rm = RM.DeviceClockMirror(*mirror_caps)
    pm = PM.DeviceClockMirror(*mirror_caps, device="cpu")
    ref.attach_mirror("r", rm)
    port.attach_mirror("r", pm)
    return ref, port, rm, pm


def _store_mix(seed, ref, port, steps=120):
    rng = random.Random(seed)
    docs = [f"doc{i}" for i in range(12)]
    actors = [f"actor{i}" for i in range(6)]
    for _ in range(steps):
        op = rng.random()
        doc = rng.choice(docs)
        clock = {
            rng.choice(actors): rng.choice([rng.randrange(1, 100), 2**53 - 1])
            for _ in range(rng.randrange(1, 4))
        }
        repo = "r" if rng.random() < 0.9 else "other"
        for s in (ref, port):
            if op < 0.6:
                got = s.update(repo, doc, clock)
            elif op < 0.8:
                got = s.update_many(
                    repo, {docs[(i * 5 + len(doc)) % 12]: clock for i in range(3)}
                )
            elif op < 0.9:
                got = s.set(repo, doc, clock)
            else:
                got = s.delete_doc(doc)
            if s is ref:
                want = got
        assert got == want


@pytest.mark.parametrize("seed", [7, 8])
def test_clock_store_identical(seed):
    ref, port, rm, pm = _store_pair()
    _store_mix(seed, ref, port)
    assert pm.rows() == rm.rows() == _host_rows(port, "r")
    assert _host_rows(port, "r") == _host_rows(ref, "r")
    assert _host_rows(port, "other") == _host_rows(ref, "other")
    ids = sorted(_host_rows(ref, "r"))
    queries = [{"actor0": 50, "actor1": 60, "actor2": INF}, {},
               {f"actor{i}": 99 for i in range(6)}]
    for repo in ("r", "other"):
        # mirror route (whole corpus of "r") and sqlite subset route
        assert port.union_query(repo) == ref.union_query(repo)
        assert port.union_query(repo, ids[::2]) == ref.union_query(repo, ids[::2])
        for q in queries:
            assert port.dominated_query(repo, q) == ref.dominated_query(repo, q)
            assert port.dominated_query(repo, q, ids[1::2]) == ref.dominated_query(
                repo, q, ids[1::2]
            )
        assert port.all_doc_ids(repo) == ref.all_doc_ids(repo)
        assert port.get_multiple(repo, ids) == ref.get_multiple(repo, ids)


def test_clock_store_reference_cases():
    """tests/test_clock_mirror.py's store cases on the port's store."""
    store = pstores.ClockStore(psql.SqlDatabase(":memory:"), device="cpu")
    store.update("A", "D", {"a1": 7})
    store.update("B", "D", {"a2": 9})
    m = PM.DeviceClockMirror(device="cpu")
    store.attach_mirror("A", m)
    assert m.rows() == {"D": {"a1": 7}}
    store.set("B", "D", {"a2": 1})  # must not erase A's view
    store.update("B", "D2", {"a3": 3})
    assert m.rows() == {"D": {"a1": 7}}
    store.update("A", "d1", {"a": 3})
    store.update("A", "d2", {"b": 5})
    assert store.union_query("A") == {"a1": 7, "a": 3, "b": 5}
    assert store.dominated_query("A", {"a": 3}) == ["d1"]
    assert store.union_query("A", ["d1"]) == {"a": 3}
    assert store.union_query("A", ["nope"]) == {}
    assert store.dominated_query("A", {}, ["nope"]) == ["nope"]


def _cursor_ops(seed):
    rnd = random.Random(seed)
    ops = []
    for _ in range(80):
        doc = f"doc{rnd.randrange(6)}"
        actor = f"actor{rnd.randrange(5)}"
        seq = rnd.choice([rnd.randrange(1, 50), math.inf])
        repo = rnd.choice(["r", "r", "s"])
        kind = rnd.random()
        if kind < 0.35:
            ops.append(("update", (repo, doc, {actor: seq})))
        elif kind < 0.5:
            ops.append(("merge_mem", (repo, doc, {actor: seq})))
        elif kind < 0.6:
            ops.append(("update_many_rows", (repo, [(doc, actor, seq)])))
        elif kind < 0.7:
            ops.append(("add_actor", (repo, doc, actor)))
        elif kind < 0.8:
            ops.append(("add_actors", (repo, [(doc, actor), ("doc0", actor)], 4)))
        elif kind < 0.87:
            ops.append(("delete_doc", (repo, doc)))
        else:
            ops.append(("entry", (repo, doc, actor)))
        ops.append(("docs_with_actor", (repo, actor)))
    return ops


@pytest.mark.parametrize("seed", [0, 1])
def test_cursor_store_identical(seed):
    ref = rstores.CursorStore(rsql.SqlDatabase(":memory:"))
    port = pstores.CursorStore(psql.SqlDatabase(":memory:"))
    for name, args in _cursor_ops(seed):
        want = getattr(ref, name)(*args)
        got = getattr(port, name)(*args)
        assert got == want, name
    docs = [f"doc{i}" for i in range(6)]
    for repo in ("r", "s"):
        assert port.get_multiple(repo, docs) == ref.get_multiple(repo, docs)
        for d in docs:
            assert port.actors_for(repo, d) == ref.actors_for(repo, d)
    rows = "SELECT * FROM cursors ORDER BY repo_id, doc_id, actor_id"
    assert port.db.query(rows) == ref.db.query(rows)
    # fresh stores over the same databases hydrate from sqlite alone
    # (merge_mem rows live in memory only, in both)
    fresh = pstores.CursorStore(port.db)
    ref_fresh = rstores.CursorStore(ref.db)
    for repo in ("r", "s"):
        assert fresh.get_multiple(repo, docs) == ref_fresh.get_multiple(repo, docs)


def test_sql_schema_identical():
    q = "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY name"
    assert psql.SqlDatabase().query(q) == rsql.SqlDatabase().query(q)


# ---------------------------------------------------------------------------
# convert.clock_mirror_from_reference


@pytest.mark.parametrize("state", ["empty", "pending", "flushed",
                                   "pending_and_deleted"])
def test_clock_mirror_from_reference(state):
    rm = RM.DeviceClockMirror(4, 2)
    for i in range(9 if state != "empty" else 0):
        rm.update(f"d{i}", {f"a{i % 3}": i + 1, "b": 9 - i})
    if state in ("flushed", "pending_and_deleted"):
        rm.union()
    if state == "pending_and_deleted":
        rm.delete_doc("d2")
        rm.update("d2", {"a0": 4})  # re-added: a new row past the hole
        rm.update("d5", {"c": 70})
    pm = convert.clock_mirror_from_reference(rm, device="cpu")
    assert (pm._matrix is None) == (rm._matrix is None) == (state == "empty")
    assert pm._docs == rm._docs and pm.actor_index == rm.actor_index
    assert (pm._cap_d, pm._cap_a) == (rm._cap_d, rm._cap_a)
    _assert_mirrors_agree(pm, rm, [{"a0": 5, "a1": 9, "a2": 9, "b": 9}, {}])
