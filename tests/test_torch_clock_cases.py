"""Every case of tests/test_clock.py not already in tests/test_torch_clock.py,
under its own name on the port's clock plane (hypermerge_tpu_torch:
crdt/clock.py, and ops/clock_kernels.py's programs on CPU tensors —
`pack_clocks(..., device="cpu")` — which run the plain versions of
clock_pair.cu, clock_union.cu and clock_topk.cu). Each value a case
checks is also held against the reference package's answer on the same
inputs (its host algebra, its jitted programs on CPU jax); tolerance 0.

The twinned file's own docstring follows.

Clock algebra truth tables — host pure fns and device kernels must agree.

Mirrors the reference's tests/unit.test.ts (cmp/union truth table) and adds a
randomized host==device equivalence sweep the reference lacks.
"""

import math
import random

import numpy as np
import torch

from hypermerge_tpu.crdt import clock as RC
from hypermerge_tpu.ops import clock_kernels as RK
from hypermerge_tpu_torch.crdt import clock as C
from hypermerge_tpu_torch.ops import clock_kernels as K


def _pack(rows):
    return K.pack_clocks(rows, device="cpu")


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def test_union_intersection():
    a = {"a": 3, "b": 1}
    b = {"a": 1, "b": 5, "c": 2}
    assert C.union(a, b) == {"a": 3, "b": 5, "c": 2}
    assert C.intersection(a, b) == {"a": 1, "b": 1}
    assert C.intersection({"a": 1}, {"b": 1}) == {}
    assert C.union(a, b) == RC.union(a, b)
    assert C.intersection(a, b) == RC.intersection(a, b)


def test_gte_equivalent():
    assert C.gte({"a": 2, "b": 2}, {"a": 2})
    assert not C.gte({"a": 2}, {"a": 2, "b": 1})
    assert C.equivalent({"a": 1}, {"a": 1})
    assert not C.equivalent({"a": 1}, {"a": 2})
    for x, y in (({"a": 2, "b": 2}, {"a": 2}), ({"a": 2}, {"a": 2, "b": 1}),
                 ({"a": 1}, {"a": 1}), ({"a": 1}, {"a": 2})):
        assert C.gte(x, y) == RC.gte(x, y)
        assert C.equivalent(x, y) == RC.equivalent(x, y)


def test_strs_codec_roundtrip():
    clock = {"actorA": 5, "actorB": C.INFINITY_SEQ}
    strs = C.clock_to_strs(clock)
    assert strs == ["actorA:5", "actorB"]
    assert C.strs_to_clock(strs) == clock
    assert C.clock_to_strs({"x": math.inf}) == ["x"]
    assert C.INFINITY_SEQ == RC.INFINITY_SEQ
    assert strs == RC.clock_to_strs(clock)
    assert RC.strs_to_clock(strs) == clock


def test_add_to_in_place():
    acc = {"a": 1}
    C.add_to(acc, {"a": 3, "b": 2})
    C.add_to(acc, {"a": 2})
    assert acc == {"a": 3, "b": 2}
    ref = {"a": 1}
    RC.add_to(ref, {"a": 3, "b": 2})
    RC.add_to(ref, {"a": 2})
    assert acc == ref


def test_pack_unpack_roundtrip():
    clocks = [{"a": 1, "c": 7}, {"b": 2}, {}]
    actors = C.actor_axis(clocks)
    rows = C.pack(clocks, actors)
    assert C.unpack(rows, actors) == clocks
    assert actors == RC.actor_axis(clocks)
    assert rows == RC.pack(clocks, actors)


_CODE_TO_ORD = {K.EQ: C.Ordering.EQ, K.GT: C.Ordering.GT,
                K.LT: C.Ordering.LT, K.CONCUR: C.Ordering.CONCUR}


def test_device_matches_host_randomized():
    import jax.numpy as jnp

    rnd = random.Random(7)
    actors = [f"actor{i}" for i in range(6)]
    clocks = []
    for _ in range(64):
        clocks.append(
            {a: rnd.randint(1, 9) for a in actors if rnd.random() < 0.6}
        )
    rows = _pack(C.pack(clocks, actors))
    n = len(clocks)
    # all-pairs cmp in one call; one bulk read back
    a = rows.repeat_interleave(n, dim=0)
    b = rows.repeat(n, 1)
    codes = _np(K.cmp(a, b))
    unions = _np(K.union(a, b))
    inters = _np(K.intersection(a, b))
    gtes = _np(K.gte(a, b))
    for i in range(n):
        for j in range(n):
            k = i * n + j
            assert _CODE_TO_ORD[int(codes[k])] is C.cmp(clocks[i], clocks[j])
            assert bool(gtes[k]) == C.gte(clocks[i], clocks[j])
            host_u = C.pack([C.union(clocks[i], clocks[j])], actors)[0]
            assert list(map(int, unions[k])) == host_u
            host_i = C.pack([C.intersection(clocks[i], clocks[j])], actors)[0]
            assert list(map(int, inters[k])) == host_i
    # the reference's programs on the same pairs
    rrows = RK.pack_clocks(RC.pack(clocks, actors))
    ra, rb = jnp.repeat(rrows, n, axis=0), jnp.tile(rrows, (n, 1))
    np.testing.assert_array_equal(codes, np.asarray(RK.cmp(ra, rb)))
    np.testing.assert_array_equal(unions, np.asarray(RK.union(ra, rb)))
    np.testing.assert_array_equal(inters, np.asarray(RK.intersection(ra, rb)))
    np.testing.assert_array_equal(gtes, np.asarray(RK.gte(ra, rb)))


def test_union_reduce_matches_fold():
    rnd = random.Random(3)
    actors = [f"a{i}" for i in range(4)]
    clocks = [{a: rnd.randint(0, 5) for a in actors} for _ in range(50)]
    rows = _pack(C.pack(clocks, actors))
    device = list(map(int, K.union_reduce(rows)))
    host = {}
    for c in clocks:
        C.add_to(host, c)
    assert device == C.pack([host], actors)[0]
    ref = RK.union_reduce(RK.pack_clocks(RC.pack(clocks, actors)))
    assert device == list(map(int, ref))


def test_satisfied_and_cursor_window():
    doc = _pack([[3, 1, 0]])
    minimum = _pack([[2, 1, 0]])
    assert bool(K.satisfied(doc, minimum)[0])
    minimum2 = _pack([[2, 2, 0]])
    assert not bool(K.satisfied(doc, minimum2)[0])

    cursor = _pack([[5, 1, int(K.INT32_INF)]])
    window = K.cursor_window(doc, cursor)
    assert list(map(int, window[0])) == [2, 0, int(K.INT32_INF)]
    # the reference's programs on the same rows
    rdoc = RK.pack_clocks([[3, 1, 0]])
    assert bool(RK.satisfied(rdoc, RK.pack_clocks([[2, 1, 0]]))[0])
    assert not bool(RK.satisfied(rdoc, RK.pack_clocks([[2, 2, 0]]))[0])
    rwin = RK.cursor_window(rdoc, RK.pack_clocks([[5, 1, int(RK.INT32_INF)]]))
    np.testing.assert_array_equal(_np(window), np.asarray(rwin))


def test_infinity_clamps_to_int32():
    rows = _pack(C.pack([{"a": C.INFINITY_SEQ}], ["a"]))
    assert int(rows[0, 0]) == int(K.INT32_INF)
    assert K.INT32_INF == int(RK.INT32_INF)
    ref = RK.pack_clocks(RC.pack([{"a": RC.INFINITY_SEQ}], ["a"]))
    np.testing.assert_array_equal(_np(rows), np.asarray(ref))


def test_pack_handles_math_inf():
    rows = C.pack([{"a": math.inf, "b": 2}], ["a", "b"])
    assert rows == [[C.INFINITY_SEQ, 2]]
    assert rows == RC.pack([{"a": math.inf, "b": 2}], ["a", "b"])


def test_top_k_dominated_with_inf_entries():
    m = [[int(K.INT32_INF), int(K.INT32_INF)], [1, 1], [9, 9]]
    clocks = _pack(m)
    query = _pack([[int(K.INT32_INF), int(K.INT32_INF)]])[0]
    scores, idx = K.top_k_dominated(clocks, query, 3)
    # all three dominated; the inf-clock doc must rank first, not wrap negative
    assert int(idx[0]) == 0 and int(scores[0]) > 0
    rscores, ridx = RK.top_k_dominated(
        RK.pack_clocks(m), RK.pack_clocks([m[0]])[0], 3)
    np.testing.assert_array_equal(_np(idx), np.asarray(ridx))
    np.testing.assert_array_equal(_np(scores), np.asarray(rscores))


def test_inf_and_infinity_seq_compare_equal():
    a = {"x": math.inf}
    b = C.strs_to_clock(C.clock_to_strs(a))
    assert b == {"x": C.INFINITY_SEQ}
    assert C.equivalent(a, b)
    assert C.cmp(a, b) is C.Ordering.EQ
    assert b == RC.strs_to_clock(RC.clock_to_strs(a))
    assert RC.cmp(a, b) is RC.Ordering.EQ
