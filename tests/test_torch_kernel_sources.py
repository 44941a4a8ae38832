"""The port's CUDA kernel sources, run on the host, against the plain
PyTorch versions.

A CUDA kernel has no interpret mode, so the card is the only place it
truly runs (tests/test_torch_cuda.py, chip_smoke.py). This file checks the
kernels' logic on every CPU run instead: it compiles
hypermerge_tpu_torch/kernels/csrc/*.cu with g++ against
tests/cuda_host_shim.h (one std::thread per CUDA thread, std::barrier for
__syncthreads and warp ballots), calls the same C entry points the
wrappers call, with CPU buffers, and compares every lane and wire byte
with doc_kernel_plain / summarize_wire_plain, and every packed plane and
the value range with pack_prefix_plain (on the pack inputs of the cases
of test_torch_pack.py and on its crafted parity traps), and the four
clock kernels with the plain versions in ops/clock_kernels.py (seeded
clocks with INT32_INF entries, broadcast rows, negative inputs, duplicate
scatter cells, mass top-k ties), and the three read-serving kernels with
the plain versions in serve/kernels.py (synthetic lanes with pad rows,
pad batch slots, misses, all-matching rows, mass rank ties and ranks at
the int32 ends; a bucket above serve_order's shared-memory limit sorts in
global scratch). Mutants of the clock kernels (top-k ties broken by the
higher index, a scatter by plain store, a union started at 0) and of the
serve kernels (a lookup that answers -1 when nothing matches, an order
that breaks ties by the higher row, counts that ignore INSERT) must fail.
Tolerance: exact.
"""

import ctypes
import math
import os
import random
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import Site, random_mutation, sync
from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu_torch import convert
from hypermerge_tpu_torch.ops import clock_kernels as ckk
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops import pack_kernels as pk
from hypermerge_tpu_torch.ops import synth
from hypermerge_tpu_torch.ops.columnar import COLUMNS, round_up_pow2
from hypermerge_tpu_torch.serve import kernels as sk
from test_torch_pack import CASES as PACK_CASES
from test_torch_pack import port_pack, trap_inputs, trap_variants

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "hypermerge_tpu_torch" / "kernels" / "csrc"
_LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),.*?>>>\(", re.S)


def _host_source(text: str) -> str:
    """The .cu text with the CUDA runtime include and every <<<>>> launch
    replaced by the shim's (launches run one after another, as on one
    stream)."""
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_host_shim.h"')
    out, pos = [], 0
    for m in _LAUNCH.finditer(text):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        kernel, grid, block = m.groups()
        out += [
            text[pos : m.start()],
            f"shim_launch({grid}, {block}, [&] {{ {kernel}(",
            text[m.end() : i],
            "; })",
        ]
        pos = i
    assert out, "no kernel launch found"
    return "".join(out) + text[pos:]


@pytest.fixture(autouse=True)
def _few_cores():
    """Run the host-compiled kernels (a std::thread per CUDA thread) and
    their g++ builds on at most two cores: hundreds of threads meeting at
    barriers would otherwise crowd out every other test process on the
    machine."""
    if not hasattr(os, "sched_setaffinity"):
        yield
        return
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, sorted(cores)[-2:])
    try:
        yield
    finally:
        os.sched_setaffinity(0, cores)


def _compile_host(sources, out):
    """{stem: bound C entry} of .cu texts ({stem: text}) compiled for the
    host into `out`, one g++ per source, all at once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel sources for the host")
    procs = {}
    for stem, text in sources.items():
        src = out / f"{stem}.cpp"
        src.write_text(_host_source(text))
        procs[stem] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             f"-I{CSRC}", f"-I{TESTS}", "-o", str(out / f"lib{stem}.so"),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    fns = {}
    for stem, proc in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{stem}:\n{log}"
        symbol, argtypes = ck._SIGNATURES[stem]
        fn = getattr(ctypes.CDLL(str(out / f"lib{stem}.so")), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[stem] = fn
    return fns


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """{stem: bound C entry} of the kernels compiled for the host."""
    return _compile_host(
        {stem: (CSRC / f"{stem}.cu").read_text() for stem in ck._SIGNATURES},
        tmp_path_factory.mktemp("host_kernels"),
    )


def _run_host_materialize(fn, args, A, K):
    flags, slot, ctr, seq, obj, key, ref, value, _psrc, ptgt, _da = args
    D, N = flags.shape
    wide = [
        None if t is None else t.to(torch.int32).contiguous()
        for t in (slot, ctr, seq, obj, key, ref, value, ptgt)
    ]
    # outputs start as garbage: the kernel must write every element
    out = ck.MaterializeOut(
        *(torch.ones(D, N, dtype=torch.bool) for _ in range(5)),
        torch.full((D, N), 7, dtype=torch.int32),
        torch.full((D, N), 7, dtype=torch.int32),
        torch.full((D, A), 9, dtype=torch.int32),
    )
    scratch = torch.full((D, ck._DOC_SCRATCH_LANES, N + 2), 12345, dtype=torch.int32)
    keys = torch.full((D, N), 3, dtype=torch.int64)
    rc = fn(
        flags.data_ptr(), *(None if t is None else t.data_ptr() for t in wide),
        D, N, ptgt.shape[1], A, K, *(t.data_ptr() for t in out),
        scratch.data_ptr(), keys.data_ptr(), None,
    )
    assert rc == 0
    return out


def _run_host_wire(fn, out, N, A, lean):
    D = out.rank.shape[0]
    spec = ck.summary_wire_spec(N, A, lean)
    wire = torch.full((D, spec["total"]), 0xAB, dtype=torch.uint8)
    scratch = torch.full((D, N), -1, dtype=torch.int64)
    rc = fn(
        out.map_winner.data_ptr(), out.elem_live.data_ptr(),
        out.rank.data_ptr(), None if lean else out.clock.data_ptr(),
        D, N, A, spec["mask_bytes"], spec["order_bits"], spec["order_bytes"],
        spec["count_bytes"], spec["total"], int(lean),
        wire.data_ptr(), scratch.data_ptr(), None,
    )
    assert rc == 0
    return wire


def _fuzz_batch():
    r = random.Random(11)
    sites = [Site(a) for a in ("alice", "bob", "carol")]
    for _ in range(6):
        for s in sites:
            for _ in range(r.randint(1, 3)):
                random_mutation(s, r)
        if r.random() < 0.6:
            donor, receiver = r.sample(sites, 2)
            receiver.receive(list(donor.opset.history))
    sync(*sites)
    ref = ref_columnar.pack_docs([list(s.opset.history) for s in sites])
    return convert.batch_from_numpy(**convert.batch_to_numpy(ref))


CASES = {
    "synth_3actor_text": lambda: synth.synth_batch(4, 100, n_actors=3, text_frac=0.5),
    "synth_1actor": lambda: synth.synth_batch(2, 256, n_actors=1),
    "synth_tiny": lambda: synth.synth_batch(2, 3, n_actors=2),
    "fuzz": _fuzz_batch,
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("lean", [False, True])
def test_kernel_sources_equal_plain(host_kernels, name, lean):
    batch = CASES[name]()
    np_args, A, K = ck.host_args(batch, lean=lean)
    args = tuple(None if a is None else torch.from_numpy(a) for a in np_args)
    want = ck.materialize_device(*args, A=A, K=K)  # CPU: the plain version
    got = _run_host_materialize(host_kernels["doc_kernel"], args, A, K)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    N = batch.n_rows
    assert torch.equal(
        _run_host_wire(host_kernels["summary_wire"], want, N, A, lean),
        ck.summarize_wire_plain(want, N, A, lean),
    )


def _run_host_pack(fn, kw):
    """pack_prefix.cu, compiled for the host, over pack_prefix keyword
    arguments (CPU tensors); outputs start as garbage."""
    dtypes = pk._out_dtypes(kw["row32"], kw["key32"])
    Dp, N = kw["Dp"], kw["N"]
    outs = tuple(
        torch.full((Dp, N), 0x5A, dtype=dtypes[name]) for name in COLUMNS
    )
    minmax = torch.zeros(2, dtype=torch.int32)
    planes, luts = kw["planes"], kw["luts"]
    src_ptrs = np.asarray([t.data_ptr() for t in planes], np.int64)
    src_codes = np.asarray([pk._TORCH_CODE[t.dtype] for t in planes], np.int32)
    out_ptrs = np.asarray([t.data_ptr() for t in outs], np.int64)
    rc = fn(
        src_ptrs.ctypes.data, src_codes.ctypes.data, kw["doc_start"].data_ptr(),
        kw["ends"].data_ptr(), kw["writer"].data_ptr(), kw["lut_off"].data_ptr(),
        *(t.data_ptr() for t in luts), *(int(t.shape[0]) for t in luts),
        kw["ends"].shape[0], Dp, N, int(kw["row32"]), int(kw["key32"]),
        out_ptrs.ctypes.data, minmax.data_ptr(), None,
    )
    assert rc == 0
    return outs, minmax


PACK_SOURCE_CASES = [c for c in PACK_CASES if c != "multi_actor_general"]


@pytest.mark.parametrize("case", PACK_SOURCE_CASES + list(trap_variants()))
def test_pack_kernel_source_equals_plain(host_kernels, tmp_path, monkeypatch, case):
    if case in PACK_CASES:
        _, port_specs, kw_pack, _ = PACK_CASES[case](tmp_path)
        _, calls = port_pack(monkeypatch, port_specs, **kw_pack)
        (kw,) = calls
    else:
        kw = trap_inputs(case)
    want, want_mm = pk.pack_prefix_plain(**kw)
    got, got_mm = _run_host_pack(host_kernels["pack_prefix"], kw)
    assert got_mm.tolist() == want_mm.tolist()
    for name, g, w in zip(COLUMNS, got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


# ---------------------------------------------------------------------------
# the clock kernels: clock_pair, clock_union, clock_scatter, clock_topk

INF = ckk.INT32_INF


def _clock_matrix(seed, R, A, lo=0, hi=6):
    """[R, A] int32 clocks with INT32_INF entries and a few equal rows."""
    rng = np.random.default_rng(seed)
    m = rng.integers(lo, hi, size=(R, A)).astype(np.int32)
    m[rng.random((R, A)) < 0.05] = INF
    if R > 3:
        m[3] = m[1]
    return torch.from_numpy(m)


def _run_host_pair(fn, op, a, b):
    """clock_pair.cu on the host, as pair_cuda calls it; outputs start as
    garbage, and a bool lane must come back 0 or 1."""
    A = a.shape[-1]
    lead = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    a, sa = ckk._operand(a, lead, A)
    b, sb = ckk._operand(b, lead, A)
    if op == ckk._GTE:
        out = torch.full(lead, 7, dtype=torch.uint8)
    elif op == ckk._CMP:
        out = torch.full(lead, 99, dtype=torch.int32)
    else:
        out = torch.full((*lead, A), 0x5A5A, dtype=torch.int32)
    rc = fn(a.data_ptr(), b.data_ptr(), sa, sb, math.prod(lead), A, op,
            out.data_ptr(), None)
    assert rc == 0
    if op == ckk._GTE:
        assert set(out.unique().tolist()) <= {0, 1}
        return out == 1
    return out


PAIR_OPS = {
    "gte": ckk._GTE, "cmp": ckk._CMP, "union": ckk._UNION,
    "intersection": ckk._INTERSECTION, "cursor_window": ckk._CURSOR_WINDOW,
}


@pytest.mark.parametrize("name", list(PAIR_OPS))
def test_clock_pair_source_equals_plain(host_kernels, name):
    op = PAIR_OPS[name]
    plain = ckk._PLAIN_PAIR[op]
    for R, A in ((40, 3), (9, 64), (17, 1), (5, 70)):
        a = _clock_matrix(R * A, R, A)
        b = _clock_matrix(R * A + 1, R, A)
        b[::4] = a[::4]  # EQ rows
        b[1::4] = torch.clamp(a[1::4] - 1, min=0)  # GT rows (or EQ)
        cases = [(a, b), (a[0], b), (a, b[2]), (a[:1], b)]
        if name == "cursor_window":  # wrap-around of the int32 difference
            cases.append((torch.full((2, A), -5, dtype=torch.int32),
                          torch.full((2, A), INF, dtype=torch.int32)))
        for x, y in cases:
            got = _run_host_pair(host_kernels["clock_pair"], op, x, y)
            want = plain(x, y)
            assert got.dtype == want.dtype and torch.equal(got, want), (R, A)


def _run_host_union(fn, m):
    D, A = m.shape
    out = torch.full((A,), 12345, dtype=torch.int32)
    assert fn(m.contiguous().data_ptr(), D, A, out.data_ptr(), None) == 0
    return out


UNION_CASES = {
    "clocks": lambda: _clock_matrix(0, 300, 40),  # 5 blocks, 2 tiles
    "negative": lambda: -1 - _clock_matrix(1, 70, 3, hi=100).abs(),
    "one_row": lambda: _clock_matrix(2, 1, 5),
}


@pytest.mark.parametrize("case", list(UNION_CASES))
def test_clock_union_source_equals_plain(host_kernels, case):
    m = UNION_CASES[case]()
    got = _run_host_union(host_kernels["clock_union"], m)
    assert torch.equal(got, ckk.union_reduce_plain(m))


def _scatter_inputs(seed, n):
    """A [16, 8] matrix and n triples: many on one cell, some below the
    cell's value, the (0, 0, 0) pads of the mirror, and two outside."""
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.integers(0, 50, (16, 8)).astype(np.int32))
    rows = rng.integers(0, 16, n).astype(np.int32)
    cols = rng.integers(0, 8, n).astype(np.int32)
    vals = rng.integers(0, 100, n).astype(np.int32)
    rows[: n // 3], cols[: n // 3] = 5, 2  # one hot cell
    rows[-4:], cols[-4:], vals[-4:] = 0, 0, 0  # pads
    rows[-5], cols[-6] = 16, -1  # dropped
    return m, [torch.from_numpy(x) for x in (rows, cols, vals)]


def _run_host_scatter(fn, m, rows, cols, vals):
    m = m.clone()
    rc = fn(m.data_ptr(), m.shape[0], m.shape[1], rows.data_ptr(),
            cols.data_ptr(), vals.data_ptr(), rows.shape[0], None)
    assert rc == 0
    return m


@pytest.mark.parametrize("n", [64, 1000])
def test_clock_scatter_source_equals_plain(host_kernels, n):
    m, trip = _scatter_inputs(n, n)
    got = _run_host_scatter(host_kernels["clock_scatter"], m, *trip)
    assert torch.equal(got, ckk.scatter_max_plain_(m.clone(), *trip))


def _run_host_topk(fn, clocks, q, k):
    D, A = clocks.shape
    P = round_up_pow2(D)
    key = torch.full((P,), 3, dtype=torch.int64)
    val = torch.full((P,), -9, dtype=torch.int32)
    scores = torch.full((k,), 77, dtype=torch.int32)
    idx = torch.full((k,), 77, dtype=torch.int32)
    rc = fn(clocks.data_ptr(), D, A, q.data_ptr(), k, P, key.data_ptr(),
            val.data_ptr(), scores.data_ptr(), idx.data_ptr(), None)
    assert rc == 0
    return scores, idx


def _topk_ties(D=50, A=4):
    """Mass ties: scores from a handful of values, half the rows not
    dominated, INT32_INF rows that must rank first."""
    m = _clock_matrix(5, D, A, hi=3)
    m[m == INF] = 1
    m[7] = INF
    m[30] = INF
    q = torch.full((A,), INF, dtype=torch.int32)
    q[0] = 1
    return m, q


TOPK_CASES = {
    "ties_k1": (_topk_ties, 1),
    "ties_k7": (_topk_ties, 7),
    "ties_kD": (_topk_ties, 50),
    "pow2_rows_none_dominated": (
        lambda: (_clock_matrix(6, 64, 3, lo=5, hi=9),
                 torch.zeros(3, dtype=torch.int32)), 64),
    "one_row": (
        lambda: (_clock_matrix(7, 1, 2), torch.full((2,), 9, dtype=torch.int32)), 1
    ),
}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_clock_topk_source_equals_plain(host_kernels, case):
    make, k = TOPK_CASES[case]
    clocks, q = make()
    got = _run_host_topk(host_kernels["clock_topk"], clocks, q, k)
    want = ckk.top_k_dominated_plain(clocks, q, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# mutants: each breaks one property the plain version pins; compiled from
# the real source with one edit, each must disagree with the plain version
MUTANTS = {
    "topk_ties_by_higher_index": ("clock_topk", [
        ("val[d] = d;", "val[d] = P - 1 - d;"),
        ("out_idx[i] = val[i];", "out_idx[i] = P - 1 - val[i];"),
    ]),
    "scatter_plain_store": ("clock_scatter", [
        ("atomicMax(&m[(long long)r * cap_a + c], vals[i]);",
         "m[(long long)r * cap_a + c] = vals[i];"),
    ]),
    "union_starts_at_zero": ("clock_union", [
        ("constexpr int kNoValue = INT32_MIN;", "constexpr int kNoValue = 0;"),
    ]),
}


@pytest.mark.parametrize("name", list(MUTANTS))
def test_clock_mutants_fail(tmp_path, name):
    stem, edits = MUTANTS[name]
    text = (CSRC / f"{stem}.cu").read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    fn = _compile_host({stem: text}, tmp_path)[stem]
    if stem == "clock_topk":
        clocks, q = _topk_ties()
        got = _run_host_topk(fn, clocks, q, 50)
        want = ckk.top_k_dominated_plain(clocks, q, 50)
        assert torch.equal(got[0], want[0]) and not torch.equal(got[1], want[1])
    elif stem == "clock_scatter":
        m, trip = _scatter_inputs(3, 64)
        got = _run_host_scatter(fn, m, *trip)
        assert not torch.equal(got, ckk.scatter_max_plain_(m.clone(), *trip))
    else:
        m = UNION_CASES["negative"]()
        assert not torch.equal(_run_host_union(fn, m), ckk.union_reduce_plain(m))


# ---------------------------------------------------------------------------
# the read-serving kernels: serve_lookup, serve_order, serve_counts

SERVE_PLAIN = {
    "serve_lookup": lambda st, qo, qk: sk.map_lookup_plain(st, qo, qk),
    "serve_order": lambda st, qo, _qk: sk.seq_order_plain(st, qo),
    "serve_counts": lambda st, qo, _qk: sk.counts_plain(st, qo),
}


def _serve_inputs(scenario, N, B=3, seed=0):
    """Synthetic lanes of B entries plus one pad slot, as stack_entries
    pads a batch: the pad repeats entry 0's lanes with the NO_OBJ query."""
    lanes, qobj, qkey = synth.synth_serve_lanes(B, N, scenario, seed=seed)
    lanes = torch.from_numpy(np.concatenate([lanes, lanes[:1]]))
    qobj = np.append(qobj, sk.NO_OBJ).astype(np.int32)
    qkey = np.append(qkey, -1).astype(np.int32)
    return lanes, qobj, qkey


def _run_host_serve(fn, stem, lanes, qobj, qkey, pad_ptr=True):
    """A serve kernel compiled for the host, called as its wrapper calls
    it: one int64 argument array of lane pointers and queries (the pad
    slot points at entry 0's lanes); outputs start as garbage."""
    B, _, N = lanes.shape
    stride = lanes[0].numel() * lanes.element_size()
    ptrs = [lanes.data_ptr() + b * stride for b in range(B)]
    if pad_ptr:
        ptrs[-1] = ptrs[0]
    queries = [qobj] if stem != "serve_lookup" else [qobj, qkey]
    args = torch.from_numpy(
        np.concatenate([np.asarray(ptrs, np.int64)]
                       + [q.astype(np.int64) for q in queries])
    )
    if stem == "serve_order":
        out = torch.full((B * N + B,), 77, dtype=torch.int32)
        scratch = (
            torch.full((B, 2, N), 5, dtype=torch.int32)
            if N > sk.ORDER_SHARED_ROWS else None
        )
        rc = fn(args.data_ptr(), B, N, ck._ptr(scratch), out.data_ptr(), None)
        assert rc == 0
        return out[: B * N].reshape(B, N), out[B * N :]
    out = torch.full((2 * B,), 77, dtype=torch.int32)
    assert fn(args.data_ptr(), B, N, out.data_ptr(), None) == 0
    if stem == "serve_lookup":
        return out[:B], out[B:] == 1
    return out[:B], out[B:]


def _serve_equal(got, want):
    return all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)
    )


SERVE_SOURCE_CASES = [
    (scenario, N) for scenario in synth.SERVE_SCENARIOS for N in (64, 256)
] + [("random", 4096), ("ties", 4096)]


@pytest.mark.parametrize("scenario,N", SERVE_SOURCE_CASES)
@pytest.mark.parametrize("stem", list(SERVE_PLAIN))
def test_serve_source_equals_plain(host_kernels, stem, scenario, N):
    lanes, qobj, qkey = _serve_inputs(scenario, N, seed=N)
    got = _run_host_serve(host_kernels[stem], stem, lanes, qobj, qkey)
    want = SERVE_PLAIN[stem](
        lanes, torch.from_numpy(qobj), torch.from_numpy(qkey)
    )
    assert _serve_equal(got, want)


SERVE_MUTANTS = {
    "lookup_minus_one_when_none": ("serve_lookup", "misses", [
        ("out[b] = best < N ? best : 0;", "out[b] = best < N ? best : -1;"),
    ]),
    "order_ties_by_higher_row": ("serve_order", "ties", [
        ("val[i] = i;", "val[i] = N - 1 - i;"),
        ("order[i] = val[i];", "order[i] = N - 1 - val[i];"),
    ]),
    "counts_ignore_insert": ("serve_counts", "random", [
        ("elems += lanes[kLive * N + i] != 0 && lanes[kInsert * N + i] == 1;",
         "elems += lanes[kLive * N + i] != 0;"),
    ]),
}


@pytest.mark.parametrize("name", list(SERVE_MUTANTS))
def test_serve_mutants_fail(tmp_path, name):
    stem, scenario, edits = SERVE_MUTANTS[name]
    text = (CSRC / f"{stem}.cu").read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    fn = _compile_host({stem: text}, tmp_path)[stem]
    lanes, qobj, qkey = _serve_inputs(scenario, 64, B=6, seed=3)
    got = _run_host_serve(fn, stem, lanes, qobj, qkey)
    want = SERVE_PLAIN[stem](
        lanes, torch.from_numpy(qobj), torch.from_numpy(qkey)
    )
    assert not _serve_equal(got, want)
