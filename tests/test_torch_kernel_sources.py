"""The port's CUDA kernel sources, run on the host, against the plain
PyTorch versions.

A CUDA kernel has no interpret mode, so the card is the only place it
truly runs (tests/test_torch_cuda.py, chip_smoke.py). This file checks the
kernels' logic on every CPU run instead: it compiles
hypermerge_tpu_torch/kernels/csrc/*.cu with g++ against
tests/cuda_host_shim.h (one std::thread per CUDA thread, std::barrier for
__syncthreads and warp ballots), calls the same C entry points the
wrappers call, with CPU buffers, and compares every lane and wire byte
with doc_kernel_plain / summarize_wire_plain, and every packed plane, the
slab launch's flags and slot and the five ranges with pack_prefix_plain
(on the pack inputs of the cases of test_torch_pack.py, its parity traps
and its crafted shapes: tiles across a doc's end, every window offset
mod 16, every source dtype, int32 row and key planes, N not a multiple
of 16; also on a shim of one SM, whose tiles are 2,048 cells), and the four
clock kernels with the plain versions in ops/clock_kernels.py (seeded
clocks with INT32_INF entries, broadcast rows, negative inputs, duplicate
scatter cells; clock_pair's every op on each of its routes at A in {1, 3,
4, 5, 8, 16, 32, 64, 70, 132, 260} (G = 1 .. 32 lanes a row, int4 and
scalar units, units past the held registers) and R = 37 and 1: the row
from the device on either side, two full operands, the query by value on
either side, the host copy of the result, every base one int off
alignment; the column reduce on both of its routes, with D = 64 and
65 on the two sides of their boundary, an A that is not a multiple of 4,
a base 4 bytes past an aligned address and the int32 ends; top-k at
small tiles on both of its routes: mass ties,
ties straddling tiles, ragged tiles, k = tile + 1 and k = D, A = 3 and
wide rows, wrapped and INT32_MIN scores), and the three read-serving
kernels with the plain versions in serve/kernels.py (serve_order and
serve_counts also with the JAX package's jitted programs; synthetic lanes
with pad rows, pad batch slots, misses, all-matching rows, mass rank ties
and ranks at the int32 ends; a bucket above serve_order's shared-memory
limit sorts in global scratch), and the ring gather against the blocks
concatenated in rank order (n in {1, 2, 3, 5} ranks, odd widths,
one-row blocks; the push route, and the flagged route as one grid and as
one launch per rank from concurrent threads: a second call whose flags a
rank already advanced, a rank that never raises its flag, a rank that
pushes late). doc_kernel.cu's many-block route runs forced in builds
whose sort tile is 32 or 64 rows (HM_DOC_TILE), equal to the plain
version and to the one-block route, and its route rule is held on shims
of two SM counts (HM_SHIM_SMS); its mutants (the sort direction from the
batch position, doubling rounds short of N, a skipped global stage, run
ends at tile seams, the map's run ends launched before the global
stages) must fail. Its one-block route runs with the doc's scratch in
shared memory and in global lanes, with and without the summary wire as
its epilogue (the slab's one launch), on lanes of int8 / int16 / int32
mixes carrying every negative sentinel; summary_wire.cu alone runs with
its keys in shared memory and in global scratch; the shared / global split
is held on a shim that lets a block opt into 16 KB; and the one-block
mutants (a zero-extending int8 load, an epilogue reading the Wyllie buffer
the last round did not write, a word packer dropping the last partial
word, the climb's first buffer over the keys) must fail, each in a
subprocess. Mutants of the clock kernels (top-k ties broken by the
higher index, a tile keeping k - 1 candidates, a key packing that loses
the sign order, a pair verdict from one lane's columns, a broadcast row
held from the wrong column, a scatter by plain store, a union or a min started at 0
on each route, a columns route that drops the A % 4 tail), of the serve
kernels (a lookup that answers -1 when nothing matches, a lookup that
keeps the highest match, a split lookup launch that drops its last
chunk, an order that
breaks ties by the higher row, counts that ignore INSERT, a split counts
launch that drops its last chunk, a warp sum that skips one shuffle)
and of the ring (a wrong source block, a wait over n - 1 ranks, a wait
for == epoch, a push that skips the last vector, a raise before the
pushes), and of the pack (pad cells taking the next doc's rows, the
vector holding a doc's end written as pads, a staged window read without
its misalignment, insert at bit 2 of flags, the value maximum folded from
INT_MIN; each in a subprocess) must fail. The ring runs in a subprocess with a time limit of
its own, so that a deadlock fails its test and the run goes on.
Tolerance: exact.
"""

import ctypes
import inspect
import math
import os
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import Site, random_mutation, sync
from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu_torch import convert
from hypermerge_tpu_torch.crdt.change import Action
from hypermerge_tpu_torch.ops import clock_kernels as ckk
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops import pack_kernels as pk
from hypermerge_tpu_torch.ops import synth
from hypermerge_tpu_torch.ops.columnar import COLUMNS
from hypermerge_tpu_torch.serve import kernels as sk
from test_torch_pack import CASES as PACK_CASES
from test_torch_pack import CRAFTED, pack_inputs, port_pack, trap_variants

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "hypermerge_tpu_torch" / "kernels" / "csrc"
_LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),.*?>>>\(", re.S)
_DYNAMIC_SHARED = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")


def _host_source(text: str) -> str:
    """The .cu text with the CUDA runtime include and every <<<>>> launch
    replaced by the shim's (launches run one after another, as on one
    stream, each with its dynamic shared memory); a cooperative launch
    goes to the shim's own cudaLaunchCooperativeKernel, which runs every
    block at once."""
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_host_shim.h"')
    # the shim stands in for the asynchronous-copy primitives
    text = text.replace("#include <cuda_pipeline_primitives.h>\n", "")
    text = _DYNAMIC_SHARED.sub(r"\1* \2 = shim_dynamic_shared<\1>();", text)
    out, pos = [], 0
    for m in _LAUNCH.finditer(text):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        kernel, grid, block, dynamic = m.groups()
        out += [
            text[pos : m.start()],
            f"shim_launch({grid}, {block}, {dynamic}, [&] {{ {kernel}(",
            text[m.end() : i],
            "; })",
        ]
        pos = i
    assert out or "cudaLaunchCooperativeKernel" in text, "no kernel launch found"
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


def _bind(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _compile_host(sources, out, defines=()):
    """{name: bound C entry} of .cu texts ({stem: text}) compiled for the
    host into `out`, one g++ per source, all at once: each source's main
    entry by its stem, its other entries by their names in
    crdt_kernels._SIGNATURES, and its cap query (if any) as
    "<stem>_cap"."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel sources for the host")
    procs = {}
    for stem, text in sources.items():
        src = out / f"{stem}.cpp"
        src.write_text(_host_source(text))
        procs[stem] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             *(f"-D{d}" for d in defines),
             f"-I{CSRC}", f"-I{TESTS}", "-o", str(out / f"lib{stem}.so"),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    fns = {}
    for stem, proc in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{stem}:\n{log}"
        lib = ctypes.CDLL(str(out / f"lib{stem}.so"))
        for name, (symbol, argtypes) in ck._SIGNATURES.items():
            if ck._STEMS.get(name, name) == stem:
                fns[name] = _bind(lib, symbol, argtypes)
        if stem in ck._CAP_SYMBOLS:
            fns[f"{stem}_cap"] = _bind(lib, *ck._CAP_SYMBOLS[stem])
    return fns


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """{name: bound C entry} of the kernels compiled for the host."""
    return _compile_host(
        {stem: (CSRC / f"{stem}.cu").read_text() for stem in ck._SIGNATURES
         if stem not in ck._STEMS
         and stem != "ring_gather"},  # runs in a subprocess of its own below
        tmp_path_factory.mktemp("host_kernels"),
    )


def _run_host_doc(fn, args, A, K, route=ck.DOC_ROUTE_AUTO, lean=None):
    """doc_kernel.cu's entry on the host, as the wrapper calls it: the
    lanes as they are (int8, int16 or int32, with their widths), outputs
    that start as garbage (the kernel must write every element); with
    `lean` not None also the summary wire of its one-block epilogue.
    Returns (MaterializeOut, wire or None)."""
    flags, slot, ctr, seq, obj, key, ref, value, _psrc, ptgt, _da = args
    D, N = flags.shape
    lanes = (slot, ctr, seq, obj, key, ref, value, ptgt)
    widths = sum((4 if t is None else t.element_size()) << (4 * k)
                 for k, t in enumerate(lanes))
    out = ck.MaterializeOut(
        *(torch.ones(D, N, dtype=torch.bool) for _ in range(5)),
        torch.full((D, N), 7, dtype=torch.int32),
        torch.full((D, N), 7, dtype=torch.int32),
        torch.full((D, A), 9, dtype=torch.int32),
    )
    scratch = torch.full((D, ck._DOC_SCRATCH_LANES, N + 2), 12345, dtype=torch.int32)
    keys = torch.full((D, N), 3, dtype=torch.int64)
    spec = dict(mask_bytes=0, order_bits=0, order_bytes=0, count_bytes=0,
                total=0)
    wire = None
    if lean is not None:
        spec = ck.summary_wire_spec(N, A, lean)
        wire = torch.full((D, spec["total"]), 0xAB, dtype=torch.uint8)
    rc = fn(
        flags.data_ptr(), *(None if t is None else t.data_ptr() for t in lanes),
        widths, D, N, ptgt.shape[1], A, K, route, *(t.data_ptr() for t in out),
        scratch.data_ptr(), keys.data_ptr(),
        None if wire is None else wire.data_ptr(), spec["mask_bytes"],
        spec["order_bits"], spec["order_bytes"], spec["count_bytes"],
        spec["total"], int(bool(lean)), None,
    )
    assert rc == 0
    return out, wire


def _run_host_materialize(fn, args, A, K, route=ck.DOC_ROUTE_AUTO):
    return _run_host_doc(fn, args, A, K, route)[0]


def _run_host_wire(fn, out, N, A, lean):
    D = out.rank.shape[0]
    spec = ck.summary_wire_spec(N, A, lean)
    wire = torch.full((D, spec["total"]), 0xAB, dtype=torch.uint8)
    scratch = torch.full((D, N), -1, dtype=torch.int64)
    rc = fn(
        out.map_winner.data_ptr(), out.elem_live.data_ptr(),
        out.rank.data_ptr(), None if lean else out.clock.data_ptr(),
        D, N, A, spec["mask_bytes"], spec["order_bits"], spec["order_bytes"],
        spec["count_bytes"], spec["total"], int(lean), wire.data_ptr(),
        scratch.data_ptr(), None,
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


# doc_kernel.cu's many-block route at host sizes: builds with tiles of 32
# or 64 rows (HM_DOC_TILE), so that a few hundred rows take the sorts'
# global stages (j >= tile) and their shared stages per tile


def _doc_source(out, *defines):
    """doc_kernel.cu's entries ({"doc_kernel", "doc_route"}) built for the
    host with `defines`, into `out`."""
    out.mkdir(parents=True, exist_ok=True)
    return _compile_host({"doc_kernel": (CSRC / "doc_kernel.cu").read_text()},
                         out, defines=defines)


@pytest.fixture(scope="module")
def doc_tiles(tmp_path_factory):
    """{tile: doc_kernel.cu's entry built with HM_DOC_TILE = tile}."""
    return {tile: _doc_source(tmp_path_factory.mktemp(f"doc_tile{tile}"),
                              f"HM_DOC_TILE={tile}")["doc_kernel"]
            for tile in (32, 64)}


def _live_tick_args(D, n_ops, seed):
    """The padded tick batch `live.tick_batch` builds for D docs of seeded
    live columns (a packed history plus a peer's INC ops, deletes, inserts
    and sets), cut to D docs (the batch pads D to a power of two), as the
    11 arguments of materialize_device with seq absent and a zero actor
    map; with (A, K)."""
    from hypermerge_tpu_torch.backend import live
    from hypermerge_tpu_torch.ops import columnar as port_columnar

    lvs = []
    for d in range(D):
        hist = synth.synth_changes(n_ops, n_actors=1 + d % 2, ops_per_change=1,
                                   text_frac=0.9, seed=seed + d)
        lv = port_columnar.LiveColumns.from_batch(
            port_columnar.pack_docs([hist]), 0)
        lv.append_changes(synth.synth_live_edits(hist, 40, seed=seed + d))
        lvs.append(lv)
    N = ck.live_bucket(max(lv.n for lv in lvs), ck.LIVE_MIN_ROWS)
    planes, A, K = live.tick_batch(lvs, N)
    flags, slot, ctr, obj, key, ref, value, psrc, ptgt = (
        torch.from_numpy(a[:D]) for a in planes)
    assert ((flags & 7) == int(Action.INC)).any(), "no INC op"
    da = torch.zeros(D, A, dtype=torch.int32)
    return (flags, slot, ctr, None, obj, key, ref, value, psrc, ptgt, da), A, K


def _synth_args(D, n_ops, lean=False, **kw):
    np_args, A, K = ck.host_args(synth.synth_batch(D, n_ops, **kw), lean=lean)
    return tuple(None if a is None else torch.from_numpy(a) for a in np_args), A, K


def _conflict_args(D=2, N=128, A=4, K=4):
    """Concurrent root-key sets (no preds, every one visible) in runs of
    40 rows a key, then pad rows: each key's group of the sorted map
    pairs straddles tile seams, and its one winner is the group's last."""
    i = torch.arange(N, dtype=torch.int32).expand(D, N)
    d = torch.arange(D, dtype=torch.int32)[:, None]
    pad = i >= N - 9
    flags = torch.where(pad, int(Action.PAD), int(Action.SET)).to(torch.uint8)
    slot = ((i + d) % A).to(torch.int8)
    ctr = (N - i + 3 * d).to(torch.int32)  # comp descends with the row
    seq = torch.ones(D, N, dtype=torch.int32)
    obj = torch.full((D, N), -1, dtype=torch.int32)
    key = torch.where(pad, -1, (i // 40 + d) % 3).to(torch.int32)
    ref = torch.full((D, N), -3, dtype=torch.int32)
    value = (i % 7).to(torch.int32)
    preds = torch.full((D, 16), -1, dtype=torch.int32)
    da = torch.zeros(D, A, dtype=torch.int32)
    return (flags, slot, ctr, seq, obj, key, ref, value, preds, preds, da), A, K


# (D, rows, tile, kwargs): D in {1, 2, 3}, N in {128, 512}; one actor with
# one op a change makes the long text chains the doubling must climb
MANY_BLOCK_SHAPES = {
    "d1_n128": (1, 120, 32, dict(n_actors=1, ops_per_change=1, text_frac=1.0)),
    "d2_n128": (2, 100, 32, dict(n_actors=3, text_frac=0.5)),
    "d3_n128": (3, 128, 32, dict(n_actors=2, text_frac=0.7, seed=4)),
    "d1_n512": (1, 500, 64, dict(n_actors=3, text_frac=0.5)),
    "d2_n512": (2, 512, 32, dict(n_actors=1, ops_per_change=1, text_frac=1.0)),
    "d3_n512": (3, 400, 64, dict(n_actors=2, text_frac=0.85, seed=7)),
}


def _routes_equal_plain(fn, args, A, K):
    """doc_kernel.cu (a build of one tile) on the many-block route and on
    the one-block route, each lane equal to the plain version's."""
    want = ck.materialize_device(*args, A=A, K=K)  # CPU: the plain version
    many = _run_host_materialize(fn, args, A, K, ck.DOC_ROUTE_MANY_BLOCK)
    one = _run_host_materialize(fn, args, A, K, ck.DOC_ROUTE_ONE_BLOCK)
    for f in want._fields:
        assert torch.equal(getattr(many, f), getattr(want, f)), f
        assert torch.equal(getattr(many, f), getattr(one, f)), f


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("lean", [False, True])
def test_doc_kernel_many_block_source_equals_plain(doc_tiles, name, lean):
    batch = CASES[name]()
    np_args, A, K = ck.host_args(batch, lean=lean)
    args = tuple(None if a is None else torch.from_numpy(a) for a in np_args)
    _routes_equal_plain(doc_tiles[32], args, A, K)


@pytest.mark.parametrize("shape", list(MANY_BLOCK_SHAPES))
def test_doc_kernel_many_block_shapes_equal_plain(doc_tiles, shape):
    D, n_ops, tile, kw = MANY_BLOCK_SHAPES[shape]
    args, A, K = _synth_args(D, n_ops, **kw)
    assert args[0].shape[0] == D and args[0].shape[1] in (128, 512)
    _routes_equal_plain(doc_tiles[tile], args, A, K)


def test_doc_kernel_many_block_conflicts_equal_plain(doc_tiles):
    """Map groups that straddle tile seams: one winner each, the last."""
    args, A, K = _conflict_args()
    _routes_equal_plain(doc_tiles[32], args, A, K)


@pytest.mark.parametrize("D", [1, 3])
def test_doc_kernel_many_block_live_tick_equals_plain(doc_tiles, D):
    """The live tick's entry as materialize_live_device calls it (seq
    absent, INC ops), on an odd D at N = 512."""
    args, A, K = _live_tick_args(D, 430, seed=20)
    assert args[0].shape == (D, 512)
    _routes_equal_plain(doc_tiles[32], args, A, K)


def test_doc_kernel_source_rejects_bad_routes(host_kernels):
    args, A, K = _synth_args(1, 100)
    for route in (4, -1, 7):
        with pytest.raises(AssertionError):
            _run_host_materialize(host_kernels["doc_kernel"], args, A, K,
                                  route)
    route = host_kernels["doc_route"]
    assert route(0, 4096, 0) == route(1, 0, 0) == route(1, 1024, 4) == -1


@pytest.mark.parametrize("sms", [132, 114])
def test_doc_kernel_source_route_rule(tmp_path, sms):
    """The route the entry picks, on a card of `sms` SMs that lets a block
    opt into 227 KB of shared memory: where a doc's scratch fits there
    (N <= 8,192), one block a doc with it there; above 8,192 rows the
    many-block route while 2 D <= sms, else one block a doc with its
    scratch in global memory."""
    route = _doc_source(tmp_path, f"HM_SHIM_SMS={sms}")["doc_route"]
    one, many = ck.DOC_ROUTE_ONE_BLOCK, ck.DOC_ROUTE_MANY_BLOCK
    glob = ck.DOC_ROUTE_ONE_BLOCK_GLOBAL
    half = sms // 2
    for D, N, want in ((1, 2048, one), (4096, 1024, one), (1, 4096, one),
                       (half, 4096, one), (1024, 4096, one), (1, 8192, one),
                       (7, 8192, one), (8, 8192, one), (half + 1, 8192, one),
                       (1, 16384, many), (half, 16384, many),
                       (half + 1, 16384, glob), (256, 16384, glob),
                       (half, 262144, many), (half + 1, 262144, glob),
                       (1, 1 << 20, many)):
        assert route(D, N, ck.DOC_ROUTE_AUTO) == want, (D, N)
    # a forced one-block route keeps its scratch where the doc fits
    assert route(1, 8192, one) == one and route(1, 16384, one) == glob
    assert route(4096, 1024, glob) == glob and route(4096, 1024, many) == many
    # the rule on the card's own count, on a shim whose 4 KB of shared
    # memory holds no doc of 128 rows: the entry forced to the route it
    # picks gives the auto pick's bytes
    fn = _doc_source(tmp_path / "tile32", "HM_DOC_TILE=32",
                     f"HM_SHIM_SMS={sms}", "HM_SHIM_SHARED_OPTIN=4096")
    args, A, K = _synth_args(3, 100, n_actors=2, text_frac=0.7)
    auto = _run_host_materialize(fn["doc_kernel"], args, A, K)
    forced = _run_host_materialize(fn["doc_kernel"], args, A, K,
                                   fn["doc_route"](3, 128, 0))
    assert fn["doc_route"](3, 128, 0) == many
    for f in auto._fields:
        assert torch.equal(getattr(auto, f), getattr(forced, f)), f


# mutants of the many-block route: each edit must change some lane on
# the case beside it (a build of tile 32)
DOC_MUTANTS = {
    # the direction from the row's place in the batch: at k = N every odd
    # doc would merge descending
    "direction_from_batch_position": (
        [("const bool ascending = (i & k) == 0;",
          "const bool ascending = ((base + i) & k) == 0;")], "d2_n128"),
    # ceil_log2(N) rounds already climb a chain of N rows (the + 1 is the
    # reference's margin, kept), so one round fewer cannot show; a round
    # short of covering N must
    "doubling_rounds_short_of_n": (
        [("const int rounds = ceil_log2(b.N) + 1;",
          "const int rounds = ceil_log2(b.N) - 1;")], "d1_n128"),
    "skips_last_global_stage": (
        [("for (long long j = k >> 1; rc == 0 && j >= T; j >>= 1) {",
          "for (long long j = k >> 1; rc == 0 && j > T; j >>= 1) {")],
        "d3_n128"),
    # the run ends read within each tile of 32, as if they ran after the
    # tile sort: a gid run across a seam gets two winners (the run-end
    # pass is shared, so the one-block route breaks too)
    "run_end_at_tile_seam": (
        [("const bool last = j == b.N - 1;",
          "const bool last = ((j + 1) & 31) == 0;")], "conflicts"),
    # the many-block route's launch order: the map's run ends launched
    # after the tile sort and before the global stages, reading each run
    # as the tiles left it (the one-block route is untouched)
    "map_ends_before_merge": (
        [("""  if (rc == 0) rc = merge_tiles(b, T, s);
  if (rc == 0) {
    mb_map_ends_kernel<<<grid_for(rows), kRowThreads, 0, s>>>(b);
    rc = static_cast<int>(cudaGetLastError());
  }
""", """  if (rc == 0) {
    mb_map_ends_kernel<<<grid_for(rows), kRowThreads, 0, s>>>(b);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc == 0) rc = merge_tiles(b, T, s);
""")], "conflicts"),
}


@pytest.mark.parametrize("name", list(DOC_MUTANTS))
def test_doc_kernel_many_block_mutants_fail(tmp_path, name):
    edits, shape = DOC_MUTANTS[name]
    text = (CSRC / "doc_kernel.cu").read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    fn = _compile_host({"doc_kernel": text}, tmp_path,
                       defines=("HM_DOC_TILE=32",))["doc_kernel"]
    if shape == "conflicts":
        args, A, K = _conflict_args()
    else:
        D, n_ops, _tile, kw = MANY_BLOCK_SHAPES[shape]
        args, A, K = _synth_args(D, n_ops, **kw)
    want = ck.materialize_device(*args, A=A, K=K)
    got = _run_host_materialize(fn, args, A, K, ck.DOC_ROUTE_MANY_BLOCK)
    assert not all(torch.equal(getattr(got, f), getattr(want, f))
                   for f in want._fields)
    if name != "run_end_at_tile_seam":  # the one-block route is untouched
        one = _run_host_materialize(fn, args, A, K, ck.DOC_ROUTE_ONE_BLOCK)
        assert all(torch.equal(getattr(one, f), getattr(want, f))
                   for f in want._fields)


# doc_kernel.cu's one-block route: its scratch in shared memory (route 1)
# or in global lanes (route 3), the same body; the summary wire as its
# epilogue (the slab's one launch), and the lanes read at their narrow
# widths


def _doc_case(name, lean=False):
    """(args, A, K) of a named batch: the CASES, the seam-straddling map
    conflicts, and one long text chain (one actor, one op a change, 120
    rows at N = 128: a chain longer than N / 2, which the ranking's last
    round must still climb)."""
    if name == "conflicts":
        args, A, K = _conflict_args()
        return (args[:3] + (None,) + args[4:7] + (None,) + args[8:]
                if lean else args), A, K
    if name == "long_chain":
        D, n_ops, _tile, kw = MANY_BLOCK_SHAPES["d1_n128"]
        return _synth_args(D, n_ops, lean=lean, **kw)
    np_args, A, K = ck.host_args(CASES[name](), lean=lean)
    return tuple(None if a is None else torch.from_numpy(a) for a in np_args), A, K


def _plain_lanes_and_wire(args, A, K, lean):
    want = ck.materialize_device(*args, A=A, K=K)  # CPU: the plain version
    return want, ck.summarize_wire_plain(want, args[0].shape[1], A, lean)


def _fused_equals(fn, args, A, K, lean, route):
    """doc_kernel.cu's one launch (lanes + wire) on `route` == the plain
    versions; False if any lane or wire byte differs."""
    want, want_wire = _plain_lanes_and_wire(args, A, K, lean)
    got, wire = _run_host_doc(fn, args, A, K, route, lean=lean)
    return torch.equal(wire, want_wire) and all(
        torch.equal(getattr(got, f), getattr(want, f)) for f in want._fields)


FUSED_CASES = list(CASES) + ["conflicts", "long_chain"]


@pytest.mark.parametrize("name", FUSED_CASES)
@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("route", [ck.DOC_ROUTE_ONE_BLOCK,
                                   ck.DOC_ROUTE_ONE_BLOCK_GLOBAL])
def test_doc_kernel_fused_wire_equals_plain(host_kernels, name, lean, route):
    """The slab's one launch: every lane and every wire byte equal to
    doc_kernel_plain + summarize_wire_plain, with the doc's scratch in
    shared memory and in global lanes at the same N."""
    args, A, K = _doc_case(name, lean)
    want, want_wire = _plain_lanes_and_wire(args, A, K, lean)
    got, wire = _run_host_doc(host_kernels["doc_kernel"], args, A, K, route,
                              lean=lean)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(wire, want_wire)


def test_doc_kernel_fused_wire_refuses_the_many_block_route(host_kernels):
    args, A, K = _doc_case("synth_1actor")
    with pytest.raises(AssertionError):
        _run_host_doc(host_kernels["doc_kernel"], args, A, K,
                      ck.DOC_ROUTE_MANY_BLOCK, lean=False)


def _sentinel_args():
    """A live tick batch of two docs at N = 128 with every negative
    sentinel the lanes carry: ref -2 (a head insert) and -3 (no ref), key
    -1 (a list op), obj -1 (the root), ptgt -1 (a pad edge), and negative
    INC deltas (the peer's INC ops negated); a seq lane (1 .. 50) and a
    zero actor map, so that the clock is read too."""
    (flags, slot, ctr, _seq, obj, key, ref, value, psrc, ptgt, da), A, K = (
        _live_tick_args(2, 60, seed=31))
    assert flags.shape == (2, 128)
    inc = (flags & 7) == int(Action.INC)
    value = torch.where(inc, -value.to(torch.int32), value.to(torch.int32))
    seq = (torch.arange(128, dtype=torch.int32) % 50 + 1).expand(2, 128)
    for lane, v in ((ref, -2), (ref, -3), (key, -1), (obj, -1), (ptgt, -1)):
        assert (lane == v).any(), v
    assert (value[inc] < 0).any()
    return (flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt, da), A, K


def _fit(t, dtype):
    info = torch.iinfo(dtype)
    assert info.min <= int(t.min()) and int(t.max()) <= info.max, dtype
    return t.to(dtype).contiguous()


def _narrowest(t):
    for dtype in (torch.int8, torch.int16):
        info = torch.iinfo(dtype)
        if info.min <= int(t.min()) and int(t.max()) <= info.max:
            return t.to(dtype).contiguous()
    return t.to(torch.int32).contiguous()


# lane dtypes of doc_kernel.cu's eight lanes (slot .. ptgt), a mix each
NARROW_MIXES = {
    "narrowest": None,
    "int16": (torch.int16,) * 8,
    "int32": (torch.int32,) * 8,
    "mixed": (torch.int8, torch.int32, torch.int16, torch.int16, torch.int8,
              torch.int8, torch.int32, torch.int16),
}
_LANE_AT = (1, 2, 3, 4, 5, 6, 7, 9)  # slot .. ptgt in the 11 args


def _narrow_args(mix):
    args, A, K = _sentinel_args()
    args = list(args)
    for k, at in enumerate(_LANE_AT):
        dtypes = NARROW_MIXES[mix]
        args[at] = _narrowest(args[at]) if dtypes is None else _fit(args[at], dtypes[k])
    if mix == "narrowest":  # the sentinels ride int8 lanes, INC deltas int16
        assert all(args[at].dtype == torch.int8 for at in (1, 4, 5, 6, 9))
        assert args[7].dtype == torch.int16
    return tuple(args), A, K


@pytest.mark.parametrize("mix", list(NARROW_MIXES))
def test_doc_kernel_narrow_lanes_equal_plain(host_kernels, mix):
    """doc_kernel.cu reads each lane at its own width, sign-extended: the
    lanes (both routes) and the fused wire equal the plain version's,
    which widens first, on int8 / int16 / int32 mixes carrying every
    negative sentinel."""
    args, A, K = _narrow_args(mix)
    fn = host_kernels["doc_kernel"]
    assert _fused_equals(fn, args, A, K, False, ck.DOC_ROUTE_ONE_BLOCK)
    want = ck.materialize_device(*args, A=A, K=K)
    many = _run_host_materialize(fn, args, A, K, ck.DOC_ROUTE_MANY_BLOCK)
    for f in want._fields:
        assert torch.equal(getattr(many, f), getattr(want, f)), f


@pytest.fixture(scope="module")
def wire_builds(host_kernels, tmp_path_factory):
    """{placement: (summary_wire.cu's entry, its shared-key cap)}: as the
    card builds it ("shared": every doc here sorts its keys in shared
    memory) and with HM_WIRE_SHARED_KEYS=2 ("global": every doc here is
    longer, so its keys go to global scratch)."""
    small = _compile_host(
        {"summary_wire": (CSRC / "summary_wire.cu").read_text()},
        tmp_path_factory.mktemp("wire_keys2"),
        defines=("HM_WIRE_SHARED_KEYS=2",))
    return {
        "shared": (host_kernels["summary_wire"],
                   host_kernels["summary_wire_cap"](0)),
        "global": (small["summary_wire"], small["summary_wire_cap"](0)),
    }


@pytest.mark.parametrize("name", FUSED_CASES)
@pytest.mark.parametrize("placement", ["shared", "global"])
def test_summary_wire_source_both_placements(wire_builds, name, placement):
    """summary_wire.cu alone, its sort keys in shared memory or in global
    scratch, full and lean, == summarize_wire_plain."""
    fn, cap = wire_builds[placement]
    for lean in (False, True):
        args, A, K = _doc_case(name, lean)
        want, want_wire = _plain_lanes_and_wire(args, A, K, lean)
        N = args[0].shape[1]
        assert (N <= cap) == (placement == "shared")
        assert torch.equal(_run_host_wire(fn, want, N, A, lean), want_wire)


def test_doc_kernel_source_shared_split(tmp_path):
    """Where a doc's scratch fits the shared memory a block may opt into
    (27 bytes a row, a 1 KB clock and 1 KB kept free), the one-block route
    keeps it there, else in global lanes: on a card that lets a block opt
    into 16 KB, 512 rows fit and 1,024 do not; either way the bytes are
    the plain version's."""
    fns = _doc_source(tmp_path, "HM_SHIM_SHARED_OPTIN=16384")
    route = fns["doc_route"]
    one, glob = ck.DOC_ROUTE_ONE_BLOCK, ck.DOC_ROUTE_ONE_BLOCK_GLOBAL
    assert route(4096, 512, ck.DOC_ROUTE_AUTO) == one
    assert route(4096, 1024, ck.DOC_ROUTE_AUTO) == glob
    assert route(4, 1024, one) == glob
    args, A, K = _synth_args(2, 600, n_actors=2, text_frac=0.7)
    assert args[0].shape == (2, 1024)
    assert _fused_equals(fns["doc_kernel"], args, A, K, False, one)


# mutants of the one-block route and the wire: (file, edits, cases); each
# must change some lane or wire byte of the fused launch on one of its cases
FUSED_MUTANTS = {
    # a narrow lane read without its sign: -1, -2, -3 and negative INC
    # deltas become large positives
    "zero_extends_narrow_lane": (
        "doc_kernel.cu",
        [("if (width == 1) return static_cast<const int8_t*>(p)[i];",
          "if (width == 1) return static_cast<const uint8_t*>(p)[i];")],
        ("narrow",)),
    # the epilogue reads the ranks of the round before the last: short of
    # a chain longer than N / 2
    "epilogue_rank_from_unwritten_buffer": (
        "doc_kernel.cu",
        [("const int* rank = rank_a;  // the last round's",
          "const int* rank = rank_b;  // the last round's")],
        ("long_chain",)),
    # elem_order's last word when order_bytes is not a multiple of 4 (N = 4:
    # one byte)
    "word_packer_drops_last_partial_word": (
        "summary_wire.cuh",
        [("const int words = (w.order_bytes + 3) / 4;",
          "const int words = w.order_bytes / 4;")],
        ("synth_tiny",)),
    # the climb's first buffer over the keys' upper half: sibling_end
    # writes it while other rows' keys are still being read
    "doubling_buffer_over_keys": (
        "doc_kernel.cu",
        [("s.buf[0] = w + 5 * N + 3;", "s.buf[0] = w + N;")],
        ("long_chain", "synth_3actor_text", "fuzz")),
}


# a mutant's launches run in a subprocess of their own: a broken alias can
# send an index out of its doc, and a fault there must fail the mutant's
# test, not the test process
FUSED_RUNNER = r"""
import ctypes, inspect, sys
import torch
from hypermerge_tpu_torch.ops import crdt_kernels as ck
lib, cases, source = sys.argv[1:]
exec(source)  # _run_host_doc
symbol, argtypes = ck._SIGNATURES["doc_kernel"]
fn = getattr(ctypes.CDLL(lib), symbol)
fn.argtypes, fn.restype = argtypes, ctypes.c_int
for args, A, K, want, want_wire in torch.load(cases):
    got, wire = _run_host_doc(fn, args, A, K, ck.DOC_ROUTE_ONE_BLOCK, lean=False)
    if not torch.equal(wire, want_wire) or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        sys.exit(1)
"""


@pytest.mark.parametrize("name", list(FUSED_MUTANTS))
def test_doc_kernel_fused_mutants_fail(tmp_path, name):
    path, edits, cases = FUSED_MUTANTS[name]
    text = (CSRC / path).read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    if path.endswith(".cuh"):
        # the source's quoted include finds the edited header beside it
        (tmp_path / path).write_text(text)
        text = (CSRC / "doc_kernel.cu").read_text()
    _compile_host({"doc_kernel": text}, tmp_path)
    inputs = []
    for case in cases:
        args, A, K = _narrow_args("narrowest") if case == "narrow" else _doc_case(case)
        want, want_wire = _plain_lanes_and_wire(args, A, K, False)
        inputs.append((args, A, K, tuple(want), want_wire))
    torch.save(inputs, tmp_path / "cases.pt")
    try:
        proc = subprocess.run(
            [sys.executable, "-c", FUSED_RUNNER,
             str(tmp_path / "libdoc_kernel.so"), str(tmp_path / "cases.pt"),
             inspect.getsource(_run_host_doc)],
            capture_output=True, text=True, timeout=180,
            env=dict(os.environ, PYTHONPATH=str(TESTS.parent)))
    except subprocess.TimeoutExpired:
        return  # the mutant hung its launch: caught
    # 1: some lane or wire byte differs; a signal: the launch faulted
    assert proc.returncode != 0, f"mutant {name} passed on {cases}"
    assert proc.returncode == 1 or proc.returncode < 0, proc.stderr


def _run_host_pack(fn, kw):
    """pack_prefix.cu, compiled for the host, over pack_prefix keyword
    arguments (CPU tensors), as the card runs it: the inputs staged at
    16-byte offsets of one buffer (`marshal_pack_inputs`' layout), the
    outputs carved from one buffer (`pack_prefix_cuda`'s) and starting as
    garbage. Returns a PackOut."""
    cpu = torch.device("cpu")
    inputs = [*kw["planes"], kw["doc_start"], kw["ends"], kw["writer"],
              kw["lut_off"], *kw["luts"]]
    staged = ck.staged_upload([t.numpy() for t in inputs], cpu)
    planes, (doc_start, ends, writer, lut_off), luts = (
        staged[:12], staged[12:16], staged[16:])
    codes = sum(pk._TORCH_CODE[t.dtype] << (2 * k) for k, t in enumerate(planes))
    dtypes = pk._out_dtypes(kw["row32"], kw["key32"])
    Dp, N = kw["Dp"], kw["N"]
    lane_dtypes = [dtypes[name] for name in COLUMNS] + [torch.uint8, torch.int8]
    sizes = [32] + [Dp * N * t.itemsize for t in lane_dtypes]
    offs, total = ck.aligned_layout(sizes)
    buf = torch.full((total,), 0x5A, dtype=torch.uint8)
    lanes = [buf[o : o + n].view(t).view(Dp, N)
             for o, n, t in zip(offs[1:], sizes[1:], lane_dtypes)]
    host = torch.zeros(8, dtype=torch.int32)
    rc = fn(
        *(t.data_ptr() for t in planes), codes, doc_start.data_ptr(),
        ends.data_ptr(), writer.data_ptr(), lut_off.data_ptr(),
        *(t.data_ptr() for t in luts), *(int(t.shape[0]) for t in luts),
        ends.shape[0], Dp, N, int(kw["row32"]), int(kw["key32"]),
        *(t.data_ptr() for t in lanes), buf[:32].data_ptr(), host.data_ptr(),
        None,
    )
    assert rc == 0
    return pk.PackOut(planes=tuple(lanes[:11]), flags=lanes[11],
                      slot=lanes[12], ranges=host[:5].clone())


def _pack_equal(got, want):
    """Whether two PackOuts agree: every plane and lane with its dtype,
    and the ranges."""
    return got.ranges.tolist() == want.ranges.tolist() and all(
        g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip((*got.planes, got.flags, got.slot),
                        (*want.planes, want.flags, want.slot)))


PACK_SOURCE_CASES = [c for c in PACK_CASES if c != "multi_actor_general"]
PACK_CRAFTED = list(trap_variants()) + list(CRAFTED)


def _pack_kwargs(case, tmp_path, monkeypatch):
    if case in PACK_CASES:
        _, port_specs, kw_pack, _ = PACK_CASES[case](tmp_path)
        _, calls = port_pack(monkeypatch, port_specs, **kw_pack)
        (kw,) = calls
        return kw
    return pack_inputs(case)


@pytest.mark.parametrize("case", PACK_SOURCE_CASES + PACK_CRAFTED)
def test_pack_kernel_source_equals_plain(host_kernels, tmp_path, monkeypatch, case):
    kw = _pack_kwargs(case, tmp_path, monkeypatch)
    want = pk.pack_prefix_plain(**kw)
    got = _run_host_pack(host_kernels["pack_prefix"], kw)
    for name, g, w in zip(COLUMNS, got.planes, want.planes):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    assert torch.equal(got.flags, want.flags)
    assert got.slot.dtype == torch.int8 and torch.equal(got.slot, want.slot)
    assert got.ranges.tolist() == want.ranges.tolist()


@pytest.fixture(scope="module")
def pack_one_sm(tmp_path_factory):
    """pack_prefix.cu on a shim of one SM: the entry keeps 128 threads
    (tiles of 2,048 cells) where the 132-SM shim halves them."""
    out = tmp_path_factory.mktemp("pack_one_sm")
    return _compile_host({"pack_prefix": (CSRC / "pack_prefix.cu").read_text()},
                         out, defines=("HM_SHIM_SMS=1",))["pack_prefix"]


@pytest.mark.parametrize("case", list(CRAFTED))
def test_pack_kernel_source_wide_tiles(pack_one_sm, case):
    kw = pack_inputs(case)
    assert _pack_equal(_run_host_pack(pack_one_sm, kw), pk.pack_prefix_plain(**kw))


def test_pack_kernel_source_reports_its_limits(host_kernels):
    cap = host_kernels["pack_prefix_cap"]
    assert [cap(i) for i in range(4)] == [128, 16, 132, 232448]
    assert cap(4) == -1


def test_pack_kernel_source_rejects_misaligned_planes(host_kernels):
    """A source plane off its 16-byte boundary (the staged copy reads
    aligned chunks) is refused, and nothing is written."""
    kw = pack_inputs("offsets")
    kw["planes"] = list(kw["planes"])
    raw = torch.zeros(kw["planes"][0].numel() + 1, dtype=torch.uint8)
    kw["planes"][0] = raw[1:]
    fn = host_kernels["pack_prefix"]
    args = [t.data_ptr() for t in kw["planes"]] + [0] + [
        t.data_ptr() for t in (kw["doc_start"], kw["ends"], kw["writer"],
                               kw["lut_off"], *kw["luts"])]
    rc = fn(*args, 7, 7, 7, 7, 40, 41, 64, 0, 0, *([None] * 14),
            torch.zeros(8, dtype=torch.int32).data_ptr(), None)
    assert rc == -1


# mutants of the pack: (edits, the cases each must fail on)
PACK_MUTANTS = {
    # a pad cell's window length from the tile, not from ends[d]: the
    # cells past a doc's end take the next doc's rows
    "pad_cells_take_real_rows": (
        [("const int n_real = left <= 0 ? 0 : (left < a.tile ? left : a.tile);",
          "const int n_real = a.tile;")],
        ("straddle",)),
    # the vector holding ends[d] written as pads: its real cells are lost
    "drops_the_last_partial_vector": (
        [("const int real = left <= 0 ? 0 : (left < kV ? left : kV);",
          "const int real = left < kV ? 0 : kV;")],
        ("offsets",)),
    # the staged window read from its aligned superset's start
    "window_ignores_misalignment": (
        [("return static_cast<int>((s_first * code_bytes(code)) & 15);",
          "return 0;")],
        ("offsets",)),
    "insert_at_bit_2": (
        [("return static_cast<uint8_t>(action | insert << 3);",
          "return static_cast<uint8_t>(action | insert << 2);")],
        ("fuzz",)),
    # the value maximum folded from INT_MIN: no 0 in it when every value
    # is negative and no cell is a pad
    "value_fold_from_int_min": (
        [("int vmin = 0, vmax = 0, ctr = 0, seq = 0, inc = 0;",
          "int vmin = 0, vmax = INT_MIN, ctr = 0, seq = 0, inc = 0;")],
        ("no_pad_negative",)),
}

# a pack mutant runs in a subprocess: a window past its doc can read past
# the staged planes, and a fault there must fail the mutant, not the run
PACK_RUNNER = r"""
import ctypes, sys
import torch
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops import pack_kernels as pk
from hypermerge_tpu_torch.ops.columnar import COLUMNS
lib, cases, source = sys.argv[1:]
exec(source)  # _run_host_pack, _pack_equal
symbol, argtypes = ck._SIGNATURES["pack_prefix"]
fn = getattr(ctypes.CDLL(lib), symbol)
fn.argtypes, fn.restype = argtypes, ctypes.c_int
for kw, want in torch.load(cases):
    if not _pack_equal(_run_host_pack(fn, kw), pk.PackOut(*want)):
        sys.exit(1)
"""


@pytest.mark.parametrize("name", list(PACK_MUTANTS))
def test_pack_mutants_fail(tmp_path, monkeypatch, name):
    edits, cases = PACK_MUTANTS[name]
    text = (CSRC / "pack_prefix.cu").read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    _compile_host({"pack_prefix": text}, tmp_path)
    inputs = []
    for case in cases:
        kw = _pack_kwargs(case, tmp_path, monkeypatch)
        # tensors of their own: the pack's are views of one staging buffer
        kw = {k: [t.clone() for t in v] if isinstance(v, list)
              else v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
        inputs.append((kw, tuple(pk.pack_prefix_plain(**kw))))
    torch.save(inputs, tmp_path / "cases.pt")
    source = inspect.getsource(_run_host_pack) + inspect.getsource(_pack_equal)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", PACK_RUNNER,
             str(tmp_path / "libpack_prefix.so"), str(tmp_path / "cases.pt"),
             source],
            capture_output=True, text=True, timeout=180,
            env=dict(os.environ, PYTHONPATH=str(TESTS.parent)))
    except subprocess.TimeoutExpired:
        return  # the mutant hung its launch: caught
    # 1: some plane, lane or range differs; a signal: the launch faulted
    assert proc.returncode != 0, f"mutant {name} passed on {cases}"
    assert proc.returncode == 1 or proc.returncode < 0, proc.stderr


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


def _pair_result(op, lead, A):
    """clock_pair's output, filled with garbage."""
    if op == ckk._GTE:
        return torch.full(lead, 7, dtype=torch.uint8)
    if op == ckk._CMP:
        return torch.full(lead, 99, dtype=torch.int32)
    return torch.full((*lead, A), 0x5A5A, dtype=torch.int32)


def _pair_verdicts(op, out):
    """The result as pair_cuda returns it; a bool lane must be 0 or 1."""
    if op == ckk._GTE:
        assert set(out.unique().tolist()) <= {0, 1}
        return out == 1
    return out


def _run_host_pair(fn, op, a, b):
    """clock_pair.cu on the host, as pair_cuda calls it; outputs start as
    garbage, and a bool lane must come back 0 or 1."""
    A = a.shape[-1]
    lead = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    a, sa = ckk._operand(a, lead, A)
    b, sb = ckk._operand(b, lead, A)
    out = _pair_result(op, lead, A)
    rc = fn(a.data_ptr(), b.data_ptr(), sa, sb, math.prod(lead), A, op,
            None, 0, out.data_ptr(), None, None)
    assert rc == 0
    return _pair_verdicts(op, out)


def _run_host_pair_query(fn, op, query, m, side, host_out=False):
    """clock_pair.cu's by-value route on the host, as pair_query_cuda
    calls it: the [A] query row from host memory on `side` (0: a, 1: b)
    with no device pointer, against the [R, A] matrix m; with host_out,
    the result is read from the host copy the entry makes (the device
    output must hold the same)."""
    R, A = m.shape
    q = np.ascontiguousarray(query.numpy(), dtype=np.int32)
    lead = (R,) if op in (ckk._GTE, ckk._CMP) else (R, A)
    out = _pair_result(op, (R,), A)
    host = _pair_result(op, (R,), A) if host_out else None
    ptrs = (None, m.data_ptr()) if side == 0 else (m.data_ptr(), None)
    strides = (0, A) if side == 0 else (A, 0)
    rc = fn(*ptrs, *strides, R, A, op, q.ctypes.data, side, out.data_ptr(),
            None if host is None else host.data_ptr(), None)
    assert rc == 0
    if host is not None:
        assert torch.equal(host, out)
        out = host
    return _pair_verdicts(op, out.view(lead))


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


# the widths of the redesigned layout: G = 1 (A <= 4), 2, 4, 8, 16 and 32
# lanes a row, the scalar route (A % 4 != 0), rows past 128 ints (a lane
# takes several units) and past 256 (units beyond the held registers)
PAIR_WIDTHS = (1, 3, 4, 5, 8, 16, 32, 64, 70, 132, 260)
# R = 37: not a multiple of the rows a warp takes at any G (kRows x 32 / G)
PAIR_ROUTES = ("device", "by_value", "host_out", "offset")


def _pair_operands(A, R=37, seed=0):
    """(a, b) [R, A] int32 with EQ, GT, LT and CONCUR rows and INT32_INF
    entries, and the broadcast rows the cases take from them."""
    a = _clock_matrix(R * A + seed, R, A)
    b = _clock_matrix(R * A + seed + 1, R, A)
    b[::4] = a[::4]  # EQ rows
    b[1::4] = torch.clamp(a[1::4] - 1, min=0)  # GT rows (or EQ)
    b[2::4] = a[2::4] + 1  # LT rows
    return a, b


def _pair_mutant_operands(A, R=37):
    """(q, m): a query row rising by column, and rows that it dominates
    (even rows) or that exceed it in their last column alone (odd rows),
    so that a verdict from one lane's columns, or a query read at another
    column, differs from the plain version."""
    q = 10 + torch.arange(A, dtype=torch.int32)
    m = q - (torch.arange(R, dtype=torch.int32)[:, None] % 3)
    m[1::2, A - 1] = q[A - 1] + 1
    return q, m.contiguous()


@pytest.mark.parametrize("route", PAIR_ROUTES)
@pytest.mark.parametrize("A", PAIR_WIDTHS)
def test_clock_pair_routes_equal_plain(host_kernels, A, route):
    """Every op on one route of the redesigned kernel == its plain
    version: "device" reads the broadcast row (either side) and full
    operands from device memory, "by_value" takes the row from the
    launch's parameters on either side, "host_out" also copies the
    result into a host buffer, "offset" puts every operand's base 4 bytes
    off 16-byte alignment (the scalar route at any A); R = 37 and R = 1."""
    fn = host_kernels["clock_pair"]
    a, b = _pair_operands(A)
    for op, plain in ckk._PLAIN_PAIR.items():
        if route == "device":
            cases = [(a, b), (a[5], b), (a, b[5]), (a[:1], b[:1]), (a[3], b[:1])]
            for x, y in cases:
                got = _run_host_pair(fn, op, x, y)
                assert torch.equal(got, plain(x, y)), (op, x.shape, y.shape)
        elif route == "offset":
            x, y = _offset_view(a), _offset_view(b)
            row = _offset_view(b[6:7])[0]
            for xx, yy in ((x, y), (row, x), (x, row)):
                got = _run_host_pair(fn, op, xx, yy)
                assert torch.equal(got, plain(xx, yy)), (op, xx.shape)
        else:
            host_out = route == "host_out"
            for m in (b, b[:1]):
                for side in (0, 1):
                    q = a[5]
                    got = _run_host_pair_query(fn, op, q, m, side, host_out)
                    want = plain(q, m) if side == 0 else plain(m, q)
                    assert torch.equal(got, want), (op, side, m.shape)


def test_clock_pair_source_reports_its_limits(host_kernels):
    """The query row's structs follow the toolkit's parameter limit
    (CUDA 12.4 on the shim: 4,096 ints, the small one 256); a query
    wider than the largest, or on a side with a row stride, is refused."""
    fn, cap = host_kernels["clock_pair"], host_kernels["clock_pair_cap"]
    assert (cap(0), cap(1)) == (4096, 256)
    m = torch.zeros(3, 4097, dtype=torch.int32)
    q = np.zeros(4097, np.int32)
    out = torch.zeros(3, dtype=torch.uint8)
    assert fn(None, m.data_ptr(), 0, 4097, 3, 4097, ckk._GTE, q.ctypes.data,
              0, out.data_ptr(), None, None) == -1
    assert fn(m.data_ptr(), m.data_ptr(), 4097, 4097, 3, 4097, ckk._GTE,
              q.ctypes.data, 0, out.data_ptr(), None, None) == -1
    assert fn(m.data_ptr(), m.data_ptr(), 4097, 4097, 3, 4097, 5, None, 0,
              out.data_ptr(), None, None) == -1


def _run_host_union(fn, m, op=ckk._MAX):
    D, A = m.shape
    assert m.is_contiguous()
    out = torch.full((A,), 12345, dtype=torch.int32)
    assert fn(m.data_ptr(), D, A, op, out.data_ptr(), None) == 0
    return out


def _offset_view(m):
    """m copied into a flat buffer one int in and viewed there: a
    contiguous matrix whose base sits 4 bytes past an aligned address."""
    flat = torch.empty(m.numel() + 1, dtype=m.dtype)
    flat[1:] = m.flatten()
    return flat[1:].view(m.shape)


def _extremes(seed, D, A):
    """[D, A] int32 of the int32 ends and the values beside them."""
    i32 = np.iinfo(np.int32)
    vals = [i32.min, i32.min + 1, -7, -1, 0, 1, i32.max - 1, i32.max]
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice(vals, (D, A)).astype(np.int32))


# tall (D > 64: fill and column reduce) and columns (D <= 64: one launch;
# int4 loads when A % 4 == 0 and the base is 16-byte aligned, else scalar)
UNION_CASES = {
    "clocks": lambda: _clock_matrix(0, 300, 40),  # 5 blocks, 2 tiles
    "negative": lambda: -1 - _clock_matrix(1, 70, 3, hi=100).abs(),
    "one_row": lambda: _clock_matrix(2, 1, 5),  # columns, scalar
    "wide": lambda: _clock_matrix(6, 2, 2000),  # columns, int4
    "rows_64": lambda: _clock_matrix(7, 64, 36),  # columns, int4
    "rows_65": lambda: _clock_matrix(8, 65, 36),  # tall, 2 row blocks
    "odd_width": lambda: _clock_matrix(9, 3, 4099),  # columns, scalar
    "offset_base": lambda: _offset_view(_clock_matrix(10, 4, 40)),  # scalar
    "extremes": lambda: _extremes(11, 5, 64),  # columns, int4
    "extremes_tall": lambda: _extremes(12, 80, 5),
}


@pytest.mark.parametrize("case", list(UNION_CASES))
def test_clock_union_source_equals_plain(host_kernels, case):
    m = UNION_CASES[case]()
    got = _run_host_union(host_kernels["clock_union"], m)
    assert torch.equal(got, ckk.union_reduce_plain(m))


MIN_CASES = dict(UNION_CASES, positive=lambda: 1 + _clock_matrix(3, 90, 7).clamp(max=10**6),
                 partials=lambda: _clock_matrix(4, 5, 3, hi=2))


@pytest.mark.parametrize("case", list(MIN_CASES))
def test_clock_union_min_mode_equals_plain(host_kernels, case):
    m = MIN_CASES[case]()
    got = _run_host_union(host_kernels["clock_union"], m, op=ckk._MIN)
    assert torch.equal(got, ckk.min_reduce_plain(m))


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


def _run_host_params(fn, m, rows, cols, vals, per_launch=0):
    """The parameter route, called as scatter_max_params_cuda_ calls it:
    the triples as host arrays (here numpy views of the tensors)."""
    m = m.clone()
    arrs = [t.numpy() for t in (rows, cols, vals)]
    rc = fn(m.data_ptr(), m.shape[0], m.shape[1], *(a.ctypes.data for a in arrs),
            len(arrs[0]), per_launch, None)
    assert rc == 0
    return m


def _params_inputs(n, seed):
    """_scatter_inputs at any n >= 0, with the last triple raising its
    cell above every other value, so that a launch that drops it shows."""
    if n < 8:
        m = torch.from_numpy(
            np.random.default_rng(seed).integers(0, 50, (16, 8)).astype(np.int32))
        trip = [torch.from_numpy(np.arange(n, dtype=np.int32) % k)
                for k in (16, 8)] + [torch.full((n,), 60, dtype=torch.int32)]
    else:
        m, trip = _scatter_inputs(seed, n)
    if n:
        trip[0][-1], trip[1][-1], trip[2][-1] = 7, 3, 1000
    return m, trip


# (n, per_launch): 0 takes launches of up to the source's cap (2,048 at
# CUDA 12.1 and later), each in the smallest struct that holds it; a
# per_launch sizes every launch's struct for that many
PARAMS_CASES = {
    "empty": (0, 0), "one": (1, 0), "duplicates": (64, 0),
    "config5_flush": (1024, 0), "cap_plus_one": (17, 16),
    "split_five_ways": (1000, 200), "mid_struct_plus_one": (1025, 1024),
    "source_cap_plus_one": (2049, 0), "largest_struct_part_full": (1000, 2048),
}


@pytest.mark.parametrize("case", list(PARAMS_CASES))
def test_clock_scatter_params_source_equals_plain(host_kernels, case):
    """hm_clock_scatter_params (the mirror's route: host triples in the
    launch parameters) against the plain version: duplicate cells, values
    below the cell's, the mirror's (0, 0, 0) pads, triples outside the
    matrix, n = 0, and batches split over several launches (per_launch
    below the cap, and the cap itself + 1: a full struct then a small
    one)."""
    n, per_launch = PARAMS_CASES[case]
    assert host_kernels["clock_scatter_cap"](0) == 2048
    assert host_kernels["clock_scatter_cap"](1) == 1024
    m, trip = _params_inputs(n, seed=n + per_launch)
    got = _run_host_params(host_kernels["clock_scatter_params"], m, *trip,
                           per_launch=per_launch)
    assert torch.equal(got, ckk.scatter_max_plain_(m.clone(), *trip))


def test_clock_scatter_params_rejects_a_launch_above_its_cap(host_kernels):
    m, trip = _params_inputs(8, seed=1)
    arrs = [t.numpy() for t in trip]
    assert host_kernels["clock_scatter_params"](
        m.data_ptr(), 16, 8, *(a.ctypes.data for a in arrs), 8, 2049, None) == -1


def test_clock_scatter_params_source_under_an_old_toolkit(tmp_path):
    """Built as under CUDA 11.8 (the 4,096-byte parameter limit): 256
    triples a launch, so 300 take two."""
    fns = _compile_host({"clock_scatter": (CSRC / "clock_scatter.cu").read_text()},
                        tmp_path, defines=("CUDART_VERSION=11080",))
    assert fns["clock_scatter_cap"](0) == fns["clock_scatter_cap"](1) == 256
    m, trip = _params_inputs(300, seed=3)
    got = _run_host_params(fns["clock_scatter_params"], m, *trip)
    assert torch.equal(got, ckk.scatter_max_plain_(m.clone(), *trip))


def test_scatter_max_host_equals_reference_on_the_cpu():
    """The mirror's entry on the CPU (the plain version on tensors made
    from the host arrays) against the reference's jitted scatter-max, on
    triples inside the matrix as the mirror makes them (duplicates, the
    (0, 0, 0) pads)."""
    from hypermerge_tpu.ops import clock_mirror as ref_mirror

    rng = np.random.default_rng(5)
    m = rng.integers(0, 50, (16, 8)).astype(np.int32)
    rows, cols, vals = (rng.integers(0, hi, 1024).astype(np.int32)
                        for hi in (16, 8, 100))
    rows[:300], cols[:300] = 5, 2
    rows[1000:] = cols[1000:] = vals[1000:] = 0
    got = ckk.scatter_max_host_(torch.from_numpy(m.copy()), rows, cols, vals)
    want = ref_mirror._jits()[0](m, rows, cols, vals)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# clock_topk.cu's launch shape in these runs: tiles of 16 rows and 32
# threads (so that tens of rows make several tiles and the shim's
# std::threads stay few); the route as topk_plan picks it for a merge of
# at most 32 candidates (so that a k of half a tile already takes the
# large-k route)
HOST_TILE, HOST_THREADS, HOST_MERGE_MAX = 16, 32, 32


def _run_host_topk(fn, clocks, q, k, route=None, tile=HOST_TILE,
                   threads=HOST_THREADS, merge_max=HOST_MERGE_MAX):
    """clock_topk.cu on the host at the shape above, as the wrapper calls
    it; the scratch keys start as 0 (the key of the best possible row) and
    the outputs as garbage, so that every slot the kernel leaves unwritten
    shows."""
    D, A = clocks.shape
    plan, n_keys = ckk.topk_plan(D, k, tile, merge_max)
    if route is not None:
        assert plan == route, (plan, route)
    keys = torch.zeros(n_keys, dtype=torch.int64)
    scores = torch.full((k,), 77, dtype=torch.int32)
    idx = torch.full((k,), 77, dtype=torch.int32)
    rc = fn(clocks.contiguous().data_ptr(), D, A, q.data_ptr(), k, tile,
            threads, ckk._TOPK_ROUTE[plan], keys.data_ptr(), n_keys,
            scores.data_ptr(), idx.data_ptr(), None)
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


def _topk_straddle(D=70, A=8):
    """Equal scores on both sides of every tile boundary: the best six
    rows straddle the first, the next ties straddle the others and end
    the last, partial tile."""
    m = torch.ones((D, A), dtype=torch.int32)
    for b in range(HOST_TILE, D, HOST_TILE):
        m[b - 3 : b + 3] = 2
    m[HOST_TILE - 3 : HOST_TILE + 3] = 3
    m[D - 2 :] = 2
    return m, torch.full((A,), 5, dtype=torch.int32)


def _topk_extremes(D=40):
    """Scores at the int32 ends: sums that wrap negative, INT32_MIN,
    INT32_MAX and -1 (not dominated) rows, one column, ints read one at a
    time."""
    m = torch.from_numpy(np.random.default_rng(8).integers(
        -2**31, 2**20, (D, 1)).astype(np.int32))
    m[::5] = -2**31
    m[3] = 2**20
    m[::7] = -1
    q = torch.full((1,), 2**20, dtype=torch.int32)
    q_low = torch.full((1,), -5, dtype=torch.int32)  # some rows not dominated
    return m, q, q_low


def _topk_wrapped(D=40, A=8):
    """Row sums that wrap (int32, as XLA's sum does): three entries near
    INT32_MIN wrap past it to a negative sum, two wrap to a positive one."""
    m = torch.full((D, A), 2**20, dtype=torch.int32)
    m[::2, :3] = -2**31 + 5
    m[1::4, :2] = -2**31 + 5
    m[3::8] = 2**20 - 3
    return m, torch.full((A,), INF, dtype=torch.int32)


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
    # several tiles, a ragged last one (70 = 4 x 16 + 6), A = 3 read as ints
    "ragged_tiles_A3": (
        lambda: (_clock_matrix(9, 70, 3, hi=4), torch.full((3,), 3, dtype=torch.int32)),
        3),
    "ties_straddle_tiles": (_topk_straddle, 4),
    "k_tile_plus_1": (_topk_straddle, HOST_TILE + 1),  # the large-k route
    "vector_rows_A8": (
        lambda: (_clock_matrix(10, 100, 8, hi=50), torch.full((8,), 40, dtype=torch.int32)),
        4),
    "wide_rows_A70": (
        lambda: (_clock_matrix(11, 33, 70, hi=9), torch.full((70,), INF, dtype=torch.int32)),
        4),
    # 34 16-byte chunks a row: 32 lanes, two of them read a second chunk
    "wide_vector_rows_A136": (
        lambda: (_clock_matrix(12, 20, 136, hi=9), torch.full((136,), 8, dtype=torch.int32)),
        4),
    "int32_extremes": (lambda: _topk_extremes()[:2], 16),
    "int32_extremes_not_dominated": (lambda: _topk_extremes()[::2], 4),
    "wrapped_negative_sums": (_topk_wrapped, 16),
}
# which route each case must take at the host shape (the rest: "select")
TOPK_ROUTES = {"ties_kD": "sort", "pow2_rows_none_dominated": "sort",
               "k_tile_plus_1": "sort", "int32_extremes": "sort",
               "wrapped_negative_sums": "sort"}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_clock_topk_source_equals_plain(host_kernels, case):
    make, k = TOPK_CASES[case]
    clocks, q = make()
    got = _run_host_topk(host_kernels["clock_topk"], clocks, q, k,
                         route=TOPK_ROUTES.get(case, "select"))
    want = ckk.top_k_dominated_plain(clocks, q, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k,route", [(40, "select"), (100, "sort")])
def test_clock_topk_source_wide_tiles(host_kernels, k, route):
    """Tiles of 128 rows and 64 threads: the sorts' stages with j >= 32
    run in shared memory between barriers (j = 32 in the merge's runs of
    64; j = 32, 64 in a tile), the rest on warp shuffles; equal ties
    straddle the tile boundaries."""
    clocks, q = _topk_straddle(D=300, A=5)
    clocks[120:136] = 3
    clocks[250:262] = 3
    got = _run_host_topk(host_kernels["clock_topk"], clocks, q, k, route=route,
                         tile=128, threads=64, merge_max=256)
    want = ckk.top_k_dominated_plain(clocks, q, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [3, 4, 8, 9, 15, 16])
def test_clock_topk_source_select_and_sort_routes_agree(host_kernels, k):
    """The same matrix through the select route (a merge of up to 128
    candidates) and the large-k route (a merge capacity of one tile):
    both equal the plain version."""
    clocks, q = _topk_straddle(D=90)
    want = ckk.top_k_dominated_plain(clocks, q, k)
    fn = host_kernels["clock_topk"]
    for merge_max, route in ((128, "select"), (HOST_TILE, "sort")):
        plan, n_keys = ckk.topk_plan(90, k, HOST_TILE, merge_max)
        assert plan == route
        keys = torch.zeros(n_keys, dtype=torch.int64)
        scores = torch.full((k,), 77, dtype=torch.int32)
        idx = torch.full((k,), 77, dtype=torch.int32)
        assert fn(clocks.data_ptr(), 90, 8, q.data_ptr(), k, HOST_TILE,
                  HOST_THREADS, ckk._TOPK_ROUTE[plan], keys.data_ptr(), n_keys,
                  scores.data_ptr(), idx.data_ptr(), None) == 0
        assert torch.equal(scores, want[0]) and torch.equal(idx, want[1]), plan


# mutants: each breaks one property the plain version pins; compiled from
# the real source with one edit, each must disagree with the plain version
MUTANTS = {
    "topk_ties_by_higher_index": ("clock_topk", [
        ("return (static_cast<Key>(hi) << 32) | static_cast<unsigned>(d);",
         "return (static_cast<Key>(hi) << 32) | (0xfffffffeu - static_cast<unsigned>(d));"),
        ("*row = static_cast<int>(key & 0xffffffffu);",
         "*row = static_cast<int>(0xfffffffeu - (key & 0xffffffffu));"),
    ]),
    "topk_tile_keeps_k_minus_1": ("clock_topk", [
        ("for (int i = threadIdx.x; i < keep; i += blockDim.x)",
         "for (int i = threadIdx.x; i < keep - 1; i += blockDim.x)"),
    ]),
    "topk_key_loses_sign_order": ("clock_topk", [
        ("const unsigned hi = static_cast<unsigned>(score) ^ kScoreFlip;",
         "const unsigned hi = static_cast<unsigned>(-score);"),
        ("*score = static_cast<int>(static_cast<unsigned>(key >> 32) ^ kScoreFlip);",
         "*score = -static_cast<int>(static_cast<unsigned>(key >> 32));"),
    ]),
    "scatter_plain_store": ("clock_scatter", [
        ("atomicMax(&m[static_cast<long long>(r) * cap_a + c], v);",
         "m[static_cast<long long>(r) * cap_a + c] = v;"),
    ]),
    "scatter_split_drops_last_chunk": ("clock_scatter", [
        ("for (int i0 = 0; i0 < n; i0 += chunk) {",
         "for (int i0 = 0; i0 + chunk < n; i0 += chunk) {"),
    ]),
    # the row's verdict from its first lane's columns alone
    "pair_no_fold_across_lanes": ("clock_pair", [
        ("const bool all_ge = ((wge >> (s * G)) & gmask) == 0;",
         "const bool all_ge = ((wge >> (s * G)) & 1u) == 0;"),
    ]),
    # every lane holds the broadcast row's first unit of its pass
    "pair_broadcast_wrong_column": ("clock_pair", [
        ("bcast_unit<kVec, kParam>(hrow, q, j + k * G, held[k]);",
         "bcast_unit<kVec, kParam>(hrow, q, k * G, held[k]);"),
    ]),
    "union_starts_at_zero": ("clock_union", [
        ("constexpr int kNoValue = INT32_MIN;", "constexpr int kNoValue = 0;"),
    ]),
    "min_starts_at_zero": ("clock_union", [
        ("constexpr int kMinNoValue = INT32_MAX;",
         "constexpr int kMinNoValue = 0;"),
    ]),
    # int4 loads without the A % 4 check: the columns past A / 4 * 4 are
    # never written and every row after the first is read off its start
    "union_columns_drop_the_tail": ("clock_union", [
        ("A % 4 == 0 && reinterpret_cast<std::uintptr_t>(m) % 16 == 0 &&",
         "reinterpret_cast<std::uintptr_t>(m) % 16 == 0 &&"),
    ]),
}

# the cases each clock_union mutant must fail: one on every route it
# reaches (tall, columns with int4 loads, columns with scalar loads)
UNION_MUTANT_CASES = {
    "union_starts_at_zero": (ckk._MAX, [
        lambda: -1 - _clock_matrix(1, 70, 3, hi=100).abs(),
        lambda: -1 - _clock_matrix(13, 4, 64, hi=100).abs(),
        lambda: -1 - _clock_matrix(14, 4, 7, hi=100).abs(),
    ]),
    "min_starts_at_zero": (ckk._MIN, [
        lambda: 1 + _clock_matrix(3, 90, 7).clamp(max=10**6),
        lambda: 1 + _clock_matrix(15, 2, 64).clamp(max=10**6),
        lambda: _offset_view(1 + _clock_matrix(16, 2, 64).clamp(max=10**6)),
    ]),
    "union_columns_drop_the_tail": (ckk._MAX, [
        UNION_CASES["odd_width"],
    ]),
}


# the top-k cases each mutant must fail, on both routes where it reaches
# both
TOPK_MUTANT_CASES = {
    "topk_ties_by_higher_index": ["ties_kD", "ties_straddle_tiles"],
    "topk_tile_keeps_k_minus_1": ["ties_k7", "ties_straddle_tiles"],
    "topk_key_loses_sign_order": ["int32_extremes", "ties_k7"],
}


@pytest.mark.parametrize("name", list(MUTANTS))
def test_clock_mutants_fail(tmp_path, name):
    stem, edits = MUTANTS[name]
    text = (CSRC / f"{stem}.cu").read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    fns = _compile_host({stem: text}, tmp_path)
    fn = fns[stem]
    if stem == "clock_topk":
        for case in TOPK_MUTANT_CASES[name]:
            make, k = TOPK_CASES[case]
            clocks, q = make()
            got = _run_host_topk(fn, clocks, q, k)
            want = ckk.top_k_dominated_plain(clocks, q, k)
            if name == "topk_ties_by_higher_index":  # the same scores
                assert torch.equal(got[0], want[0])
            assert not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])), case
    elif stem == "clock_pair":  # gte on both routes, from device and by value
        for A in (64, 70):
            q, a = _pair_mutant_operands(A)
            assert not torch.equal(_run_host_pair(fn, ckk._GTE, q, a),
                                   ckk.gte_plain(q, a)), A
            assert not torch.equal(
                _run_host_pair_query(fn, ckk._GTE, q, a, 0),
                ckk.gte_plain(q, a)), A
    elif name == "scatter_split_drops_last_chunk":  # n = per_launch + 1
        m, trip = _params_inputs(17, seed=2)
        got = _run_host_params(fns["clock_scatter_params"], m, *trip,
                               per_launch=16)
        assert not torch.equal(got, ckk.scatter_max_plain_(m.clone(), *trip))
    elif stem == "clock_scatter":  # both routes
        m, trip = _scatter_inputs(3, 64)
        want = ckk.scatter_max_plain_(m.clone(), *trip)
        assert not torch.equal(_run_host_scatter(fn, m, *trip), want)
        got = _run_host_params(fns["clock_scatter_params"], m, *trip)
        assert not torch.equal(got, want)
    else:
        op, makes = UNION_MUTANT_CASES[name]
        plain = ckk.min_reduce_plain if op == ckk._MIN else ckk.union_reduce_plain
        for make in makes:
            m = make()
            assert not torch.equal(_run_host_union(fn, m, op=op), plain(m)), (
                tuple(m.shape))


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


def _run_host_order(fn, ptrs, qobj, N, per_launch=0, shared_keys=0):
    """serve_order's entry as seq_order_cuda calls it: the lane pointers
    and qobj as host arrays, a device output and a host copy (standing in
    for the pinned buffer) that start as garbage, scratch when N is above
    the keys sorted in shared memory; returns what the copy holds."""
    B = len(ptrs)
    ptrs = np.asarray(ptrs, np.int64)
    qobj = np.ascontiguousarray(qobj, np.int32)
    out = torch.full((B * N + B,), 77, dtype=torch.int32)
    host = torch.full((B * N + B,), 78, dtype=torch.int32)
    scratch, scratch_len = None, 0
    if N > (shared_keys or sk.ORDER_SHARED_KEYS):
        m = min(B, per_launch or B)
        scratch_len = m * N + m
        scratch = torch.full((scratch_len,), 5, dtype=torch.int64)
    rc = fn(ptrs.ctypes.data, qobj.ctypes.data, B, N, per_launch, shared_keys,
            ck._ptr(scratch), scratch_len, out.data_ptr(), host.data_ptr(),
            None)
    assert rc == 0
    return host[: B * N].reshape(B, N), host[B * N :]


def _run_host_counts(fn, ptrs, qobj, N, per_launch=0):
    """serve_counts' entry as counts_cuda calls it: the lane pointers and
    qobj as host arrays, a device output and a host copy (standing in for
    the pinned buffer) that start as garbage; returns what the copy
    holds."""
    B = len(ptrs)
    ptrs = np.asarray(ptrs, np.int64)
    qobj = np.ascontiguousarray(qobj, np.int32)
    out = torch.full((2 * B,), 77, dtype=torch.int32)
    host = torch.full((2 * B,), 78, dtype=torch.int32)
    rc = fn(ptrs.ctypes.data, qobj.ctypes.data, B, N, per_launch,
            out.data_ptr(), host.data_ptr(), None)
    assert rc == 0
    return host[:B], host[B:]


def _run_host_lookup(fn, ptrs, qobj, qkey, N, per_launch=0):
    """serve_lookup's entry as map_lookup_cuda calls it: the lane
    pointers, qobj and qkey as host arrays, a device output and a host
    copy (standing in for the pinned buffer) that start as garbage;
    returns what the copy holds: found as a bool lane when every value
    came back 0 or 1, else as the raw int32 lane, which no bool lane
    equals."""
    B = len(ptrs)
    ptrs = np.asarray(ptrs, np.int64)
    qobj = np.ascontiguousarray(qobj, np.int32)
    qkey = np.ascontiguousarray(qkey, np.int32)
    out = torch.full((2 * B,), 77, dtype=torch.int32)
    host = torch.full((2 * B,), 78, dtype=torch.int32)
    rc = fn(ptrs.ctypes.data, qobj.ctypes.data, qkey.ctypes.data, B, N,
            per_launch, out.data_ptr(), host.data_ptr(), None)
    assert rc == 0
    found = host[B:]
    return host[:B], (found == 1 if set(found.tolist()) <= {0, 1} else found)


def _run_host_serve(fn, stem, lanes, qobj, qkey, pad_ptr=True, **kw):
    """A serve kernel compiled for the host, called as its wrapper calls
    it, with its arguments in host memory (the pad slot points at entry
    0's lanes); outputs start as garbage."""
    B, _, N = lanes.shape
    stride = lanes[0].numel() * lanes.element_size()
    ptrs = [lanes.data_ptr() + b * stride for b in range(B)]
    if pad_ptr:
        ptrs[-1] = ptrs[0]
    if stem == "serve_order":
        return _run_host_order(fn, ptrs, qobj, N, **kw)
    if stem == "serve_counts":
        return _run_host_counts(fn, ptrs, qobj, N, **kw)
    return _run_host_lookup(fn, ptrs, qobj, qkey, N, **kw)


def _serve_equal(got, want):
    return all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)
    )


SERVE_SOURCE_CASES = [
    (scenario, N) for scenario in synth.SERVE_SCENARIOS for N in (64, 256)
] + [("random", 4096), ("ties", 4096), ("all_masked", 4096)]


@pytest.mark.parametrize("scenario,N", SERVE_SOURCE_CASES)
@pytest.mark.parametrize("stem", list(SERVE_PLAIN))
def test_serve_source_equals_plain(host_kernels, stem, scenario, N):
    """At N = 4096 serve_order sorts at most 1,024 keys in shared memory,
    so its keys live in global scratch: heads of up to 1,024 keys are
    sorted in shared memory after all, larger ones ("all_masked") on the
    global route."""
    lanes, qobj, qkey = _serve_inputs(scenario, N, seed=N)
    kw = {"shared_keys": 1024} if stem == "serve_order" and N > 1024 else {}
    got = _run_host_serve(host_kernels[stem], stem, lanes, qobj, qkey, **kw)
    want = SERVE_PLAIN[stem](
        lanes, torch.from_numpy(qobj), torch.from_numpy(qkey)
    )
    assert _serve_equal(got, want)


def _order_lanes(case, B, N, seed):
    """synth_order_lanes of B entries, then a pad slot (entry 0 again,
    query NO_OBJ)."""
    lanes, qobj = synth.synth_order_lanes(case, B, N, seed=seed)
    return (np.concatenate([lanes, lanes[:1]]),
            np.append(qobj, sk.NO_OBJ).astype(np.int32))


# (B with its pad slot, N, per_launch, shared_keys); 0 takes the source's
# cap. "split": several launches of 2 entries; "global": keys above
# shared_keys in global scratch, heads above it on the global route;
# "global_split": both, scratch reused launch after launch
ORDER_SHAPES = {
    "shared": (6, 64, 0, 0), "tiny_bucket": (3, 16, 0, 0),
    "split": (6, 64, 2, 0), "global": (4, 256, 0, 32),
    "global_split": (6, 256, 4, 32),
}


@pytest.mark.parametrize("shape", list(ORDER_SHAPES))
@pytest.mark.parametrize("case", synth.ORDER_CASES)
def test_serve_order_source_equals_plain_and_reference(host_kernels, case,
                                                       shape):
    """serve_order's packed-key sort of the head and straight tail against
    seq_order_plain on every slot, and the real slots against the JAX
    package's jitted _build_seq_order (which pads the batch itself)."""
    import jax.numpy as jnp
    from hypermerge_tpu.serve import kernels as ref_sk

    B, N, per_launch, shared_keys = ORDER_SHAPES[shape]
    lanes, qobj = _order_lanes(case, B - 1, N, seed=B * N + per_launch)
    t = torch.from_numpy(lanes)
    ptrs = [t[b].data_ptr() for b in range(B)]
    ptrs[-1] = ptrs[0]
    got = _run_host_order(host_kernels["serve_order"], ptrs, qobj, N,
                          per_launch, shared_keys)
    want = sk.seq_order_plain(t, torch.from_numpy(qobj))
    assert _serve_equal(got, want)

    class _Entry:
        def __init__(self, dev):
            self.dev = dev

    ref_order, ref_count = ref_sk.seq_order(
        [_Entry(jnp.asarray(lanes[b])) for b in range(B - 1)],
        list(qobj[: B - 1]))
    np.testing.assert_array_equal(got[0][: B - 1].numpy(), ref_order[: B - 1])
    np.testing.assert_array_equal(got[1][: B - 1].numpy(), ref_count[: B - 1])


def test_serve_order_source_under_an_old_toolkit(tmp_path):
    """Built as under CUDA 11.8: 256 entries a launch, so 300 take two,
    the second through the small struct."""
    fns = _compile_host({"serve_order": (CSRC / "serve_order.cu").read_text()},
                        tmp_path, defines=("CUDART_VERSION=11080",))
    assert fns["serve_order_cap"](0) == 256
    assert fns["serve_order_cap"](1) == sk.ORDER_SHARED_KEYS
    lanes, qobj = _order_lanes("ties_across_head", 299, 32, seed=7)
    t = torch.from_numpy(lanes)
    got = _run_host_order(fns["serve_order"], [t[b].data_ptr() for b in range(300)],
                          qobj, 32)
    assert _serve_equal(got, sk.seq_order_plain(t, torch.from_numpy(qobj)))


def test_serve_order_source_rejects_bad_arguments(host_kernels):
    fn = host_kernels["serve_order"]
    assert host_kernels["serve_order_cap"](0) == 2048
    lanes, qobj = _order_lanes("all_live", 1, 64, seed=1)
    t = torch.from_numpy(lanes)
    ptrs = np.asarray([t[b].data_ptr() for b in range(2)], np.int64)
    out = torch.zeros(2 * 64 + 2, dtype=torch.int32)
    for B, N, per_launch, shared_keys in ((2, 48, 0, 0), (2, 64, 2049, 0),
                                          (2, 64, 0, 24), (2, 64, 0, 32)):
        # N not a power of two; a launch above the cap; shared keys not a
        # power of two; N above shared keys without scratch
        assert fn(ptrs.ctypes.data, qobj.ctypes.data, B, N, per_launch,
                  shared_keys, None, 0, out.data_ptr(), None, None) == -1


def _counts_lanes(scenario, B, N, seed, offset=False):
    """(lanes [B + 1, 6, N] with a pad slot (entry 0 again, query NO_OBJ),
    the B + 1 lane pointers, qobj) of synth_serve_lanes; with `offset`
    the lanes sit 4 bytes past an aligned address."""
    lanes, qobj, _qkey = synth.synth_serve_lanes(B, N, scenario, seed=seed)
    t = torch.from_numpy(np.concatenate([lanes, lanes[:1]]))
    if offset:
        t = _offset_view(t)
    ptrs = [t[b].data_ptr() for b in range(B + 1)]
    ptrs[-1] = ptrs[0]
    return t, ptrs, np.append(qobj, sk.NO_OBJ).astype(np.int32)


# (real entries, N, per_launch, lanes 4 bytes off alignment); per_launch
# 0 takes the source's cap. "split": 17 slots in launches of 16 + 1;
# N = 1 and 2 and the offset lanes read with scalar loads
COUNTS_SHAPES = {
    "int4": (5, 64, 0, False), "split": (16, 64, 16, False),
    "n1": (3, 1, 0, False), "n2": (3, 2, 0, False), "n4": (4, 4, 0, False),
    "offset": (5, 64, 0, True), "wide": (2, 4096, 0, False),
}


@pytest.mark.parametrize("shape", list(COUNTS_SHAPES))
@pytest.mark.parametrize("scenario", synth.SERVE_SCENARIOS)
def test_serve_counts_source_equals_plain_and_reference(host_kernels,
                                                        scenario, shape):
    """serve_counts' by-value entry (int4 or scalar loads, the shuffle
    sum) against counts_plain on every slot, and the real slots against
    the JAX package's jitted _build_counts (which pads the batch
    itself)."""
    import jax.numpy as jnp
    from hypermerge_tpu.serve import kernels as ref_sk

    B, N, per_launch, offset = COUNTS_SHAPES[shape]
    t, ptrs, qobj = _counts_lanes(scenario, B, N, seed=B * N + per_launch,
                                  offset=offset)
    got = _run_host_counts(host_kernels["serve_counts"], ptrs, qobj, N,
                           per_launch)
    want = sk.counts_plain(t, torch.from_numpy(qobj))
    assert _serve_equal(got, want)

    class _Entry:
        def __init__(self, dev):
            self.dev = dev

    ref = ref_sk.counts([_Entry(jnp.asarray(t[b].numpy())) for b in range(B)],
                        list(qobj[:B]))
    np.testing.assert_array_equal(got[0][:B].numpy(), ref[0][:B])
    np.testing.assert_array_equal(got[1][:B].numpy(), ref[1][:B])


def test_serve_counts_source_under_an_old_toolkit(tmp_path):
    """Built as under CUDA 11.8: 256 entries a launch, so 300 take two,
    the second through the small struct."""
    fns = _compile_host({"serve_counts": (CSRC / "serve_counts.cu").read_text()},
                        tmp_path, defines=("CUDART_VERSION=11080",))
    assert fns["serve_counts_cap"](0) == 256
    t, ptrs, qobj = _counts_lanes("random", 299, 16, seed=9)
    got = _run_host_counts(fns["serve_counts"], ptrs, qobj, 16)
    assert _serve_equal(got, sk.counts_plain(t, torch.from_numpy(qobj)))


def test_serve_counts_source_rejects_bad_arguments(host_kernels):
    fn = host_kernels["serve_counts"]
    assert host_kernels["serve_counts_cap"](0) == 2048
    _t, ptrs, qobj = _counts_lanes("random", 1, 64, seed=1)
    ptrs = np.asarray(ptrs, np.int64)
    out = torch.zeros(4, dtype=torch.int32)
    for B, N, per_launch in ((2, 48, 0), (2, 0, 0), (0, 64, 0), (2, 64, 2049),
                             (2, 64, -1)):
        # N not a power of two, or 0; no entry; a launch above the cap or
        # below 0
        assert fn(ptrs.ctypes.data, qobj.ctypes.data, B, N, per_launch,
                  out.data_ptr(), None, None) == -1


def _lookup_lanes(scenario, B, N, seed, offset=False):
    """(lanes [B + 1, 6, N] with a pad slot (entry 0 again, query NO_OBJ
    and key -1), the B + 1 lane pointers, qobj, qkey) of
    synth_serve_lanes; with `offset` the lanes sit 4 bytes past an
    aligned address."""
    t, ptrs, qobj = _counts_lanes(scenario, B, N, seed, offset=offset)
    _lanes, _qobj, qkey = synth.synth_serve_lanes(B, N, scenario, seed=seed)
    return t, ptrs, qobj, np.append(qkey, -1).astype(np.int32)


# (real entries, N, per_launch, lanes 4 bytes off alignment); per_launch
# 0 takes the source's cap. "split": 17 slots in launches of 16 + 1;
# N = 1 and 2 and the offset lanes read with scalar loads
LOOKUP_SHAPES = {
    "int4": (5, 64, 0, False), "split": (16, 64, 16, False),
    "split_three_ways": (20, 32, 7, False),
    "n1": (3, 1, 0, False), "n2": (3, 2, 0, False), "n4": (4, 4, 0, False),
    "offset": (5, 64, 0, True), "wide": (2, 4096, 0, False),
}


@pytest.mark.parametrize("shape", list(LOOKUP_SHAPES))
@pytest.mark.parametrize("scenario", synth.SERVE_SCENARIOS)
def test_serve_lookup_source_equals_plain_and_reference(host_kernels,
                                                        scenario, shape):
    """serve_lookup's by-value entry (int4 or scalar loads, the shuffle
    min, launches split over the batch) against map_lookup_plain on every
    slot, and the real slots against the JAX package's jitted
    _build_map_lookup (which pads the batch itself)."""
    import jax.numpy as jnp
    from hypermerge_tpu.serve import kernels as ref_sk

    B, N, per_launch, offset = LOOKUP_SHAPES[shape]
    t, ptrs, qobj, qkey = _lookup_lanes(scenario, B, N,
                                        seed=B * N + per_launch, offset=offset)
    got = _run_host_lookup(host_kernels["serve_lookup"], ptrs, qobj, qkey, N,
                           per_launch)
    want = sk.map_lookup_plain(t, torch.from_numpy(qobj),
                               torch.from_numpy(qkey))
    assert _serve_equal(got, want)

    class _Entry:
        def __init__(self, dev):
            self.dev = dev

    ref = ref_sk.map_lookup(
        [_Entry(jnp.asarray(t[b].numpy())) for b in range(B)],
        list(qobj[:B]), list(qkey[:B]))
    np.testing.assert_array_equal(got[0][:B].numpy(), ref[0][:B])
    np.testing.assert_array_equal(got[1][:B].numpy(), ref[1][:B])


def test_serve_lookup_source_under_an_old_toolkit(tmp_path):
    """Built as under CUDA 11.8: 128 entries a launch, so 300 take three,
    the last through the small struct."""
    fns = _compile_host({"serve_lookup": (CSRC / "serve_lookup.cu").read_text()},
                        tmp_path, defines=("CUDART_VERSION=11080",))
    assert fns["serve_lookup_cap"](0) == sk.LOOKUP_ENTRIES_MIN == 128
    t, ptrs, qobj, qkey = _lookup_lanes("random", 299, 16, seed=9)
    got = _run_host_lookup(fns["serve_lookup"], ptrs, qobj, qkey, 16)
    assert _serve_equal(got, sk.map_lookup_plain(
        t, torch.from_numpy(qobj), torch.from_numpy(qkey)))


def test_serve_lookup_source_rejects_bad_arguments(host_kernels):
    fn = host_kernels["serve_lookup"]
    assert host_kernels["serve_lookup_cap"](0) == 1024
    _t, ptrs, qobj, qkey = _lookup_lanes("random", 1, 64, seed=1)
    ptrs = np.asarray(ptrs, np.int64)
    out = torch.zeros(4, dtype=torch.int32)
    for B, N, per_launch in ((2, 48, 0), (2, 0, 0), (0, 64, 0), (2, 64, 1025),
                             (2, 64, -1)):
        # N not a power of two, or 0; no entry; a launch above the cap or
        # below 0
        assert fn(ptrs.ctypes.data, qobj.ctypes.data, qkey.ctypes.data, B, N,
                  per_launch, out.data_ptr(), None, None) == -1


SERVE_MUTANTS = {
    "lookup_minus_one_when_none": ("serve_lookup", "misses", [
        ("out[b0 + e] = best < N ? best : 0;",
         "out[b0 + e] = best < N ? best : -1;"),
    ], {}),
    # each warp and the block keep the highest of their threads' first
    # matches: every row matches, so the lowest is 0 and the highest not
    "lookup_keeps_highest_match": ("serve_lookup", "all_masked", [
        ("row = other < row ? other : row;",
         "row = other != N && (row == N || other > row) ? other : row;"),
        ("best = warp_rows[w] < best ? warp_rows[w] : best;",
         "best = warp_rows[w] != N && (best == N || warp_rows[w] > best)"
         " ? warp_rows[w] : best;"),
    ], {}),
    "lookup_split_drops_last_chunk": ("serve_lookup", "random", [
        ("for (int b0 = 0; rc == 0 && b0 < B; b0 += chunk) {",
         "for (int b0 = 0; rc == 0 && b0 + chunk < B; b0 += chunk) {"),
    ], {"per_launch": 4}),
    "order_ties_by_higher_row": ("serve_order", "all_masked", [
        ("= pack_key(key, i);", "= pack_key(key, 0x7ffffffe - i);"),
        ("return static_cast<int>(key & 0xffffffffu);",
         "return 0x7ffffffe - static_cast<int>(key & 0xffffffffu);"),
    ], {}),
    "order_tail_reversed": ("serve_order", "random", [
        ("if (w > warp) later += v;", "if (w < warp) later += v;"),
        ("- __popc(tb & behind)] = i;",
         "- __popc(tb & ~behind & ~(1u << lane))] = i;"),
    ], {}),
    "order_split_drops_last_chunk": ("serve_order", "random", [
        ("for (int b0 = 0; rc == 0 && b0 < B; b0 += chunk) {",
         "for (int b0 = 0; rc == 0 && b0 + chunk < B; b0 += chunk) {"),
    ], {"per_launch": 4}),
    "counts_ignore_insert": ("serve_counts", "random", [
        ("return (static_cast<Word>(live != 0 && ins == 1) << 32) |",
         "return (static_cast<Word>(live != 0) << 32) |"),
    ], {}),
    "counts_split_drops_last_chunk": ("serve_counts", "random", [
        ("for (int b0 = 0; rc == 0 && b0 < B; b0 += chunk) {",
         "for (int b0 = 0; rc == 0 && b0 + chunk < B; b0 += chunk) {"),
    ], {"per_launch": 4}),
    "counts_shuffle_skips_a_step": ("serve_counts", "random", [
        ("for (int lane_mask = 16; lane_mask > 0; lane_mask >>= 1)",
         "for (int lane_mask = 16; lane_mask > 1; lane_mask >>= 1)"),
    ], {}),
}


@pytest.mark.parametrize("name", list(SERVE_MUTANTS))
def test_serve_mutants_fail(tmp_path, name):
    stem, scenario, edits, kw = SERVE_MUTANTS[name]
    text = (CSRC / f"{stem}.cu").read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    fn = _compile_host({stem: text}, tmp_path)[stem]
    lanes, qobj, qkey = _serve_inputs(scenario, 64, B=6, seed=3)
    got = _run_host_serve(fn, stem, lanes, qobj, qkey, **kw)
    want = SERVE_PLAIN[stem](
        lanes, torch.from_numpy(qobj), torch.from_numpy(qkey)
    )
    assert not _serve_equal(got, want)


# ---------------------------------------------------------------------------
# the ring gather: the push route (an ordinary launch, no flags) and the
# flagged route (cooperative blocks that wait on each other's flags), so
# every run is a subprocess with its own time limit

RING_RUNNER = r"""
import ctypes, json, sys, threading
import numpy as np

lib = ctypes.CDLL(sys.argv[1])
fn, hooks = lib.hm_ring_gather, lib.hm_ring_test_hooks
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
fn.argtypes = [P] * 3 + [I] * 3 + [L, I, L] + [I] * 4 + [P]
fn.restype = I
hooks.argtypes = [I, I, L]
hooks.restype = None
PUSH, FLAGGED = 0, 1
THREADS, SLICES, BLOCKS = 32, 3, 2  # a block's threads; per source; per rank


def aligned(nbytes, fill):
    # 64-byte aligned, so that 16-byte copies run wherever offsets allow
    raw = np.full(nbytes + 64, fill, np.uint8)
    off = -raw.ctypes.data % 64
    return raw[off : off + nbytes]


results = []
for case in json.loads(sys.argv[2]):
    n, rows, W = case["n"], case["rows"], case["W"]
    route = case.get("route", "push")
    rng = np.random.default_rng(case["seed"])
    blocks = [aligned(rows * W, 0) for _ in range(n)]
    for b in blocks:
        b[:] = rng.integers(0, 256, rows * W)
    want = np.concatenate(blocks)
    outs = [aligned(n * rows * W, 0xAB) for _ in range(n)]
    flags = [np.zeros(n + 2, np.int32) for _ in range(n)]
    ptrs = [np.asarray([a.ctypes.data for a in arrs], np.int64)
            for arrs in (blocks, outs, flags)]
    B = rows * W
    for epoch, call in enumerate(case["calls"], start=1):
        ahead = call.get("ahead", -1)
        for o in outs:  # every call must write every byte, except that a
            # rank ahead by a call has already written its block of this one
            kept = o[ahead * B : (ahead + 1) * B].copy()
            o[:] = 0xAB
            if ahead >= 0:
                o[ahead * B : (ahead + 1) * B] = kept
        if ahead >= 0:  # this rank already raised the next call's flags
            for f in flags:
                f[ahead] = epoch + 1
        for f in flags:
            f[n] = 0
        hooks(call.get("silent", -1), call.get("late", -1),
              call.get("late_ns", 0))

        def launch(rank0, count, mode):
            return fn(*(p.ctypes.data for p in ptrs), n, rank0, count,
                      B, epoch, call.get("timeout_ns", 10**9), mode, THREADS,
                      SLICES, BLOCKS, None)

        if route == "peer":
            # one launch per rank from a host thread of its own, as one
            # card each runs; a rank's output is read as soon as its
            # launch returns
            rcs, snaps = [0] * n, [None] * n

            def run(r):
                rcs[r] = launch(r, 1, FLAGGED)
                snaps[r] = outs[r].copy()

            threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        elif route == "push":  # one concatenation, every rank's result
            rcs = [launch(0, n, PUSH)]
            snaps = [outs[0].copy()]
        else:
            rcs = [launch(0, n, FLAGGED)]
            snaps = [o.copy() for o in outs]
        results.append(dict(
            rc=max(rcs), errors=[int(f[n]) for f in flags],
            equal=[bool(np.array_equal(s, want)) for s in snaps]))
print(json.dumps(results))
"""


def _ring_call(lib, cases, timeout=120):
    """The ring cases run by RING_RUNNER on `lib`: one result per call,
    or None when the subprocess outlived its time limit."""
    import json
    import sys

    try:
        proc = subprocess.run(
            [sys.executable, "-c", RING_RUNNER, str(lib), json.dumps(cases)],
            capture_output=True, text=True, timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return None
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def _ring_lib(text, out):
    """ring_gather.cu built for the host with its test hooks."""
    _compile_host({"ring_gather": "#define HM_RING_TEST_HOOKS\n" + text}, out)
    return out / "libring_gather.so"


@pytest.fixture(scope="module")
def ring_lib(tmp_path_factory):
    return _ring_lib((CSRC / "ring_gather.cu").read_text(),
                     tmp_path_factory.mktemp("ring"))


def _ok(r):
    return r["rc"] == 0 and not any(r["errors"]) and all(r["equal"])


# (n, rows, W): odd widths, one-row blocks, a width whose blocks start at
# every offset modulo 16 (byte copies) and one that takes 16-byte copies
RING_SHAPES = [(1, 1, 3), (2, 1, 1), (3, 1, 5), (5, 1, 3), (2, 3, 33),
               (3, 4, 32), (5, 2, 7)]


@pytest.mark.parametrize("n,rows,W", RING_SHAPES)
def test_ring_gather_source_equals_concatenation(ring_lib, n, rows, W):
    """The push route (one concatenation, every rank's result), twice on
    the same buffers."""
    res = _ring_call(ring_lib, [dict(n=n, rows=rows, W=W, seed=n * W + rows,
                                     calls=[{}, {}])])
    assert res is not None, "the push route hung"
    assert all(_ok(r) for r in res), res


@pytest.mark.parametrize("n,rows,W", RING_SHAPES)
@pytest.mark.parametrize("route", ["protocol", "peer"])
def test_ring_gather_flagged_source_equals_concatenation(ring_lib, route, n,
                                                         rows, W):
    """The flagged launch, over virtual ranks in one cooperative grid and
    as one launch per rank from concurrent host threads; the second call
    runs at the next epoch on the same flags."""
    res = _ring_call(ring_lib, [dict(n=n, rows=rows, W=W, seed=n * W + rows,
                                     route=route, calls=[{}, {}])])
    assert res is not None, "the ring deadlocked"
    assert all(_ok(r) for r in res), res


# the second call: rank 1 already finished it (its block of this call is
# in place) and raised every rank's flag for the call after, so it raises
# nothing now
AHEAD = [{}, {"silent": 1, "ahead": 1, "timeout_ns": 500_000_000}]


def test_ring_gather_source_passes_pre_advanced_flags(ring_lib):
    """A wait passes once the flag is >= the epoch: a rank that already
    raised its flags for a later call also finished this one."""
    res = _ring_call(ring_lib, [dict(n=5, rows=1, W=3, seed=1, route="protocol",
                                     calls=AHEAD)])
    assert res is not None and all(_ok(r) for r in res), res


def test_ring_gather_source_times_out_instead_of_hanging(ring_lib):
    """A rank that never raises its flag: every rank gives up after the
    timeout, sets its error word, and returns."""
    res = _ring_call(ring_lib, [dict(n=4, rows=1, W=5, seed=2, route="protocol",
                                     calls=[{"silent": 1,
                                             "timeout_ns": 100_000_000}])])
    assert res is not None, "the ring hung"
    (r,) = res
    assert r["rc"] == 0 and r["errors"][2] == 1 and all(r["errors"]), r


# a rank whose pushes start 150 ms late: the others must wait for them
LATE = [{"late": 4, "late_ns": 150_000_000}]
PEER_PROTOCOL_CASES = {
    "pre_advanced_flags": (AHEAD, True),
    "late_rank": (LATE, True),
    "timeout": ([{"silent": 1, "timeout_ns": 100_000_000}], False),
}


@pytest.mark.parametrize("case", list(PEER_PROTOCOL_CASES))
def test_ring_gather_peer_source_protocol(ring_lib, case):
    """The flagged launch as peer ranks run it: each rank's output is read
    the moment its own launch returns, so it must be whole by then (a
    rank that pushes late is waited for); a rank ahead by one call passes;
    a silent rank makes every rank time out instead of hanging."""
    calls, ok = PEER_PROTOCOL_CASES[case]
    res = _ring_call(ring_lib, [dict(n=5, rows=2, W=32, seed=4, route="peer",
                                     calls=calls)])
    assert res is not None, "the ring hung"
    if ok:
        assert all(_ok(r) for r in res), res
    else:
        (r,) = res
        assert r["rc"] == 0 and all(r["errors"]), r


RING_MUTANTS = {
    # a block reads source block (src + 1) mod n for src's place
    "source_r_plus_s": (
        [("const unsigned char* src_p = a.local[src] + lo;",
          "const unsigned char* src_p = a.local[(src + 1) % a.n] + lo;")],
        dict(route="push", calls=[{}])),
    # the wait covers n - 1 ranks: a late last rank's block is missing
    "n_minus_2_steps": (
        [("for (int src = 0; src < n; ++src) {",
          "for (int src = 0; src < n - 1; ++src) {")],
        dict(route="peer", calls=LATE)),
    "wait_for_equal_epoch": (
        [("while (*flag < a.epoch) {", "while (*flag != a.epoch) {")],
        dict(route="protocol", calls=AHEAD)),
    # the last 16-byte chunk of every slice is never copied
    "push_skips_last_vector": (
        [("for (; i < nvec; i += stride) dv[i]",
          "for (; i < nvec - 1; i += stride) dv[i]")],
        dict(route="push", calls=[{}])),
    # the arrival flags go up before the rank's pushes (and their fence)
    "raise_before_fence": (
        [("  const int g = static_cast<int>(blockIdx.x) % a.blocks;\n",
          "  const int g = static_cast<int>(blockIdx.x) % a.blocks;\n"
          "  arrive(a, r);\n"),
         ("  arrive(a, r);\n}\n", "}\n")],
        dict(route="peer", calls=LATE)),
}


@pytest.mark.parametrize("name", list(RING_MUTANTS))
def test_ring_mutants_fail(tmp_path, name):
    edits, case = RING_MUTANTS[name]
    text = (CSRC / "ring_gather.cu").read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    res = _ring_call(_ring_lib(text, tmp_path),
                     [dict(n=5, rows=2, W=32, seed=3, **case)], timeout=60)
    assert res is None or not all(_ok(r) for r in res), res


def test_ring_gather_source_without_hooks(tmp_path):
    """ring_gather.cu built as the wrappers load it: no test hooks are
    exported, and the push route through the wrappers' signature writes
    the concatenation."""
    fn = _compile_host({"ring_gather": (CSRC / "ring_gather.cu").read_text()},
                       tmp_path)["ring_gather"]
    assert not hasattr(ctypes.CDLL(str(tmp_path / "libring_gather.so")),
                       "hm_ring_test_hooks")
    rng = np.random.default_rng(6)
    blocks = [rng.integers(0, 256, 37, dtype=np.uint8) for _ in range(3)]
    out = np.zeros(3 * 37, np.uint8)
    locals_ = np.asarray([b.ctypes.data for b in blocks], np.int64)
    outs = np.asarray([out.ctypes.data], np.int64)
    rc = fn(locals_.ctypes.data, outs.ctypes.data, None, 3, 0, 3, 37, 0, 0, 0,
            4, 2, 1, None)
    assert rc == 0
    np.testing.assert_array_equal(out, np.concatenate(blocks))
