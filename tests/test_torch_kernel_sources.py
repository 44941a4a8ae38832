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
of test_torch_pack.py and on its crafted parity traps). Tolerance: exact.
"""

import ctypes
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
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops import pack_kernels as pk
from hypermerge_tpu_torch.ops import synth
from hypermerge_tpu_torch.ops.columnar import COLUMNS
from test_torch_pack import CASES as PACK_CASES
from test_torch_pack import port_pack, trap_inputs, trap_variants

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "hypermerge_tpu_torch" / "kernels" / "csrc"
_LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),.*?>>>\(", re.S)


def _host_source(text: str) -> str:
    """The .cu text with the CUDA runtime include and the <<<>>> launch
    replaced by the shim's."""
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_host_shim.h"')
    m = _LAUNCH.search(text)
    assert m, "no kernel launch found"
    depth, i = 1, m.end()
    while depth:
        depth += {"(": 1, ")": -1}.get(text[i], 0)
        i += 1
    kernel, grid, block = m.groups()
    return (
        text[: m.start()]
        + f"shim_launch({grid}, {block}, [&] {{ {kernel}("
        + text[m.end() : i]
        + "; })"
        + text[i:]
    )


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """{stem: bound C entry} of the kernels compiled for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel sources for the host")
    out = tmp_path_factory.mktemp("host_kernels")
    fns = {}
    for stem, (symbol, argtypes) in ck._SIGNATURES.items():
        src = out / f"{stem}.cpp"
        src.write_text(_host_source((CSRC / f"{stem}.cu").read_text()))
        lib = out / f"lib{stem}.so"
        subprocess.run(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             f"-I{CSRC}", f"-I{TESTS}", "-o", str(lib), str(src)],
            check=True, capture_output=True, timeout=300,
        )
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[stem] = fn
    return fns


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
