#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA Hopper GPU, end to end.

    python3 chip_smoke.py        # from the repository root

Phases (any failure raises, and the script exits non-zero before it
prints a result):
  1. build every CUDA kernel from kernels/csrc (one nvcc per source, all
     at once) and the port's host C++ library (native/, g++), print the
     card's name and power limit, and whether the native library loaded
     and with which capabilities;
  2. hold each kernel against its plain PyTorch version on the card, on
     the same inputs, exactly (integer and bool outputs, tolerance 0):
     materialize and summary_wire at the bulk slab (4096 docs x 1024
     rows, 1 actor) and at a multi-actor batch (1024 x 512, 3 actors,
     half text); pack_prefix on the inputs the sidecar pack hands it at
     the slab, at a ragged slab (partial windows, an empty doc, a shared
     feed, values outside int16) and at one doc of 65,536 rows (int32
     row planes); the four clock kernels at the mirror's capacity of
     BASELINE config 5 (131072 x 64): the pairwise ops (also at A = 3
     and A = 1024, full and broadcast rows), the scatter-max with 1,000
     and 65,536 triples piled on one cell, the column max (also at
     [5, 3] and on negative clocks), top-k with mass ties and INT32_INF
     rows at k = 1, 64 and D; the three read-serving kernels at
     B in {1, 8, 64} x N in {64, 1024, 65536}, each shape with every
     synthetic scenario (ops/synth.py synth_serve_lanes: misses,
     all-matching rows, mass rank ties, ranks at the int32 ends) and a
     pad batch slot;
  3. drive each main path through the user entry points, its launch
     counts set to 0 just before it and read just after:
     a. the first slice: the slab dispatch `run_batch_full` (full and
        lean) with its host decode, and `materialize_batch` /
        `summarize_columnar` over 64 distinct histories, checked against
        the same entries run on the CPU;
     b. the sidecar slice: 8 template feeds written to column sidecars on
        disk and compacted, 4096 docs packed from them on the card by
        `pack_docs_columns`, `run_batch_full` and `fetch_summary`; live
        counts of every doc and decoded patches of 64 docs are held
        against the first slice's path (`pack_docs` over the same
        histories); pack_prefix, materialize and summary_wire must each
        have launched once;
     c. the clock slice: BASELINE config 5 (`bench.py` `_config5_union`)
        on the card — a DeviceClockMirror seeded with 100,000 docs x 64
        actors, then 1,000 `update`s, `union()`, `dominated(q)` and
        `top_k_dominated(q, 64)`, each answer and the whole matrix equal
        to a mirror on the CPU fed the same calls, with exactly one
        launch each of clock_scatter, clock_union, clock_pair and
        clock_topk; then a sqlite ClockStore with a mirror attached
        (2,000 docs x 16 actors, a seeded mix of update, update_many,
        set and delete_doc), `union_query` / `dominated_query` on the
        mirror route and the doc-subset route, equal to the same store
        on the CPU;
     d. the read slice: bench.py's `_config_read` serving configuration —
        a corpus of 2,048 docs x 1,024 ops written with the port's
        `make_corpus` to a temporary directory (its .sig sidecars only
        when the host library has libsodium), `Repo(path)`,
        `open_many` of all of them and `fetch_bulk_summaries()`, the
        32-doc hot set made resident, then 8 reader threads issuing
        4,000 `len` reads (90% over the hot set, RNG seed 0xEAD5), timed
        read by read; the host twin on the same 4,000 reads; the same
        window again under torch.profiler, residency dropped first so it
        pays the same installs; then a mixed pass over the hot set
        (lookup of k0..k9, text, index and len of the text and of the
        root); every answer equal to `host_read` (the HM_SERVE=0 twin)
        on the same doc; serve_lookup,
        serve_order and serve_counts each launched, their launches
        summing to the tier's `serve.dispatches`, and the bulk kernels
        launched once per slab;
  4. time each kernel (CUDA events, median of 7 runs after warm-up) beside
     its plain version, its bound and, where one PyTorch call computes
     the same function, that call (torch.argsort for the sort in the
     summary wire; torch.amax, scatter_reduce_ and torch.topk for the
     clock kernels, whose device time alone torch.profiler also
     reads; torch.sort for serve_order); time the pack's host stages,
     config 5's hot query (1,000 writes + union(), host buffering
     included), and print the read mix's QPS, its p50 and p99 from the
     raw per-read latencies (and the `serve.read_s` histogram's bucket
     bounds), the host twin's QPS, p50 and p99 on the same 4,000 reads,
     and the profiled window's device busy time and idle share; print
     the kernels as one JSON line; profile one slab dispatch of each
     slice for its device time by kernel and the device's idle share (a
     profiler reading that gets no device record is printed as not
     measured, None: the profiler is a reading, not a check);
  5. print {"ok": true, "device": {...}} as the last line.

It exits non-zero with no result when no GPU is present, and when the
port's package is not beside it.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores; the
# published table has no int32 rate, and these kernels do int32 work
SLAB = dict(n_docs=4096, n_ops=1024, n_actors=1)
MULTI = dict(n_docs=1024, n_ops=512, n_actors=3, text_frac=0.5)
TEMPLATES = 8  # distinct template feeds behind the sidecar slab
INF = float("inf")
SLICE1 = ("materialize", "summary_wire")
SLICE2 = ("pack_prefix", "materialize", "summary_wire")
# BASELINE config 5 (bench.py _config5_union): the mirror's size
CONFIG5 = dict(n_docs=100_000, n_actors=64, dirty=1000)
CLOCKS = ("clock_scatter", "clock_union", "clock_pair", "clock_topk")
STORE = dict(n_docs=2000, n_actors=16, steps=600, seed=5)
# bench.py _config_read: the serving configuration and its read mix
READ = dict(n_docs=2048, n_ops=1024, hot=32, readers=8, reads=4000,
            seed=0xEAD5)
SERVE = ("serve_lookup", "serve_order", "serve_counts")
BULK = ("pack_prefix", "materialize", "summary_wire")
# torch.profiler now and then delivers no device record for a window; a
# kernel-alone window is tried again, and every window is padded with idle
# host time so that device records near its edges fall inside it
PROFILE_TRIES = 3
PROFILE_PAD_S = 0.005


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_batch(synth, cfg):
    cfg = dict(cfg)
    return synth.synth_batch(cfg.pop("n_docs"), cfg.pop("n_ops"), **cfg)


def cuda_args(ck, batch, lean=False):
    import torch

    np_args, A, K = ck.host_args(batch, lean=lean)
    args = tuple(
        None if a is None else torch.from_numpy(a).cuda() for a in np_args
    )
    return args, A, K


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def compare_kernels(ck, batch, name):
    """Kernel vs plain on the card, same inputs; returns the max abs err
    per kernel and raises on any difference."""
    import torch

    errs = {"materialize": 0, "summary_wire": 0}
    N = batch.n_rows
    for lean in (False, True):
        args, A, K = cuda_args(ck, batch, lean=lean)
        got = ck.materialize_cuda(*args, A=A, K=K)
        want = ck.doc_kernel_plain(
            *ck.widen_plain(*args[:10]), args[10], A=A, K=K
        )
        torch.cuda.synchronize()
        for f in want._fields:
            e = max_abs_err(getattr(got, f), getattr(want, f))
            errs["materialize"] = max(errs["materialize"], e)
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"{name} lean={lean}: lane {f} differs")
        wire = ck.summary_wire_cuda(want, N, A, lean)
        wire_plain = ck.summarize_wire_plain(want, N, A, lean)
        torch.cuda.synchronize()
        errs["summary_wire"] = max(
            errs["summary_wire"], max_abs_err(wire, wire_plain)
        )
        if not torch.equal(wire, wire_plain):
            raise AssertionError(f"{name} lean={lean}: summary wire differs")
    log(f"phase 2 {name} {batch.shape}: kernels == plain (exact)")
    return errs


def check_summary(arrays, dec, decode_columnar, lean):
    import numpy as np

    ref = decode_columnar(dec)
    for k, v in ref.items():
        if lean and k == "clock":
            continue
        if not np.array_equal(np.asarray(v), np.asarray(arrays[k])):
            raise AssertionError(f"summary {k} differs from its host decode")


def main_path(ck, mat, synth, columnar, slab):
    """The first slice's entries as a user calls them; returns its launch
    counts."""
    import numpy as np
    import torch

    for k in ck.launches:
        ck.launches[k] = 0
    t0 = time.perf_counter()
    # the bulk slab dispatch (full and lean) + host decode
    for lean in (False, True):
        out, wire = ck.run_batch_full(slab, lean=lean)
        arrays = mat.fetch_summary(wire, slab, lean=lean)
        check_summary(arrays, mat.DecodedBatch(slab, out),
                      mat.decode_columnar, lean)
        if arrays["elem_order"].shape != slab.shape:
            raise AssertionError("elem_order shape")
    # a pack of distinct histories, end to end, against the CPU path
    hists = [
        synth.synth_changes(512, n_actors=3, text_frac=0.5, seed=1000 + i)
        for i in range(64)
    ]
    docs = mat.materialize_docs(mat.materialize_batch(hists))
    docs_cpu = mat.materialize_docs(mat.materialize_batch(hists, device="cpu"))
    if docs != docs_cpu:
        raise AssertionError("materialize_docs: GPU != CPU")
    batch = columnar.pack_docs(hists)
    summ = mat.summarize_columnar(batch)
    summ_cpu = mat.summarize_columnar(batch, device="cpu")
    for k in summ_cpu:
        if not np.array_equal(summ[k], summ_cpu[k]):
            raise AssertionError(f"summarize_columnar {k}: GPU != CPU")
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    log(f"phase 3a first slice: {time.perf_counter() - t0:.3f} s wall, "
        f"launches {counts}")
    for k in SLICE1:
        if counts[k] == 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    return counts


def median_ms(fn, runs=7, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def time_kernels(ck, batch):
    """{kernel: numbers} at this batch's shape."""
    import torch

    args, A, K = cuda_args(ck, batch)
    flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt, da = args
    D, N = batch.shape
    plain_args = ck.widen_plain(*args[:10]) + (da,)
    out = ck.materialize_cuda(*args, A=A, K=K)
    rounds = max(1, math.ceil(math.log2(max(N, 2)))) + 1
    log2n = max(1, int(math.log2(N)))
    res = {}

    # kernel 1: reads flags..value + ptgt once, writes 5 bool + 2 int32
    # lanes + the clock; ops: two comparison sorts (N log2 N each) and
    # the doubling + ranking rounds (1 + 3 int ops per row per round)
    b1 = nbytes(flags, slot, ctr, seq, obj, key, ref, value, ptgt) + nbytes(
        *out
    )
    o1 = D * (2 * N * log2n + 4 * (N + 1) * rounds)
    res["materialize"] = dict(
        ms=median_ms(lambda: ck.materialize_cuda(*args, A=A, K=K)),
        plain_ms=median_ms(lambda: ck.doc_kernel_plain(*plain_args, A=A, K=K)),
        library_ms=None, bytes=b1, ops=o1,
    )

    # kernel 2: reads two masks + rank + clock, writes the wire; ops: one
    # comparison sort (N log2 N)
    wire = ck.summary_wire_cuda(out, N, A, False)
    b2 = nbytes(out.map_winner, out.elem_live, out.rank, out.clock, wire)
    o2 = D * N * log2n
    order_key = torch.where(out.elem_live, -out.rank, 2**31 - 1)
    res["summary_wire"] = dict(
        ms=median_ms(lambda: ck.summary_wire_cuda(out, N, A, False)),
        plain_ms=median_ms(lambda: ck.summarize_wire_plain(out, N, A, False)),
        library_ms=median_ms(
            lambda: torch.argsort(order_key, dim=1, stable=True)
        ),
        bytes=b2, ops=o2,
    )
    for r in res.values():
        t_bytes = r["bytes"] / MEM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / SCALAR_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return res


def profile_dispatch(label, fn) -> dict:
    """Device time by kernel for one call of fn (a slab dispatch or a
    read window, host stages included), from torch.profiler; returns the
    wall, the device's busy time and its idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)

    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    # busy = device-side events only (kernels, copies); a CPU op such as
    # aten::copy_ also carries the device time of the work it launched
    busy_ms = sum(
        dev_us(e) for e in rows
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ) / 1e3
    if busy_ms <= 0:
        # the window's work ran (fn's own checks stand); only the
        # profiler's reading of it is missing
        log(f"profile {label}: wall_ms={wall_ms!r}; the profiler delivered "
            "no device record: busy time and idle share not measured")
        return dict(wall_ms=wall_ms, device_busy_ms=None,
                    device_idle_share=None)
    log(f"profile {label}: wall_ms={wall_ms!r} device_busy_ms="
        f"{busy_ms!r} device_idle_share={1 - busy_ms / wall_ms!r}")
    for e in rows[:8]:
        if dev_us(e) > 0:
            log(f"  {dev_us(e) / 1e3!r} ms  x{e.count}  {e.key[:70]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms)


# -- the sidecar slice --------------------------------------------------------


def value_tail(history, port_types):
    """`history` plus changes that set root keys to values of every lane
    the pack remaps: ints outside int16, floats, bools, bigints, strings."""
    Action, Change, Op, ROOT = port_types
    last = history[-1]
    values = [2**20, -(2**20), 3.25, True, 2**40, "wide", 70000, -40000]
    out = list(history)
    start, seq = last.max_op + 1, last.seq + 1
    for i, v in enumerate(values):
        op = Op(action=Action.SET, obj=ROOT, key=f"v{i}", value=v)
        out.append(Change(actor=last.actor, seq=seq + i,
                              start_op=start + i, deps={}, ops=(op,)))
    return out


def sidecar_feeds(colcache, root, hists):
    """Each history written to its own column sidecar file under `root`,
    compacted into a v3 checkpoint, and reopened: plane-backed
    FeedColumns, as a cold open reads them."""
    fcs = []
    for t, hist in enumerate(hists):
        path = f"{root}/t{t}.cols2"
        writer = hist[0].actor
        cc = colcache.FeedColumnCache(
            colcache.FileColumnStorageV2(path), writer=writer
        )
        for c in hist:
            cc.append_change(c)
        cc.compact()
        fc = colcache.FeedColumnCache(
            colcache.FileColumnStorageV2(path), writer=writer
        ).columns()
        if fc.planes is None:
            raise AssertionError(f"{path}: no checkpoint planes after compact")
        fcs.append(fc)
    return fcs


def slab_specs(fcs, n_docs):
    return [[(fcs[d % TEMPLATES], 0, INF)] for d in range(n_docs)]


def capture(module, name, fn):
    """(fn's result, the arguments of every call of module.name during
    it)."""
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    setattr(module, name, spy)
    try:
        return fn(), calls
    finally:
        setattr(module, name, orig)


def compare_pack(pk, columnar, specs, label, **kw):
    """Pack `specs` on the card, then hold pack_prefix against its plain
    version on the inputs the pack handed it; returns (max abs err, the
    pack_prefix keyword arguments)."""
    import torch

    _batch, calls = capture(
        pk, "pack_prefix",
        lambda: columnar.pack_docs_columns(specs, device="cuda", **kw),
    )
    if len(calls) != 1:
        raise AssertionError(f"{label}: the fast pack path was not taken")
    k = calls[0][1]
    got, mm = pk.pack_prefix_cuda(**k)
    want, mm_plain = pk.pack_prefix_plain(**k)
    torch.cuda.synchronize()
    err = max_abs_err(mm, mm_plain)
    if not torch.equal(mm, mm_plain):
        raise AssertionError(f"{label}: value range {mm} != {mm_plain}")
    for name, a, b in zip(columnar.COLUMNS, got, want):
        err = max(err, max_abs_err(a, b))
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{label}: packed plane {name} differs")
    log(f"phase 2 pack {label} [{k['Dp']}, {k['N']}] "
        f"M={k['planes'][0].shape[0]} row32={k['row32']}: "
        f"kernel == plain (exact)")
    return err, k


def slice_path(ck, columnar, mat, fcs):
    """The sidecar slice's entries as a user calls them, counts set to 0
    just before and read just after; returns (batch, out, summary arrays,
    lean, counts)."""
    import numpy as np
    import torch

    from hypermerge_tpu_torch.crdt.change import Action

    specs = slab_specs(fcs, SLAB["n_docs"])
    for k in ck.launches:
        ck.launches[k] = 0
    t0 = time.perf_counter()
    batch = columnar.pack_docs_columns(
        specs, n_docs=SLAB["n_docs"], n_rows=SLAB["n_ops"], device="cuda"
    )
    # lean as the bulk loader picks it: no INC ops, host clocks in hand
    lean = not bool(np.any(batch.cols["action"] == int(Action.INC)))
    out, wire = ck.run_batch_full(batch, lean=lean)
    arrays = mat.fetch_summary(wire, batch, lean=lean)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ck.launches)
    log(f"phase 3b sidecar slice: {wall:.3f} s wall (pack + dispatch + "
        f"fetch), lean={lean}, launches {counts}")
    for k in SLICE2:
        if counts[k] != 1:
            raise AssertionError(
                f"kernel {k} launched {counts[k]} times on the sidecar "
                f"slice, expected 1"
            )
    return batch, out, arrays, lean, counts


def check_slice(ck, columnar, mat, hists, batch, out, arrays, lean):
    """The sidecar slice against the first slice's path over the same
    histories: live counts of every doc, decoded patches of 64 docs
    (the contract of pack_docs_columns: equal patches, not equal
    bytes — table ids differ between the two packs)."""
    import numpy as np

    ref = columnar.pack_docs(hists)
    ref_out, ref_wire = ck.run_batch_full(ref)
    ref_arrays = mat.fetch_summary(ref_wire, ref)
    n = SLAB["n_docs"]
    tmpl = np.arange(n) % TEMPLATES
    for key in ("n_live_elems", "n_map_entries"):
        if not np.array_equal(arrays[key][:n], ref_arrays[key][tmpl]):
            raise AssertionError(f"sidecar slice {key} != first slice")
    clocks = [{hists[t][0].actor: len(hists[t])} for t in tmpl]
    dec = mat.DecodedBatch(batch, out, host_clocks=clocks if lean else None)
    ref_dec = mat.DecodedBatch(ref, ref_out)
    # 64 docs spread over the slab, every template among them
    sample = [(i * (n // 64) + i % TEMPLATES) % n for i in range(64)]
    for d in sample:
        got = mat.decode_patch(dec, d).to_json()
        if got != mat.decode_patch(ref_dec, d % TEMPLATES).to_json():
            raise AssertionError(f"sidecar slice doc {d}: patch differs")
    log(f"phase 3b check: live counts of {n} docs and patches of "
        f"{len(sample)} docs == first slice's path")


def host_medians_ms(fns, runs=7, warmup=2):
    """{name: median host wall in ms} of each fn() ending in a
    synchronize; the fns take turns in every round, so that host noise
    falls on all of them alike."""
    import torch

    for _ in range(warmup):
        for fn in fns.values():
            fn()
            torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def kernel_device_ms(fn, name: str, runs=20) -> float | None:
    """Mean device time of the kernel called `name` (the whole identifier,
    demangled or mangled) over `runs` calls of fn, from torch.profiler.
    A window in which the profiler delivered no record of it is tried
    again; after PROFILE_TRIES such windows the time is not measured
    (None). It is a reading beside the CUDA-event times, not a check."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # demangled: the bare identifier; mangled: its length, then the name
    n = re.escape(name)
    pat = re.compile(rf"(?<!\w){n}(?!\w)|{len(name)}{n}")
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        total = sum(
            dev_us(e) for e in prof.key_averages() if pat.search(e.key)
        )
        if total > 0:
            return total / runs / 1e3
        log(f"profiler: no device record of {name} (window {attempt} of "
            f"{PROFILE_TRIES})")
    log(f"profiler: {name} alone not measured")
    return None


def dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0
    )


def time_pack(pk, columnar, fcs, k_slab):
    """pack_prefix numbers at the slab, and the pack's host stages."""
    import numpy as np
    import torch

    specs = slab_specs(fcs, SLAB["n_docs"])
    kw = dict(n_docs=SLAB["n_docs"], n_rows=SLAB["n_ops"])
    _b, calls = capture(
        pk, "device_pack_prefix",
        lambda: columnar.pack_docs_columns(specs, device="cuda", **kw),
    )
    a = calls[0][0]  # fcs, fc_idx, fc_idx_a, ends, writer_g, flat_lut, ...
    N = k_slab["N"]
    inp = pk.marshal_pack_inputs(*a[:6], N)
    dev = torch.device("cuda")
    outs, _mm = pk.pack_prefix_cuda(**k_slab)
    in_bytes = nbytes(*k_slab["planes"], k_slab["doc_start"], k_slab["ends"],
                      k_slab["writer"], k_slab["lut_off"], *k_slab["luts"])
    out_bytes = nbytes(*outs)
    cells = k_slab["Dp"] * k_slab["N"]
    r = dict(
        ms=median_ms(lambda: pk.pack_prefix_cuda(**k_slab)),
        kernel_device_ms=kernel_device_ms(
            lambda: pk.pack_prefix_cuda(**k_slab), "pack_prefix_kernel"
        ),
        plain_ms=median_ms(lambda: pk.pack_prefix_plain(**k_slab)),
        library_ms=None,
        bytes=in_bytes + out_bytes,
        # per cell: the (d, p) split, the row test, 4 compares/selects
        # for obj/ref, 2 LUT index clamps, the min/max: ~16 int ops
        ops=16 * cells,
    )
    # the pack's host stages: the marshal, the upload of its output, the
    # whole emit (marshal, upload, kernel, download) and the whole pack
    r.update(host_medians_ms({
        "marshal_ms": lambda: pk.marshal_pack_inputs(*a[:6], N),
        "upload_ms": lambda: pk.upload(inp, dev),
        "device_pack_prefix_ms": lambda: pk.device_pack_prefix(*a),
        "pack_docs_columns_ms": lambda: columnar.pack_docs_columns(
            specs, device="cuda", **kw
        ),
    }))
    t_bytes = r["bytes"] / MEM_BYTES_PER_S * 1e3
    t_ops = r["ops"] / SCALAR_OPS_PER_S * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    r["marshal_share"] = r["marshal_ms"] / r["pack_docs_columns_ms"]
    log(f"timing pack [{k_slab['Dp']}, {k_slab['N']}] "
        f"M={k_slab['planes'][0].shape[0]}: "
        + " ".join(f"{k}={v!r}" for k, v in r.items()))
    if not np.isfinite(r["ms"]):
        raise AssertionError("pack_prefix time is not finite")
    return r


# -- the clock slice ----------------------------------------------------------


def clock_matrix(seed, D, A, hi=1000, inf_frac=0.02):
    """[D, A] int32 clocks on the card: uniform in [0, hi) with INT32_INF
    entries."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    m = rng.integers(0, hi, size=(D, A)).astype(np.int32)
    m[rng.random((D, A)) < inf_frac] = 2**31 - 1
    return torch.from_numpy(m).cuda()


def hold(label, got, want) -> int:
    """Raise unless got equals want exactly; returns the max abs err."""
    import torch

    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    torch.cuda.synchronize()
    err = 0
    for g, w in pairs:
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{label}: kernel != plain")
        err = max(err, max_abs_err(g, w))
    return err


def compare_clock_kernels(ckk):
    """Phase 2 for the clock kernels: each against its plain version on
    the same card tensors; returns the max abs err per kernel."""
    import numpy as np
    import torch

    D = 131072  # the mirror's capacity at config 5
    errs = dict.fromkeys(CLOCKS, 0)
    m = clock_matrix(0, D, 64)
    for A, rows in ((64, D), (3, D), (1024, 16384)):
        a = m if A == 64 else clock_matrix(A, rows, A)
        b = clock_matrix(A + 1, rows, A)
        b[::3] = a[::3]  # EQ rows
        for op, plain in ckk._PLAIN_PAIR.items():
            for x, y in ((a, b), (b[9], a), (a, b[9])):
                e = hold(f"clock_pair op {op} A={A}", ckk.pair_cuda(op, x, y),
                         plain(x, y))
                errs["clock_pair"] = max(errs["clock_pair"], e)
    small = clock_matrix(5, 5, 3)
    for x in (m, small, -1 - m.abs(), -1 - small.abs()):
        e = hold(f"clock_union {tuple(x.shape)}", ckk.union_reduce_cuda(x),
                 ckk.union_reduce_plain(x))
        errs["clock_union"] = max(errs["clock_union"], e)
    rng = np.random.default_rng(1)
    for n in (1000, 65536):
        trip = [torch.from_numpy(rng.integers(0, hi, n).astype(np.int32)).cuda()
                for hi in (D, 64, 3000)]
        trip[0][: n // 2], trip[1][: n // 2] = 17, 5  # one hot cell
        e = hold(f"clock_scatter n={n}", ckk.scatter_max_cuda_(m.clone(), *trip),
                 ckk.scatter_max_plain_(m.clone(), *trip))
        errs["clock_scatter"] = max(errs["clock_scatter"], e)
    ties = m % 4  # mass ties: row sums from a handful of values
    ties[::97] = 2**31 - 1  # INT32_INF rows: must rank first, not wrap
    q_all = torch.full((64,), 2**31 - 1, dtype=torch.int32, device="cuda")
    q = torch.full((64,), 990, dtype=torch.int32, device="cuda")
    for x, qq in ((ties, q_all), (ties, q), (m, q)):
        for k in (1, 64, D):
            e = hold(f"clock_topk k={k}", ckk.top_k_dominated_cuda(x, qq, k),
                     ckk.top_k_dominated_plain(x, qq, k))
            errs["clock_topk"] = max(errs["clock_topk"], e)
    log(f"phase 2 clock kernels at [{D}, 64] (pairwise also at A=3, 1024): "
        f"kernels == plain (exact)")
    return errs


def config5_mirrors(PM):
    """(a mirror on the card, one on the CPU), both seeded as bench.py's
    _config5_union seeds its mirror."""
    import numpy as np

    n, A = CONFIG5["n_docs"], CONFIG5["n_actors"]
    clocks = np.random.default_rng(0).integers(1, 1000, size=(n, A),
                                                 dtype=np.int32)
    docs = [f"d{i}" for i in range(n)]
    actors = [f"a{j}" for j in range(A)]
    gpu = PM.DeviceClockMirror(capacity_docs=n, capacity_actors=A)
    cpu = PM.DeviceClockMirror(capacity_docs=n, capacity_actors=A,
                               device="cpu")
    for mirror in (gpu, cpu):
        mirror.seed_bulk(docs, actors, clocks)
    return gpu, cpu, actors


def clock_path(ck, PM):
    """The clock slice's main path, config 5 on the card: counts set to 0
    just before and read just after; every answer and the matrix held
    against the CPU mirror fed the same calls. Returns the counts."""
    import torch

    gpu, cpu, actors = config5_mirrors(PM)
    q = {a: 990 for a in actors}
    torch.cuda.synchronize()

    def drive(mirror):
        for i in range(CONFIG5["dirty"]):
            mirror.update(f"d{i}", {actors[i % len(actors)]: 2000 + i})
        return (mirror.union(), mirror.dominated(q),
                mirror.top_k_dominated(q, 64))

    for k in ck.launches:
        ck.launches[k] = 0
    t0 = time.perf_counter()
    got = drive(gpu)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ck.launches)
    log(f"phase 3c clock slice (config 5, {CONFIG5['n_docs']} x "
        f"{CONFIG5['n_actors']}): {wall:.3f} s wall (1,000 updates, union, "
        f"dominated, top-k 64), launches {counts}")
    for k, v in counts.items():
        if v != (1 if k in CLOCKS else 0):
            raise AssertionError(f"clock slice: {k} launched {v} times")
    want = drive(cpu)
    for name, g, w in zip(("union", "dominated", "top_k_dominated"), got, want):
        if g != w:
            raise AssertionError(f"config 5 {name}: card != CPU")
    union, dominated, top = got
    if len(union) != CONFIG5["n_actors"] or union[actors[-1]] < 2000:
        raise AssertionError(f"config 5 union is wrong: {union}")
    if not dominated or len(top) != 64:
        raise AssertionError("config 5: no dominated docs")
    if not torch.equal(gpu._mat().cpu(), cpu._mat()):
        raise AssertionError("config 5: the card's matrix != the CPU's")
    if gpu._docs != cpu._docs or gpu.actor_index != cpu.actor_index:
        raise AssertionError("config 5: mirror indexes differ")
    log(f"phase 3c check: union of {len(union)} actors, {len(dominated)} "
        f"dominated docs, top-64 and the {tuple(gpu._mat().shape)} matrix == "
        f"the CPU mirror")
    return counts, gpu, actors


def store_path(ck, PM, sql, stores):
    """A sqlite ClockStore with a mirror attached, on the card and on the
    CPU, through one seeded mix of writes; both query routes held
    against the CPU. Returns the counts of the card's run."""
    import random

    import torch

    n, A = STORE["n_docs"], STORE["n_actors"]
    docs = [f"doc{i}" for i in range(n)]
    actors = [f"actor{j}" for j in range(A)]
    rnd = random.Random(STORE["seed"])
    seed_rows = {d: {a: rnd.randrange(1, 500) for a in actors} for d in docs}
    ops = []
    for _ in range(STORE["steps"]):
        doc = rnd.choice(docs)
        clock = {rnd.choice(actors): rnd.randrange(1, 1000)
                 for _ in range(rnd.randrange(1, 5))}
        r = rnd.random()
        if r < 0.6:
            ops.append(("update", ("r", doc, clock)))
        elif r < 0.8:
            ops.append(("update_many",
                        ("r", {rnd.choice(docs): clock for _ in range(4)})))
        elif r < 0.95:
            ops.append(("set", ("r", doc, clock)))
        else:
            ops.append(("delete_doc", (doc,)))
    subset = docs[::4]
    queries = [{a: 700 for a in actors}, {a: 999 for a in actors[:8]}]

    def run(device):
        store = stores.ClockStore(sql.SqlDatabase(":memory:"), device=device)
        store.update_many("r", seed_rows)
        store.attach_mirror("r", PM.DeviceClockMirror(device=device))
        out = [store.union_query("r")]
        for name, args in ops:
            getattr(store, name)(*args)
        out.append(store.union_query("r"))
        out.append(store.union_query("r", subset))
        for q in queries:
            out.append(store.dominated_query("r", q))
            out.append(store.dominated_query("r", q, subset))
        out.append(store.mirror.rows())
        return out

    for k in ck.launches:
        ck.launches[k] = 0
    t0 = time.perf_counter()
    got = run(None)  # the default device: the card
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ck.launches)
    if got != run("cpu"):
        raise AssertionError("ClockStore on the card != on the CPU")
    for k in ("clock_scatter", "clock_union", "clock_pair"):
        if counts[k] < 1:
            raise AssertionError(f"ClockStore: {k} never launched")
    log(f"phase 3c ClockStore ({n} docs x {A} actors, {len(ops)} writes, "
        f"both query routes): {wall:.3f} s wall, launches {counts}; "
        f"answers == the CPU store")
    return counts


def time_clock_kernels(ckk, PM, mirror, actors):
    """Phase 4 for the clock kernels at the config-5 mirror's matrix, and
    config 5's hot query wall; {kernel: numbers}."""
    import numpy as np
    import torch

    m = mirror._mat()
    D, A = m.shape
    q = torch.full((A,), 990, dtype=torch.int32, device="cuda")
    res = {}
    # the dominated query: gte of the broadcast query row against m
    out = ckk.pair_cuda(ckk._GTE, q, m)
    res["clock_pair"] = dict(
        ms=median_ms(lambda: ckk.pair_cuda(ckk._GTE, q, m)),
        plain_ms=median_ms(lambda: ckk.gte_plain(q, m)),
        library_ms=None, bytes=nbytes(m, q, out), ops=2 * D * A,
    )
    u = ckk.union_reduce_cuda(m)
    res["clock_union"] = dict(
        ms=median_ms(lambda: ckk.union_reduce_cuda(m)),
        plain_ms=median_ms(lambda: ckk.union_reduce_plain(m)),
        library_ms=median_ms(lambda: torch.amax(m, dim=0)),
        bytes=nbytes(m, u), ops=D * A,
    )
    # the pending flush of config 5: 1,000 writes, padded to 1,024
    n = CONFIG5["dirty"]
    rng = np.random.default_rng(2)
    trip = np.zeros((3, 1024), np.int32)
    trip[0, :n] = rng.integers(0, D, n)
    trip[1, :n] = rng.integers(0, A, n)
    trip[2, :n] = 2000 + np.arange(n)
    t = torch.from_numpy(trip).cuda()
    target = m.clone()
    idx = t[0].long() * A + t[1].long()
    cells = int(torch.unique(idx).numel())
    res["clock_scatter"] = dict(
        ms=median_ms(lambda: ckk.scatter_max_cuda_(target, t[0], t[1], t[2])),
        plain_ms=median_ms(lambda: ckk.scatter_max_plain_(target, t[0], t[1],
                                                          t[2])),
        library_ms=median_ms(lambda: target.view(-1).scatter_reduce_(
            0, idx, t[2], "amax")),
        # the triples read once, each touched cell read and written once
        bytes=nbytes(t) + 8 * cells, ops=t.shape[1],
    )
    k = 64
    s, i = ckk.top_k_dominated_cuda(m, q, k)
    score = ckk.top_k_scores_plain(m, q)
    res["clock_topk"] = dict(
        ms=median_ms(lambda: ckk.top_k_dominated_cuda(m, q, k)),
        plain_ms=median_ms(lambda: ckk.top_k_dominated_plain(m, q, k)),
        library_ms=median_ms(lambda: torch.topk(score, k)),
        # the matrix and query read once, k pairs written; per element a
        # compare, a min and an add, then the selection over D scores
        bytes=nbytes(m, q, s, i), ops=3 * D * A + D * int(math.log2(D)),
    )
    # device time of the kernels alone, without the wrapper's host work
    alone = {
        "clock_pair": (lambda: ckk.pair_cuda(ckk._GTE, q, m),
                       ("clock_pair_kernel",)),
        "clock_union": (lambda: ckk.union_reduce_cuda(m),
                        ("fill_kernel", "column_max_kernel")),
        "clock_scatter": (lambda: ckk.scatter_max_cuda_(target, t[0], t[1],
                                                        t[2]),
                          ("scatter_max_kernel",)),
        "clock_topk": (lambda: ckk.top_k_dominated_cuda(m, q, k),
                       ("score_kernel", "select_kernel")),
    }
    for name, (fn, names) in alone.items():
        parts = [kernel_device_ms(fn, kn) for kn in names]
        res[name]["kernel_ms"] = None if None in parts else sum(parts)
    for r in res.values():
        t_bytes = r["bytes"] / MEM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / SCALAR_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    for name, r in res.items():
        log(f"timing {name} [{D}, {A}]: " + " ".join(
            f"{key}={v!r}" for key, v in r.items()))

    # config 5's hot query, as bench.py times it: 1,000 fresh writes land
    # and the union runs, host buffering included (fresh values each run)
    rounds = iter(range(1, 100))

    def hot_query():
        base = 3000 * next(rounds)
        for j in range(n):
            mirror.update(f"d{j}", {actors[j % A]: base + j})
        return mirror.union()

    walls = host_medians_ms({"hot_query_ms": hot_query,
                             "union_alone_ms": mirror.union})
    log(f"timing config 5 hot query (1,000 writes + union): "
        f"wall_ms={walls['hot_query_ms']!r}; union() with nothing pending "
        f"{walls['union_alone_ms']!r} ms")
    return res, walls["hot_query_ms"]


# -- the read slice -----------------------------------------------------------


class _Entry:
    """A resident entry as the serve kernels read it: its lanes."""

    def __init__(self, dev):
        self.dev = dev


def serve_inputs(synth, sk, B, N, scenario, seed):
    """(lane tensors on the card, qobj, qkey) of B batch slots: B - 1
    synthetic entries and, for B > 1, a pad slot repeating entry 0 with
    the NO_OBJ query, as stack_entries pads a batch."""
    import numpy as np
    import torch

    lanes, qobj, qkey = synth.synth_serve_lanes(B, N, scenario, seed=seed)
    t = torch.from_numpy(lanes).cuda()
    devs = list(t.unbind(0))
    if B > 1:
        devs[-1] = devs[0]
        qobj[-1], qkey[-1] = sk.NO_OBJ, -1
    return devs, qobj.astype(np.int32), qkey.astype(np.int32)


def serve_plain(sk, name, devs, qobj, qkey):
    """The plain version of one serve kernel on the card, as numpy."""
    import torch

    st = torch.stack(devs)
    qo = torch.from_numpy(qobj).cuda()
    qk = torch.from_numpy(qkey).cuda()
    out = {
        "serve_lookup": lambda: sk.map_lookup_plain(st, qo, qk),
        "serve_order": lambda: sk.seq_order_plain(st, qo),
        "serve_counts": lambda: sk.counts_plain(st, qo),
    }[name]()
    return tuple(x.cpu().numpy() for x in out)


def serve_cuda(sk, name, devs, qobj, qkey):
    return {
        "serve_lookup": lambda: sk.map_lookup_cuda(devs, qobj, qkey),
        "serve_order": lambda: sk.seq_order_cuda(devs, qobj),
        "serve_counts": lambda: sk.counts_cuda(devs, qobj),
    }[name]()


def compare_serve_kernels(synth, sk):
    """Phase 2 for the read-serving kernels; returns the max abs err per
    kernel and raises on any difference."""
    import numpy as np

    errs = dict.fromkeys(SERVE, 0)
    for B in (1, 8, 64):
        for N in (64, 1024, 65536):
            for i, scenario in enumerate(synth.SERVE_SCENARIOS):
                devs, qobj, qkey = serve_inputs(synth, sk, B, N, scenario,
                                                seed=B * N + i)
                for name in SERVE:
                    got = serve_cuda(sk, name, devs, qobj, qkey)
                    want = serve_plain(sk, name, devs, qobj, qkey)
                    for g, w in zip(got, want):
                        g = np.asarray(g).astype(np.int64)
                        w = np.asarray(w).astype(np.int64)
                        if g.shape != w.shape:
                            raise AssertionError(f"{name} B={B} N={N}: shape")
                        errs[name] = max(errs[name], int(np.abs(g - w).max()))
                        if not np.array_equal(g, w):
                            raise AssertionError(
                                f"{name} B={B} N={N} {scenario}: kernel != "
                                "plain")
    log("phase 2 serve kernels at B in {1, 8, 64} x N in {64, 1024, 65536}, "
        f"scenarios {list(synth.SERVE_SCENARIOS)}: kernels == plain (exact)")
    return errs


def hist_quantile_ms(bounds, before, after, q):
    """Quantile (ms) from the delta of two Histogram.value() snapshots:
    the upper bound of the bucket where the cumulative count crosses q
    (the +Inf tail reports the largest finite bound), as bench.py
    reads the serve.read_s histogram."""
    counts = [b - a for a, b in zip(before["buckets"], after["buckets"])]
    n = sum(counts)
    if n <= 0:
        raise AssertionError("the read histogram recorded no reads")
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= q * n:
            return bounds[min(i, len(bounds) - 1)] * 1e3
    return bounds[-1] * 1e3


def quantile_ms(samples, q):
    """Nearest-rank quantile (ms) of raw per-read latencies (s)."""
    ordered = sorted(samples)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)] * 1e3


def run_threads(readers, fn):
    import threading

    errs = []

    def body(n):
        try:
            fn(n)
        except Exception as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(n,))
               for n in range(readers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return dt


def read_path(ck, sk, root):
    """The read slice (bench.py _config_read) on the card. The corpus is
    written first (set-up); the launch counts are set to 0 just before
    the Repo opens and read just after the mixed pass. Returns (counts,
    the read mix's numbers, the dispatches captured for phase 4)."""
    import random
    from collections import Counter

    import numpy as np
    import torch

    from hypermerge_tpu_torch import native, telemetry
    from hypermerge_tpu_torch.ops.corpus import make_corpus
    from hypermerge_tpu_torch.repo import Repo
    from hypermerge_tpu_torch.serve.tier import host_read, host_value
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    # the .sig sidecars only where libsodium signs them: in pure Python
    # the signatures alone take minutes at this size, and the read path
    # never reads them (only replication verifies them)
    sign = bool(native.caps() & native.CAP_SODIUM)
    t0 = time.perf_counter()
    urls = make_corpus(root, READ["n_docs"], READ["n_ops"], sign=sign)
    log(f"phase 3d corpus: {READ['n_docs']} docs x {READ['n_ops']} ops "
        f"(signed={sign}) written in {time.perf_counter() - t0:.1f} s")

    # every serve dispatch's shape and inputs, for phase 4
    seen = {name: Counter() for name in SERVE}
    last = {}
    wrappers = {"serve_lookup": "map_lookup_cuda",
                "serve_order": "seq_order_cuda",
                "serve_counts": "counts_cuda"}
    origs = {name: getattr(sk, fn) for name, fn in wrappers.items()}

    def spy(name):
        def call(devs, *qs):
            key = (len(devs), devs[0].shape[1])
            seen[name][key] += 1
            last[(name, key)] = (list(devs), [np.array(q) for q in qs])
            return origs[name](devs, *qs)
        return call

    for name, fn in wrappers.items():
        setattr(sk, fn, spy(name))
    for k in ck.launches:
        ck.launches[k] = 0
    snap0 = telemetry.snapshot()
    repo = Repo(path=root)
    try:
        back = repo.back
        if back.serve is None:
            raise AssertionError("the repo has no serving tier")
        t0 = time.perf_counter()
        repo.open_many(urls)
        summ = back.fetch_bulk_summaries()
        t_open = time.perf_counter() - t0
        stats = dict(back.last_bulk_stats)
        if stats["fast"] != READ["n_docs"] or len(summ.doc_ids) != READ["n_docs"]:
            raise AssertionError(f"bulk open: {stats}")
        bulk = {k: ck.launches[k] for k in BULK}
        slabs = math.ceil(READ["n_docs"] / 4096)
        if any(v != slabs for v in bulk.values()):
            raise AssertionError(f"bulk kernels {bulk}, expected {slabs} each")
        log(f"phase 3d open_many + fetch_bulk_summaries: {t_open:.3f} s, "
            f"stats {stats}, launches {bulk}")

        sub, hot = urls, urls[: READ["hot"]]
        rng = random.Random(READ["seed"])
        mix = [
            hot[rng.randrange(len(hot))] if rng.random() < 0.9
            else sub[rng.randrange(len(sub))]
            for _ in range(READ["reads"])
        ]
        query = {"kind": "len", "path": []}

        def warm_hot():  # steady state: the hot set resident before timing
            for u in hot:
                repo.read(u, query)

        def read_mix(answers, lat):
            def reader(n):
                for i in range(n, len(mix), READ["readers"]):
                    t = time.perf_counter()
                    answers[i] = repo.read(mix[i], query)
                    lat[i] = time.perf_counter() - t
            return run_threads(READ["readers"], reader)

        warm_hot()
        hist = back.serve._hist
        h0 = hist.value()
        answers, lat = [None] * len(mix), [0.0] * len(mix)
        dt = read_mix(answers, lat)
        h1 = hist.value()
        docs = {u: back.docs[validate_doc_url(u)] for u in set(mix)}
        want = {u: host_read(d, query)["value"] for u, d in docs.items()}

        def check(answers):
            bad = [i for i, u in enumerate(mix) if answers[i] != want[u]]
            if bad or any(a is None for a in answers):
                raise AssertionError(
                    f"{len(bad)} len reads differ from host_read")

        check(answers)
        # the host twin on the whole mix, same threads (bench.py's baseline)
        host_lat = [0.0] * len(mix)

        def host_reader(n):
            for i in range(n, len(mix), READ["readers"]):
                t = time.perf_counter()
                if host_value(docs[mix[i]], query) != want[mix[i]]:
                    raise AssertionError("host twin read differs")
                host_lat[i] = time.perf_counter() - t

        host_dt = run_threads(READ["readers"], host_reader)
        # the same window again under torch.profiler for the device's
        # busy and idle share: residency dropped first, so it pays the
        # same installs (uploads) as the timed window
        back.serve._cache.clear()
        warm_hot()
        answers2, lat2 = [None] * len(mix), [0.0] * len(mix)
        prof = profile_dispatch(
            "read window (4,000 len reads, 8 threads)",
            lambda: read_mix(answers2, lat2))
        check(answers2)

        # the mixed pass: every read kind the kernels serve
        mixed = [{"kind": "lookup", "path": [f"k{i}"]} for i in range(10)]
        mixed += [{"kind": "text", "path": ["t"]},
                  {"kind": "len", "path": []}, {"kind": "len", "path": ["t"]}]
        n_mixed = 0
        for j, u in enumerate(hot):
            doc = docs.get(u) or back.docs[validate_doc_url(u)]
            qs = mixed + [{"kind": "index", "path": ["t"], "index": i}
                          for i in (0, j, 7 * j + 3, 10**6)]
            for q in qs:
                got = repo.read(u, q)
                if got != host_read(doc, q)["value"]:
                    raise AssertionError(f"read {q} of {u}: served != host")
                n_mixed += 1
        torch.cuda.synchronize()
        counts = dict(ck.launches)
        snap1 = telemetry.snapshot()
    finally:
        repo.close()
        for name, fn in wrappers.items():
            setattr(sk, fn, origs[name])

    def delta(key):
        return int(snap1.get(key, 0) - snap0.get(key, 0))

    dispatches = delta("serve.dispatches")
    serve_sum = sum(counts[k] for k in SERVE)
    log(f"phase 3d reads: 2 x {len(mix)} len reads (timed, profiled) + "
        f"{n_mixed} mixed, launches "
        f"{counts}, serve.dispatches {dispatches}, installs "
        f"{delta('serve.installs')}, memo_hits {delta('serve.memo_hits')}, "
        f"fallbacks {delta('serve.fallbacks')}, batches "
        f"{delta('serve.batches')}")
    for k in SERVE:
        if counts[k] == 0:
            raise AssertionError(f"kernel {k} never launched on the read path")
    if serve_sum != dispatches:
        raise AssertionError(
            f"serve launches {serve_sum} != serve.dispatches {dispatches}")
    if any(counts[k] != bulk[k] for k in BULK):
        raise AssertionError(f"bulk kernels launched during reads: {counts}")
    if delta("serve.fallbacks"):
        raise AssertionError("reads fell back to the host path")
    numbers = dict(
        qps=len(mix) / dt,
        p50_ms=quantile_ms(lat, 0.50),
        p99_ms=quantile_ms(lat, 0.99),
        p50_bucket_ms=hist_quantile_ms(hist.buckets, h0, h1, 0.50),
        p99_bucket_ms=hist_quantile_ms(hist.buckets, h0, h1, 0.99),
        host_qps=len(mix) / host_dt,
        host_p50_ms=quantile_ms(host_lat, 0.50),
        host_p99_ms=quantile_ms(host_lat, 0.99),
        profiled_qps=len(mix) / (prof["wall_ms"] / 1e3),
        device_busy_ms=prof["device_busy_ms"],
        device_idle_share=prof["device_idle_share"],
        open_s=t_open,
        batches=delta("serve.batches"),
    )
    log("phase 3d check: every answer == host_read; read mix " + " ".join(
        f"{k}={v!r}" for k, v in numbers.items()))
    shapes = {name: dict(seen[name]) for name in SERVE}
    log(f"phase 3d dispatch shapes (B, N): {shapes}")
    return counts, numbers, seen, last


def time_serve_kernels(sk, seen, last):
    """Phase 4 for the serve kernels, each at the (B, N) that the read
    slice dispatched most, on the lanes of one of those dispatches."""
    import numpy as np
    import torch

    res = {}
    kernel_names = {"serve_lookup": "lookup_kernel",
                    "serve_order": "order_kernel",
                    "serve_counts": "counts_kernel"}
    for name in SERVE:
        (B, N), n_calls = seen[name].most_common(1)[0]
        devs, qs = last[(name, (B, N))]
        qobj = qs[0]
        qkey = qs[1] if len(qs) > 1 else np.full(B, -1, np.int32)
        real = len({t.data_ptr() for t in devs})  # pad slots repeat entry 0
        lanes_read = {"serve_lookup": 3, "serve_order": 4, "serve_counts": 4}
        out_words = B * N + B if name == "serve_order" else 2 * B
        args_bytes = 8 * B * (1 + len(qs))
        r = dict(
            B=B, N=N, dispatches_at_shape=n_calls,
            ms=median_ms(lambda: serve_cuda(sk, name, devs, qobj, qkey)),
            kernel_ms=kernel_device_ms(
                lambda: serve_cuda(sk, name, devs, qobj, qkey),
                kernel_names[name]),
            plain_ms=median_ms(lambda: serve_plain(sk, name, devs, qobj, qkey)),
            library_ms=None,
            bytes=4 * lanes_read[name] * real * N + 4 * out_words + args_bytes,
            ops=(B * N * max(1, int(math.log2(N))) if name == "serve_order"
                 else lanes_read[name] * B * N),
        )
        if name == "serve_order":
            st = torch.stack(devs)
            qo = torch.from_numpy(qobj).cuda()
            mask = (st[:, 0] != 0) & (st[:, 2] == qo[:, None]) & (st[:, 3] == 1)
            key = torch.where(mask, -st[:, 1], 2**31 - 1)
            r["library_ms"] = median_ms(
                lambda: torch.sort(key, dim=1, stable=True))
        t_bytes = r["bytes"] / MEM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / SCALAR_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"timing {name} [B={B}, N={N}]: " + " ".join(
            f"{k}={v!r}" for k, v in r.items()))
        res[name] = r
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from hypermerge_tpu_torch.crdt.change import ROOT, Action, Change, Op
        from hypermerge_tpu_torch import native
        from hypermerge_tpu_torch.kernels import _build
        from hypermerge_tpu_torch.ops import clock_kernels as ckk
        from hypermerge_tpu_torch.ops import clock_mirror as PM
        from hypermerge_tpu_torch.ops import columnar, synth
        from hypermerge_tpu_torch.ops import crdt_kernels as ck
        from hypermerge_tpu_torch.ops import materialize as mat
        from hypermerge_tpu_torch.ops import pack_kernels as pk
        from hypermerge_tpu_torch.serve import kernels as sk
        from hypermerge_tpu_torch.storage import colcache, sql, stores
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules or any(
        m.startswith("hypermerge_tpu.") or m == "hypermerge_tpu"
        for m in sys.modules
    ):
        raise AssertionError("the port imported jax or the JAX package")

    # -- 1. build + device line ---------------------------------------------
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    _build.build()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
    for stem, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {stem}: {line.strip()}")
    t0 = time.perf_counter()
    lib = native.load()
    log(f"phase 1 native library: loaded={lib is not None} "
        f"caps={native.caps()} (sodium={bool(native.caps() & native.CAP_SODIUM)}"
        f", brotli={bool(native.caps() & native.CAP_BROTLI)}) in "
        f"{time.perf_counter() - t0:.1f} s; error={native.load_error!r}")

    with tempfile.TemporaryDirectory(prefix="hm-sidecars-") as root:
        # the sidecar slab's template feeds (the bench corpus' shape:
        # single writer, 1024 ops in changes of 16)
        hists = [
            synth.synth_changes(SLAB["n_ops"], n_actors=1, ops_per_change=16,
                                seed=t)
            for t in range(TEMPLATES)
        ]
        fcs = sidecar_feeds(colcache, root, hists)
        wide = value_tail(hists[3], (Action, Change, Op, ROOT))
        big = synth.synth_changes(65536, n_actors=1, ops_per_change=16,
                                  seed=99)
        fc_wide, fc_big = sidecar_feeds(colcache, f"{root}/x", [wide, big])

        # -- 2. kernels vs plain, on the card ---------------------------------
        slab = make_batch(synth, SLAB)
        multi = make_batch(synth, MULTI)
        errs = compare_kernels(ck, slab, "slab")
        for k, e in compare_kernels(ck, multi, "multi").items():
            errs[k] = max(errs[k], e)
        e_slab, k_slab = compare_pack(
            pk, columnar, slab_specs(fcs, SLAB["n_docs"]), "slab",
            n_docs=SLAB["n_docs"], n_rows=SLAB["n_ops"],
        )
        half = fcs[1].n_changes // 2
        ragged = [[(fcs[0], 0, INF)], [(fcs[1], 0, half)], [(fcs[0], 0, INF)],
                  [(fcs[2], 0, 0)], [(fc_wide, 0, INF)]]
        e_ragged, k_ragged = compare_pack(
            pk, columnar, ragged, "ragged", n_docs=8, n_rows=2048
        )
        if k_ragged["row32"] or k_ragged["Dp"] != 8:
            raise AssertionError("ragged pack: expected [8, 2048] int16 rows")
        e_big, k_big = compare_pack(
            pk, columnar, [[(fc_big, 0, INF)]], "i16ok=False"
        )
        if not k_big["row32"] or k_big["N"] != 65536:
            raise AssertionError("the 65,536-row doc did not pack int32 rows")
        errs["pack_prefix"] = max(e_slab, e_ragged, e_big)
        errs.update(compare_clock_kernels(ckk))
        errs.update(compare_serve_kernels(synth, sk))

        # -- 3. the main paths -------------------------------------------------
        main_path(ck, mat, synth, columnar, slab)
        batch, out, arrays, lean, counts = slice_path(ck, columnar, mat, fcs)
        check_slice(ck, columnar, mat, hists, batch, out, arrays, lean)
        clock_counts, mirror, actors = clock_path(ck, PM)
        store_path(ck, PM, sql, stores)
        with tempfile.TemporaryDirectory(prefix="hm-read-") as read_root:
            read_counts, read_numbers, seen, last = read_path(
                ck, sk, read_root)

        # -- 4. times ------------------------------------------------------
        timing = time_kernels(ck, slab)
        for name, r in time_kernels(ck, multi).items():
            log(f"timing multi {multi.shape} {name}: ms={r['ms']!r} "
                f"plain_ms={r['plain_ms']!r} library_ms={r['library_ms']!r} "
                f"bound_ms={r['bound_ms']!r} ({r['bound_by']})")
        timing["pack_prefix"] = time_pack(pk, columnar, fcs, k_slab)
        clock_timing, hot_ms = time_clock_kernels(ckk, PM, mirror, actors)
        timing.update(clock_timing)
        timing.update(time_serve_kernels(sk, seen, last))
        del seen, last
        del mirror
        profile_dispatch("first-slice slab dispatch",
                         lambda: ck.run_batch_full(slab))
        specs = slab_specs(fcs, SLAB["n_docs"])

        def sidecar_dispatch():
            b = columnar.pack_docs_columns(
                specs, n_docs=SLAB["n_docs"], n_rows=SLAB["n_ops"],
                device="cuda",
            )
            _o, w = ck.run_batch_full(b, lean=lean)
            mat.fetch_summary(w, b, lean=lean)

        profile_dispatch("sidecar slab (pack + dispatch + fetch)",
                         sidecar_dispatch)

    meta = {
        "pack_prefix": ("hypermerge_tpu_torch/kernels/csrc/pack_prefix.cu",
                        "hypermerge_tpu/ops/pack_kernels.py:73"),
        "materialize": ("hypermerge_tpu_torch/kernels/csrc/doc_kernel.cu",
                        "hypermerge_tpu/ops/crdt_kernels.py:100"),
        "summary_wire": ("hypermerge_tpu_torch/kernels/csrc/summary_wire.cu",
                         "hypermerge_tpu/ops/crdt_kernels.py:380"),
        "clock_pair": ("hypermerge_tpu_torch/kernels/csrc/clock_pair.cu",
                       "hypermerge_tpu/ops/clock_kernels.py:28"),
        "clock_union": ("hypermerge_tpu_torch/kernels/csrc/clock_union.cu",
                        "hypermerge_tpu/ops/clock_kernels.py:56"),
        "clock_scatter": ("hypermerge_tpu_torch/kernels/csrc/clock_scatter.cu",
                          "hypermerge_tpu/ops/clock_mirror.py:50"),
        "clock_topk": ("hypermerge_tpu_torch/kernels/csrc/clock_topk.cu",
                       "hypermerge_tpu/ops/clock_kernels.py:81"),
        "serve_lookup": ("hypermerge_tpu_torch/kernels/csrc/serve_lookup.cu",
                         "hypermerge_tpu/serve/kernels.py:87"),
        "serve_order": ("hypermerge_tpu_torch/kernels/csrc/serve_order.cu",
                        "hypermerge_tpu/serve/kernels.py:102"),
        "serve_counts": ("hypermerge_tpu_torch/kernels/csrc/serve_counts.cu",
                         "hypermerge_tpu/serve/kernels.py:120"),
    }
    # launches: each kernel's count on its slice's main path (the sidecar
    # slice, the config-5 clock slice, the read slice)
    counts.update({k: clock_counts[k] for k in CLOCKS})
    counts.update({k: read_counts[k] for k in SERVE})
    clock_shape = [131072, CONFIG5["n_actors"]]
    kernels = []
    for name, (source, replaces) in meta.items():
        r = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": (clock_shape if name in CLOCKS
                      else [r["B"], r["N"]] if name in SERVE
                      else list(slab.shape)),
        })
    log(f"config5_hot_query_ms={hot_ms!r}")
    log("read_mix " + json.dumps(read_numbers))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
