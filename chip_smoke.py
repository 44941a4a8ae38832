#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA Hopper GPU, end to end.

    python3 chip_smoke.py        # from the repository root

Phases (any failure raises, and the script exits non-zero before it
prints a result):
  1. build every CUDA kernel from kernels/csrc (one nvcc per source, all
     at once) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, on
     the same inputs, exactly (integer and bool outputs, tolerance 0):
     materialize and summary_wire at the bulk slab (4096 docs x 1024
     rows, 1 actor) and at a multi-actor batch (1024 x 512, 3 actors,
     half text); pack_prefix on the inputs the sidecar pack hands it at
     the slab, at a ragged slab (partial windows, an empty doc, a shared
     feed, values outside int16) and at one doc of 65,536 rows (int32
     row planes);
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
  4. time each kernel (CUDA events, median of 7 runs after warm-up) beside
     its plain version, its bound and, for the sort in the summary wire,
     torch.argsort; time the pack's host stages; print the kernels as one
     JSON line; profile one slab dispatch of each slice for its device
     time by kernel and the device's idle share;
  5. print {"ok": true, "device": {...}} as the last line.

It exits non-zero with no result when no GPU is present, and when the
port's package is not beside it.
"""

from __future__ import annotations

import json
import math
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


def profile_dispatch(label, fn) -> None:
    """Device time by kernel for one call of fn (a slab dispatch, host
    stages included), from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    # busy = device-side events only (kernels, copies); a CPU op such as
    # aten::copy_ also carries the device time of the work it launched
    busy_ms = sum(
        dev_us(e) for e in rows
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ) / 1e3
    log(f"profile {label}: wall_ms={wall_ms!r} device_busy_ms="
        f"{busy_ms!r} device_idle_share={1 - busy_ms / wall_ms!r}")
    for e in rows[:8]:
        if dev_us(e) > 0:
            log(f"  {dev_us(e) / 1e3!r} ms  x{e.count}  {e.key[:70]}")


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


def kernel_device_ms(fn, name: str, runs=5) -> float:
    """Mean device time of the kernels whose name contains `name`, over
    `runs` calls of fn, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = sum(
        dev_us(e) for e in prof.key_averages() if name in e.key
    )
    if total <= 0:
        raise AssertionError(f"the profiler saw no device time for {name}")
    return total / runs / 1e3


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
        from hypermerge_tpu_torch.kernels import _build
        from hypermerge_tpu_torch.ops import columnar, synth
        from hypermerge_tpu_torch.ops import crdt_kernels as ck
        from hypermerge_tpu_torch.ops import materialize as mat
        from hypermerge_tpu_torch.ops import pack_kernels as pk
        from hypermerge_tpu_torch.storage import colcache
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

        # -- 3. the main paths -------------------------------------------------
        main_path(ck, mat, synth, columnar, slab)
        batch, out, arrays, lean, counts = slice_path(ck, columnar, mat, fcs)
        check_slice(ck, columnar, mat, hists, batch, out, arrays, lean)

        # -- 4. times ------------------------------------------------------
        timing = time_kernels(ck, slab)
        for name, r in time_kernels(ck, multi).items():
            log(f"timing multi {multi.shape} {name}: ms={r['ms']!r} "
                f"plain_ms={r['plain_ms']!r} library_ms={r['library_ms']!r} "
                f"bound_ms={r['bound_ms']!r} ({r['bound_by']})")
        timing["pack_prefix"] = time_pack(pk, columnar, fcs, k_slab)
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
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": list(slab.shape),
        })
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
