#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA Hopper GPU, end to end.

    python3 chip_smoke.py        # from the repository root

Phases (any failure raises, and the script exits non-zero before it
prints a result):
  1. build every CUDA kernel from kernels/csrc (one nvcc per source, all
     at once) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, on
     the same inputs, at the bulk slab (4096 docs x 1024 rows, 1 actor)
     and at a multi-actor batch (1024 x 512, 3 actors, half text): every
     lane and every wire byte must be equal (integer and bool outputs, so
     the tolerance is 0);
  3. drive the slice's main path through the user entry points with the
     launch counts set to 0: the slab dispatch `run_batch_full` (full and
     lean) with its host decode, and `materialize_batch` /
     `summarize_columnar` over 64 distinct histories, checked against the
     same entries run on the CPU; every kernel must have launched;
  4. time each kernel (CUDA events, median of 7 runs after warm-up) beside
     its plain version, its bound and, for the sort in the summary wire,
     torch.argsort, and print them as one JSON line; profile one slab
     dispatch for its device time by kernel and the device's idle share;
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
import time

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores; the
# published table has no int32 rate, and these kernels do int32 work
SLAB = dict(n_docs=4096, n_ops=1024, n_actors=1)
MULTI = dict(n_docs=1024, n_ops=512, n_actors=3, text_frac=0.5)


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
    """The slice's entries as a user calls them; returns launch counts."""
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
    log(f"phase 3 main path: {time.perf_counter() - t0:.3f} s wall, "
        f"launches {counts}")
    for k, n in counts.items():
        if n == 0:
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


def profile_dispatch(ck, slab) -> None:
    """Device time by kernel for one slab dispatch (`run_batch_full`,
    host pack and upload included), from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ck.run_batch_full(slab)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0
        )

    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    # busy = device-side events only (kernels, copies); a CPU op such as
    # aten::copy_ also carries the device time of the work it launched
    busy_ms = sum(
        dev_us(e) for e in rows
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ) / 1e3
    log(f"profile slab dispatch: wall_ms={wall_ms!r} device_busy_ms="
        f"{busy_ms!r} device_idle_share={1 - busy_ms / wall_ms!r}")
    for e in rows[:8]:
        if dev_us(e) > 0:
            log(f"  {dev_us(e) / 1e3!r} ms  x{e.count}  {e.key[:70]}")


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
        from hypermerge_tpu_torch.kernels import _build
        from hypermerge_tpu_torch.ops import columnar, synth
        from hypermerge_tpu_torch.ops import crdt_kernels as ck
        from hypermerge_tpu_torch.ops import materialize as mat
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

    # -- 2. kernels vs plain, on the card -------------------------------------
    slab = make_batch(synth, SLAB)
    multi = make_batch(synth, MULTI)
    errs = compare_kernels(ck, slab, "slab")
    for k, e in compare_kernels(ck, multi, "multi").items():
        errs[k] = max(errs[k], e)

    # -- 3. the main path ----------------------------------------------------
    counts = main_path(ck, mat, synth, columnar, slab)

    # -- 4. times ----------------------------------------------------------
    timing = time_kernels(ck, slab)
    for name, r in time_kernels(ck, multi).items():
        log(f"timing multi {multi.shape} {name}: ms={r['ms']!r} "
            f"plain_ms={r['plain_ms']!r} library_ms={r['library_ms']!r} "
            f"bound_ms={r['bound_ms']!r} ({r['bound_by']})")
    profile_dispatch(ck, slab)
    meta = {
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
