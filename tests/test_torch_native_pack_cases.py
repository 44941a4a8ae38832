"""Every case of tests/test_native_pack.py under its own name on the port
(hypermerge_tpu_torch), beside the port's own pack tests in
tests/test_torch_native_pack.py. Histories come from the port's Site
(tests/port_helpers.py).

The port's routes stand in for the reference's: its host route
(HM_DEVICE_PACK=0) is the native `hm_pack_prefix` under HM_NATIVE_PACK=1
and `pack_prefix_plain` on the CPU under HM_NATIVE_PACK=0 (the numpy
twin's place); its device route (HM_DEVICE_PACK=1, the default) is
`pack_kernels.device_pack_prefix`, on the CPU tensors `device="cpu"`
gives it, `pack_prefix_plain`. Where the reference falls back to its host
twins on a device failure, the port raises (pack_kernels.py: "Nothing
here falls back"), and its explicit host route gives the reference's
bytes. Every batch a case packs is also held against the reference
package's `pack_docs_columns` (its host route, HM_DEVICE_PACK=0) over its
own caches of the same changes; tolerance 0, dtypes included.

The twinned file's own docstring follows.

Native C++ bulk pack (hm_pack_prefix) vs the numpy twin.

The cold-open pack stage has two implementations: the C++ batch entry
point that emits the padded column planes straight from the feeds'
checkpoint planes (native/src/hm_native.cpp), and the numpy scatter in
ops/columnar.py that remains both the fallback and the correctness
reference. These tests pin them BIT-identical — same values, same wire
dtypes — over fuzzed histories covering the prefix-single fast path,
every value-kind lane, empty/padded docs, and (through the general
sorted-composite path, which the native entry must leave untouched)
multi-actor tie-break lanes."""

import random

import numpy as np
import pytest

from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu.storage import colcache as ref_colcache
from hypermerge_tpu_torch import native
from hypermerge_tpu_torch.models import Counter, Text
from hypermerge_tpu_torch.ops import columnar
from hypermerge_tpu_torch.ops.columnar import COLUMNS
from hypermerge_tpu_torch.storage.colcache import (
    FeedColumnCache,
    FileColumnStorageV2,
    MemoryColumnStorage,
)
from port_helpers import Site, env_vars, random_mutation, sync, to_reference

INF = float("inf")

needs_pack = pytest.mark.skipif(
    native.pack_lib() is None, reason="native pack layer unavailable"
)


def pack_docs_columns(specs, **kw):
    """The port's pack on the CPU."""
    return columnar.pack_docs_columns(specs, device="cpu", **kw)


def _single_writer_history(seed, n_mut=30):
    r = random.Random(seed)
    site = Site(f"actor{seed % 7:02d}")
    for _ in range(n_mut):
        random_mutation(site, r)
    # widen value coverage: floats, bools, bigints, >int16 inline ints
    site.change(lambda d: d.__setitem__("f", 3.25 + seed))
    site.change(lambda d: d.__setitem__("b", True))
    site.change(lambda d: d.__setitem__("big", 2**40 + seed))
    site.change(lambda d: d.__setitem__("wide", 2**20 + seed))
    return list(site.opset.history)


class _Cache(FeedColumnCache):
    """A port cache that remembers the history it was built from, so the
    reference can build its own cache of the same changes."""

    history = ()


def _plane_cache(tmp_path, name, history):
    """A compacted (v3 checkpoint) cache: plane-backed with plane_meta,
    i.e. exactly what a bulk cold open hands the pack."""
    path = str(tmp_path / name)
    writer = history[0].actor
    cc = FeedColumnCache(FileColumnStorageV2(path), writer=writer)
    for c in sorted(history, key=lambda c: (c.actor, c.seq)):
        cc.append_change(c)
    cc.compact()
    cc.close()
    out = _Cache(FileColumnStorageV2(path), writer=writer)
    out.history = list(history)
    out.ref_path = str(tmp_path / f"ref-{name}")
    return out


def _ref_columns(cc):
    """The reference's plane-backed columns of the same changes (its own
    compacted cache, written beside the port's)."""
    if not hasattr(cc, "_ref_fc"):
        writer = cc.history[0].actor
        rcc = ref_colcache.FeedColumnCache(
            ref_colcache.FileColumnStorageV2(cc.ref_path), writer=writer)
        for c in sorted(to_reference(cc.history),
                        key=lambda c: (c.actor, c.seq)):
            rcc.append_change(c)
        rcc.compact()
        rcc.close()
        rcc = ref_colcache.FeedColumnCache(
            ref_colcache.FileColumnStorageV2(cc.ref_path), writer=writer)
        cc._ref_fc = rcc.columns()
        cc._ref_cc = rcc
    return cc._ref_fc


def _ref_pack(ref_specs, **kw):
    """The reference's host-route pack."""
    with env_vars(HM_DEVICE_PACK="0", HM_NATIVE_PACK="1"):
        return ref_columnar.pack_docs_columns(ref_specs, **kw)


def _assert_batches_identical(a, b):
    for name in COLUMNS:
        assert a.cols[name].dtype == b.cols[name].dtype, name
        assert np.array_equal(a.cols[name], b.cols[name]), name
    assert a.psrc.dtype == b.psrc.dtype
    assert np.array_equal(a.psrc, b.psrc)
    assert np.array_equal(a.ptgt, b.ptgt)
    assert np.array_equal(a.n_ops, b.n_ops)
    assert np.array_equal(a.doc_actors, b.doc_actors)
    assert a.actors == b.actors and a.keys == b.keys
    assert a.strings == b.strings
    assert a.floats == b.floats and a.bigints == b.bigints
    if a.slot is not None or b.slot is not None:
        assert np.array_equal(a.slot, b.slot)


def _pack_both(monkeypatch, specs, counted=True, **kw):
    """(native_batch, plain_batch) of the port's host route."""
    calls = []
    orig = columnar._native_pack_prefix

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(bool(out))
        return out

    monkeypatch.setattr(columnar, "_native_pack_prefix", spy)
    monkeypatch.setenv("HM_DEVICE_PACK", "0")
    monkeypatch.setenv("HM_NATIVE_PACK", "1")
    b_native = pack_docs_columns(specs, **kw)
    monkeypatch.setenv("HM_NATIVE_PACK", "0")
    b_numpy = pack_docs_columns(specs, **kw)
    if counted:
        assert calls and all(calls), "native entry point was not used"
    return b_native, b_numpy


@needs_pack
def test_prefix_single_fuzz_bit_identical(tmp_path, monkeypatch):
    """The dominant cold-open shape: single-writer plane-backed feeds,
    whole-prefix windows — the native path must be exercised and agree
    bit-for-bit (values AND dtypes) with the plain twin."""
    caches = [
        _plane_cache(tmp_path, f"f{seed}", _single_writer_history(seed))
        for seed in range(6)
    ]
    specs = [[(cc.columns(), 0, INF)] for cc in caches]
    assert all(s[0][0].planes is not None for s in specs)
    assert all(s[0][0].plane_meta is not None for s in specs)
    b_native, b_numpy = _pack_both(monkeypatch, specs)
    _assert_batches_identical(b_native, b_numpy)
    want = _ref_pack([[(_ref_columns(cc), 0, INF)] for cc in caches])
    _assert_batches_identical(b_native, want)
    for cc in caches:
        cc.close()


@needs_pack
def test_prefix_single_padded_and_partial_windows(tmp_path, monkeypatch):
    """Doc-axis padding (slab buckets) and partial end_seq windows."""
    caches = [
        _plane_cache(tmp_path, f"p{seed}", _single_writer_history(seed))
        for seed in (11, 12)
    ]
    fcs = [cc.columns() for cc in caches]
    half = max(1, fcs[1].n_changes // 2)
    specs = [[(fcs[0], 0, INF)], [(fcs[1], 0, half)]]
    b_native, b_numpy = _pack_both(
        monkeypatch, specs, n_docs=8, n_rows=512, n_pred=128
    )
    assert b_native.n_docs == 8
    _assert_batches_identical(b_native, b_numpy)
    rfcs = [_ref_columns(cc) for cc in caches]
    want = _ref_pack([[(rfcs[0], 0, INF)], [(rfcs[1], 0, half)]],
                     n_docs=8, n_rows=512, n_pred=128)
    _assert_batches_identical(b_native, want)
    for cc in caches:
        cc.close()


@needs_pack
def test_shared_feed_and_empty_doc(tmp_path, monkeypatch):
    """Two docs sharing one feed object, plus a zero-change window."""
    cc = _plane_cache(tmp_path, "s0", _single_writer_history(3))
    fc = cc.columns()
    specs = [[(fc, 0, INF)], [(fc, 0, INF)], [(fc, 0, 0)]]
    b_native, b_numpy = _pack_both(monkeypatch, specs)
    assert int(b_native.n_ops[2]) == 0
    _assert_batches_identical(b_native, b_numpy)
    rfc = _ref_columns(cc)
    want = _ref_pack([[(rfc, 0, INF)], [(rfc, 0, INF)], [(rfc, 0, 0)]])
    _assert_batches_identical(b_native, want)
    cc.close()


def test_multi_actor_general_path_unchanged(monkeypatch):
    """Multi-actor histories take the general sorted-composite path; the
    native toggle must not change a single bit there either (the fuzz
    corpus of test_bulk_cold_start runs with the toggle's default)."""
    specs, ref_specs = [], []
    for seed in (21, 22, 23):
        r = random.Random(seed)
        sites = [Site(f"actor{i:02d}") for i in range(3)]
        for _ in range(30):
            random_mutation(r.choice(sites), r)
            if r.random() < 0.3:
                sync(*sites)
        sync(*sites)
        caches, ref_caches = {}, {}
        for c in sorted(
            sites[0].opset.history, key=lambda c: (c.actor, c.seq)
        ):
            cc = caches.setdefault(
                c.actor,
                FeedColumnCache(MemoryColumnStorage(), writer=c.actor),
            )
            cc.append_change(c)
            rcc = ref_caches.setdefault(
                c.actor,
                ref_colcache.FeedColumnCache(
                    ref_colcache.MemoryColumnStorage(), writer=c.actor),
            )
            rcc.append_change(to_reference([c])[0])
        specs.append([(cc.columns(), 0, INF) for cc in caches.values()])
        ref_specs.append([(cc.columns(), 0, INF)
                          for cc in ref_caches.values()])
    b_native, b_numpy = _pack_both(monkeypatch, specs, counted=False)
    _assert_batches_identical(b_native, b_numpy)
    _assert_batches_identical(b_native, _ref_pack(ref_specs))


@needs_pack
def test_pack_releases_gil(tmp_path, monkeypatch):
    """The hm_pack_prefix binding must DROP the GIL (ctypes.CDLL
    foreign-call semantics) — the streaming slab pipeline's pack
    worker relies on it to overlap packing with sidecar IO. Two
    checks: (1) a Python thread keeps making progress while packs run
    (GIL actually released — meaningful even on one core); (2) with
    >=2 cores, two concurrent packs on DISTINCT output buffers overlap
    in wall time."""
    import os
    import threading
    import time

    from hypermerge_tpu_torch.ops.synth import synth_changes

    assert native.pack_drops_gil()
    monkeypatch.setenv("HM_DEVICE_PACK", "0")
    monkeypatch.setenv("HM_NATIVE_PACK", "1")

    # one sizeable plane-backed feed; packs of 8 whole-prefix windows
    # of it spend their time inside the native batch entry
    history = synth_changes(
        40_000, n_actors=1, ops_per_change=64, text_frac=0.5, seed=9
    )
    cc = _plane_cache(tmp_path, "gil", history)
    fc = cc.columns()
    assert fc.planes is not None

    def one_pack():
        specs = [[(fc, 0, INF)] for _ in range(8)]
        b = pack_docs_columns(specs)
        assert b.n_rows >= 40_000

    one_pack()  # warm the interner memos / allocator

    # -- (1) GIL-progress: a spinner thread must not starve ------------
    stop = [False]
    spins = [0]

    def spinner():
        while not stop[0]:
            spins[0] += 1

    t = threading.Thread(target=spinner, daemon=True)
    t.start()
    time.sleep(0.02)  # let it settle
    spins[0] = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.4:
        one_pack()
    held_spins = spins[0]
    stop[0] = True
    t.join(5)
    # a GIL-holding native call would leave the spinner almost no
    # iterations; released, it runs freely (other core) or timeslices
    assert held_spins > 10_000, (
        f"spinner starved during native packs ({held_spins} iters): "
        "is the pack binding holding the GIL?"
    )

    # -- (2) wall-time overlap of two concurrent packs -----------------
    if (os.cpu_count() or 1) < 2:
        cc.close()
        pytest.skip("single core: wall-time overlap is unmeasurable")

    def packs(n):
        for _ in range(n):
            one_pack()

    # min serial vs min concurrent across attempts: unrelated machine
    # load inflates both, the minima are what the scheduling allows
    best_serial = best_conc = None
    for _attempt in range(5):
        t0 = time.perf_counter()
        packs(6)
        serial = time.perf_counter() - t0
        ts = [
            threading.Thread(target=packs, args=(3,), daemon=True)
            for _ in range(2)
        ]
        t0 = time.perf_counter()
        for th in ts:
            th.start()
        for th in ts:
            th.join(60)
        conc = time.perf_counter() - t0
        best_serial = min(serial, best_serial or serial)
        best_conc = min(conc, best_conc or conc)
        if best_conc < 0.9 * best_serial:
            break
    cc.close()
    ratio = best_conc / max(best_serial, 1e-9)
    if ratio >= 0.9:
        # the spinner above already PROVED the GIL drops; wall-time
        # overlap additionally needs a genuinely idle second core,
        # which a loaded CI box can't promise — don't flake the suite
        pytest.skip(
            f"GIL release proven by spinner, but no idle core to show "
            f"wall overlap (conc/serial={ratio:.2f})"
        )
    # reaching here means the overlap was actually observed (< 0.9);
    # the hard GIL enforcement is the spinner assert above


# ---------------------------------------------------------------------------
# Device pack route (ops/pack_kernels.py) — the third twin
# ---------------------------------------------------------------------------


def _pack_device(monkeypatch, specs, counted=True, native_ref=False, **kw):
    """(device_batch, host_batch). The host reference is the plain twin
    unless native_ref=True; the device route must actually have packed
    (spied)."""
    from hypermerge_tpu_torch.ops import pack_kernels

    calls = []
    orig = pack_kernels.device_pack_prefix

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(bool(out))
        return out

    monkeypatch.setattr(pack_kernels, "device_pack_prefix", spy)
    monkeypatch.setenv("HM_DEVICE_PACK", "1")
    monkeypatch.setenv("HM_NATIVE_PACK", "0")
    b_dev = pack_docs_columns(specs, **kw)
    monkeypatch.setenv("HM_DEVICE_PACK", "0")
    monkeypatch.setenv("HM_NATIVE_PACK", "1" if native_ref else "0")
    b_host = pack_docs_columns(specs, **kw)
    if counted:
        assert calls and all(calls), "device pack route was not used"
    return b_dev, b_host


def test_device_pack_fuzz_bit_identical(tmp_path, monkeypatch):
    """Three-way pin over fuzzed single-writer plane-backed feeds: the
    device route must agree bit-for-bit (values AND dtypes) with the
    plain twin — and, when the native layer is present, with the C++
    batch entry too — and with the reference's host pack."""
    caches = [
        _plane_cache(tmp_path, f"dv{seed}", _single_writer_history(seed))
        for seed in range(6)
    ]
    specs = [[(cc.columns(), 0, INF)] for cc in caches]
    b_dev, b_numpy = _pack_device(monkeypatch, specs)
    _assert_batches_identical(b_dev, b_numpy)
    if native.pack_lib() is not None:
        b_dev2, b_native = _pack_device(
            monkeypatch, specs, native_ref=True
        )
        _assert_batches_identical(b_dev2, b_native)
        _assert_batches_identical(b_dev, b_dev2)
    want = _ref_pack([[(_ref_columns(cc), 0, INF)] for cc in caches])
    _assert_batches_identical(b_dev, want)
    for cc in caches:
        cc.close()


def test_device_pack_ragged_padded_and_empty(tmp_path, monkeypatch):
    """Doc-axis padding (ragged slab tails), partial end_seq windows, a
    shared feed, and a zero-change (empty-doc) window: the gather's
    pad cells must come out exactly as the plain twin's defaults."""
    caches = [
        _plane_cache(tmp_path, f"dr{seed}", _single_writer_history(seed))
        for seed in (31, 32)
    ]
    fcs = [cc.columns() for cc in caches]
    half = max(1, fcs[1].n_changes // 2)
    specs = [
        [(fcs[0], 0, INF)],
        [(fcs[1], 0, half)],
        [(fcs[0], 0, INF)],  # shared feed object
        [(fcs[1], 0, 0)],  # empty-doc window
    ]
    b_dev, b_numpy = _pack_device(
        monkeypatch, specs, n_docs=8, n_rows=512, n_pred=128
    )
    assert b_dev.n_docs == 8
    assert int(b_dev.n_ops[3]) == 0
    _assert_batches_identical(b_dev, b_numpy)
    rfcs = [_ref_columns(cc) for cc in caches]
    want = _ref_pack([[(rfcs[0], 0, INF)], [(rfcs[1], 0, half)],
                      [(rfcs[0], 0, INF)], [(rfcs[1], 0, 0)]],
                     n_docs=8, n_rows=512, n_pred=128)
    _assert_batches_identical(b_dev, want)
    for cc in caches:
        cc.close()


def test_device_pack_rows_backed_cache(monkeypatch):
    """Pre-compaction caches carry no checkpoint planes; the marshal
    reads the materialized rows matrix instead — same bits."""
    r = random.Random(17)
    site = Site("actor03")
    for _ in range(25):
        random_mutation(site, r)
    history = list(site.opset.history)
    cc = FeedColumnCache(MemoryColumnStorage(), writer=history[0].actor)
    rcc = ref_colcache.FeedColumnCache(ref_colcache.MemoryColumnStorage(),
                                       writer=history[0].actor)
    for c in sorted(history, key=lambda c: (c.actor, c.seq)):
        cc.append_change(c)
        rcc.append_change(to_reference([c])[0])
    fc = cc.columns()
    assert fc.planes is None
    b_dev, b_numpy = _pack_device(monkeypatch, [[(fc, 0, INF)]])
    _assert_batches_identical(b_dev, b_numpy)
    _assert_batches_identical(b_dev, _ref_pack([[(rcc.columns(), 0, INF)]]))


def test_device_pack_env_order_both_ways(tmp_path, monkeypatch):
    """HM_DEVICE_PACK and HM_NATIVE_PACK are read independently at call
    time: whichever order they are set in, the device route wins the
    routing race and the bits match the host reference."""
    from hypermerge_tpu_torch.ops import pack_kernels

    cc = _plane_cache(tmp_path, "de0", _single_writer_history(5))
    specs = [[(cc.columns(), 0, INF)]]
    monkeypatch.setenv("HM_NATIVE_PACK", "0")
    monkeypatch.setenv("HM_DEVICE_PACK", "0")
    b_ref = pack_docs_columns(specs)
    calls = []
    orig = pack_kernels.device_pack_prefix
    monkeypatch.setattr(pack_kernels, "device_pack_prefix",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    for order in (
        ("HM_DEVICE_PACK", "HM_NATIVE_PACK"),
        ("HM_NATIVE_PACK", "HM_DEVICE_PACK"),
    ):
        for var in order:
            monkeypatch.setenv(var, "1")
        n = len(calls)
        b = pack_docs_columns(specs)
        assert len(calls) == n + 1, "the device route did not pack"
        _assert_batches_identical(b, b_ref)
        for var in order:
            monkeypatch.setenv(var, "0")
    _assert_batches_identical(
        b_ref, _ref_pack([[(_ref_columns(cc), 0, INF)]]))
    cc.close()


def test_device_pack_falls_back_bit_identical(tmp_path, monkeypatch):
    """The reference falls back to its host twins on any device-kernel
    failure. The port does not (ops/pack_kernels.py: a failed build,
    copy, launch or check raises out of the pack): here a failing device
    pack must raise out of `pack_docs_columns`, and the explicit host
    route (HM_DEVICE_PACK=0, native and plain) must give the same bits
    as the device route and as the reference's host pack."""
    from hypermerge_tpu_torch.ops import pack_kernels

    cc = _plane_cache(tmp_path, "dfb", _single_writer_history(8))
    specs = [[(cc.columns(), 0, INF)]]
    monkeypatch.setenv("HM_NATIVE_PACK", "0")
    monkeypatch.setenv("HM_DEVICE_PACK", "1")
    b_dev = pack_docs_columns(specs)

    def boom(*a, **k):
        raise RuntimeError("boom-device")

    with monkeypatch.context() as m:
        m.setattr(pack_kernels, "pack_prefix", boom)
        with pytest.raises(RuntimeError, match="boom-device"):
            pack_docs_columns(specs)
    monkeypatch.setenv("HM_DEVICE_PACK", "0")
    b_plain = pack_docs_columns(specs)
    _assert_batches_identical(b_plain, b_dev)
    if native.pack_lib() is not None:
        monkeypatch.setenv("HM_NATIVE_PACK", "1")
        _assert_batches_identical(pack_docs_columns(specs), b_dev)
    _assert_batches_identical(
        b_dev, _ref_pack([[(_ref_columns(cc), 0, INF)]]))
    cc.close()


@needs_pack
def test_counter_and_text_kinds_roundtrip(tmp_path, monkeypatch):
    """INC lanes (dt/ref) and text inserts through both twins, then a
    full host-kernel decode to pin semantic equality too."""
    from hypermerge_tpu_torch.crdt.frontend_state import FrontendDoc
    from hypermerge_tpu_torch.ops.host_kernel import run_batch_host
    from hypermerge_tpu_torch.ops.materialize import DecodedBatch, decode_patch
    from port_helpers import plainify

    site = Site("actor00")
    site.change(lambda d: d.__setitem__("n", Counter(2)))
    site.change(lambda d: d.increment("n", 5))
    site.change(lambda d: d.__setitem__("t", Text("hey")))
    site.change(lambda d: d["t"].insert(3, "!"))
    cc = _plane_cache(tmp_path, "c0", list(site.opset.history))
    specs = [[(cc.columns(), 0, INF)]]
    b_native, b_numpy = _pack_both(monkeypatch, specs)
    _assert_batches_identical(b_native, b_numpy)
    _assert_batches_identical(
        b_native, _ref_pack([[(_ref_columns(cc), 0, INF)]]))
    dec = DecodedBatch(b_native, run_batch_host(b_native))
    front = FrontendDoc()
    front.apply_patch(decode_patch(dec, 0))

    got = plainify(front.materialize())
    assert got["n"] == ("__counter__", 7)
    assert got["t"] == ("__text__", "hey!")
    cc.close()
