"""The port's host pack route and its native marshal against the plain
pack and the JAX package.

Under HM_DEVICE_PACK=0 the port's prefix pack (ops/columnar.py
`_try_pack_prefix_single`) writes its host planes through the native
`hm_pack_prefix` (native/src/hm_native.cpp, the reference's entries),
and the dispatch then takes `host_args`; without the native library, or
under HM_NATIVE_PACK=0, or for feeds without planes, the host route is
`pack_prefix_plain` on the CPU. These tests hold, over the pack cases of
tests/test_torch_pack.py (fuzz, padded and partial windows, shared feed,
empty doc, rows-backed cache, counter and text kinds, int32 rows):

- the host route byte-identical to the port's device route on the CPU
  (`pack_prefix_plain`) and to the reference's `pack_docs_columns` under
  HM_DEVICE_PACK=0 (its native host pack where its library loads);
- the device route's marshal (`marshal_pack_inputs`) through the native
  `hm_pack_gather` byte-identical to its numpy twin, staging layout and
  dtypes included;
- a corrupt window raising the same ValueError on both routes, and a
  non-zero return of a native entry raising;
- the pack and marshal bindings dropping the GIL, after the reference's
  test_pack_releases_gil: a spinner thread keeps its pace beside long
  native calls, and loses it beside the same calls made through a
  GIL-holding handle.

Tolerance: exact.
"""

import ctypes
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu.ops.synth import synth_changes
from hypermerge_tpu_torch import native
from hypermerge_tpu_torch.ops import columnar as port_columnar
from hypermerge_tpu_torch.ops import pack_kernels as port_pk
from test_torch_colcache import INF, plane_caches
from test_torch_pack import CASES, assert_batches_identical

CPU = torch.device("cpu")
PREFIX_CASES = [c for c in CASES if c != "multi_actor_general"]


def _spied(monkeypatch, module, name):
    """Record each call of module.name (thread-safe: packs may run on
    worker threads)."""
    calls = []
    lock = threading.Lock()
    orig = getattr(module, name)

    def spy(*a, **k):
        with lock:
            calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _port_host(monkeypatch, specs, native_pack, **kw):
    monkeypatch.setenv("HM_DEVICE_PACK", "0")
    monkeypatch.setenv("HM_NATIVE_PACK", native_pack)
    return port_columnar.pack_docs_columns(specs, device="cpu", **kw)


@pytest.mark.parametrize("native_pack", ["1", "0"])
@pytest.mark.parametrize("case", PREFIX_CASES)
def test_host_route_identical(tmp_path, monkeypatch, case, native_pack):
    ref_specs, port_specs, kw, _ = CASES[case](tmp_path)
    monkeypatch.setenv("HM_DEVICE_PACK", "0")
    monkeypatch.setenv("HM_NATIVE_PACK", "1")
    want = ref_columnar.pack_docs_columns(ref_specs, **kw)
    monkeypatch.setenv("HM_DEVICE_PACK", "1")
    plain = port_columnar.pack_docs_columns(port_specs, device="cpu", **kw)
    natives = _spied(monkeypatch, port_columnar, "_native_pack_prefix")
    plains = _spied(monkeypatch, port_pk, "pack_prefix")
    got = _port_host(monkeypatch, port_specs, native_pack, **kw)
    planes = all(fc.planes is not None for spec in port_specs
                 for fc, _s, _e in spec)
    if native_pack == "1" and planes:
        assert (len(natives), len(plains)) == (1, 0)
        assert got.lanes is None and got.ranges is None
        assert isinstance(got.cols, dict)
    else:
        assert (len(natives), len(plains)) == (0, 1)
    assert_batches_identical(got, want)
    assert_batches_identical(got, plain)
    assert got.has_inc() == plain.has_inc()


def test_host_route_needs_no_device(tmp_path, monkeypatch):
    """The host route packs on the host whatever the dispatch device: a
    CUDA `device` is resolved (and so raises here) before the route, but
    the native pack itself never touches it."""
    _, port_specs, kw, _ = CASES["fuzz"](tmp_path)
    natives = _spied(monkeypatch, port_columnar, "_native_pack_prefix")
    monkeypatch.setenv("HM_DEVICE_PACK", "0")
    batch = port_columnar._try_pack_prefix_single(
        port_specs, None, None, None, torch.device("cuda"))
    assert len(natives) == 1 and batch.lanes is None


@pytest.mark.parametrize("case", PREFIX_CASES)
def test_marshal_native_equals_numpy(tmp_path, monkeypatch, case):
    _, port_specs, kw, _ = CASES[case](tmp_path)
    captured = []
    orig = port_pk.marshal_pack_inputs

    def capture(*a, **k):
        captured.append((a, k))
        return orig(*a, **k)

    monkeypatch.setattr(port_pk, "marshal_pack_inputs", capture)
    monkeypatch.setenv("HM_DEVICE_PACK", "1")
    port_columnar.pack_docs_columns(port_specs, device="cpu", **kw)
    (a, k), = captured
    gathers = _spied(monkeypatch, native.pack_lib(), "hm_pack_gather")
    monkeypatch.setenv("HM_NATIVE_PACK", "1")
    got = orig(*a, **k)
    planes = all(fc.planes is not None for fc in a[0])
    assert len(gathers) == int(planes)
    monkeypatch.setenv("HM_NATIVE_PACK", "0")
    want = orig(*a, **k)
    assert got.specs == want.specs and got.offsets == want.offsets
    for x, y in zip(got.arrays, want.arrays):  # the gaps are not written
        assert x.tobytes() == y.tobytes()


def _corrupt(fc):
    """The feed with its last change claiming 5 rows more than its planes
    hold (a corrupt sidecar)."""
    row_ends = fc.row_ends.copy()
    row_ends[-1] += 5
    return dataclasses.replace(fc, row_ends=row_ends)


@pytest.mark.parametrize("device_pack", ["1", "0"])
def test_corrupt_window_raises(tmp_path, monkeypatch, device_pack):
    _, port_specs, _, _ = CASES["fuzz"](tmp_path)
    fc = port_specs[0][0][0]
    bad = _corrupt(fc)
    assert bad.window(0, INF)[1] > bad.n_rows
    monkeypatch.setenv("HM_DEVICE_PACK", device_pack)
    natives = _spied(monkeypatch, port_columnar, "_native_pack_prefix")
    with pytest.raises(ValueError, match="past its feed's rows"):
        port_columnar.pack_docs_columns(
            [[(bad, 0, INF)], *port_specs[1:]], device="cpu")
    assert len(natives) == (1 if device_pack == "0" else 0)


class _FailingLib:
    """The native library with one entry made to return an error."""

    def __init__(self, lib, name):
        self._lib, self._name = lib, name

    def __getattr__(self, attr):
        if attr == self._name:
            return lambda *a: -1
        return getattr(self._lib, attr)


@pytest.mark.parametrize("entry", ["hm_pack_value_minmax", "hm_pack_prefix",
                                   "hm_pack_gather"])
def test_native_error_raises(tmp_path, monkeypatch, entry):
    _, port_specs, _, _ = CASES["fuzz"](tmp_path)
    lib = _FailingLib(native.pack_lib(), entry)
    monkeypatch.setattr(port_columnar, "_native_pack_lib", lambda: lib)
    monkeypatch.setattr(port_pk, "_native_pack_lib", lambda: lib)
    monkeypatch.setenv("HM_DEVICE_PACK", "1" if entry == "hm_pack_gather"
                       else "0")
    with pytest.raises(RuntimeError, match=f"{entry} failed"):
        port_columnar.pack_docs_columns(port_specs, device="cpu")


@pytest.fixture(scope="module")
def big_feed(tmp_path_factory):
    """One sizeable plane-backed feed (40,000 rows): entry calls over many
    windows of it run tens of milliseconds in C."""
    history = synth_changes(
        40_000, n_actors=1, ops_per_change=64, text_frac=0.5, seed=9
    )
    _, pc = plane_caches(tmp_path_factory.mktemp("gil"), "gil", history)
    fc = pc.columns()
    assert fc.planes is not None
    return fc


def _entry_call(lib, what, fc):
    """A long call of one native entry over windows of `fc`: the host
    pack's value fold over 1,000 windows, or the marshal's gather of 48
    windows into int32 planes (the converting loop)."""
    srcs, sdts, keep = port_columnar.feed_plane_ptrs([fc])
    ptr = port_columnar._ptr
    if what == "host_pack":
        D = 1000
        fc_idx = np.zeros(D, np.int64)
        ends = np.full(D, fc.n_rows, np.int64)
        lut, offs = np.zeros(1, np.int64), np.zeros(1, np.int64)
        lens = np.ones(4, np.int64)
        mm = np.zeros(2, np.int64)
        arrays = (fc_idx, ends, lut, offs, lens, mm)
        args = (D, ptr(fc_idx), ptr(ends), ptr(srcs), ptr(sdts),
                *[ptr(a) for a in (lut, offs) * 3], ptr(lens), ptr(mm))
        fn = lib.hm_pack_value_minmax
    else:
        D = 48
        fc_idx = np.zeros(D, np.int64)
        ends = np.full(D, fc.n_rows, np.int64)
        start = np.arange(D, dtype=np.int64) * fc.n_rows
        outs = [np.empty(D * fc.n_rows, np.int32) for _ in range(12)]
        optrs = np.asarray([ptr(o) for o in outs], np.int64)
        odts = np.full(12, 2, np.uint8)
        arrays = (fc_idx, ends, start, outs, optrs, odts)
        args = (D, ptr(fc_idx), ptr(ends), ptr(start), ptr(srcs),
                ptr(sdts), ptr(optrs), ptr(odts))
        fn = lib.hm_pack_gather
    held = (keep, srcs, sdts, arrays)  # every buffer the call reads

    def call():
        assert fn(*args) == 0 and held
    return call


def _spin_share(call, seconds=0.3, calls=2):
    """The share that a pure-Python spinner takes of the CPU time that it
    and a thread running `call` back to back spend in one window: about a
    half when the call drops the GIL (the two run at once), near zero
    when it holds it (the spinner waits for every call to return). Both
    are the threads' own CPU clocks, not the wall clock, so other
    processes loading the CPU move them alike and not the share. The
    window lasts `seconds` and until `calls` calls have returned in it: a
    worker that the loaded CPU has not scheduled yet leaves the spinner
    alone, which would read as a GIL-free call."""
    stop = [False]
    done = [0]

    def worker():
        while not stop[0]:
            call()
            done[0] += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    time.sleep(0.01)
    clock = time.pthread_getcpuclockid(t.ident)
    w0, s0, d0 = time.clock_gettime(clock), time.thread_time(), done[0]
    until = time.perf_counter() + seconds
    while time.perf_counter() < until or done[0] - d0 < calls:
        pass
    spun = time.thread_time() - s0
    worked = time.clock_gettime(clock) - w0
    stop[0] = True
    t.join(10)
    assert not t.is_alive()
    return spun / (spun + worked)


@pytest.mark.parametrize("what", ["host_pack", "marshal"])
def test_native_calls_drop_the_gil(big_feed, what):
    """The bound entries run GIL-free: a spinner takes a far larger share
    of the CPU beside back-to-back calls through `native.pack_lib()` than
    beside the same calls through a GIL-holding (PyDLL) handle of the
    library."""
    lib = native.pack_lib()
    assert native.pack_drops_gil() and native.pack_parallel_ok()
    held = native._bind(ctypes.PyDLL(lib._name))
    free_call = _entry_call(lib, what, big_feed)
    held_call = _entry_call(held, what, big_feed)
    t0 = time.perf_counter()
    free_call()
    assert time.perf_counter() - t0 > 0.005, "the call is too short to tell"
    free = _spin_share(free_call)
    gil = _spin_share(held_call)
    assert free > 2 * gil, (free, gil)
