"""The port's telemetry layer (hypermerge_tpu_torch/telemetry/), on the
CPU: every case of tests/test_telemetry.py under its own name on the
port — registry exactness under concurrency, trace-ring wraparound,
the golden Chrome-trace and Prometheus exporters, the stats dicts'
key/shape compatibility, the Telemetry IPC query, HM_TRACE env
activation, the acceptance trace (live + pipeline + net + storage in
one run) and the hot-path overhead and contention bounds, with the
reference's bounds. The command-line tools print this registry
(`tools.top`, `tools.meta --stats`).

Cross-package: the same series in a registry of each package give the
same Prometheus text, and the same span-ring tuples give the same
Chrome trace events and file. Repos and backends run on the CPU
(`device="cpu"`).

Tolerance: exact.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from hypermerge_tpu_torch import telemetry
from hypermerge_tpu_torch.telemetry import trace as ttrace
from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.telemetry.registry import MetricsRegistry

from helpers import wait_until


def Repo(**kwargs):
    return _PortRepo(device="cpu", **kwargs)


@pytest.fixture
def tracer():
    """Isolated tracing window: fresh ring, enabled, restored after."""
    was_on = ttrace.enabled()
    ttrace.reset()
    ttrace.enable()
    yield ttrace
    if not was_on:
        ttrace.disable()
    ttrace.reset()


# ---------------------------------------------------------------------------
# registry


def test_counter_concurrent_adds_exact():
    reg = MetricsRegistry()
    c = reg.counter("t.hammer")
    N, T = 20000, 8

    def worker():
        for _ in range(N):
            c.add(1)

    ts = [threading.Thread(target=worker) for _ in range(T)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # EXACT, not approximate: each thread owns its shard, merge on read
    assert c.value() == N * T


def test_float_counter_concurrent_adds_exact():
    """The t_resync_ms shape: float accumulation from many threads
    (the old dict += from reader threads could lose increments)."""
    reg = MetricsRegistry()
    c = reg.counter("t.ms")
    N, T = 5000, 6

    def worker():
        for _ in range(N):
            c.add(0.5)

    ts = [threading.Thread(target=worker) for _ in range(T)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value() == N * T * 0.5


def test_histogram_concurrent_observes_exact():
    reg = MetricsRegistry()
    h = reg.histogram("t.h", buckets=(1.0, 10.0))
    T, N = 6, 3000

    def worker(i):
        for j in range(N):
            h.observe((0.5, 5.0, 50.0)[(i + j) % 3])

    ts = [
        threading.Thread(target=worker, args=(i,)) for i in range(T)
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    v = h.value()
    assert v["count"] == T * N
    assert sum(v["buckets"]) == T * N
    total = T * N // 3
    assert v["buckets"] == [total, total, total]


def test_registry_get_or_create_and_labels():
    reg = MetricsRegistry()
    a = reg.counter("x.c", inst="1")
    b = reg.counter("x.c", inst="1")
    other = reg.counter("x.c", inst="2")
    assert a is b and a is not other
    a.add(3)
    other.add(4)
    reg.gauge("x.g").set(7)
    snap = reg.snapshot()
    # aggregated across label sets, int-ness preserved
    assert snap["x.c"] == 7 and isinstance(snap["x.c"], int)
    assert snap["x.g"] == 7


def test_retire_folds_into_closed_aggregate():
    """Open/close cycles must not grow the registry a label set per
    lifecycle — retire() folds counters into inst="closed" while the
    process totals (snapshot) stay exact."""
    reg = MetricsRegistry()
    for i in range(5):
        c = reg.counter("live.ticks", inst=str(i))
        g = reg.gauge("live.live_docs", inst=str(i))
        c.add(10)
        g.set(3)
        reg.retire(c, g)
        reg.retire(c, g)  # idempotent: no double-fold
    assert reg.snapshot()["live.ticks"] == 50
    # one aggregate series survives, not five (+ no dead gauges)
    assert len(reg.series()) == 1


def test_engine_close_retires_series():
    from hypermerge_tpu_torch import telemetry
    repo = Repo(memory=True)
    eng = repo.back.live
    if eng is None:
        repo.close()
        pytest.skip("live engine off (HM_LIVE=0)")
    labeled = {
        (m.name, m.labels)
        for m in telemetry.REGISTRY.series()
        if m in set(eng._m.values())
    }
    assert labeled  # registered while open
    repo.close()
    live_series = set(eng._m.values())
    assert not any(
        m in live_series for m in telemetry.REGISTRY.series()
    )
    # the historical dict stays readable after close (handle-based)
    assert "ticks" in eng.stats


def test_reset_zeroes_in_place_keeping_handles():
    """reset() must not blind module-level cached handles (net.tcp.*,
    pipeline.* are created once at import): series zero in place and
    keep reporting."""
    reg = MetricsRegistry()
    c = reg.counter("x.c")
    g = reg.gauge("x.g")
    c.add(5)
    g.set(3)
    reg.reset()
    assert reg.snapshot() == {"x.c": 0, "x.g": 0}
    c.add(2)  # the cached handle is still live and visible
    assert reg.snapshot()["x.c"] == 2


def test_snapshot_rounds_floats():
    reg = MetricsRegistry()
    reg.counter("x.t").add(0.1)
    reg.counter("x.t").add(0.2)
    v = reg.snapshot()["x.t"]
    assert v == round(v, 6)


# ---------------------------------------------------------------------------
# trace ring


def test_trace_ring_wraparound():
    r = ttrace._Ring(16)
    for i in range(40):
        r.add(("X", f"s{i}", "", float(i), 1.0, 0, None))
    got = r.events()
    # the LAST 16 events, oldest first
    assert [e[1] for e in got] == [f"s{i}" for i in range(24, 40)]
    assert len(r) == 16


def test_span_begin_end_tags(tracer):
    sp = telemetry.begin("t.window", cat="net", a=1)
    time.sleep(0.001)
    sp.end(b=2)
    with telemetry.span("t.block", cat="live"):
        pass
    telemetry.instant("t.point", cat="storage", k="v")
    evs = telemetry.trace_events()
    by_name = {e[1]: e for e in evs}
    ph, name, cat, ts, dur, tid, args = by_name["t.window"]
    assert ph == "X" and cat == "net"
    assert dur >= 1000  # the 1ms sleep, in µs
    assert args == {"a": 1, "b": 2}  # begin tags merged with end tags
    assert by_name["t.block"][0] == "X"
    assert by_name["t.point"][0] == "i"
    assert by_name["t.point"][6] == {"k": "v"}


def test_disabled_span_is_shared_noop():
    was_on = ttrace.enabled()
    ttrace.disable()
    try:
        # no allocation: every disabled span() IS the same singleton
        assert telemetry.span("a") is telemetry.span("b")
        assert telemetry.begin("c") is telemetry.NOOP
        n0 = telemetry.event_count()
        with telemetry.span("d"):
            pass
        telemetry.instant("e")
        assert telemetry.event_count() == n0  # nothing recorded
        # and cheap: 100k disabled spans well under any hot-path budget
        t0 = time.perf_counter()
        for _ in range(100_000):
            with telemetry.span("f"):
                pass
        assert time.perf_counter() - t0 < 1.0
    finally:
        if was_on:
            ttrace.enable()


# ---------------------------------------------------------------------------
# golden exporters


def test_chrome_trace_golden(tracer, tmp_path):
    with telemetry.span("live.tick", cat="live", docs=3):
        pass
    telemetry.instant("net.resync", cat="net", ms=5)
    path = str(tmp_path / "t.json")
    telemetry.flush_trace(path)
    doc = json.load(open(path))
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert {m["name"] for m in meta} >= {"process_name", "thread_name"}
    (x,) = [e for e in evs if e["ph"] == "X"]
    assert x["name"] == "live.tick" and x["cat"] == "live"
    assert x["args"] == {"docs": 3}
    assert {"ts", "dur", "pid", "tid"} <= set(x)
    (i,) = [e for e in evs if e["ph"] == "i"]
    assert i["name"] == "net.resync" and i["s"] == "t"


def test_prometheus_golden():
    reg = MetricsRegistry()
    reg.counter("live.ticks", inst="1").add(3)
    reg.gauge("live.live_docs").set(2)
    h = reg.histogram("live.tick_s", buckets=(0.01, 0.1))
    for v in (0.005, 0.05, 5.0):
        h.observe(v)
    from hypermerge_tpu_torch.telemetry import prometheus_text

    assert prometheus_text(reg) == (
        "# TYPE hm_live_live_docs gauge\n"
        "hm_live_live_docs 2\n"
        "# TYPE hm_live_tick_s histogram\n"
        'hm_live_tick_s_bucket{le="0.01"} 1\n'
        'hm_live_tick_s_bucket{le="0.1"} 2\n'
        'hm_live_tick_s_bucket{le="+Inf"} 3\n'
        "hm_live_tick_s_sum 5.055\n"
        "hm_live_tick_s_count 3\n"
        "# TYPE hm_live_ticks counter\n"
        'hm_live_ticks{inst="1"} 3\n'
    )


# ---------------------------------------------------------------------------
# migrated stats dicts: shape compatibility + races closed


def test_live_engine_stats_keys_unchanged():
    repo = Repo(memory=True)
    try:
        eng = repo.back.live
        if eng is None:
            pytest.skip("live engine off (HM_LIVE=0)")
        assert list(eng.stats) == [
            "adopted", "refused", "ticks", "tick_docs", "tick_changes",
            "inc_changes", "kernel_runs", "device_dispatches",
            "local_changes", "adopt_retries", "demoted", "readopted",
            "live_bytes", "live_docs",
            "t_live_append", "t_live_apply", "t_live_kernel",
            "t_live_decode", "t_live_diff",
            "t_adopt_pack", "t_adopt_kernel", "t_adopt_decode",
            "t_adopt_reach", "t_adopt_lock_free", "t_adopt_lock_held",
        ]
        # int counters stay ints (bench JSON bit-compatibility)
        assert isinstance(eng.stats["adopted"], int)
        assert isinstance(eng.stats["t_live_append"], float)
    finally:
        repo.close()


def test_replication_stats_shape_and_race_closed():
    from hypermerge_tpu_torch.net.replication import ReplicationManager

    rm = ReplicationManager(feeds=None, on_discovery=lambda *a: None)
    try:
        assert set(rm.stats) == {
            "resyncs", "t_resync_ms", "antientropy_sweeps",
            # round 19: wire frame counters exposed for the fleet
            # bench's per-peer frame-amplification measurement
            "frames_tx", "frames_rx",
        }
        # the exact race the migration closes: t_resync_ms += from
        # many reader threads at once
        T, N = 8, 2000

        def worker():
            for _ in range(N):
                rm._m["t_resync_ms"].add(1.0)

        ts = [threading.Thread(target=worker) for _ in range(T)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert rm.stats["t_resync_ms"] == T * N
    finally:
        rm.close()


def test_supervisor_stats_shape():
    from hypermerge_tpu_torch.net.resilience import SessionSupervisor

    sup = SessionSupervisor(dial=lambda a: None, deliver=lambda d, x: None)
    assert sup.stats == {"dials": 0, "reconnects": 0}
    sup.stop()


# ---------------------------------------------------------------------------
# the IPC/serve seam


def test_backend_answers_telemetry_query():
    from hypermerge_tpu_torch.backend.repo_backend import RepoBackend

    back = RepoBackend(memory=True, device="cpu")
    try:
        got = []
        back.subscribe(got.append)
        back.handle_query(7, {"type": "Telemetry"})
        wait_until(
            lambda: any(
                m.get("type") == "Reply" and m.get("queryId") == 7
                for m in got
            )
        )
        (reply,) = [m for m in got if m.get("type") == "Reply"]
        payload = reply["payload"]
        assert isinstance(payload["counters"], dict)
        assert "time" in payload and "tracing" in payload
        # JSON-serializable end to end (it rides the unix socket)
        json.dumps(payload)
    finally:
        back.close()


# ---------------------------------------------------------------------------
# HM_TRACE env activation (subprocess: import-time hook + atexit write)


def test_hm_trace_env_writes_file_at_exit(tmp_path):
    out = str(tmp_path / "trace.json")
    env = {
        **os.environ,
        "HM_TRACE": out,
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": os.path.dirname(os.path.dirname(__file__)),
    }
    code = (
        "from hypermerge_tpu_torch import telemetry\n"
        "assert telemetry.tracing_enabled()\n"
        "with telemetry.span('live.tick', cat='live'):\n"
        "    pass\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    doc = json.load(open(out))
    assert any(
        e.get("name") == "live.tick" and e.get("ph") == "X"
        for e in doc["traceEvents"]
    )


# ---------------------------------------------------------------------------
# acceptance: one run's trace carries live + pipeline + net + storage


def test_trace_spans_every_subsystem(tracer, tmp_path):
    """A bulk cold open + a TCP live-edit burst under tracing produces
    spans from the live, pipeline, net, and storage subsystems in one
    Perfetto-loadable file (the acceptance trace)."""
    from hypermerge_tpu_torch.net.tcp import TcpSwarm
    from hypermerge_tpu_torch.ops.corpus import make_corpus

    path = str(tmp_path / "repo")
    urls = make_corpus(path, 16, 16)
    repo = Repo(path=path)
    repo.open_many(urls)
    repo.back.fetch_bulk_summaries()
    repo.close()

    ra, rb = Repo(memory=True), Repo(memory=True)
    sa, sb = TcpSwarm(), TcpSwarm()
    try:
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        u = ra.create({"edits": []})
        h = rb.open(u)
        for i in range(10):
            ra.change(u, lambda d, i=i: d["edits"].append(i))
        wait_until(
            lambda: (h.value() or {}).get("edits", [])[9:] == [9],
            timeout=30,
        )
    finally:
        ra.close()
        rb.close()
        sa.destroy()
        sb.destroy()

    cats = {e[2] for e in telemetry.trace_events()}
    assert {"live", "pipeline", "net", "storage"} <= cats, cats
    out = str(tmp_path / "t.json")
    telemetry.flush_trace(out)
    doc = json.load(open(out))
    evs = doc["traceEvents"]
    assert {e.get("cat") for e in evs if e.get("ph") == "X"} >= {
        "pipeline", "storage"
    }
    # every event carries the fields Perfetto requires
    for e in evs:
        assert {"ph", "name", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert "ts" in e and "dur" in e


# ---------------------------------------------------------------------------
# overhead regression (the config2 live-edit hot path budget)


def test_counter_overhead_config2_budget():
    """Registry on vs off on the live-edit hot path, bounded delta:
    one edit on the config2 path bumps ~10 counters (tick + append +
    apply + frame counters), so the per-add cost must stay micro-scale
    or telemetry would show up in config2_edits_per_s. Pin per-add
    under 2µs (min over trials — the scheduler can't make code FASTER)
    and under 30x a raw dict bump; at the bound, telemetry costs
    <20µs/edit, ~2% of config2's ~1ms/edit."""
    reg = MetricsRegistry()
    c = reg.counter("hot.path")
    d = {"hot.path": 0}
    N = 50_000

    def t_counter():
        add = c.add
        t0 = time.perf_counter()
        for _ in range(N):
            add(1)
        return time.perf_counter() - t0

    def t_dict():
        t0 = time.perf_counter()
        for _ in range(N):
            d["hot.path"] += 1
        return time.perf_counter() - t0

    counter_s = min(t_counter() for _ in range(5))
    dict_s = min(t_dict() for _ in range(5))
    assert counter_s / N < 2e-6, f"{counter_s / N * 1e9:.0f}ns/add"
    assert counter_s < max(dict_s * 30, N * 1e-6), (
        f"counter {counter_s:.4f}s vs dict {dict_s:.4f}s"
    )


def test_counter_contention_bounded():
    """Sharded adds must not serialize: 8 threads hammering ONE
    counter finish in wall time comparable to one thread's work (a
    lock-per-add implementation would blow this bound under the GIL's
    contention pathologies)."""
    reg = MetricsRegistry()
    c = reg.counter("hot.contended")
    T, N = 8, 20_000

    def worker():
        add = c.add
        for _ in range(N):
            add(1)

    ts = [threading.Thread(target=worker) for _ in range(T)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    assert c.value() == T * N
    assert wall < 5.0, f"contended adds took {wall:.2f}s"


# ---------------------------------------------------------------------------
# cross-package: the exporters' output for the same series


def _series(reg):
    reg.counter("live.ticks", inst="1").add(3)
    reg.counter("live.ticks", inst="2").add(4)
    reg.counter("net.tcp.frames_rx").add(11)
    reg.counter("storage.wal.t_ms").add(0.25)
    reg.gauge("live.live_docs").set(2)
    reg.gauge("serve.resident_bytes").set(4096)
    h = reg.histogram("live.tick_s", buckets=(0.01, 0.1))
    for v in (0.005, 0.05, 5.0):
        h.observe(v)
    reg.histogram("serve.read_s").observe(0.002)


def test_prometheus_text_equal_reference():
    from hypermerge_tpu.telemetry import prometheus_text as ref_prom
    from hypermerge_tpu.telemetry.registry import (
        MetricsRegistry as RefRegistry,
    )

    ref, port = RefRegistry(), MetricsRegistry()
    _series(ref)
    _series(port)
    assert telemetry.prometheus_text(port) == ref_prom(ref)
    assert port.snapshot() == ref.snapshot()


def test_chrome_trace_equal_reference(tmp_path):
    from hypermerge_tpu.telemetry import export as ref_export

    from hypermerge_tpu_torch.telemetry import export

    events = [
        ("X", "live.tick", "live", 10.0, 1.5, 7, {"docs": 3}),
        ("X", "pipeline.pack", "pipeline", 11.25, 2.125, 9, None),
        ("i", "net.resync", "net", 12.0, 0.0, 7, {"ms": 5}),
        ("X", "storage.fsync", "", 13.0004, 0.0006, 11, {}),
    ]
    names = {7: "hm-live", 9: "hm-pipe-pack-0"}
    assert export.chrome_trace_events(events, names) == (
        ref_export.chrome_trace_events(events, names))
    got = export.write_chrome_trace(str(tmp_path / "port.json"), events,
                                    names)
    want = ref_export.write_chrome_trace(str(tmp_path / "ref.json"), events,
                                         names)
    assert open(got, "rb").read() == open(want, "rb").read()
