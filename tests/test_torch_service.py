"""The port's service plane (hypermerge_tpu_torch/serve/overload.py)
against the JAX package's (hypermerge_tpu/serve/overload.py), on the CPU.

- Every case of tests/test_service.py under its name, run on the port:
  the brownout ladder's hysteresis, the token buckets, the controller on
  injected signals and a fake clock, enforcement through a port `Repo`
  (forced states), the journal's ack pacing, the typed Overload across a
  port hub's IPC seam (`--device cpu`) and the `-m slow` churn soak. As
  in the reference, the module runs under the lock-order and lockset
  checkers (`lockdep_suite`, `racedep_suite` of
  tests/test_torch_analysis.py), whose teardown fails on any finding.
- Parity with the reference on numpy-seeded inputs: `BrownoutLadder`
  state traces, `TokenBucket` takes, retry-after and occupancy,
  `OverloadController` outcomes and `report()` (tenant eviction
  included), `HistogramWindow.quantile` over each package's `Histogram`,
  and an in-process `Repo(memory=True)` of each package under brownout
  and under shed (answers, refusals and `service.*` counts).
- A process that imports `serve.overload` and the frontend loads no
  torch.
- The port's one departure: its default is HM_SERVICE=0 (the reference's
  is 1), so every case here runs with HM_SERVICE=1 set, and one case
  holds that a `Repo` built without it has no controller.

Tolerance: exact.
"""

import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from hypermerge_tpu.repo import Repo as RefRepo
from hypermerge_tpu.serve import overload as ref_ov
from hypermerge_tpu.telemetry.registry import Histogram as RefHistogram
from hypermerge_tpu_torch import telemetry
from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.serve import overload as port_ov
from hypermerge_tpu_torch.serve.overload import (
    BROWNOUT,
    HEALTHY,
    SHED,
    BrownoutLadder,
    Overload,
    OverloadController,
    TokenBucket,
)
from hypermerge_tpu_torch.telemetry.registry import Histogram

from test_torch_analysis import lockdep_suite, racedep_suite

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO_ROOT,
       "HM_SERVICE": "1"}
PORT_IPC = "hypermerge_tpu_torch.net.ipc"

_lockdep = lockdep_suite()
_racedep = racedep_suite()


@pytest.fixture(autouse=True)
def service_on(monkeypatch):
    """The plane on in both packages (the port's default is off)."""
    monkeypatch.setenv("HM_SERVICE", "1")


def Repo(**kwargs):
    return _PortRepo(device="cpu", **kwargs)


def snap():
    return telemetry.snapshot()


# ---------------------------------------------------------------------------
# the ladder: hysteresis, no flapping


class TestBrownoutLadder:
    def test_escalates_after_up_ticks(self):
        lad = BrownoutLadder(hi=1.0, lo=0.5, up_ticks=3, down_ticks=2)
        assert lad.observe(1.2) == HEALTHY
        assert lad.observe(1.2) == HEALTHY
        assert lad.observe(1.2) == BROWNOUT  # third consecutive

    def test_interrupted_streak_does_not_escalate(self):
        lad = BrownoutLadder(hi=1.0, lo=0.5, up_ticks=3, down_ticks=2)
        for _ in range(10):
            lad.observe(1.2)
            lad.observe(1.2)
            assert lad.observe(0.7) == HEALTHY  # dead band resets

    def test_climbs_to_shed_and_recovers(self):
        lad = BrownoutLadder(hi=1.0, lo=0.5, up_ticks=2, down_ticks=3)
        for _ in range(2):
            lad.observe(1.5)
        assert lad.state == BROWNOUT
        for _ in range(2):
            lad.observe(1.5)
        assert lad.state == SHED
        for _ in range(4):
            lad.observe(1.5)
        assert lad.state == SHED  # already at the top rung
        for _ in range(3):
            lad.observe(0.1)
        assert lad.state == BROWNOUT  # one rung per down streak
        for _ in range(3):
            lad.observe(0.1)
        assert lad.state == HEALTHY

    def test_dead_band_holds_rung(self):
        lad = BrownoutLadder(hi=1.0, lo=0.5, up_ticks=1, down_ticks=1)
        lad.observe(1.0)
        assert lad.state == BROWNOUT
        for _ in range(50):
            assert lad.observe(0.75) == BROWNOUT

    def test_oscillation_inside_band_never_flaps(self):
        # a noisy signal bouncing lo..hi exclusive must never move
        # the ladder in EITHER direction
        lad = BrownoutLadder(hi=1.0, lo=0.5, up_ticks=2, down_ticks=2)
        lad.observe(1.0)
        lad.observe(1.0)
        assert lad.state == BROWNOUT
        for i in range(100):
            assert lad.observe(0.55 + 0.4 * (i % 2)) == BROWNOUT

    def test_watermark_order_enforced(self):
        with pytest.raises(ValueError):
            BrownoutLadder(hi=0.5, lo=0.5)


# ---------------------------------------------------------------------------
# token buckets: refill, burst, retry-after (fake clock throughout)


class TestTokenBucket:
    def test_burst_then_refill(self):
        b = TokenBucket(rate=10.0, burst=3.0, now=0.0)
        assert [b.take(0.0) for _ in range(4)] == [
            True, True, True, False,
        ]
        assert b.take(0.1)  # one token back after 100ms at 10/s
        assert not b.take(0.1)

    def test_burst_caps_refill(self):
        b = TokenBucket(rate=100.0, burst=2.0, now=0.0)
        assert b.occupancy(1000.0) == 0.0  # full, not 100k tokens
        assert b.take(1000.0) and b.take(1000.0) and not b.take(1000.0)

    def test_retry_after(self):
        b = TokenBucket(rate=2.0, burst=1.0, now=0.0)
        assert b.take(0.0)
        assert b.retry_after_s(0.0) == pytest.approx(0.5)
        assert b.retry_after_s(0.5) == pytest.approx(0.0)

    def test_occupancy(self):
        b = TokenBucket(rate=1.0, burst=4.0, now=0.0)
        b.take(0.0)
        b.take(0.0)
        assert b.occupancy(0.0) == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# the controller: injected signals drive enforcement deterministically


def _controller(monkeypatch, env=None, **kw):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    return OverloadController(**kw)


class TestController:
    def test_pressure_is_max_of_normalized_signals(self, monkeypatch):
        c = _controller(
            monkeypatch, env={"HM_SERVICE_P99_SLO_MS": "100"}
        )
        c.tick({"p99_s": 0.05, "queue_frac": 0.9, "debt_frac": 0.1})
        assert c.report()["pressure"] == pytest.approx(0.9)
        c.tick({"p99_s": 0.2, "queue_frac": 0.1, "debt_frac": 0.0})
        assert c.report()["pressure"] == pytest.approx(2.0)

    def test_signal_feed_walks_the_ladder(self, monkeypatch):
        c = _controller(
            monkeypatch,
            env={
                "HM_BROWNOUT_UP_TICKS": "2",
                "HM_BROWNOUT_DOWN_TICKS": "2",
            },
        )
        hot = {"queue_frac": 1.5}
        cold = {"queue_frac": 0.0}
        assert c.tick(hot) == HEALTHY
        assert c.tick(hot) == BROWNOUT
        assert c.tick(hot) == HEALTHY + 1  # still brownout, streak reset
        assert c.tick(hot) == SHED
        assert c.tick(cold) == SHED
        assert c.tick(cold) == BROWNOUT
        assert c.tick(cold) == BROWNOUT
        assert c.tick(cold) == HEALTHY
        assert c.report()["transitions"] == 4

    def test_healthy_admits_everything(self, monkeypatch):
        c = _controller(monkeypatch)
        assert c.admit_read("t1") is None
        assert c.refuse_overflow("t1") is None
        assert not c.defer_install()
        assert not c.deprioritize()
        assert c.ack_extra_s() == 0.0

    def test_shed_enforces_per_tenant_quota(self, monkeypatch):
        clock = [100.0]
        c = _controller(
            monkeypatch,
            env={
                "HM_QUOTA_READS_S": "10",
                "HM_QUOTA_BURST": "2",
                "HM_SERVICE_FORCE": "shed",
            },
            now=lambda: clock[0],
        )
        assert c.state() == SHED
        assert c.admit_read("a") is None
        assert c.admit_read("a") is None
        refusal = c.admit_read("a")  # burst spent
        assert refusal is not None
        info = refusal["overload"]
        assert info["state"] == "shed"
        assert info["tenant"] == "a"
        assert info["retry_after_s"] > 0
        # tenant isolation: b's bucket is untouched by a's storm
        assert c.admit_read("b") is None
        # refill: 10/s for 0.2s = 2 tokens back
        clock[0] += 0.2
        assert c.admit_read("a") is None
        rep = c.report()
        assert rep["tenants"]["a"]["refused"] == 1
        assert rep["tenants"]["a"]["admitted"] == 3
        assert rep["tenants"]["b"]["admitted"] == 1
        assert rep["shed_reads"] >= 1

    def test_brownout_defers_not_refuses(self, monkeypatch):
        c = _controller(
            monkeypatch, env={"HM_SERVICE_FORCE": "brownout"}
        )
        assert c.admit_read("a") is None  # reads still admitted
        assert c.defer_install(reads=3)
        assert c.deprioritize()
        assert c.ack_extra_s() == 0.0  # backpressure is SHED-only
        rep = c.report()
        assert rep["brownout_reads"] == 3
        assert rep["deferred_installs"] == 1

    def test_shed_stretches_acks(self, monkeypatch):
        c = _controller(
            monkeypatch,
            env={
                "HM_SERVICE_FORCE": "shed",
                "HM_SERVICE_ACK_STRETCH_MS": "40",
            },
        )
        assert c.ack_extra_s() == pytest.approx(0.04)
        assert c.report()["ack_stretch_ms"] == pytest.approx(40.0)

    def test_overflow_refusal_charges_no_token(self, monkeypatch):
        clock = [5.0]
        c = _controller(
            monkeypatch,
            env={
                "HM_QUOTA_READS_S": "10",
                "HM_QUOTA_BURST": "4",
                "HM_SERVICE_FORCE": "shed",
            },
            now=lambda: clock[0],
        )
        for _ in range(8):
            assert c.refuse_overflow("a") is not None
        # the queue was the constraint, not the quota: the bucket is
        # still full, so front-door admission proceeds
        assert c.admit_read("a") is None
        assert c.report()["tenants"]["a"]["refused"] == 8

    def test_tenant_table_is_bounded(self, monkeypatch):
        from hypermerge_tpu_torch.serve.overload import MAX_TENANTS

        c = _controller(
            monkeypatch, env={"HM_SERVICE_FORCE": "shed"}
        )
        for i in range(MAX_TENANTS + 50):
            c.admit_read(f"t{i}")
        assert len(c.report()["tenants"]) == MAX_TENANTS


# ---------------------------------------------------------------------------
# enforcement through a real repo (forced states, no load needed)


def test_front_door_refusal_raises_typed_overload(monkeypatch):
    monkeypatch.setenv("HM_SERVICE_FORCE", "shed")
    monkeypatch.setenv("HM_QUOTA_READS_S", "1")
    monkeypatch.setenv("HM_QUOTA_BURST", "0")
    repo = Repo(memory=True)
    try:
        url = repo.create({"n": 1})
        with pytest.raises(Overload) as exc:
            repo.read(url, {"kind": "lookup", "path": ["n"]})
        assert exc.value.retry_after_s > 0
        assert exc.value.state == "shed"
        # fully attributable: the refusal is on the tenant table AND
        # the counter, never silent
        svc = repo.back.telemetry_payload()["service"]
        assert svc["state_name"] == "shed"
        assert svc["tenants"]["local"]["refused"] >= 1
        assert svc["shed_reads"] >= 1
    finally:
        repo.close()


def test_front_door_refusal_cb_path(monkeypatch):
    monkeypatch.setenv("HM_SERVICE_FORCE", "shed")
    monkeypatch.setenv("HM_QUOTA_READS_S", "1")
    monkeypatch.setenv("HM_QUOTA_BURST", "0")
    repo = Repo(memory=True)
    try:
        url = repo.create({"n": 1})
        got = []
        repo.front.read(url, {"kind": "lookup", "path": ["n"]}, got.append)
        deadline = time.monotonic() + 10
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
        assert got and isinstance(got[0], dict)
        assert got[0]["_overload"]["retry_after_s"] > 0
    finally:
        repo.close()


def test_brownout_serves_cold_reads_from_host(monkeypatch):
    monkeypatch.setenv("HM_SERVICE_FORCE", "brownout")
    repo = Repo(memory=True)
    try:
        url = repo.create({"n": 77})
        # the read ANSWERS (host memo path) but the device install is
        # deferred — cold installs shed first, reads never error
        assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 77
        svc = repo.back.telemetry_payload()["service"]
        assert svc["deferred_installs"] >= 1
        assert svc["brownout_reads"] >= 1
        assert svc["shed_reads"] == 0  # brownout refuses nothing
    finally:
        repo.close()


def test_healthy_repo_never_touches_the_ladder():
    repo = Repo(memory=True)
    try:
        url = repo.create({"n": 5})
        assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 5
        svc = repo.back.telemetry_payload()["service"]
        assert svc["state_name"] == "healthy"
        assert svc["shed_reads"] == 0
        assert svc["brownout_reads"] == 0
    finally:
        repo.close()


@pytest.mark.parametrize("value", [None, "0"])
def test_port_default_runs_without_the_plane(monkeypatch, value):
    """Unset or 0, HM_SERVICE leaves the port's backend without a
    controller: no front-door check, no ack pacer, no service block."""
    if value is None:
        monkeypatch.delenv("HM_SERVICE")
    else:
        monkeypatch.setenv("HM_SERVICE", value)
    monkeypatch.setenv("HM_SERVICE_FORCE", "shed")
    monkeypatch.setenv("HM_QUOTA_BURST", "0")
    repo = Repo(memory=True)
    try:
        assert repo.back.overload is None
        url = repo.create({"n": 5})
        for _ in range(4):
            assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 5
        assert "service" not in repo.back.telemetry_payload()
    finally:
        repo.close()


# ---------------------------------------------------------------------------
# WAL ack pacing: backpressured, never dropped


def test_wal_ack_pacing_stretches_commit(tmp_path):
    from hypermerge_tpu_torch.storage.wal import WriteAheadLog

    wal = WriteAheadLog(str(tmp_path / "wal.log"), tier=2)
    try:
        paced0 = snap().get("storage.wal.paced_commits", 0)
        end = wal.append("feedA", 0, b"x" * 64)
        assert end is not None
        t0 = time.perf_counter()
        wal.commit(end)
        fast = time.perf_counter() - t0
        wal.ack_pacer = lambda: 0.05
        end = wal.append("feedA", 1, b"y" * 64)
        t0 = time.perf_counter()
        wal.commit(end)
        slow = time.perf_counter() - t0
        # lower bound only (upper bounds flake on loaded CI): the
        # paced commit waited at least most of the stretch, and the
        # write is DURABLE — backpressure, not loss
        assert slow >= 0.04
        assert slow > fast
        assert snap()["storage.wal.paced_commits"] == paced0 + 1
    finally:
        wal.close()


# ---------------------------------------------------------------------------
# typed Overload across the IPC seam (the hub front door)


def _start_hub(repo_dir, env_extra):
    """A port hub on the CPU, in a process group of its own."""
    sock = tempfile.mktemp(suffix=".sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", PORT_IPC, repo_dir, sock, "--hub",
         "--device", "cpu"],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env={**ENV, **env_extra},
        cwd=REPO_ROOT,
        start_new_session=True,
    )
    deadline = time.time() + 60
    while time.time() < deadline and not os.path.exists(sock):
        if proc.poll() is not None:
            raise AssertionError(proc.stderr.read())
        time.sleep(0.05)
    if not os.path.exists(sock):
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
        raise AssertionError("daemon socket never appeared")
    return proc, sock


def test_overload_reply_round_trips_ipc(tmp_path):
    from hypermerge_tpu_torch.net.ipc import connect_frontend

    proc, sock = _start_hub(
        str(tmp_path / "repo"),
        {
            "HM_SERVICE_FORCE": "shed",
            "HM_QUOTA_READS_S": "1",
            "HM_QUOTA_BURST": "0",
        },
    )
    try:
        front, close = connect_frontend(sock)
        try:
            url = front.create({"n": 3})
            with pytest.raises(Overload) as exc:
                front.read(url, {"kind": "lookup", "path": ["n"]},
                           timeout=30)
            assert exc.value.retry_after_s > 0
            assert exc.value.state == "shed"
            # the hub tagged the connection as the tenant
            assert (exc.value.tenant or "").startswith("conn")
            # attribution survives the seam: the daemon's Telemetry
            # payload names the tenant and the refusal
            got = []
            front.telemetry(got.append)
            deadline = time.time() + 10
            while not got and time.time() < deadline:
                time.sleep(0.05)
            svc = (got[0] or {}).get("service") or {}
            assert svc.get("state_name") == "shed"
            tenants = svc.get("tenants") or {}
            assert any(
                k.startswith("conn") and v["refused"] >= 1
                for k, v in tenants.items()
            )
        finally:
            close()
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=10)
        if os.path.exists(sock):
            os.remove(sock)


# ---------------------------------------------------------------------------
# the soak: churn DURING a read storm, acked writes survive (-m slow)


@pytest.mark.slow
def test_read_storm_churn_soak(monkeypatch):
    """FaultSwarm kill/heal mid-ramp while reader threads hammer every
    peer: the fleet reconverges bit-identically, every acknowledged
    write survives (acked_lost=0), and no read ever ERRORS — every
    outcome is a value, a None (not-yet-replicated), or a typed
    Overload."""
    import json

    from hypermerge_tpu_torch.net.discovery import DhtNode, DhtSwarm
    from hypermerge_tpu_torch.net.faults import FaultPlan, FaultSwarm

    monkeypatch.setenv("HM_GOSSIP_FANOUT", "4")
    monkeypatch.setenv("HM_ANTIENTROPY_S", "2")
    monkeypatch.setenv("HM_REDIAL_BASE_MS", "30")
    monkeypatch.setenv("HM_REDIAL_MAX_S", "0.5")
    n = 8
    boot = DhtNode()
    repos, swarms = [], []
    plans = {
        i: FaultPlan(seed=20 + i, events=[(1, "kill"), (2, "heal")])
        for i in (2, 5)
    }
    stop = threading.Event()
    errors = []
    try:
        for i in range(n):
            r = Repo(memory=True)
            sw = DhtSwarm(bootstrap=[boot.address])
            if i in plans:
                sw = FaultSwarm(sw, plans[i])
            r.set_swarm(sw)
            repos.append(r)
            swarms.append(sw)
        url = repos[0].create({"edits": []})
        handles = [r.open(url) for r in repos[1:]]
        deadline = time.monotonic() + 300
        ready = set()
        while len(ready) < len(handles):
            assert time.monotonic() < deadline, "discovery stalled"
            for i, h in enumerate(handles):
                if i not in ready:
                    try:
                        if h.value(timeout=0.01) is not None:
                            ready.add(i)
                    except TimeoutError:
                        pass
            time.sleep(0.25)

        def reader(r):
            # the ramp: back-to-back reads, no pacing — a storm
            while not stop.is_set():
                try:
                    r.read(url, {"kind": "len", "path": ["edits"]})
                except Overload:
                    pass  # typed shed is a legal outcome
                except TimeoutError:
                    pass  # churn window; not an error reply
                except Exception as e:  # anything else is a failure
                    errors.append(repr(e))
                    return

        threads = [
            threading.Thread(target=reader, args=(r,), daemon=True)
            for r in repos
            for _ in range(2)
        ]
        for t in threads:
            t.start()
        acked = []
        edits = 60
        third = edits // 3
        faulted = [swarms[i] for i in plans]
        for i in range(edits):
            repos[0].change(url, lambda d, i=i: d["edits"].append(i))
            acked.append(i)  # change() returned: the write is acked
            if i == third or i == 2 * third:
                for fs in faulted:
                    fs.tick()
        for fs in faulted:
            while fs.plan.tick < 2:
                fs.tick()
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not errors, f"reads errored during the storm: {errors[:3]}"
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if all(
                (h.value() or {}).get("edits") == acked for h in handles
            ):
                break
            time.sleep(0.5)
        else:
            behind = sum(
                1 for h in handles
                if (h.value() or {}).get("edits") != acked
            )
            raise AssertionError(
                f"acked writes lost on {behind} peers (acked_lost>0)"
            )
        blobs = {json.dumps(h.value(), sort_keys=True) for h in handles}
        blobs.add(json.dumps(repos[0].doc(url), sort_keys=True))
        assert len(blobs) == 1, "diverged under churn + read storm"
    finally:
        stop.set()
        for r in repos:
            r.close()
        for sw in swarms:
            sw.destroy()
        boot.close()


# ---------------------------------------------------------------------------
# parity with the reference on seeded inputs


def _runs(rng, n, lo, hi):
    """`n` pressures in runs of 1..15 equal values: streaks long enough
    to climb and step down the ladder, broken often enough to reset it."""
    out = []
    while len(out) < n:
        out += [float(rng.uniform(lo, hi))] * int(rng.integers(1, 16))
    return out[:n]


LADDER_SETTINGS = [(1.0, 0.5, 3, 10), (0.8, 0.2, 1, 1), (2.0, 1.5, 5, 2)]


@pytest.mark.parametrize("setting", LADDER_SETTINGS)
def test_ladder_trace_equals_reference(setting):
    hi, lo, up, down = setting
    pressures = _runs(np.random.default_rng(int(hi * 10 + up)), 1000, 0.0,
                      2.0 * hi)
    port = BrownoutLadder(hi=hi, lo=lo, up_ticks=up, down_ticks=down)
    ref = ref_ov.BrownoutLadder(hi=hi, lo=lo, up_ticks=up, down_ticks=down)
    got = [port.observe(p) for p in pressures]
    want = [ref.observe(p) for p in pressures]
    assert got == want
    assert set(got) == {HEALTHY, BROWNOUT, SHED}  # every rung visited
    assert (port._up, port._down) == (ref._up, ref._down)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_equals_reference(seed):
    rng = np.random.default_rng(seed)
    rate = float(rng.uniform(1.0, 200.0))
    burst = float(rng.integers(1, 32))
    port = TokenBucket(rate, burst, now=1.0)
    ref = ref_ov.TokenBucket(rate, burst, now=1.0)
    now = 1.0
    got, want = [], []
    for _ in range(2000):
        now += float(rng.exponential(0.15 / rate))
        n = float(rng.choice([1.0, 1.0, 1.0, 2.0, 0.5]))
        op = int(rng.integers(0, 3))
        for b, out in ((port, got), (ref, want)):
            if op == 0:
                out.append(("take", b.take(now, n)))
            elif op == 1:
                out.append(("retry", b.retry_after_s(now, n)))
            else:
                out.append(("occ", b.occupancy(now)))
    assert got == want
    assert {v for k, v in got if k == "take"} == {True, False}


def _drive_controller(mod, monkeypatch, seed):
    """A seeded (tenant, now) sequence through one package's controller
    under HM_SERVICE_FORCE=shed: every outcome, then the report."""
    monkeypatch.setenv("HM_SERVICE_FORCE", "shed")
    monkeypatch.setenv("HM_QUOTA_READS_S", "40")
    monkeypatch.setenv("HM_QUOTA_BURST", "3")
    clock = [50.0]
    c = mod.OverloadController(now=lambda: clock[0])
    rng = np.random.default_rng(seed)
    outs = []
    # more tenants than the table holds: the least recently seen rows
    # are evicted and come back with a full bucket
    tenants = [f"t{i}" for i in range(mod.MAX_TENANTS + 40)] + [None]
    for _ in range(4000):
        clock[0] += float(rng.exponential(0.002))
        t = tenants[int(rng.integers(0, len(tenants)))]
        if rng.random() < 0.8:
            outs.append(("admit", c.admit_read(t)))
        else:
            outs.append(("overflow", c.refuse_overflow(t)))
        if rng.random() < 0.05:
            outs.append(("defer", c.defer_install(int(rng.integers(1, 4)))))
    outs.append(("ack", c.ack_extra_s()))
    return outs, c.report()


@pytest.mark.parametrize("seed", [0, 7])
def test_controller_equals_reference(monkeypatch, seed):
    got, got_rep = _drive_controller(port_ov, monkeypatch, seed)
    want, want_rep = _drive_controller(ref_ov, monkeypatch, seed)
    assert got == want
    assert got_rep == want_rep
    assert len(got_rep["tenants"]) == port_ov.MAX_TENANTS
    assert got_rep["shed_reads"] > 0 and got_rep["deferred_installs"] > 0


def test_controller_ladder_equals_reference(monkeypatch):
    """Unforced: seeded signals through `tick` walk both ladders alike,
    and their reports (transitions, pressure, signals) agree."""
    monkeypatch.delenv("HM_SERVICE_FORCE", raising=False)
    monkeypatch.setenv("HM_BROWNOUT_UP_TICKS", "2")
    monkeypatch.setenv("HM_BROWNOUT_DOWN_TICKS", "4")
    rng = np.random.default_rng(3)
    port = OverloadController(now=lambda: 0.0)
    ref = ref_ov.OverloadController(now=lambda: 0.0)
    p99 = _runs(rng, 600, 0.0, 0.12)
    queue = _runs(rng, 600, 0.0, 1.4)
    debt = _runs(rng, 600, 0.0, 0.8)
    got, want = [], []
    for a, b, d in zip(p99, queue, debt):
        sig = {"p99_s": a, "queue_frac": b, "debt_frac": d}
        got.append((port.tick(dict(sig)), port.ack_extra_s(),
                    port.deprioritize()))
        want.append((ref.tick(dict(sig)), ref.ack_extra_s(),
                     ref.deprioritize()))
    assert got == want
    assert port.report() == ref.report()
    assert port.report()["transitions"] >= 4


def test_histogram_window_equals_reference():
    rng = np.random.default_rng(11)
    port_h, ref_h = Histogram("serve.read_s"), RefHistogram("serve.read_s")
    port_w = port_ov.HistogramWindow(port_h)
    ref_w = ref_ov.HistogramWindow(ref_h)
    got, want = [], []
    for w in range(200):
        n = int(rng.integers(0, 60))  # some windows see no reads
        for v in rng.lognormal(np.log(0.004), 1.5, n):
            port_h.observe(float(v))
            ref_h.observe(float(v))
        q = float(rng.choice([0.5, 0.9, 0.99]))
        got.append(port_w.quantile(q))
        want.append(ref_w.quantile(q))
    assert got == want
    assert 0.0 in got and max(got) > 1.0  # empty and overflow windows


def _repo_under(make_repo, monkeypatch, force):
    """Reads through one package's in-process repo with the ladder
    pinned: per read the answer or the refusal, then the service
    block's counts."""
    monkeypatch.setenv("HM_SERVICE_FORCE", force)
    monkeypatch.setenv("HM_QUOTA_READS_S", "0")  # no refill: timeless
    monkeypatch.setenv("HM_QUOTA_BURST", "5")
    repo = make_repo(memory=True)
    try:
        urls = [repo.create({"n": i, "t": list(range(i))}) for i in range(6)]
        out = []
        for k in range(24):
            url = urls[k % len(urls)]
            q = {"kind": "len", "path": ["t"]} if k % 3 else {
                "kind": "lookup", "path": ["n"]}
            if k % 4:
                q["tenant"] = "ab"[k % 2]
            try:
                out.append(("value", repo.read(url, q)))
            except Exception as e:
                assert type(e).__name__ == "Overload", e
                out.append(("overload", e.state, e.retry_after_s, e.tenant))
        svc = repo.back.telemetry_payload()["service"]
    finally:
        repo.close()
    return out, svc


@pytest.mark.parametrize("force", ["brownout", "shed"])
def test_repo_service_equals_reference(monkeypatch, force):
    got, got_svc = _repo_under(Repo, monkeypatch, force)
    want, want_svc = _repo_under(RefRepo, monkeypatch, force)
    assert got == want
    for k in ("state", "state_name", "transitions", "shed_reads",
              "brownout_reads", "deferred_installs", "ack_stretch_ms",
              "tenants"):
        assert got_svc[k] == want_svc[k], k
    if force == "shed":
        assert got_svc["shed_reads"] == sum(
            1 for o in got if o[0] == "overload") > 0
        # SHED sits above BROWNOUT: the admitted reads' installs wait too
        assert got_svc["deferred_installs"] > 0
    else:
        assert all(o[0] == "value" for o in got)
        assert got_svc["deferred_installs"] > 0 and got_svc["shed_reads"] == 0


def test_overload_and_frontend_import_without_torch():
    """A frontend process imports the typed refusal and the frontend with
    torch made unimportable."""
    code = (
        "import sys; sys.modules['torch'] = None\n"
        "from hypermerge_tpu_torch.serve.overload import Overload, "
        "OverloadController, overload_error\n"
        "import hypermerge_tpu_torch.frontend\n"
        "from hypermerge_tpu_torch.frontend import repo_frontend\n"
        "from hypermerge_tpu_torch.net.ipc import connect_frontend\n"
        "c = OverloadController()\n"
        "assert c.admit_read('t') is None\n"
        "e = overload_error({'retry_after_s': 0.25, 'tenant': 't'})\n"
        "assert isinstance(e, Overload) and e.retry_after_s == 0.25\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "'hypermerge_tpu.') or m.startswith('hypermerge_tpu_torch.backend')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=ENV,
                          cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
