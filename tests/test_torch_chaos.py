"""Fault injection and the shared-loop transport on the port
(hypermerge_tpu_torch/net/faults.py, net/aio.py, the HM_NET_ASYNC=1 paths
of net/tcp.py and HM_FAULT in net/network.py), on the CPU.

- Every case of tests/test_chaos.py and tests/test_aio.py under its own
  name on the port's modules (the soak stays marked `slow`), and the two
  anti-entropy cases of tests/test_crash.py. Repos are
  `Repo(memory=True, device="cpu")`, so the live tick runs its plain
  version. Like the reference's suites, this one runs under the
  lockdep and racedep module fixtures (`lockdep_suite`, `racedep_suite`
  of tests/test_torch_analysis.py, on the port's analysis/lockdep.py):
  every lock and guarded field the fault harness churns is
  instrumented, and the module's teardown fails on any finding. The
  reference's timeouts are kept.
- The `made` fixture closes every repo, swarm, DHT node and duplex a case
  made, repos first (a repo's network destroys its own swarm): a
  FaultSwarm's ticker, a delay line, a DHT node's UDP threads or a
  supervised session left running would outlive the case.
- Parity with the JAX package: per-direction `frame_fate` sequences of
  `FaultPlan` over 2,000 frames for seeds and (drop, dup, delay) drawn
  with numpy, with events and partitions advanced on the same ticks;
  `parse_fault_spec` on a set of specs and its rejections; a port
  `AioDuplex` against the reference's `TcpDuplex` and `AioDuplex` in both
  roles, encrypted and authenticated; a port repo on HM_NET_ASYNC=1 and a
  reference repo on HM_NET_ASYNC=0 converging to equal values.

Tolerance: exact.
"""

import os
import random
import socket as sockmod
import threading
import time

import numpy as np
import pytest

from hypermerge_tpu_torch import telemetry
from hypermerge_tpu_torch.net import aio as _aio
from hypermerge_tpu_torch.net import faults as _faults
from hypermerge_tpu_torch.net import tcp as _tcp
from hypermerge_tpu_torch.net.aio import get_loop
from hypermerge_tpu_torch.net.faults import (
    DELIVER,
    DROP,
    DUP,
    FaultPlan,
    parse_fault_spec,
)
from hypermerge_tpu_torch.net.resilience import (
    BACKOFF,
    CONNECTED,
    CONNECTING,
    STOPPED,
    Backoff,
)
from hypermerge_tpu_torch.net.swarm import ConnectionDetails
from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.utils import base58, crypto

from helpers import wait_until
from test_torch_analysis import lockdep_suite, racedep_suite
from test_torch_repo import plain

_lockdep_suite = lockdep_suite()
# the fault harness doubles as the net layer's guard-map verifier
_racedep_suite = racedep_suite()

# every port object of a case that owns threads or sockets, in the order
# the case made them
_MADE: list = []


def _tracked(cls):
    """A subclass of `cls` whose instances are recorded for `made`."""

    def __init__(self, *args, **kwargs):
        cls.__init__(self, *args, **kwargs)
        _MADE.append(self)

    return type(cls.__name__, (cls,), {"__init__": __init__,
                                       "__module__": __name__})


TcpSwarm = _tracked(_tcp.TcpSwarm)
TcpDuplex = _tracked(_tcp.TcpDuplex)
AioDuplex = _tracked(_aio.AioDuplex)
FaultSwarm = _tracked(_faults.FaultSwarm)
FaultDuplex = _tracked(_faults.FaultDuplex)


def Repo(**kwargs):
    """The port's Repo on the CPU, recorded for `made`."""
    repo = _PortRepo(device="cpu", **kwargs)
    _MADE.append(repo)
    return repo


def close_made() -> None:
    """Close what the case left open: repos first, then swarms, nodes and
    duplexes, the newest first. Closing twice is harmless."""
    made = list(_MADE)
    _MADE.clear()
    repos = [m for m in made if isinstance(m, _PortRepo)]
    for r in repos:
        if not r.back._closed:
            r.close()
    for m in reversed(made):
        if isinstance(m, _PortRepo):
            continue
        if hasattr(m, "destroy"):
            m.destroy()
        else:
            m.close()


@pytest.fixture(autouse=True)
def made():
    try:
        yield _MADE
    finally:
        close_made()


@pytest.fixture
def fast_redial(monkeypatch):
    monkeypatch.setenv("HM_REDIAL_BASE_MS", "20")
    monkeypatch.setenv("HM_REDIAL_MAX_S", "0.25")


def _free_port() -> int:
    s = sockmod.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _counter(name):
    return telemetry.snapshot().get(name, 0)


def _tcp_pair():
    """A real accepted TCP socket pair (socketpair lacks getpeername
    quirks some paths hit)."""
    srv = sockmod.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    c = sockmod.socket()
    c.connect(srv.getsockname())
    s, _ = srv.accept()
    srv.close()
    return c, s


# ---------------------------------------------------------------------------
# tests/test_chaos.py on the port


class TestBackoff:
    def test_full_jitter_bounds_and_cap(self):
        b = Backoff(base_s=0.1, max_s=1.0, rng=random.Random(7))
        ceilings = [0.1, 0.2, 0.4, 0.8, 1.0, 1.0, 1.0]
        for ceil in ceilings:
            d = b.next_delay()
            assert 0.0 <= d <= ceil, (d, ceil)
        # deep attempts stay capped (and 2**n never overflows)
        for _ in range(200):
            assert 0.0 <= b.next_delay() <= 1.0

    def test_reset_on_success(self):
        b = Backoff(base_s=0.1, max_s=10.0, rng=random.Random(1))
        for _ in range(6):
            b.next_delay()
        assert b.attempt == 6
        b.reset()
        assert b.attempt == 0
        assert b.next_delay() <= 0.1  # back to the fast first retry

    def test_jitter_is_jittered(self):
        b = Backoff(base_s=1.0, max_s=1.0, rng=random.Random(3))
        ds = {round(b.next_delay(), 6) for _ in range(16)}
        assert len(ds) > 8  # full jitter, not a fixed schedule


class TestFaultPlan:
    def _fates(self, plan, n=400):
        return [plan.frame_fate(tx=True) for _ in range(n)] + [
            plan.frame_fate(tx=False) for _ in range(n)
        ]

    def test_same_seed_same_schedule(self):
        mk = lambda: FaultPlan(
            seed=42, drop_p=0.1, dup_p=0.1, delay_ms=(1, 5)
        )
        assert self._fates(mk()) == self._fates(mk())

    def test_different_seed_different_schedule(self):
        a = FaultPlan(seed=1, drop_p=0.3, dup_p=0.3)
        b = FaultPlan(seed=2, drop_p=0.3, dup_p=0.3)
        assert self._fates(a) != self._fates(b)

    def test_events_fire_in_tick_order(self):
        plan = FaultPlan(events=[(2, "kill"), (4, "heal"), (4, "clean")])
        assert plan.advance() == []
        assert plan.advance() == ["kill"] and plan.down
        assert plan.advance() == []
        assert plan.advance() == ["heal", "clean"]
        assert not plan.down and not plan.lossy

    def test_partition_blocks_one_direction(self):
        plan = FaultPlan(events=[(1, "partition_tx"), (2, "heal")])
        plan.advance()
        assert plan.frame_fate(tx=True)[0] == DROP
        assert plan.frame_fate(tx=False)[0] == DELIVER
        plan.advance()
        assert plan.frame_fate(tx=True)[0] == DELIVER

    def test_partition_consumes_rng(self):
        """A partition window must not SHIFT the post-heal schedule:
        blocked frames still consume the RNG stream."""
        a = FaultPlan(seed=9, drop_p=0.5)
        b = FaultPlan(seed=9, drop_p=0.5, events=[(1, "partition_tx"),
                                                  (2, "heal")])
        b.advance()
        for _ in range(100):  # b's frames drop, but the stream advances
            a.frame_fate(tx=True)
            b.frame_fate(tx=True)
        b.advance()
        assert [a.frame_fate(tx=True) for _ in range(100)] == [
            b.frame_fate(tx=True) for _ in range(100)
        ]

    def test_parse_spec(self):
        plan = parse_fault_spec(
            "seed=7,drop=0.02,dup=0.01,delay=2:8,kill@30,heal@50,tick=250"
        )
        assert plan.seed == 7 and plan.drop_p == 0.02
        assert plan.dup_p == 0.01 and plan.delay_ms == (2.0, 8.0)
        assert plan.tick_ms == 250
        assert plan.events == [(30, "kill"), (50, "heal")]

    def test_parse_spec_rejects_junk(self):
        with pytest.raises(ValueError):
            parse_fault_spec("explode@3")
        with pytest.raises(ValueError):
            parse_fault_spec("warp=9")


class TestFaultDuplex:
    def test_drop_and_dup(self):
        from hypermerge_tpu_torch.net.duplex import duplex_pair

        a, b = duplex_pair()
        got = []
        b.on_message(got.append)
        fa = FaultDuplex(a, FaultPlan(drop_p=1.0))
        fa.send({"x": 1})
        assert got == [] and fa.stats["frames_dropped_injected"] == 1

        a2, b2 = duplex_pair()
        got2 = []
        b2.on_message(got2.append)
        fa2 = FaultDuplex(a2, FaultPlan(dup_p=1.0))
        fa2.send({"x": 2})
        assert got2 == [{"x": 2}, {"x": 2}]

    def test_rx_buffering_until_subscribe(self):
        from hypermerge_tpu_torch.net.duplex import duplex_pair

        a, b = duplex_pair()
        fb = FaultDuplex(b, FaultPlan())
        a.send({"early": True})
        got = []
        fb.on_message(got.append)
        assert got == [{"early": True}]

    def test_delay_never_reorders(self):
        """Injected latency rides a FIFO delay line: frames leave in
        arrival order even when a later frame draws a shorter delay —
        no real transport reorders, so the harness must not either."""
        from hypermerge_tpu_torch.net.duplex import duplex_pair

        a, b = duplex_pair()
        got = []
        b.on_message(got.append)
        fa = FaultDuplex(a, FaultPlan(seed=5, delay_ms=(1, 20)))
        n = 30
        for i in range(n):
            fa.send({"i": i})
        wait_until(lambda: len(got) == n, timeout=10)
        assert [m["i"] for m in got] == list(range(n))


class TestSupervisor:
    def test_failed_dial_enqueues_retry_not_raise(self, fast_redial):
        """The old `connect` raised OSError into the caller; now a dead
        address backs off, surfaces status, and connects as soon as a
        listener appears."""
        port = _free_port()
        sb = TcpSwarm()
        states = []
        sb.supervisor.on_status(
            lambda s, state, info: states.append(state)
        )
        session = sb.connect(("127.0.0.1", port))  # nothing listening
        wait_until(lambda: session.failures >= 2)
        assert BACKOFF in states
        sa = TcpSwarm(port=port)  # listener appears late
        got = []
        sa.on_connection(lambda d, det: got.append(d))
        wait_until(lambda: session.state == CONNECTED)
        assert session.connects == 1 and session.failures >= 2
        sb.destroy()
        sa.destroy()

    def test_redial_after_drop_and_dedup(self, fast_redial):
        """A dropped connection redials with no manual connect; closed
        duplexes leave _duplexes (the churn leak)."""
        sa, sb = TcpSwarm(), TcpSwarm()
        accepted = []
        sa.on_connection(lambda d, det: accepted.append(d))
        session = sb.connect(sa.address)
        cycles = 4
        for i in range(cycles):
            wait_until(lambda i=i: session.connects == i + 1)
            # let the LISTENER finish its inbound handshake before the
            # drop, or that accept never materializes
            wait_until(lambda i=i: len(accepted) == i + 1)
            wait_until(lambda: session.duplex and not session.duplex.closed)
            session.duplex.close()  # hard drop; supervisor redials
        wait_until(lambda: session.connects == cycles + 1)
        assert sb.supervisor.stats["reconnects"] == cycles
        # every closed duplex left the tracking lists
        wait_until(lambda: len(sb._duplexes) <= 1)
        wait_until(lambda: len(sa._duplexes) <= 1)
        wait_until(lambda: len(accepted) == cycles + 1)
        sb.destroy()
        sa.destroy()

    def test_connect_is_idempotent(self, fast_redial):
        sa, sb = TcpSwarm(), TcpSwarm()
        s1 = sb.connect(sa.address)
        s2 = sb.connect(sa.address)
        assert s1 is s2  # one session per address, kicked not duplicated
        sb.destroy()
        sa.destroy()

    def test_reconnect_false_stops_session(self, fast_redial):
        """ConnectionDetails.reconnect(False) — recorded forever, now
        finally consulted: the session stops instead of redialing."""
        sa, sb = TcpSwarm(), TcpSwarm()
        session = sb.connect(sa.address)
        wait_until(lambda: session.details is not None)
        session.details.reconnect(False)
        session.duplex.close()
        wait_until(lambda: session.state == STOPPED)
        assert session.stop_reason == "reconnect disallowed"
        time.sleep(0.2)
        assert session.connects == 1  # no further dials
        sb.destroy()
        sa.destroy()

    def test_reconnect_false_during_backoff_stops(self, fast_redial):
        """reconnect(False) set on session.details while the session is
        between connections (backoff window) must stop the next dial —
        each dial builds fresh details, so the loop head re-consults
        the previous connection's."""
        sa, sb = TcpSwarm(), TcpSwarm()
        session = sb.connect(sa.address)
        wait_until(lambda: session.details is not None)
        sa.destroy()  # server gone: session will drop into backoff
        wait_until(lambda: session.state == BACKOFF, timeout=10)
        session.details.reconnect(False)  # stop signal mid-backoff
        session.kick()
        wait_until(lambda: session.state == STOPPED)
        assert session.stop_reason == "reconnect disallowed"
        sb.destroy()

    def test_self_connection_does_not_redial_loop(self, fast_redial):
        """Network._on_connection rejects a self-connection with
        reconnect(False); the supervisor must honor it — before this
        layer existed the one-shot dial just died, but a naive redial
        loop would hammer the repo's own listener forever."""
        ra = Repo(memory=True)
        sa = TcpSwarm()
        ra.set_swarm(sa)
        session = sa.connect(sa.address)
        wait_until(lambda: session.state == STOPPED)
        assert session.stop_reason == "reconnect disallowed"
        dials = sa.supervisor.stats["dials"]
        time.sleep(0.3)
        assert sa.supervisor.stats["dials"] == dials  # loop is dead
        ra.close()


class TestBan:
    def test_banned_peer_inbound_redial_refused(self, fast_redial):
        """ban() on an inbound connection's details records the proven
        identity; the peer's next inbound redial is dropped at ACCEPT
        time (it used to be accepted unconditionally)."""
        sa = TcpSwarm(identity=os.urandom(32))
        sb = TcpSwarm(identity=os.urandom(32))
        accepted = []

        def on_conn(duplex, details):
            accepted.append((duplex, details))
            if len(accepted) == 1:
                details.ban()  # first contact: ban the peer
                duplex.close()

        sa.on_connection(on_conn)
        session = sb.connect(sa.address)
        wait_until(lambda: len(accepted) == 1)
        assert accepted[0][0].peer_identity in sa._banned_ids
        # the supervisor keeps redialing (B doesn't know it's banned);
        # every redial must die at accept, never reach the callback
        wait_until(lambda: session.connects >= 3)
        assert len(accepted) == 1
        sb.destroy()
        sa.destroy()

    def test_ban_on_outbound_stops_session(self, fast_redial):
        sa, sb = TcpSwarm(), TcpSwarm()
        session = sb.connect(sa.address)
        wait_until(lambda: session.details is not None)
        session.details.ban()  # severs the live connection itself
        wait_until(lambda: session.duplex.closed)
        wait_until(lambda: session.state == STOPPED)
        assert session.stop_reason == "peer banned"
        assert sa.address in sb._banned_addrs
        sb.destroy()
        sa.destroy()

    def test_anonymous_inbound_ban_uses_host(self, fast_redial):
        """Without identity auth the peer host is the only stable key:
        ban() on an anonymous inbound connection must still take
        effect (it recorded nothing before and the redial was accepted
        unconditionally forever)."""
        sa, sb = TcpSwarm(), TcpSwarm()  # no identities
        accepted = []

        def on_conn(duplex, details):
            accepted.append(duplex)
            if len(accepted) == 1:
                details.ban()

        sa.on_connection(on_conn)
        session = sb.connect(sa.address)
        wait_until(lambda: len(accepted) == 1)
        wait_until(lambda: accepted[0].closed)  # ban severed it
        assert "127.0.0.1" in sa._banned_hosts
        # redials die at accept (before any handshake), never reaching
        # the callback
        wait_until(lambda: session.failures + session.connects >= 3)
        assert len(accepted) == 1
        sb.destroy()
        sa.destroy()

    def test_connect_after_stopped_session_starts_fresh(
        self, fast_redial
    ):
        """connect() on an address whose session STOPPED must start a
        fresh session (the old thread exited; kick() would wake
        nobody and the caller would wait forever)."""
        sa, sb = TcpSwarm(), TcpSwarm()
        s1 = sb.connect(sa.address)
        wait_until(lambda: s1.details is not None)
        s1.details.reconnect(False)
        s1.duplex.close()
        wait_until(lambda: s1.state == STOPPED)
        s2 = sb.connect(sa.address)
        assert s2 is not s1
        wait_until(lambda: s2.state == CONNECTED)
        sb.destroy()
        sa.destroy()


class TestKeepalive:
    def test_half_open_detected_within_budget(self, monkeypatch):
        """A peer with the socket open but nothing flowing (machine
        gone, NAT timeout, stalled reader) must be shed within
        2 * HM_NET_PING_S * HM_NET_PING_MISSES — not at the 64MB
        outbox bound."""
        monkeypatch.setenv("HM_TCP_PLAINTEXT", "1")
        monkeypatch.setenv("HM_NET_PING_S", "0.2")
        monkeypatch.setenv("HM_NET_PING_MISSES", "2")
        a, b = sockmod.socketpair()
        t0 = time.monotonic()
        d = TcpDuplex(a)
        # b: socket open, never reads, never writes
        wait_until(lambda: d.closed, timeout=5)
        elapsed = time.monotonic() - t0
        assert elapsed <= 2 * 0.2 * 2 + 0.5, elapsed
        b.close()

    def test_half_open_bound_holds_at_miss_budget_one(self, monkeypatch):
        """The documented bound (2 * P * M) must hold at M=1 too: shed
        lands ON the Nth unanswered probe, by (M+1)*P."""
        monkeypatch.setenv("HM_TCP_PLAINTEXT", "1")
        monkeypatch.setenv("HM_NET_PING_S", "0.2")
        monkeypatch.setenv("HM_NET_PING_MISSES", "1")
        a, b = sockmod.socketpair()
        t0 = time.monotonic()
        d = TcpDuplex(a)
        wait_until(lambda: d.closed, timeout=5)
        assert time.monotonic() - t0 <= 2 * 0.2 * 1 + 0.5
        b.close()

    def test_healthy_idle_pair_stays_up(self, monkeypatch):
        """Ping/pong keeps an IDLE but healthy pair alive well past the
        miss budget."""
        monkeypatch.setenv("HM_TCP_PLAINTEXT", "1")
        monkeypatch.setenv("HM_NET_PING_S", "0.15")
        monkeypatch.setenv("HM_NET_PING_MISSES", "1")
        a, b = sockmod.socketpair()
        da, db = TcpDuplex(a), TcpDuplex(b)
        got = []
        db.on_message(got.append)
        time.sleep(1.2)  # ~8 ping periods, miss budget 1
        assert not da.closed and not db.closed
        assert got == []  # keepalive frames never reach subscribers
        da.send({"still": "works"})
        wait_until(lambda: got == [{"still": "works"}])
        da.close()
        db.close()

    def test_keepalive_shed_redial_resyncs(self, fast_redial, monkeypatch):
        """Integration: an established repo link goes half-open (the
        listener's inbound processing wedges, so it stops answering
        pings); BOTH ends' keepalives shed, the dialer's supervisor
        redials, and replication resyncs from cursors — counted by
        ReplicationManager.stats."""
        monkeypatch.setenv("HM_NET_PING_S", "0.25")
        monkeypatch.setenv("HM_NET_PING_MISSES", "1")
        ra, rb = Repo(memory=True), Repo(memory=True)
        sa, sb = TcpSwarm(), TcpSwarm()
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        url = ra.create({"v": 1})
        assert rb.open(url).value(timeout=10)["v"] == 1
        wait_until(lambda: len(sa._duplexes) == 1)
        wedged = sa._duplexes[0]
        # wedge the listener side's reader: takes effect on the next
        # inbound frame, after which A never pongs (nor processes) —
        # B's writes pile up unread behind an open socket, the classic
        # half-open shape
        stall = threading.Event()

        def wedge(_n):
            stall.wait(3600)
            return None  # reader sees EOF once the test releases it

        wedged._read_exact = wedge
        t0 = time.monotonic()
        # keepalive sheds the wedged duplex (A's probes go unanswered),
        # NOT the 64MB outbox bound; the dialer sees the close and
        # redials; replication renegotiates from cursors
        wait_until(lambda: wedged.closed, timeout=10)
        assert time.monotonic() - t0 < 2 * 0.25 * 1 + 5
        wait_until(
            lambda: rb.back.network.replication.stats["resyncs"] >= 1,
            timeout=10,
        )
        assert sb.supervisor.stats["reconnects"] >= 1
        # the restored link replicates in the direction the wedge had
        # silenced (B -> A)
        rb.change(url, lambda d: d.__setitem__("v", 2))
        wait_until(lambda: ra.doc(url).get("v") == 2, timeout=15)
        stall.set()
        ra.close()
        rb.close()


def _apply_script(repo_a, repo_b, url, lo, hi):
    for i in range(lo, hi):
        repo_a.change(url, lambda d, i=i: d["a"].append(i))
        repo_b.change(url, lambda d, i=i: d["b"].append(i))


def _wait_converged(ra, rb, url, want, timeout=60):
    """Converge or fail with the full churn state (which side diverged,
    peer/replication state) instead of a bare timeout."""
    try:
        wait_until(
            lambda: ra.doc(url) == want and rb.doc(url) == want,
            timeout=timeout,
        )
    except AssertionError:
        def peers(r):
            return [
                (p.id[:6], p.is_connected)
                for p in r.back.network.peers.values()
            ]

        raise AssertionError(
            f"no reconvergence: want={want}\n"
            f"  ra={ra.doc(url)}\n  rb={rb.doc(url)}\n"
            f"  peers_a={peers(ra)} peers_b={peers(rb)}\n"
            f"  repl_a={ra.back.network.replication.stats} "
            f"repl_b={rb.back.network.replication.stats}"
        )


def _loopback_twin_state(n_total):
    """The converged state an UNFAULTED pair reaches on the same edit
    script — the bit-identical oracle for the chaos runs."""
    from hypermerge_tpu_torch.net.swarm import LoopbackHub, LoopbackSwarm

    hub = LoopbackHub()
    ra, rb = Repo(memory=True), Repo(memory=True)
    ra.set_swarm(LoopbackSwarm(hub))
    rb.set_swarm(LoopbackSwarm(hub))
    url = ra.create({"a": [], "b": []})
    assert rb.open(url).value(timeout=10) is not None
    _apply_script(ra, rb, url, 0, n_total)
    want = {"a": list(range(n_total)), "b": list(range(n_total))}
    wait_until(lambda: ra.doc(url) == want and rb.doc(url) == want)
    state = ra.doc(url)
    ra.close()
    rb.close()
    return state


class TestChaosConvergence:
    @pytest.mark.parametrize("live", ["1", "0"])
    def test_kill_heal_reconverges_bit_identical(
        self, live, fast_redial, monkeypatch
    ):
        """The tier-1 deterministic chaos test: a seeded kill-and-heal
        FaultPlan severs the link mid-edit; the supervised redial (no
        manual re-connect) restores replication and both repos
        reconverge bit-identically to the loopback twin."""
        monkeypatch.setenv("HM_LIVE", live)
        plan = FaultPlan(seed=11, events=[(1, "kill"), (2, "heal")])
        ra, rb = Repo(memory=True), Repo(memory=True)
        sa = TcpSwarm()
        fb = FaultSwarm(TcpSwarm(), plan)
        ra.set_swarm(sa)
        rb.set_swarm(fb)
        fb.connect(sa.address)
        url = ra.create({"a": [], "b": []})
        assert rb.open(url).value(timeout=10) is not None

        n1, n2, n3 = 5, 5, 5
        _apply_script(ra, rb, url, 0, n1)  # healthy phase
        fb.tick()  # kill: link down, connection severed
        wait_until(lambda: plan.down)
        _apply_script(ra, rb, url, n1, n1 + n2)  # partitioned edits
        fb.tick()  # heal: the next supervised redial goes through
        _apply_script(ra, rb, url, n1 + n2, n1 + n2 + n3)

        want = _loopback_twin_state(n1 + n2 + n3)
        _wait_converged(ra, rb, url, want)
        assert rb.back.network.replication.stats["resyncs"] >= 1
        ra.close()
        rb.close()

    def test_lossy_then_kill_heal_fuzz(self, fast_redial, monkeypatch):
        """Seeded drop/dup faults during the burst, then a clean
        kill+heal cycle: the reconnect's from-scratch renegotiation
        recovers whatever the lossy window ate, and the final state is
        bit-identical to the loopback twin."""
        monkeypatch.setenv("HM_LIVE", "1")
        plan = FaultPlan(
            seed=1337,
            drop_p=0.05,
            dup_p=0.05,
            events=[(1, "clean"), (2, "kill"), (3, "heal")],
        )
        ra, rb = Repo(memory=True), Repo(memory=True)
        sa = TcpSwarm()
        fb = FaultSwarm(TcpSwarm(), plan)
        ra.set_swarm(sa)
        rb.set_swarm(fb)
        fb.connect(sa.address)
        url = ra.create({"a": [], "b": []})
        assert rb.open(url).value(timeout=10) is not None
        n = 12
        _apply_script(ra, rb, url, 0, n)  # under drop/dup faults
        assert fb.stats["frames_dropped_injected"] >= 0  # counted
        fb.tick()  # clean: loss stops
        fb.tick()  # kill
        fb.tick()  # heal -> redial renegotiates everything
        want = _loopback_twin_state(n)
        _wait_converged(ra, rb, url, want)
        ra.close()
        rb.close()


def test_replica_append_notifies_after_a_reader_decoded_its_slot():
    """The stall behind the chaos case's unsteady twin state: a
    replicated block lands in the feed before the feed calls its
    listeners, and a reader in between (the deferred sidecar sync,
    `Actor.sync_cache`) decodes its slot. The actor's listener then
    took the filled slot for its own write and sent no ActorSync, so
    the doc kept its tail unapplied until the next append or the 30 s
    anti-entropy sweep. Every replicated append must notify."""
    from hypermerge_tpu_torch.backend.actor import Actor
    from hypermerge_tpu_torch.crdt.change import ROOT, Action, Change, Op
    from hypermerge_tpu_torch.storage import block as blockmod
    from hypermerge_tpu_torch.storage.feed import Feed, MemoryFeedStorage

    from hypermerge_tpu_torch.utils import keys

    pk = keys.create().public_key
    feed = Feed(pk, MemoryFeedStorage())  # no secret key: a replica
    box = {}
    # runs before the actor's listener, as the sidecar flusher can
    feed.on_append(lambda i, d: box["actor"].sync_cache())
    events = []
    box["actor"] = actor = Actor(feed, events.append)
    for seq in (1, 2):
        change = Change(actor=pk, seq=seq, start_op=seq, deps={},
                        ops=(Op(Action.SET, ROOT, key="k", value=seq),))
        feed._append_raw(blockmod.pack_change(change.to_json()))
    appended = [e for e in events
                if e["type"] == "ActorSync" and e.get("origin") == "append"]
    assert len(appended) == 2, events
    assert [c.seq for c in actor.changes_in_window(0, 2)] == [1, 2]


class TestHalfWired:
    def test_pending_prunes_dead_connections(self):
        """Non-authority side: a connection that died without ever
        receiving ConfirmConnection must leave _pending — otherwise
        len(pending) > 1 forever and the next (only live) connection is
        never optimistically wired: the half-wired wedge the chaos fuzz
        exposed."""
        from hypermerge_tpu_torch.net.connection import PeerConnection
        from hypermerge_tpu_torch.net.duplex import duplex_pair
        from hypermerge_tpu_torch.net.peer import NetworkPeer

        ready = []
        p = NetworkPeer("idA", "idB", ready.append)  # B > A: no authority
        d1a, _d1b = duplex_pair()
        c1 = PeerConnection(d1a, True)
        p.add_connection(c1)
        assert p.connection is c1 and len(ready) == 1
        c1.close()  # dropped before any ConfirmConnection arrived
        assert p.connection is None
        d2a, _d2b = duplex_pair()
        c2 = PeerConnection(d2a, True)
        p.add_connection(c2)
        assert p.is_connected and p.connection is c2
        assert len(ready) == 2

    def test_info_timeout_reaps_half_wired_connection(self, monkeypatch):
        """A connection whose Info exchange never completes (peer's
        frame eaten by a faulty middlebox / injected fault) must be
        closed by the reaper, not idle forever behind healthy
        keepalives."""
        from hypermerge_tpu_torch.net.duplex import duplex_pair

        from hypermerge_tpu_torch.net.swarm import LoopbackHub, LoopbackSwarm

        monkeypatch.setenv("HM_INFO_TIMEOUT_S", "0.3")
        repo = Repo(memory=True)
        repo.set_swarm(LoopbackSwarm(LoopbackHub()))  # wires Network
        a, b = duplex_pair()
        b.on_message(lambda m: None)  # swallows Info, never replies
        repo.back.network._on_connection(
            a, ConnectionDetails(client=True)
        )
        wait_until(lambda: a.closed, timeout=5)
        repo.close()


class TestHmFaultEnv:
    def test_hm_fault_wraps_every_swarm(self, fast_redial, monkeypatch):
        """HM_FAULT=<spec> turns fault injection on for bench/soak runs
        with no code change: Network.set_swarm wraps the swarm and the
        ticker advances the plan on a wall clock; the system still
        converges through the scheduled kill/heal cycle."""
        monkeypatch.setenv("HM_FAULT", "seed=3,kill@4,heal@7,tick=50")
        ra, rb = Repo(memory=True), Repo(memory=True)
        sa, sb = TcpSwarm(), TcpSwarm()
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        from hypermerge_tpu_torch.net.faults import FaultSwarm

        assert isinstance(ra.back.network.swarm, FaultSwarm)
        sb.connect(sa.address)
        url = ra.create({"v": 1})
        assert rb.open(url).value(timeout=20)["v"] == 1
        time.sleep(0.5)  # ride through the kill@4/heal@7 window
        # continuous traffic (the soak shape): every edit after the
        # heal must land, whichever one raced the resync window
        for v in range(2, 6):
            ra.change(url, lambda d, v=v: d.__setitem__("v", v))
            time.sleep(0.2)
        wait_until(lambda: rb.doc(url).get("v") == 5, timeout=20)
        ra.close()
        rb.close()


@pytest.mark.slow
class TestChaosSoak:
    def test_churn_soak_many_cycles(self, fast_redial, monkeypatch):
        """Long soak: repeated lossy windows + kill/heal cycles under
        continuous concurrent edits; every cycle must reconverge."""
        monkeypatch.setenv("HM_LIVE", "1")
        events = []
        for c in range(4):
            base = c * 3 + 1
            events += [(base, "lossy"), (base + 1, "kill"),
                       (base + 2, "heal"), (base + 2, "clean")]
        plan = FaultPlan(seed=5, drop_p=0.03, dup_p=0.03, events=events)
        ra, rb = Repo(memory=True), Repo(memory=True)
        sa = TcpSwarm()
        fb = FaultSwarm(TcpSwarm(), plan)
        ra.set_swarm(sa)
        rb.set_swarm(fb)
        fb.connect(sa.address)
        url = ra.create({"a": [], "b": []})
        assert rb.open(url).value(timeout=10) is not None
        n = 0
        for _cycle in range(4):
            _apply_script(ra, rb, url, n, n + 8)
            n += 8
            for _ in range(3):
                fb.tick()
                time.sleep(0.3)
        want = _loopback_twin_state(n)
        _wait_converged(ra, rb, url, want, timeout=90)
        assert rb.back.network.replication.stats["resyncs"] >= 2
        ra.close()
        rb.close()


# ---------------------------------------------------------------------------
# tests/test_aio.py on the port


class TestAioDuplex:
    def test_roundtrip_both_directions(self):
        a, b = sockmod.socketpair()
        da = AioDuplex(a, is_client=True)
        db = AioDuplex(b, is_client=False)
        got_a, got_b = [], []
        da.on_message(got_a.append)
        db.on_message(got_b.append)
        da.send({"n": 1})
        da.send({"n": 2})
        db.send({"r": 3})
        wait_until(lambda: got_b == [{"n": 1}, {"n": 2}])
        wait_until(lambda: got_a == [{"r": 3}])
        da.close()
        wait_until(lambda: db.closed)

    def test_rx_buffers_until_subscribe(self):
        """utils.queue.Queue contract: frames arriving before the
        subscriber registers are buffered, then delivered in order."""
        a, b = sockmod.socketpair()
        da = AioDuplex(a, is_client=True)
        db = AioDuplex(b, is_client=False)
        for i in range(5):
            da.send({"i": i})
        time.sleep(0.3)  # frames land before anyone subscribes
        got = []
        db.on_message(got.append)
        wait_until(lambda: got == [{"i": i} for i in range(5)])
        da.close()
        db.close()

    def test_identity_auth_pins_peer(self):
        import os

        seed_a = os.urandom(32)
        seed_b = os.urandom(32)
        ready = []
        a, b = _tcp_pair()
        da = AioDuplex(
            a, is_client=True, identity=seed_a,
            on_ready=lambda d, e: ready.append(("a", e)),
        )
        db = AioDuplex(
            b, is_client=False, identity=seed_b,
            on_ready=lambda d, e: ready.append(("b", e)),
        )
        wait_until(lambda: len(ready) == 2)
        assert all(e is None for _s, e in ready), ready
        assert da.peer_identity == base58.encode(
            crypto.public_key(seed_b)
        )
        assert db.peer_identity == base58.encode(
            crypto.public_key(seed_a)
        )
        da.close()
        db.close()

    def test_interop_with_tcp_duplex_both_roles(self):
        """Bit-compatibility on the wire: a loop-driven endpoint talks
        to a thread-per-connection endpoint, with identity auth, in
        BOTH role assignments."""
        import os

        for aio_is_client in (True, False):
            seed_a = os.urandom(32)
            seed_t = os.urandom(32)
            c, s = _tcp_pair()
            ready = []
            da = AioDuplex(
                c if aio_is_client else s,
                is_client=aio_is_client,
                identity=seed_a,
                on_ready=lambda d, e: ready.append(e),
            )
            dt = TcpDuplex(
                s if aio_is_client else c,
                is_client=not aio_is_client,
                identity=seed_t,
            )
            wait_until(lambda: ready == [None])
            got_a, got_t = [], []
            da.on_message(got_a.append)
            dt.on_message(got_t.append)
            da.send({"from": "aio"})
            dt.send({"from": "tcp"})
            wait_until(lambda: got_t == [{"from": "aio"}])
            wait_until(lambda: got_a == [{"from": "tcp"}])
            assert da.peer_identity == base58.encode(
                crypto.public_key(seed_t)
            )
            assert dt.peer_identity == base58.encode(
                crypto.public_key(seed_a)
            )
            da.close()
            wait_until(lambda: dt.closed)

    def test_close_fires_listeners_and_retires_gauge(self):
        before = _counter("net.aio.conns")
        a, b = sockmod.socketpair()
        da = AioDuplex(a, is_client=True)
        db = AioDuplex(b, is_client=False)
        wait_until(lambda: _counter("net.aio.conns") == before + 2)
        closed = []
        db.on_close(lambda: closed.append(True))
        da.close()
        wait_until(lambda: db.closed and closed == [True])
        wait_until(lambda: _counter("net.aio.conns") == before)
        # registering after close fires immediately (TcpDuplex rule)
        late = []
        db.on_close(lambda: late.append(True))
        assert late == [True]

    def test_non_draining_peer_sheds_connection(self, monkeypatch):
        """Same shed policy as TcpDuplex: past the outbox cap with a
        stalled peer the connection sheds instead of growing forever —
        and the loop thread stays responsive for OTHER connections."""
        monkeypatch.setenv("HM_TCP_PLAINTEXT", "1")
        monkeypatch.setenv("HM_TCP_OUTBOX_MB", "0.01")  # ~10 KB
        monkeypatch.setenv("HM_TCP_STALL_S", "0.2")
        a, b = sockmod.socketpair()
        a.setsockopt(sockmod.SOL_SOCKET, sockmod.SO_SNDBUF, 4096)
        b.setsockopt(sockmod.SOL_SOCKET, sockmod.SO_RCVBUF, 4096)
        d = AioDuplex(a)
        # a healthy bystander pair on the SAME loop
        c1, c2 = sockmod.socketpair()
        h1, h2 = AioDuplex(c1), AioDuplex(c2)
        got = []
        h2.on_message(got.append)
        payload = {"pad": "x" * 4096}
        deadline = time.time() + 10
        while not d.closed and time.time() < deadline:
            d.send(payload)
        assert d.closed, "outbox grew past the cap without shedding"
        h1.send({"still": "alive"})
        wait_until(lambda: got == [{"still": "alive"}])
        b.close()
        h1.close()
        h2.close()

    def test_keepalive_sheds_half_open(self, monkeypatch):
        """The timer-wheel keepalive detects a silent peer within
        2 * HM_NET_PING_S * HM_NET_PING_MISSES — no thread per duplex."""
        monkeypatch.setenv("HM_TCP_PLAINTEXT", "1")
        monkeypatch.setenv("HM_NET_PING_S", "0.2")
        monkeypatch.setenv("HM_NET_PING_MISSES", "2")
        a, b = sockmod.socketpair()
        t0 = time.monotonic()
        d = AioDuplex(a)
        wait_until(lambda: d.closed, timeout=5)
        assert time.monotonic() - t0 <= 2 * 0.2 * 2 + 0.5
        b.close()

    def test_healthy_idle_pair_stays_up(self, monkeypatch):
        monkeypatch.setenv("HM_TCP_PLAINTEXT", "1")
        monkeypatch.setenv("HM_NET_PING_S", "0.15")
        monkeypatch.setenv("HM_NET_PING_MISSES", "1")
        a, b = sockmod.socketpair()
        da, db = AioDuplex(a), AioDuplex(b)
        got = []
        db.on_message(got.append)
        time.sleep(1.0)  # ~7 ping periods, miss budget 1
        assert not da.closed and not db.closed
        assert got == []  # keepalive frames never reach subscribers
        da.send({"still": "works"})
        wait_until(lambda: got == [{"still": "works"}])
        da.close()
        db.close()


class TestAsyncSwarm:
    def test_two_repos_over_async_tcp(self, monkeypatch):
        monkeypatch.setenv("HM_NET_ASYNC", "1")
        ra, rb = Repo(memory=True), Repo(memory=True)
        sa, sb = TcpSwarm(), TcpSwarm()
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        url = ra.create({"over": "aio"})
        assert rb.open(url).value(timeout=10) == {"over": "aio"}
        rb.change(url, lambda d: d.__setitem__("back", True))
        wait_until(lambda: ra.doc(url).get("back") is True)
        ra.close()
        rb.close()
        sa.destroy()
        sb.destroy()

    def test_async_and_legacy_swarms_interoperate(self, monkeypatch):
        """The =0 / =1 twins are bit-compatible END TO END: a legacy
        swarm and an async swarm converge a doc in both directions."""
        monkeypatch.setenv("HM_NET_ASYNC", "0")
        sa = TcpSwarm()  # legacy listener
        monkeypatch.setenv("HM_NET_ASYNC", "1")
        sb = TcpSwarm()  # async dialer
        ra, rb = Repo(memory=True), Repo(memory=True)
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        url = ra.create({"mode": "mixed"})
        assert rb.open(url).value(timeout=10) == {"mode": "mixed"}
        rb.change(url, lambda d: d.__setitem__("ok", 1))
        wait_until(lambda: ra.doc(url).get("ok") == 1)
        ra.close()
        rb.close()
        sa.destroy()
        sb.destroy()

    def test_fifty_daemon_thread_census(self, monkeypatch):
        """THE regression test for the tentpole: 50 dialing swarms plus
        one listener, 100 live connections, and the process pays
        O(daemons + pool) threads — one accepter per swarm, one shared
        loop, a bounded dispatch pool — NOT O(connections x 4). A
        supervised session owns no parked thread either."""
        monkeypatch.setenv("HM_NET_ASYNC", "1")
        monkeypatch.setenv("HM_NET_PING_S", "0")  # census, not liveness
        n = 50
        get_loop()  # pre-created so the census counts swarm cost only
        t0 = threading.active_count()
        conns0 = _counter("net.aio.conns")
        central = TcpSwarm()
        clients = [TcpSwarm() for _ in range(n)]
        try:
            for c in clients:
                c.connect(central.address)
            wait_until(
                lambda: len(central._duplexes) == n
                and all(len(c._duplexes) == 1 for c in clients),
                timeout=60,
            )
            assert _counter("net.aio.conns") >= conns0 + 2 * n
            # (n+1) accept threads + dispatch pool + slack; the legacy
            # stack would sit at >= 4 threads per connection here
            delta = threading.active_count() - t0
            assert delta <= (n + 1) + 12, (
                f"{delta} new threads for {n} daemons"
            )
            # async sessions park no thread (the `_thread` attr is the
            # legacy redial loop's)
            for c in clients:
                for s in c.supervisor.sessions():
                    assert getattr(s, "_thread", None) is None
        finally:
            central.destroy()
            for c in clients:
                c.destroy()
        wait_until(
            lambda: _counter("net.aio.conns") <= conns0, timeout=30
        )

    def test_accept_storm_bounded_thread_pool(self, monkeypatch):
        """tcp.py legacy accept path regression: a storm of 30
        non-handshaking sockets parks in the bounded pool's queue
        (HM_TCP_ACCEPT_POOL) instead of spawning 30 handshake
        threads."""
        monkeypatch.setenv("HM_NET_ASYNC", "0")
        sw = TcpSwarm()
        t0 = threading.active_count()
        socks = []
        try:
            for _ in range(30):
                c = sockmod.socket()
                c.connect(sw.address)
                socks.append(c)
            deadline = time.time() + 2
            worst = 0
            while time.time() < deadline:
                worst = max(worst, threading.active_count() - t0)
                time.sleep(0.05)
            assert worst <= 8 + 3, (
                f"{worst} threads spawned by a 30-socket accept storm"
            )
        finally:
            for c in socks:
                c.close()
            sw.destroy()


class TestAsyncSupervisor:
    def test_failed_dial_backs_off_and_retries(
        self, fast_redial, monkeypatch
    ):
        monkeypatch.setenv("HM_NET_ASYNC", "1")
        port = sockmod.socket()
        port.bind(("127.0.0.1", 0))
        dead = port.getsockname()
        port.close()  # nothing listens here
        sw = TcpSwarm()
        try:
            s = sw.connect(dead)
            wait_until(lambda: sw.supervisor.stats["dials"] >= 2)
            assert s.failures >= 1
            assert s.state in (BACKOFF, CONNECTING)
        finally:
            sw.destroy()
        assert s.state == STOPPED

    def test_redial_after_drop_resumes_replication(
        self, fast_redial, monkeypatch
    ):
        monkeypatch.setenv("HM_NET_ASYNC", "1")
        ra, rb = Repo(memory=True), Repo(memory=True)
        sa, sb = TcpSwarm(), TcpSwarm()
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        url = ra.create({"v": 1})
        assert rb.open(url).value(timeout=10)["v"] == 1
        for d in list(sb._duplexes):  # hard-drop b's transports
            d.close()
        ra.change(url, lambda d: d.__setitem__("v", 2))
        # the supervised session redials on its own — no connect() here
        wait_until(lambda: rb.doc(url).get("v") == 2, timeout=20)
        assert sb.supervisor.stats["reconnects"] >= 1
        ra.close()
        rb.close()
        sa.destroy()
        sb.destroy()


class TestChaosMatrixOverAio:
    """Seeded kill/heal chaos (the existing FaultPlan schedules) across
    the HM_CURSOR_DELTA x HM_NET_ASYNC matrix — the (0,0) cell is
    tests/test_chaos.py. FaultDuplex wraps the aio transport through
    the same public Duplex surface it wraps TcpDuplex through."""

    @pytest.mark.parametrize(
        "delta,asyncm", [("1", "1"), ("0", "1"), ("1", "0")]
    )
    def test_kill_heal_reconverges_bit_identical(
        self, delta, asyncm, fast_redial, monkeypatch
    ):
        monkeypatch.setenv("HM_CURSOR_DELTA", delta)
        monkeypatch.setenv("HM_NET_ASYNC", asyncm)
        cur0 = (
            _counter("net.cursor.delta_tx")
            + _counter("net.cursor.suppressed")
        )
        plan = FaultPlan(seed=11, events=[(1, "kill"), (2, "heal")])
        ra, rb = Repo(memory=True), Repo(memory=True)
        sa = TcpSwarm()
        fb = FaultSwarm(TcpSwarm(), plan)
        ra.set_swarm(sa)
        rb.set_swarm(fb)
        fb.connect(sa.address)
        url = ra.create({"a": [], "b": []})
        assert rb.open(url).value(timeout=10) is not None
        n1, n2, n3 = 4, 4, 4
        _apply_script(ra, rb, url, 0, n1)  # healthy phase
        fb.tick()  # kill
        wait_until(lambda: plan.down)
        _apply_script(ra, rb, url, n1, n1 + n2)  # partitioned edits
        fb.tick()  # heal: the supervised redial goes through
        _apply_script(ra, rb, url, n1 + n2, n1 + n2 + n3)
        monkeypatch.setenv("HM_NET_ASYNC", "0")  # oracle on legacy
        want = _loopback_twin_state(n1 + n2 + n3)
        wait_until(
            lambda: ra.doc(url) == want and rb.doc(url) == want,
            timeout=60,
        )
        if delta == "1":
            # steady-state gossip actually ran in delta mode
            assert (
                _counter("net.cursor.delta_tx")
                + _counter("net.cursor.suppressed")
            ) > cur0
        ra.close()
        rb.close()
        sa.destroy()
        fb.destroy()


# ---------------------------------------------------------------------------
# tests/test_crash.py: the anti-entropy sweep


def test_antientropy_sweep_recovers_lost_tail_frames(monkeypatch):
    """App-layer frame loss on a SURVIVING connection: the gap-driven
    protocol would only recover at the next tail flush or reconnect;
    the anti-entropy FeedLength re-announce bounds it by the sweep."""
    from hypermerge_tpu_torch.net.swarm import LoopbackHub, LoopbackSwarm

    monkeypatch.setenv("HM_ANTIENTROPY_S", "3600")  # manual sweeps
    hub = LoopbackHub()
    plan = FaultPlan(seed=1, events=[(1, "partition_rx"), (2, "heal")])
    ra, rb = Repo(memory=True), Repo(memory=True)
    fb = FaultSwarm(LoopbackSwarm(hub), plan)
    try:
        ra.set_swarm(LoopbackSwarm(hub))
        rb.set_swarm(fb)
        url = ra.create({"edits": []})
        hb = rb.open(url)
        assert hb.value(timeout=30) is not None
        ra.change(url, lambda d: d["edits"].append(0))
        wait_until(
            lambda: len((rb.doc(url) or {}).get("edits", [])) == 1
        )
        fb.tick()  # partition_rx: frames TO b silently drop
        for i in range(1, 4):
            ra.change(url, lambda d, i=i: d["edits"].append(i))
        # drain EVERY debounced sender while the partition still eats
        # frames: a gossip flush landing after the heal would recover
        # b without the sweep (and flake this test)
        ra.back.network.replication.flush_now()
        ra.back._gossip.flush_now()
        ra.back._stores.flush_now()
        fb.tick()  # heal — but the tail frames are already lost
        import time

        time.sleep(0.2)
        assert len((rb.doc(url) or {}).get("edits", [])) == 1  # stale
        sent = ra.back.network.replication.sweep_now()
        assert sent >= 1
        wait_until(
            lambda: len((rb.doc(url) or {}).get("edits", [])) == 4,
            timeout=30,
        )
    finally:
        ra.close()
        rb.close()
        fb.destroy()


def test_antientropy_timer_runs_sweeps(monkeypatch):
    from hypermerge_tpu_torch.net.swarm import LoopbackHub, LoopbackSwarm

    monkeypatch.setenv("HM_ANTIENTROPY_S", "0.05")
    hub = LoopbackHub()
    ra, rb = Repo(memory=True), Repo(memory=True)
    try:
        ra.set_swarm(LoopbackSwarm(hub))
        rb.set_swarm(LoopbackSwarm(hub))
        url = ra.create({"n": 1})
        assert rb.open(url).value(timeout=30) is not None
        wait_until(
            lambda: ra.back.network.replication.stats[
                "antientropy_sweeps"
            ]
            >= 2,
            timeout=30,
        )
    finally:
        ra.close()
        rb.close()




# ---------------------------------------------------------------------------
# parity with the JAX package


def _plan_params(rng):
    """(seed, drop, dup, delay_ms) drawn with numpy."""
    seed = int(rng.integers(0, 2**31))
    drop, dup = (float(x) for x in rng.uniform(0.0, 0.3, 2))
    lo = float(rng.uniform(0.0, 5.0))
    delay = (lo, lo + float(rng.uniform(0.0, 20.0)))
    return seed, drop, dup, delay


# events and partitions on ticks, with the tick at which each run
# advances its plan (one frame a direction between advances)
_EVENT_SETS = [
    [],
    [(3, "kill"), (5, "heal")],
    [(2, "partition_tx"), (4, "heal"), (6, "partition_rx"), (9, "heal")],
    [(1, "clean"), (3, "lossy"), (7, "kill"), (8, "heal"), (8, "clean")],
]


@pytest.mark.parametrize("case", range(8))
def test_fault_plan_fates_equal_reference(case):
    """For one seed and (drop, dup, delay), both packages' FaultPlans give
    equal per-direction frame fates over 2,000 frames, with the same
    events advanced on the same frames, and fire the same events."""
    from hypermerge_tpu.net.faults import FaultPlan as RefFaultPlan

    rng = np.random.default_rng(case)
    seed, drop, dup, delay = _plan_params(rng)
    events = _EVENT_SETS[case % len(_EVENT_SETS)]
    port = FaultPlan(seed=seed, drop_p=drop, dup_p=dup, delay_ms=delay,
                     events=events)
    ref = RefFaultPlan(seed=seed, drop_p=drop, dup_p=dup, delay_ms=delay,
                       events=events)
    advance_at = set(int(i) for i in rng.choice(2000, 12, replace=False))
    got, want = [], []
    for i in range(2000):
        if i in advance_at:
            fired = port.advance()
            assert fired == ref.advance()
            got.append(fired)
            want.append(fired)
        # the directions interleave unevenly: each has its own stream
        for tx in (True, False) if i % 3 else (False,):
            got.append(port.frame_fate(tx=tx))
            want.append(ref.frame_fate(tx=tx))
    assert got == want
    assert (port.down, port.tx_blocked, port.rx_blocked, port.lossy) == (
        ref.down, ref.tx_blocked, ref.rx_blocked, ref.lossy)
    # every fate occurs, so the comparison covers each branch
    assert {f[0] for f in got if isinstance(f, tuple)} == {
        DELIVER, DROP, DUP}


_SPECS = [
    "seed=3,kill@4,heal@7,tick=50",
    "seed=7,drop=0.02,dup=0.01,delay=2:8,kill@30,heal@50,tick=250",
    "seed=1,delay=5",
    " seed=9 , partition_tx@2,heal@3,partition_rx@4, clean@4,lossy@9,",
    "",
    "heal@4,clean@4,kill@2",
]
_JUNK = ["explode@3", "warp=9", "seed", "seed=x", "drop=", "delay=1:b",
         "kill@-1"]


def test_parse_fault_spec_equal_reference():
    """parse_fault_spec gives equal plans in both packages, and both
    refuse the same junk with ValueError."""
    from hypermerge_tpu.net.faults import parse_fault_spec as ref_parse

    def fields(plan):
        return (plan.seed, plan.drop_p, plan.dup_p, plan.delay_ms,
                plan.tick_ms, plan.events)

    for spec in _SPECS:
        port, ref = parse_fault_spec(spec), ref_parse(spec)
        assert fields(port) == fields(ref), spec
        assert [port.frame_fate(tx=True) for _ in range(50)] == [
            ref.frame_fate(tx=True) for _ in range(50)]
    for junk in _JUNK:
        with pytest.raises(ValueError):
            parse_fault_spec(junk)
        with pytest.raises(ValueError):
            ref_parse(junk)


@pytest.mark.parametrize("peer", ["tcp", "aio"])
@pytest.mark.parametrize("port_is_client", [True, False],
                         ids=["port-client", "port-server"])
def test_port_aio_duplex_talks_to_reference(peer, port_is_client,
                                           monkeypatch):
    """Wire compatibility of the shared-loop transport: a port AioDuplex
    and the reference's TcpDuplex (thread-per-connection) or AioDuplex
    (the reference's own loop) handshake in either role, encrypted, with
    identity authentication, and carry frames both ways. The reference's
    loop made here is its own and is forgotten after the case: its
    tests/test_aio.py, should it run later in this process, makes its
    loop under its lock checkers."""
    from hypermerge_tpu.net import aio as ref_aio
    from hypermerge_tpu.net.aio import AioDuplex as RefAioDuplex
    from hypermerge_tpu.net.tcp import TcpDuplex as RefTcpDuplex

    monkeypatch.setattr(ref_aio, "_LOOP", None)

    seed_p, seed_r = os.urandom(32), os.urandom(32)
    c, s = _tcp_pair()
    ready = []
    dp = AioDuplex(
        c if port_is_client else s,
        is_client=port_is_client,
        identity=seed_p,
        on_ready=lambda d, e: ready.append(("port", e)),
    )
    if peer == "tcp":
        dr = RefTcpDuplex(
            s if port_is_client else c,
            is_client=not port_is_client,
            identity=seed_r,
        )
        wait_until(lambda: len(ready) == 1)
    else:
        dr = RefAioDuplex(
            s if port_is_client else c,
            is_client=not port_is_client,
            identity=seed_r,
            on_ready=lambda d, e: ready.append(("ref", e)),
        )
        wait_until(lambda: len(ready) == 2)
    try:
        assert all(e is None for _side, e in ready), ready
        # each package's duplex rides its own package's loop
        assert dp._loop is get_loop()
        if peer == "aio":
            assert dr._loop is ref_aio.get_loop()
            assert dr._loop is not dp._loop
        assert dp.channel_binding is not None
        assert dp.channel_binding == dr.channel_binding
        got_p, got_r = [], []
        dp.on_message(got_p.append)
        dr.on_message(got_r.append)
        for i in range(3):
            dp.send({"from": "port", "i": i})
            dr.send({"from": "ref", "i": i})
        wait_until(lambda: len(got_r) == 3 and len(got_p) == 3)
        assert got_r == [{"from": "port", "i": i} for i in range(3)]
        assert got_p == [{"from": "ref", "i": i} for i in range(3)]
        assert dp.peer_identity == base58.encode(crypto.public_key(seed_r))
        assert dr.peer_identity == base58.encode(crypto.public_key(seed_p))
        dp.close()
        wait_until(lambda: dr.closed)
    finally:
        dr.close()
    if peer == "aio":
        # nothing of this case still runs on the reference's loop
        loop = dr._loop
        wait_until(lambda: not loop._ready and not loop._dispatch_q
                   and loop._dispatch_idle == loop._workers)


def test_port_async_and_reference_legacy_repos_converge(monkeypatch):
    """End to end across packages and stacks: a port repo on the port's
    TcpSwarm under HM_NET_ASYNC=1 (the port's loop) and a reference repo
    on the reference's TcpSwarm under HM_NET_ASYNC=0 share a doc each way
    and converge to equal values, authenticated."""
    from hypermerge_tpu.net.tcp import TcpSwarm as RefTcpSwarm
    from hypermerge_tpu.repo import Repo as RefRepo

    monkeypatch.setenv("HM_SERVICE", "0")
    monkeypatch.setenv("HM_NET_ASYNC", "1")
    rp = Repo(memory=True)
    sp = TcpSwarm()
    assert sp._async
    monkeypatch.setenv("HM_NET_ASYNC", "0")
    rr = RefRepo(memory=True)
    sr = RefTcpSwarm()
    try:
        assert not sr._async
        rp.set_swarm(sp)
        rr.set_swarm(sr)
        sp.connect(sr.address)
        u_ref = rr.create({"from": "reference", "edits": []})
        u_port = rp.create({"from": "port", "edits": []})
        assert plain(rp.open(u_ref).value(timeout=30))["from"] == "reference"
        assert plain(rr.open(u_port).value(timeout=30))["from"] == "port"
        for i in range(5):
            rp.change(u_ref, lambda d, i=i: d["edits"].append(i))
            rr.change(u_port, lambda d, i=i: d["edits"].append(10 + i))
            rr.change(u_ref, lambda d, i=i: d["edits"].append(20 + i))
            rp.change(u_port, lambda d, i=i: d["edits"].append(30 + i))

        def converged():
            for u in (u_ref, u_port):
                a, b = plain(rp.doc(u)), plain(rr.doc(u))
                if a != b or len(a["edits"]) != 10:
                    return False
            return True

        wait_until(converged, timeout=60)
        (peer,) = rp.back.network.peers.values()
        assert peer.connection.peer_identity == rr.back.id
    finally:
        rr.close()
        sr.destroy()
