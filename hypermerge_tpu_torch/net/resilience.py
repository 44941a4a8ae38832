"""Connection resilience: supervised redial with backoff + jitter.

The availability contract the rest of the stack already assumes — "the
peer redials and resyncs from its cursor" (net/tcp.py send() docstring,
net/network.py per-connection channel re-wiring) — lived nowhere until
now: `TcpSwarm.connect` dialed exactly once on the caller's thread and
a shed/crashed/partitioned connection stayed dead forever. The
reference delegates this to hyperswarm's reconnect loop; this module is
that loop for explicit-address swarms.

`SessionSupervisor` owns every outbound address:

- dial + handshake run on a supervisor thread (never the caller's),
  with the bounded dial timeout `HM_DIAL_TIMEOUT_S`;
- a failed dial or a dropped connection schedules a redial after
  exponential backoff with FULL jitter (`HM_REDIAL_BASE_MS`,
  `HM_REDIAL_MAX_S`), reset once a connection survives
  `HM_REDIAL_RESET_S` (instant drops keep escalating);
- retries are UNBOUNDED unless the connection's `ConnectionDetails`
  recorded `reconnect(False)` or `ban()` (the two signals net/swarm.py
  always carried but nothing consulted), or the swarm banned the
  address — then the session stops;
- a status hook surfaces every transition (connecting / connected /
  backoff / stopped) instead of raising into the caller.

Resync after the redial comes for free: `Network._on_peer_active` fires
for every replacement connection and renegotiates replication from
cursors (net/replication.py counts those resyncs in `stats`).

The port's copy of hypermerge_tpu/net/resilience.py.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..analysis.lockdep import make_rlock
from ..utils.debug import log


def _base_s() -> float:
    return float(os.environ.get("HM_REDIAL_BASE_MS", "250")) / 1e3


def _max_s() -> float:
    return float(os.environ.get("HM_REDIAL_MAX_S", "30"))


def _reset_uptime_s() -> float:
    """A connection must SURVIVE this long before its success resets
    the backoff: a peer that accepts and instantly drops (crash loop,
    post-handshake refusal) must keep escalating, not get hammered at
    the base rate forever."""
    return float(os.environ.get("HM_REDIAL_RESET_S", "1"))


def dial_timeout_s() -> float:
    return float(os.environ.get("HM_DIAL_TIMEOUT_S", "10"))


class Backoff:
    """Exponential backoff with FULL jitter: attempt n (0-based) sleeps
    uniform(0, min(max_s, base_s * 2**n)). Full jitter (vs equal or
    none) is what keeps a herd of peers redialing a recovered server
    from re-arriving in lockstep. `reset()` on success restores the
    fast first retry."""

    def __init__(
        self,
        base_s: Optional[float] = None,
        max_s: Optional[float] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.base_s = _base_s() if base_s is None else base_s
        self.max_s = _max_s() if max_s is None else max_s
        self._rng = rng if rng is not None else random.Random()
        self.attempt = 0

    def next_delay(self) -> float:
        ceiling = min(self.max_s, self.base_s * (2 ** self.attempt))
        # past the cap, 2**n overflows usefulness; clamp the exponent
        if self.attempt < 63:
            self.attempt += 1
        return self._rng.uniform(0.0, ceiling)

    def reset(self) -> None:
        self.attempt = 0


# session states surfaced through the status hook
CONNECTING = "connecting"
CONNECTED = "connected"
BACKOFF = "backoff"
STOPPED = "stopped"


class Session:
    """One supervised outbound address."""

    def __init__(self, address: Any) -> None:
        self.address = address
        self.state = CONNECTING
        self.duplex = None
        self.details = None
        self.backoff = Backoff()
        self.connects = 0  # successful dial+handshakes
        self.failures = 0  # failed dial attempts
        self.stop_reason: Optional[str] = None
        self._wake = threading.Event()  # interrupts a backoff sleep

    def kick(self) -> None:
        """Skip the current backoff sleep (idempotent re-`connect`)."""
        self._wake.set()
        hook = getattr(self, "_kick_hook", None)
        if hook is not None:  # async mode: cancel the backoff timer
            hook()


class SessionSupervisor:
    """Redial loop over a swarm's dial primitive.

    `dial(address)` must return a CONNECTED duplex (handshake done) or
    raise OSError; `deliver(duplex, details)` hands the connection to
    the swarm's on_connection callback. `banned(address)` lets the
    swarm veto an address (see TcpSwarm's ban registry).

    Async mode (`HM_NET_ASYNC=1`): pass `connector` (the shared
    net/aio.py loop, or anything with `call_soon`/`call_later`) and a
    `dial(address, cb)` primitive that starts a NON-blocking dial and
    fires `cb(duplex, exc)` exactly once when the handshake settles.
    Sessions then run as callback state machines — the same
    CONNECTING/CONNECTED/BACKOFF/STOPPED transitions, counters and
    ban/reconnect consults as the thread mode, but a supervised
    address no longer owns a parked thread: backoff waits live on the
    loop's timer wheel, so 1000 supervised peers cost 1000 heap
    entries instead of 1000 threads."""

    def __init__(
        self,
        dial: Callable[..., Any],
        deliver: Callable[[Any, Any], None],
        banned: Optional[Callable[[Any], bool]] = None,
        on_status: Optional[Callable[[Session, str, dict], None]] = None,
        connector: Optional[Any] = None,
    ) -> None:
        self._dial = dial
        self._deliver = deliver
        self._banned = banned if banned is not None else lambda a: False
        self._on_status = on_status
        self._connector = connector
        self._lock = make_rlock("net.sup")
        self._sessions: Dict[Any, Session] = {}
        self._stopped = False
        # registry-backed (one labeled series per supervisor); the
        # `stats` property keeps the historical dict shape
        from .. import telemetry

        inst = str(telemetry.next_instance())
        self._m = {
            k: telemetry.counter("net.sup." + k, inst=inst)
            for k in ("dials", "reconnects")
        }

    @property
    def stats(self) -> Dict[str, int]:
        return {
            "dials": int(self._m["dials"].value()),
            "reconnects": int(self._m["reconnects"].value()),
        }

    def on_status(
        self, cb: Callable[[Session, str, dict], None]
    ) -> None:
        self._on_status = cb

    def session(self, address: Any) -> Optional[Session]:
        with self._lock:
            return self._sessions.get(address)

    def sessions(self) -> list:
        with self._lock:
            return list(self._sessions.values())

    def connect(self, address: Any) -> Session:
        """Register (or kick) the supervised session for `address`.
        Returns immediately; the dial runs on the session thread."""
        with self._lock:
            if self._stopped:
                raise RuntimeError("supervisor stopped")
            s = self._sessions.get(address)
            if s is not None and s.state != STOPPED:
                s.kick()
                return s
            # no session, or a STOPPED one (its thread exited — kick
            # would wake nobody): an explicit connect() is a fresh
            # instruction, so start a fresh session. A still-banned
            # address stops again immediately, via the status hook
            # rather than silence.
            s = Session(address)
            self._sessions[address] = s
        if self._connector is not None:
            # async mode: no parked thread — the session advances via
            # dial callbacks and loop timers
            s._dialing = False
            s._timer = None
            s._kick_hook = lambda: self._a_kick(s)
            self._a_attempt(s)
            return s
        t = threading.Thread(
            target=self._run, args=(s,), daemon=True,
            name=f"redial:{address}",
        )
        s._thread = t  # stop() joins before retiring the counters
        t.start()
        return s

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            sessions = list(self._sessions.values())
        for s in sessions:
            s.kick()
            # a session parked on a LIVE connection waits on the
            # connection-done event, not the backoff wake: set it too,
            # or every stop() pays the full join timeout per connected
            # session (at fleet scale that is the whole teardown)
            done = getattr(s, "_conn_done", None)
            if done is not None:
                done.set()
            # async sessions have no thread to observe _stopped and
            # retire themselves: the kick above cancelled the backoff
            # timer, so finish the transition here (the callback chain
            # re-checks _stopped before any further step)
            if self._connector is not None and s.state != STOPPED:
                self._stop_session(s, "supervisor stopped")
        # bounded join before retiring the series: a session thread
        # bumping `dials` after the fold would land on a dropped
        # handle (kick() already interrupts backoff sleeps; only a
        # dial mid-flight can outlive the bound, and it re-checks
        # stopped before any further counting)
        for s in sessions:
            t = getattr(s, "_thread", None)
            if t is not None and t is not threading.current_thread():
                t.join(timeout=1.0)
        # registry hygiene (idempotent): fold this supervisor's series
        # into the closed aggregate; stats stays handle-readable
        from .. import telemetry

        telemetry.REGISTRY.retire(*self._m.values())

    # ------------------------------------------------------------------

    def _status(self, s: Session, state: str, **info: Any) -> None:
        s.state = state
        if self._on_status is not None:
            try:
                self._on_status(s, state, info)
            except Exception as e:  # a hook bug must not kill the loop
                log("net:redial", f"status hook error: {e}")

    def _sleep(self, s: Session, delay: float) -> bool:
        """Backoff sleep; True when the supervisor stopped meanwhile."""
        s._wake.wait(delay)
        s._wake.clear()
        return self._stopped

    def _stop_session(self, s: Session, reason: str) -> None:
        s.stop_reason = reason
        self._status(s, STOPPED, reason=reason)
        log("net:redial", f"session {s.address} stopped: {reason}")

    # ------------------------------------------------------------------
    # async session state machine (connector mode): one step per
    # callback, mirroring _run()'s sequence exactly — same consults,
    # same counter points, same "details exposed after deliver" rule

    def _a_kick(self, s: Session) -> None:
        t = getattr(s, "_timer", None)
        if t is not None:
            t.cancel()
        if s.state == BACKOFF and not self._stopped:
            self._connector.call_soon(lambda: self._a_attempt(s))

    def _a_attempt(self, s: Session) -> None:
        with self._lock:
            if self._stopped or s.state == STOPPED or s._dialing:
                return
            s._dialing = True
        if self._banned(s.address):
            s._dialing = False
            self._stop_session(s, "banned address")
            return
        # re-consult the stop signals set during a backoff window
        # (same rule as the thread loop's top-of-iteration check)
        d = s.details
        if d is not None:
            if d.banned:
                s._dialing = False
                self._stop_session(s, "peer banned")
                return
            if not d._reconnect_allowed:
                s._dialing = False
                self._stop_session(s, "reconnect disallowed")
                return
        self._status(s, CONNECTING, attempt=s.backoff.attempt)
        self._m["dials"].add(1)
        try:
            self._dial(
                s.address,
                lambda duplex, exc: self._a_dialed(s, duplex, exc),
            )
        except OSError as e:
            self._a_failed(s, e)

    def _a_failed(self, s: Session, e: BaseException) -> None:
        s._dialing = False
        if self._stopped:
            return
        s.failures += 1
        delay = s.backoff.next_delay()
        self._status(
            s, BACKOFF, error=str(e), delay=delay,
            attempt=s.backoff.attempt,
        )
        s._timer = self._connector.call_later(
            delay, lambda: self._a_attempt(s)
        )

    def _a_dialed(self, s: Session, duplex: Any, exc) -> None:
        if exc is not None:
            self._a_failed(s, exc)
            return
        s._dialing = False
        if self._stopped or self._banned(s.address):
            # stop()/ban landed while the dial was in flight: never
            # hand a live connection to a torn-down swarm
            duplex.close()
            if self._stopped:
                return
            self._stop_session(s, "banned address")
            return
        from .swarm import ConnectionDetails

        details = ConnectionDetails(client=True)
        s.duplex = duplex
        t_up = time.monotonic()
        s.connects += 1
        if s.connects > 1:
            self._m["reconnects"].add(1)
        self._status(s, CONNECTED, connects=s.connects)
        try:
            self._deliver(duplex, details)
        except Exception as e:  # callback bug: treat as a drop
            log("net:redial", f"deliver failed for {s.address}: {e}")
            duplex.close()
        # expose the details only once deliver wired its hooks
        s.details = details
        # register AFTER deliver: the stack's own close listeners run
        # (peer inactive -> replication reset) before the redial
        duplex.on_close(lambda: self._a_closed(s, details, t_up))

    def _a_closed(self, s: Session, details: Any, t_up: float) -> None:
        if self._stopped:
            return
        if details.banned:
            self._stop_session(s, "peer banned")
            return
        if not details._reconnect_allowed:
            self._stop_session(s, "reconnect disallowed")
            return
        if time.monotonic() - t_up >= _reset_uptime_s():
            s.backoff.reset()  # a STABLE connection earns the fast
            # first redial; instant drops keep escalating
        delay = s.backoff.next_delay()
        self._status(
            s, BACKOFF, delay=delay, attempt=s.backoff.attempt
        )
        s._timer = self._connector.call_later(
            delay, lambda: self._a_attempt(s)
        )

    def _run(self, s: Session) -> None:
        while not self._stopped:
            if self._banned(s.address):
                self._stop_session(s, "banned address")
                return
            # a caller may set reconnect(False)/ban() on s.details
            # DURING a backoff window (the documented stop signal);
            # the previous connection's post-close check already
            # passed, so re-consult before dialing again
            d = s.details
            if d is not None:
                if d.banned:
                    self._stop_session(s, "peer banned")
                    return
                if not d._reconnect_allowed:
                    self._stop_session(s, "reconnect disallowed")
                    return
            self._status(s, CONNECTING, attempt=s.backoff.attempt)
            self._m["dials"].add(1)
            try:
                duplex = self._dial(s.address)
            except OSError as e:
                s.failures += 1
                delay = s.backoff.next_delay()
                self._status(
                    s, BACKOFF, error=str(e), delay=delay,
                    attempt=s.backoff.attempt,
                )
                if self._sleep(s, delay):
                    return
                continue
            if self._stopped or self._banned(s.address):
                # stop()/ban landed while the dial was in flight (up
                # to the dial timeout): never hand a live connection
                # to a torn-down swarm
                duplex.close()
                if self._stopped:
                    return
                self._stop_session(s, "banned address")
                return
            from .swarm import ConnectionDetails

            details = ConnectionDetails(client=True)
            s.duplex = duplex
            t_up = time.monotonic()
            s.connects += 1
            if s.connects > 1:
                self._m["reconnects"].add(1)
            self._status(s, CONNECTED, connects=s.connects)
            try:
                self._deliver(duplex, details)
            except Exception as e:  # callback bug: treat as a drop
                log("net:redial", f"deliver failed for {s.address}: {e}")
                duplex.close()
            # expose the details only once deliver wired its hooks
            # (e.g. the swarm's ban recorder): a caller acting on
            # s.details must never beat the attachment
            s.details = details
            # register AFTER deliver: the connection stack's own close
            # listeners must run (peer inactive -> replication reset)
            # BEFORE the supervisor wakes to redial, or the replacement
            # races the teardown accounting. A duplex that closed in
            # between fires the listener immediately.
            closed = threading.Event()
            s._conn_done = closed  # stop() sets it (see above): a
            # supervisor teardown must not wait out a healthy link
            duplex.on_close(closed.set)
            closed.wait()
            if self._stopped:
                return
            # the two recorded-but-never-consulted signals, consulted:
            if details.banned:
                self._stop_session(s, "peer banned")
                return
            if not details._reconnect_allowed:
                self._stop_session(s, "reconnect disallowed")
                return
            if time.monotonic() - t_up >= _reset_uptime_s():
                s.backoff.reset()  # a STABLE connection earns the
                # fast first redial; instant drops keep escalating
            delay = s.backoff.next_delay()
            self._status(s, BACKOFF, delay=delay, attempt=s.backoff.attempt)
            if self._sleep(s, delay):
                return
