"""Deterministic fault injection over any Duplex/Swarm transport.

Convergence-under-churn was untestable before this module: the only way
to provoke churn was wall-clock-dependent socket surgery. `FaultPlan`
is a SEEDED schedule — per-frame fates (drop / duplicate / delay) drawn
from private per-direction RNG streams in frame order, plus tick-driven
link events (hard-kill, one-way partition, heal) advanced explicitly by
tests or by a timer in bench/soak runs — so the same seed reproduces
the same frame-level fault schedule on every run.

The wrappers sit at the OBJECT-message layer (above net/secure.py's
per-frame encryption, below net/connection.py's channels): dropping a
frame here models a lossy/partitioned link without desyncing the cipher
nonce counters, exactly the layer the replication protocol must survive
at.

  FaultDuplex  — wraps one side's duplex; every outbound (`tx`) and
                 inbound (`rx`) frame consults the plan.
  FaultSwarm   — wraps a swarm; every emitted connection is wrapped in
                 a FaultDuplex sharing the swarm's plan. While the link
                 is down (kill ... heal window) new connections are
                 killed at emission, so a supervised dialer
                 (net/resilience.py) backs off and retries until heal.

Env activation for bench/soak runs (parsed by `parse_fault_spec`,
applied to every swarm in `Network.set_swarm` when `HM_FAULT` is set):

  HM_FAULT="seed=7,drop=0.01,dup=0.005,delay=2:8,kill@30,heal@50"

Grammar: comma-separated `key=value` knobs (`seed`, `drop`, `dup`,
`delay` in ms as `N` or `MIN:MAX`, `tick` = auto-ticker period in ms,
default 100) and `event@tick` entries (`kill`, `heal`, `partition_tx`,
`partition_rx`). Ticks count from the swarm's construction.

The port's copy of hypermerge_tpu/net/faults.py.
"""

from __future__ import annotations

import random
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis.lockdep import make_condition, make_lock
from ..utils.debug import log
from .swarm import ConnectionDetails, Swarm

DELIVER = "deliver"
DROP = "drop"
DUP = "dup"

KILL = "kill"
HEAL = "heal"
PARTITION_TX = "partition_tx"
PARTITION_RX = "partition_rx"
CLEAN = "clean"  # disable drop/dup/delay from this tick on
LOSSY = "lossy"  # re-enable them

_EVENTS = (KILL, HEAL, PARTITION_TX, PARTITION_RX, CLEAN, LOSSY)


class FaultPlan:
    """Seeded frame-fate schedule + tick-driven link events.

    Frame fates consume per-direction RNG streams in frame order, so a
    single-threaded driver reproduces the exact schedule; under real
    concurrency the fate SEQUENCE per direction is still fixed by the
    seed (which message lands on which frame index is the only part
    timing decides). Events fire when `advance()` crosses their tick."""

    def __init__(
        self,
        seed: int = 0,
        drop_p: float = 0.0,
        dup_p: float = 0.0,
        delay_ms: Tuple[float, float] = (0.0, 0.0),
        events: Optional[List[Tuple[int, str]]] = None,
        tick_ms: float = 100.0,
    ) -> None:
        self.seed = seed
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.delay_ms = delay_ms
        self.tick_ms = tick_ms
        # stable sort by tick ONLY: same-tick events fire in the order
        # the plan listed them (heal@4,clean@4 means heal THEN clean)
        self.events = sorted(events or [], key=lambda e: e[0])
        for _t, ev in self.events:
            if ev not in _EVENTS:
                raise ValueError(f"unknown fault event {ev!r}")
        self._tx_rng = random.Random((seed << 1) ^ 0xFA17)
        self._rx_rng = random.Random((seed << 1) | 1)
        self._lock = make_lock("net.fault.plan")
        self.tick = 0
        self._next_event = 0
        # link state (event-driven)
        self.down = False  # kill..heal window: no connection survives
        self.tx_blocked = False
        self.rx_blocked = False
        self.lossy = True  # drop/dup/delay active (CLEAN disables)

    def frame_fate(self, tx: bool) -> Tuple[str, float]:
        """(fate, delay_s) for the next frame in one direction. The RNG
        stream advances even for blocked/clean frames so a partition or
        clean window doesn't shift the rest of the schedule."""
        with self._lock:
            rng = self._tx_rng if tx else self._rx_rng
            r = rng.random()
            lo, hi = self.delay_ms
            delay = (rng.uniform(lo, hi) if hi > 0 else 0.0) / 1e3
            if self.down or (self.tx_blocked if tx else self.rx_blocked):
                return DROP, 0.0
            if not self.lossy:
                return DELIVER, 0.0
            if r < self.drop_p:
                return DROP, 0.0
            if r < self.drop_p + self.dup_p:
                return DUP, delay
            return DELIVER, delay

    def advance(self, n: int = 1) -> List[str]:
        """Advance `n` ticks; returns the events that fired, in order."""
        fired: List[str] = []
        with self._lock:
            for _ in range(n):
                self.tick += 1
                while (
                    self._next_event < len(self.events)
                    and self.events[self._next_event][0] <= self.tick
                ):
                    ev = self.events[self._next_event][1]
                    self._next_event += 1
                    fired.append(ev)
                    if ev == KILL:
                        self.down = True
                    elif ev == HEAL:
                        self.down = False
                        self.tx_blocked = False
                        self.rx_blocked = False
                    elif ev == PARTITION_TX:
                        self.tx_blocked = True
                    elif ev == PARTITION_RX:
                        self.rx_blocked = True
                    elif ev == CLEAN:
                        self.lossy = False
                    elif ev == LOSSY:
                        self.lossy = True
        return fired


def parse_fault_spec(spec: str) -> FaultPlan:
    """Parse the HM_FAULT grammar (module docstring) into a FaultPlan."""
    seed = 0
    drop = dup = 0.0
    delay = (0.0, 0.0)
    tick_ms = 100.0
    events: List[Tuple[int, str]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"([a-z_]+)@(\d+)", part)
        if m:
            events.append((int(m.group(2)), m.group(1)))
            continue
        if "=" not in part:
            raise ValueError(f"bad HM_FAULT entry {part!r}")
        key, val = part.split("=", 1)
        if key == "seed":
            seed = int(val)
        elif key == "drop":
            drop = float(val)
        elif key == "dup":
            dup = float(val)
        elif key == "delay":
            if ":" in val:
                lo, hi = val.split(":", 1)
                delay = (float(lo), float(hi))
            else:
                delay = (float(val), float(val))
        elif key == "tick":
            tick_ms = float(val)
        else:
            raise ValueError(f"unknown HM_FAULT knob {key!r}")
    return FaultPlan(
        seed=seed, drop_p=drop, dup_p=dup, delay_ms=delay,
        events=events, tick_ms=tick_ms,
    )


class _DelayLine:
    """FIFO delayed delivery for one direction: frames leave in
    ARRIVAL order, each no earlier than its due time. Independent
    timers would reorder frames — a failure mode no real transport
    (TCP, the in-memory trampoline) exhibits — so injected latency
    must not either; a later frame drawn a shorter delay simply waits
    behind the earlier one."""

    def __init__(self, deliver: Callable[[Any, int], None]) -> None:
        self._deliver = deliver
        self._cv = make_condition("net.fault.delay")
        self._q: deque = deque()  # (due_monotonic, msg, copies)
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def pending(self) -> bool:
        return bool(self._q)

    def push(self, msg: Any, copies: int, delay_s: float) -> None:
        with self._cv:
            if self._closed:
                return
            self._q.append((time.monotonic() + delay_s, msg, copies))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="fault-delay"
                )
                self._thread.start()
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._q.clear()
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                due, msg, copies = self._q[0]
                wait = due - time.monotonic()
                if wait > 0:
                    self._cv.wait(wait)
                    continue  # re-check head: close may have landed
                self._q.popleft()
            self._deliver(msg, copies)


class FaultDuplex:
    """One side's duplex behind a FaultPlan. `tx` = frames this side
    sends, `rx` = frames delivered to this side; a one-way partition
    blocks exactly one of them. Close/identity/binding delegate to the
    wrapped transport. Delayed frames ride per-direction FIFO delay
    lines (latency never reorders)."""

    def __init__(
        self,
        inner: Any,
        plan: FaultPlan,
        stats: Optional[Dict[str, int]] = None,
    ) -> None:
        self._inner = inner
        self.plan = plan
        self.stats = stats if stats is not None else _new_stats()
        from ..utils.queue import Queue

        # rx delivery rides the stack's single-subscriber Queue: items
        # buffered before subscribe drain IN ORDER and callbacks are
        # never concurrent — a hand-rolled buffer replayed outside a
        # lock can interleave a live frame ahead of buffered ones
        self._rx_q: "Queue" = Queue("fault:rx")
        self._tx_line = _DelayLine(self._tx_now)
        self._rx_line = _DelayLine(self._rx_now)
        inner.on_close(self._on_inner_close)
        inner.on_message(self._on_rx)

    @property
    def closed(self) -> bool:
        return self._inner.closed

    @property
    def peer_identity(self):
        return getattr(self._inner, "peer_identity", None)

    @property
    def channel_binding(self):
        return getattr(self._inner, "channel_binding", None)

    def on_message(self, cb: Callable[[Any], None]) -> None:
        self._rx_q.subscribe(cb)

    def on_close(self, cb: Callable[[], None]) -> None:
        self._inner.on_close(cb)

    def close(self) -> None:
        self._inner.close()

    def kill(self) -> None:
        """Hard-kill: close the underlying transport (the supervised
        dialer sees a drop and redials)."""
        self.stats["kills"] += 1
        self._inner.close()

    # -- fault application ---------------------------------------------

    def _on_inner_close(self) -> None:
        self._tx_line.close()
        self._rx_line.close()

    def send(self, msg: Any) -> None:
        fate, delay = self.plan.frame_fate(tx=True)
        if fate == DROP:
            self.stats["frames_dropped_injected"] += 1
            return
        if fate == DUP:
            self.stats["frames_duplicated"] += 1
        n = 2 if fate == DUP else 1
        if delay > 0 or self._tx_line.pending():
            # pending() keeps FIFO across a clean transition: an
            # undelayed frame must not overtake queued delayed ones
            if delay > 0:
                self.stats["frames_delayed"] += 1
            self._tx_line.push(msg, n, delay)
        else:
            self._tx_now(msg, n)

    def _tx_now(self, msg: Any, n: int) -> None:
        for _ in range(n):
            self._inner.send(msg)

    def _on_rx(self, msg: Any) -> None:
        fate, delay = self.plan.frame_fate(tx=False)
        if fate == DROP:
            self.stats["frames_dropped_injected"] += 1
            return
        if fate == DUP:
            self.stats["frames_duplicated"] += 1
        n = 2 if fate == DUP else 1
        if delay > 0 or self._rx_line.pending():
            if delay > 0:
                self.stats["frames_delayed"] += 1
            self._rx_line.push(msg, n, delay)
        else:
            self._rx_now(msg, n)

    def _rx_now(self, msg: Any, n: int) -> None:
        for _ in range(n):
            self._rx_q.push(msg)


def _new_stats() -> Dict[str, int]:
    return {
        "frames_dropped_injected": 0,
        "frames_duplicated": 0,
        "frames_delayed": 0,
        "kills": 0,
    }


class FaultSwarm(Swarm):
    """Swarm wrapper: every connection rides a FaultDuplex on the
    shared plan. `tick()` advances the plan deterministically (tests);
    `start_ticker()` advances it on a wall-clock timer (bench/soak,
    started automatically when the plan came from HM_FAULT)."""

    def __init__(self, inner: Swarm, plan: FaultPlan) -> None:
        self.inner = inner
        self.plan = plan
        self.stats = _new_stats()
        self._lock = make_lock("net.fault.swarm")
        self._live: List[FaultDuplex] = []
        self._cb: Optional[Callable] = None
        self._ticker: Optional[threading.Thread] = None
        self._destroyed = threading.Event()
        inner.on_connection(self._on_inner_connection)

    # -- passthrough ----------------------------------------------------

    @property
    def address(self):
        return self.inner.address

    def set_identity(self, seed) -> None:
        self.inner.set_identity(seed)

    def set_need_hook(self, fn) -> None:
        """Demand-driven lookup passthrough (DhtSwarm under faults)."""
        inner = getattr(self.inner, "set_need_hook", None)
        if inner is not None:
            inner(fn)

    def set_seed_hook(self, fn) -> None:
        """Push-seed receiver passthrough (DhtSwarm under faults)."""
        inner = getattr(self.inner, "set_seed_hook", None)
        if inner is not None:
            inner(fn)

    def discovery_report(self):
        """DHT introspection passthrough (DhtSwarm under faults)."""
        fn = getattr(self.inner, "discovery_report", None)
        return fn() if fn is not None else None

    @property
    def supervisor(self):
        """Redial-supervisor passthrough (Tcp/DhtSwarm under faults)."""
        return getattr(self.inner, "supervisor", None)

    def join(self, discovery_id: str, options=None) -> None:
        if options is None:
            self.inner.join(discovery_id)
        else:
            self.inner.join(discovery_id, options)

    def leave(self, discovery_id: str) -> None:
        self.inner.leave(discovery_id)

    def connect(self, *args: Any, **kwargs: Any):
        return self.inner.connect(*args, **kwargs)

    def on_connection(self, cb) -> None:
        self._cb = cb

    def destroy(self) -> None:
        self._destroyed.set()
        self.inner.destroy()

    # -- fault wiring ---------------------------------------------------

    def _on_inner_connection(
        self, duplex: Any, details: ConnectionDetails
    ) -> None:
        fd = FaultDuplex(duplex, self.plan, self.stats)
        with self._lock:
            self._live.append(fd)
        fd.on_close(lambda: self._untrack(fd))
        if self.plan.down:
            # the link is dead this window: the connection dies before
            # the stack sees it, and the supervisor's backoff retries
            log("net:faults", "link down: killing new connection")
            fd.kill()
            return
        if self._cb is not None:
            self._cb(fd, details)

    def _untrack(self, fd: FaultDuplex) -> None:
        with self._lock:
            try:
                self._live.remove(fd)
            except ValueError:
                pass

    def live_connections(self) -> List[FaultDuplex]:
        with self._lock:
            return list(self._live)

    def tick(self, n: int = 1) -> List[str]:
        """Advance the plan `n` ticks and apply fired link events."""
        fired = self.plan.advance(n)
        if KILL in fired:
            for fd in self.live_connections():
                fd.kill()
        return fired

    def start_ticker(self) -> None:
        """Wall-clock tick advancement (plan.tick_ms) for bench/soak."""
        if self._ticker is not None:
            return

        def run() -> None:
            while not self._destroyed.wait(self.plan.tick_ms / 1e3):
                self.tick()

        self._ticker = threading.Thread(
            target=run, daemon=True, name="fault-ticker"
        )
        self._ticker.start()
