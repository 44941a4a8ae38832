"""The service plane: signal-driven overload control at the front door
(the port of hypermerge_tpu/serve/overload.py).

Every other plane defends itself against one failure mode — the serve
tier against device OOM, the WAL against crashes, the swarm against
churn — but nothing defends the PROCESS when offered load exceeds
capacity. This module is that defense: a three-state **brownout
ladder** driven by what the repo already measures, enforced at the one
place every read passes (``RepoBackend.read_doc``) and the one place
every durable write acks (the WAL group-commit gather).

States, in shed order (cheapest degradation first):

- ``HEALTHY`` — everything admitted, nothing deferred.
- ``BROWNOUT`` — cold installs shed first: reads of unresident docs
  answer from the host memo path and their device installs are
  deferred (serve/tier.py consults ``defer_install``); anti-entropy
  sweeps and gossip relay are deprioritized (net/replication.py,
  net/discovery/gossip.py). Hot resident reads are untouched.
- ``SHED`` — per-tenant token-bucket quotas enforced at the front
  door; excess reads are REFUSED with a typed Overload reply carrying
  retry-after (never an error, never a silent drop); durable writes
  are BACKPRESSURED — ``ack_extra_s`` stretches the WAL group-commit
  gather window so acks pace down — but are never dropped once acked.

Transitions use hysteresis (``HM_BROWNOUT_UP_TICKS`` consecutive
ticks over the high watermark to escalate, ``HM_BROWNOUT_DOWN_TICKS``
under the low watermark to de-escalate) so a noisy signal cannot flap
the ladder. The pressure signal is the max of three normalized feeds:
serve read p99 over its SLO, admission-queue occupancy, and WAL fsync
debt — injectable (``signals=``) so tests drive the state machine
deterministically without load.

Every decision is attributable: transitions and refusals are counters
plus trace instants tagged per tenant; ``report()`` is the
``service`` block of the Telemetry payload (tools/top.py ``[service]``
group, tools/ls.py status line, bench gating). No silent refusals.

This module imports no torch on purpose: frontend processes import the
``Overload`` exception without pulling the kernel stack (serve's
package ``__init__`` is lazy for the same reason).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from .. import telemetry
from ..analysis.lockdep import make_lock

HEALTHY, BROWNOUT, SHED = 0, 1, 2
STATE_NAMES = ("healthy", "brownout", "shed")

# bound of the per-tenant table: beyond this many distinct tenants the
# least-recently-seen row is evicted (its bucket refills from scratch
# if it returns) — the controller must not grow without bound on a
# tenant-id flood
MAX_TENANTS = 256


class Overload(RuntimeError):
    """A typed refusal from the front door.

    Raised by the blocking ``Repo.read`` path when the backend answers
    with an overload payload instead of a value; carries everything a
    well-behaved client needs to back off."""

    def __init__(
        self,
        retry_after_s: float,
        state: str = "shed",
        tenant: Optional[str] = None,
    ) -> None:
        super().__init__(
            f"overloaded ({state}): retry after {retry_after_s:.3f}s"
        )
        self.retry_after_s = retry_after_s
        self.state = state
        self.tenant = tenant


def overload_error(info: Dict[str, Any]) -> Overload:
    """The ``{"overload": {...}}`` reply payload, as an exception."""
    return Overload(
        float(info.get("retry_after_s", 0.1)),
        str(info.get("state", "shed")),
        info.get("tenant"),
    )


class TokenBucket:
    """Per-tenant read quota: ``rate`` tokens/s up to ``burst``.

    Deterministic on purpose — every method takes ``now`` so tests
    drive refill with a fake clock. Not thread-safe by itself; the
    controller serializes access under ``serve.overload``."""

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float, burst: float, now: float = 0.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t = now

    def _refill(self, now: float) -> None:
        if now > self._t:
            self.tokens = min(
                self.burst, self.tokens + (now - self._t) * self.rate
            )
            self._t = now

    def take(self, now: float, n: float = 1.0) -> bool:
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def occupancy(self, now: float) -> float:
        """Fraction of burst currently SPENT (1.0 = exhausted)."""
        self._refill(now)
        return 1.0 - (self.tokens / self.burst if self.burst else 0.0)

    def retry_after_s(self, now: float, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available."""
        self._refill(now)
        if self.tokens >= n or self.rate <= 0:
            return 0.0
        return (n - self.tokens) / self.rate


class HistogramWindow:
    """Quantile of a telemetry Histogram's observations since the
    LAST sample — the controller's p99 feed. Windowed on purpose: a
    cumulative quantile would never step back down after one spike,
    and the de-escalation half of the hysteresis needs the signal to
    recover when the storm passes. Single-caller (the ticker)."""

    __slots__ = ("_hist", "_prev")

    def __init__(self, hist: Any) -> None:
        self._hist = hist
        self._prev: Optional[list] = None

    def quantile(self, q: float = 0.99) -> float:
        counts = self._hist.value()["buckets"]
        prev = self._prev
        self._prev = counts
        delta = (
            counts if prev is None
            else [c - p for c, p in zip(counts, prev)]
        )
        n = sum(delta)
        if n <= 0:
            return 0.0
        bounds = self._hist.buckets
        run = 0
        for i, c in enumerate(delta):
            run += c
            if run >= q * n:
                # the overflow bucket has no upper bound; report one
                # step past the last edge so the signal still moves
                return bounds[i] if i < len(bounds) else bounds[-1] * 2
        return bounds[-1] * 2


class BrownoutLadder:
    """The pure three-state machine with hysteresis; no clocks, no
    locks, no telemetry — ``observe(pressure)`` per tick returns the
    (possibly new) state. Escalates one rung after ``up_ticks``
    consecutive observations at/above ``hi``; de-escalates one rung
    after ``down_ticks`` consecutive observations at/below ``lo``;
    anything between the watermarks holds the rung and resets both
    streaks (that dead band is what prevents flapping)."""

    __slots__ = ("hi", "lo", "up_ticks", "down_ticks", "state",
                 "_up", "_down")

    def __init__(
        self,
        hi: float = 1.0,
        lo: float = 0.5,
        up_ticks: int = 3,
        down_ticks: int = 10,
    ) -> None:
        if lo >= hi:
            raise ValueError("brownout lo watermark must be < hi")
        self.hi = hi
        self.lo = lo
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.state = HEALTHY
        self._up = 0
        self._down = 0

    def observe(self, pressure: float) -> int:
        if pressure >= self.hi:
            self._up += 1
            self._down = 0
            if self._up >= self.up_ticks and self.state < SHED:
                self.state += 1
                self._up = 0
        elif pressure <= self.lo:
            self._down += 1
            self._up = 0
            if self._down >= self.down_ticks and self.state > HEALTHY:
                self.state -= 1
                self._down = 0
        else:
            self._up = 0
            self._down = 0
        return self.state


class OverloadController:
    """One per backend: ties signals -> ladder -> enforcement.

    ``signals`` is a zero-arg callable returning a dict with any of
    ``p99_s`` (serve read p99, seconds), ``queue_frac`` (admission
    queue occupancy 0..1+), ``debt_frac`` (WAL fsync debt over its
    rotation budget, 0..1+); the backend wires the real feeds, tests
    inject synthetic ones. Pressure is the max of the normalized
    three; ``tick()`` may be called directly (deterministic tests) or
    from the background ticker (``start``)."""

    def __init__(
        self,
        signals: Optional[Callable[[], Dict[str, float]]] = None,
        now: Optional[Callable[[], float]] = None,
    ) -> None:
        self._signals = signals
        self._now = now or time.monotonic
        self._slo_s = (
            float(os.environ.get("HM_SERVICE_P99_SLO_MS", "50")) / 1e3
        )
        self._tick_s = (
            float(os.environ.get("HM_SERVICE_TICK_MS", "50")) / 1e3
        )
        self._retry_s = (
            float(os.environ.get("HM_SERVICE_RETRY_AFTER_MS", "100"))
            / 1e3
        )
        self._stretch_s = (
            float(os.environ.get("HM_SERVICE_ACK_STRETCH_MS", "25"))
            / 1e3
        )
        self._rate = float(os.environ.get("HM_QUOTA_READS_S", "512"))
        self._burst = float(os.environ.get("HM_QUOTA_BURST", "64"))
        self._ladder = BrownoutLadder(
            hi=float(os.environ.get("HM_BROWNOUT_HI", "1.0")),
            lo=float(os.environ.get("HM_BROWNOUT_LO", "0.5")),
            up_ticks=int(os.environ.get("HM_BROWNOUT_UP_TICKS", "3")),
            down_ticks=int(
                os.environ.get("HM_BROWNOUT_DOWN_TICKS", "10")
            ),
        )
        force = os.environ.get("HM_SERVICE_FORCE")
        self._force = (
            STATE_NAMES.index(force) if force in STATE_NAMES else None
        )
        self._lock = make_lock("serve.overload")
        self._state = self._force if self._force is not None else HEALTHY
        self._pressure = 0.0
        self._last: Dict[str, float] = {}
        self._tenants: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        reg = telemetry.REGISTRY
        inst = str(telemetry.next_instance())
        self._m: Dict[str, Any] = {
            k: reg.counter("service." + k, inst=inst)
            for k in (
                "transitions", "shed_reads", "brownout_reads",
                "deferred_installs", "admitted_reads",
                "deprioritized_sweeps", "deprioritized_gossip",
            )
        }
        for k in ("state", "pressure", "ack_stretch_ms"):
            self._m[k] = reg.gauge("service." + k, inst=inst)
        self._m["state"].set(self._state)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        """Start the background ticker (idempotent; no-op when the
        state is pinned by HM_SERVICE_FORCE or no signals are wired)."""
        with self._lock:
            if (self._thread is not None or self._closed
                    or self._signals is None
                    or self._force is not None):
                return
            t = threading.Thread(
                target=self._run, name="hm-overload", daemon=True
            )
            self._thread = t
        t.start()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=2.0)

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
            self.tick()
            time.sleep(self._tick_s)

    # -- the ladder ----------------------------------------------------

    def tick(self, sig: Optional[Dict[str, float]] = None) -> int:
        """One controller step: read signals, fold to pressure, feed
        the ladder, publish. Returns the (possibly new) state. Tests
        may pass ``sig`` directly instead of wiring ``signals``."""
        if sig is None:
            sig = self._signals() if self._signals is not None else {}
        p99 = float(sig.get("p99_s", 0.0))
        pressure = max(
            p99 / self._slo_s if self._slo_s > 0 else 0.0,
            float(sig.get("queue_frac", 0.0)),
            float(sig.get("debt_frac", 0.0)),
        )
        with self._lock:
            self._last = dict(sig)
            self._pressure = pressure
            prev = self._state
            if self._force is not None:
                new = self._force
            else:
                new = self._ladder.observe(pressure)
            self._state = new
        self._m["pressure"].set(round(pressure, 4))
        if new != prev:
            self._m["transitions"].add(1)
            self._m["state"].set(new)
            self._m["ack_stretch_ms"].set(
                round(self._stretch_s * 1e3, 3) if new >= SHED else 0
            )
            telemetry.instant(
                "service.transition", cat="service",
                frm=STATE_NAMES[prev], to=STATE_NAMES[new],
                pressure=round(pressure, 4),
            )
        return new

    def state(self) -> int:
        # GIL-atomic snapshot (atomic_read_ok): the hot-path question
        # "are we shedding" must not take the controller lock
        return self._state

    # -- enforcement seams ---------------------------------------------

    def admit_read(
        self, tenant: Optional[str], now: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        """The front door: None = admitted; a dict = the typed
        ``{"overload": {...}}`` reply payload (SHED state, tenant over
        quota). Counts every outcome so refusals are attributable."""
        if self._state < SHED:
            return None
        t = tenant or "local"
        if now is None:
            now = self._now()
        with self._lock:
            row = self._tenant_row(t, now)
            if row["bucket"].take(now):
                row["admitted"] += 1
                self._m["admitted_reads"].add(1)
                return None
            row["refused"] += 1
            retry = max(
                self._retry_s, row["bucket"].retry_after_s(now)
            )
        return self._refusal(t, retry)

    def refuse_overflow(
        self, tenant: Optional[str] = None, now: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        """The admission seam for batcher-queue overflow
        (serve/tier.py): below SHED the caller degrades to the host
        path; in SHED the read is refused typed — the queue, not the
        quota, is the binding constraint, so no token is charged."""
        if self._state < SHED:
            return None
        t = tenant or "local"
        if now is None:
            now = self._now()
        with self._lock:
            row = self._tenant_row(t, now)
            row["refused"] += 1
            retry = max(
                self._retry_s, row["bucket"].retry_after_s(now)
            )
        return self._refusal(t, retry)

    def _refusal(self, tenant: str, retry: float) -> Dict[str, Any]:
        self._m["shed_reads"].add(1)
        telemetry.instant(
            "service.shed", cat="service", tenant=tenant,
            retry_after_s=round(retry, 4),
        )
        return {
            "overload": {
                "state": STATE_NAMES[SHED],
                "retry_after_s": round(retry, 4),
                "tenant": tenant,
            }
        }

    def _tenant_row(self, tenant: str, now: float) -> Dict[str, Any]:
        row = self._tenants.get(tenant)
        if row is None:
            row = {
                "bucket": TokenBucket(self._rate, self._burst, now),
                "admitted": 0,
                "refused": 0,
            }
            self._tenants[tenant] = row
            while len(self._tenants) > MAX_TENANTS:
                self._tenants.popitem(last=False)
        else:
            self._tenants.move_to_end(tenant)
        return row

    def defer_install(self, reads: int = 1) -> bool:
        """BROWNOUT+: the serve tier asks before installing a cold
        doc; True = answer its ``reads`` pending reads from the host
        memo path instead (counted as brownout reads plus the one
        deferred install)."""
        if self._state < BROWNOUT:
            return False
        self._m["brownout_reads"].add(reads)
        self._m["deferred_installs"].add(1)
        return True

    def deprioritize(self) -> bool:
        """BROWNOUT+: anti-entropy sweeps and gossip relay yield to
        foreground traffic (callers count their own skip)."""
        return self._state >= BROWNOUT

    def note_skipped_sweep(self) -> None:
        self._m["deprioritized_sweeps"].add(1)

    def note_thinned_gossip(self, n: int = 1) -> None:
        self._m["deprioritized_gossip"].add(n)

    def ack_extra_s(self) -> float:
        """SHED: extra seconds added to the WAL group-commit gather
        window — writes pace down, they are never refused."""
        return self._stretch_s if self._state >= SHED else 0.0

    # -- observability -------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """The ``service`` block of the Telemetry payload."""
        now = self._now()
        with self._lock:
            tenants = {
                t: {
                    "admitted": row["admitted"],
                    "refused": row["refused"],
                    "quota_occupancy": round(
                        row["bucket"].occupancy(now), 4
                    ),
                }
                for t, row in self._tenants.items()
            }
            last = dict(self._last)
            pressure = self._pressure
            state = self._state
        return {
            "state": state,
            "state_name": STATE_NAMES[state],
            "pressure": round(pressure, 4),
            "signals": {k: round(float(v), 6) for k, v in last.items()},
            "transitions": int(self._m["transitions"].value()),
            "shed_reads": int(self._m["shed_reads"].value()),
            "brownout_reads": int(self._m["brownout_reads"].value()),
            "deferred_installs": int(
                self._m["deferred_installs"].value()
            ),
            "ack_stretch_ms": round(self.ack_extra_s() * 1e3, 3),
            "tenants": tenants,
        }
