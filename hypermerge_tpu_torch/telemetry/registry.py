"""Process-wide metrics registry: counters, gauges, histograms.

One registry instrument per process (the module-level ``REGISTRY``),
shared by every subsystem — live engine ticks, pipeline stage busy,
mesh dispatches, replication frames, fsync barriers all land in the
same namespace, so one snapshot answers "what is this daemon doing"
without scraping N private stats dicts.

Design constraints, in order:

- Hot-path writes must be lock-cheap. ``Counter.add`` bumps a cell
  owned by the CALLING thread (a dict lookup plus one attribute ``+=``
  on an object no other thread writes — safe under the GIL); only the
  first add from a new thread takes a lock, to install the shard.
  Reads merge the shards. Concurrent adds are therefore EXACT, which
  is also the fix for the unlocked read-modify-write races the old
  ad-hoc stats dicts carried (``stats["t_resync_ms"] +=`` from reader
  threads).
- Series are keyed (name, labels). Components that need per-instance
  exactness (two repos in one process must not blur each other's
  ``adopted`` count) label their series with an instance tag
  (``next_instance``) and keep handles; process-level views aggregate
  across labels by name (``snapshot``).
- Values are plain Python numbers: ints for event counts, float
  seconds/bytes for accumulators. ``snapshot`` preserves int-ness so
  JSON output stays bit-compatible with the dicts it replaced.
"""

from __future__ import annotations

import itertools
import threading
from bisect import bisect_left
from threading import get_ident
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..analysis import hierarchy, lockdep
from ..analysis.lockdep import make_lock

LabelsT = Tuple[Tuple[str, str], ...]

# the dotted `subsystem.metric` convention (telemetry/__init__.py):
# tools/top.py groups per-subsystem rates by the prefix, so a flat or
# oddly-cased name silently falls out of every view. Checked statically
# by the `telemetry-name` lint rule where the name is a literal, and
# here at creation time when runtime lockdep is on (HM_LOCKDEP=1) for
# the dynamically-built names the linter cannot see. The pattern is
# shared with the linter (analysis/hierarchy.py) so the two halves of
# the rule cannot drift.
_NAME_RE = hierarchy.TELEMETRY_NAME_RE


def _check_name(name: str) -> None:
    if lockdep.enabled() and not _NAME_RE.match(name):
        raise ValueError(
            f"telemetry series {name!r} breaks the dotted "
            f"`subsystem.metric` naming convention"
        )


class _Cell:
    __slots__ = ("v",)

    def __init__(self) -> None:
        self.v = 0.0


class Counter:
    """Monotone accumulator (event counts, seconds, bytes).

    ``add`` is exact under concurrency without a hot-path lock: each
    thread owns one shard cell (thread idents are reused after a thread
    dies, which only re-targets the dead thread's cell — cumulative
    totals stay exact)."""

    __slots__ = ("name", "labels", "_shards", "_lock")
    kind = "counter"

    def __init__(self, name: str, labels: LabelsT = ()) -> None:
        self.name = name
        self.labels = labels
        self._shards: Dict[int, _Cell] = {}
        self._lock = make_lock("telemetry.shard")

    def add(self, v: float = 1) -> None:
        ident = get_ident()
        cell = self._shards.get(ident)
        if cell is None:
            with self._lock:
                cell = self._shards.setdefault(ident, _Cell())
        cell.v += v

    inc = add

    def value(self) -> float:
        # list() snapshots against a concurrent shard install; the 0.0
        # start keeps untouched counters FLOAT (the migrated stats
        # dicts' time keys were 0.0, and bench JSON must stay
        # bit-compatible)
        return sum((c.v for c in list(self._shards.values())), 0.0)


class Gauge:
    """Last-value instrument (queue depth, resident bytes). ``set`` is
    one attribute assignment (atomic under the GIL); ``add`` takes the
    lock — use counters for high-rate accumulation."""

    __slots__ = ("name", "labels", "_v", "_lock")
    kind = "gauge"

    def __init__(self, name: str, labels: LabelsT = ()) -> None:
        self.name = name
        self.labels = labels
        self._v: float = 0
        self._lock = make_lock("telemetry.shard")

    def set(self, v: float) -> None:
        self._v = v

    def add(self, v: float = 1) -> None:
        with self._lock:
            self._v += v

    def value(self) -> float:
        return self._v


class _HistCell:
    __slots__ = ("counts", "sum", "n")

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.n = 0


# seconds: 100µs .. ~100s, the spread of every stage this repo times
DEFAULT_TIME_BUCKETS_S = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
    10.0, 60.0,
)


class Histogram:
    """Fixed-bucket histogram (upper bounds + implicit +Inf), sharded
    per thread like Counter so concurrent observes stay exact."""

    __slots__ = ("name", "labels", "buckets", "_shards", "_lock")
    kind = "histogram"

    def __init__(
        self,
        name: str,
        buckets: Iterable[float] = DEFAULT_TIME_BUCKETS_S,
        labels: LabelsT = (),
    ) -> None:
        self.name = name
        self.labels = labels
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self._shards: Dict[int, _HistCell] = {}
        self._lock = make_lock("telemetry.shard")

    def observe(self, v: float) -> None:
        ident = get_ident()
        cell = self._shards.get(ident)
        if cell is None:
            with self._lock:
                cell = self._shards.setdefault(
                    ident, _HistCell(len(self.buckets) + 1)
                )
        cell.counts[bisect_left(self.buckets, v)] += 1
        cell.sum += v
        cell.n += 1

    def value(self) -> Dict[str, Any]:
        """Merged view: per-bucket counts (not cumulative), sum, count."""
        counts = [0] * (len(self.buckets) + 1)
        total = 0.0
        n = 0
        for cell in list(self._shards.values()):
            for i, c in enumerate(cell.counts):
                counts[i] += c
            total += cell.sum
            n += cell.n
        return {"buckets": counts, "sum": total, "count": n}


def _labels_key(labels: Dict[str, Any]) -> LabelsT:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """The process-wide series table. ``counter``/``gauge``/``histogram``
    get-or-create, so callers may either cache handles (hot paths do)
    or re-resolve by name (tools do)."""

    def __init__(self) -> None:
        self._lock = make_lock("telemetry.table")
        self._series: Dict[Tuple[str, str, LabelsT], Any] = {}

    # -- get-or-create -------------------------------------------------

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(
        self,
        name: str,
        buckets: Iterable[float] = DEFAULT_TIME_BUCKETS_S,
        **labels: Any,
    ) -> Histogram:
        _check_name(name)
        key = ("histogram", name, _labels_key(labels))
        with self._lock:
            m = self._series.get(key)
            if m is None:
                m = self._series[key] = Histogram(
                    name, buckets, key[2]
                )
            return m

    def _get(self, kind: str, cls, name: str, labels: Dict) -> Any:
        _check_name(name)
        key = (kind, name, _labels_key(labels))
        with self._lock:
            m = self._series.get(key)
            if m is None:
                m = self._series[key] = cls(name, key[2])
            return m

    # -- read side -----------------------------------------------------

    def series(self) -> List[Any]:
        with self._lock:
            return list(self._series.values())

    def snapshot(self) -> Dict[str, Any]:
        """name -> merged value, aggregated ACROSS label sets (the
        process-level view: two repos' ``live.ticks`` sum). Counters
        and gauges sum; histograms surface as ``<name>.count`` and
        ``<name>.sum``. Integral values stay ints so embedding the
        snapshot in a JSON line round-trips bit-identically."""
        out: Dict[str, Any] = {}
        for m in self.series():
            if m.kind == "histogram":
                v = m.value()
                out[m.name + ".count"] = (
                    out.get(m.name + ".count", 0) + v["count"]
                )
                out[m.name + ".sum"] = round(
                    out.get(m.name + ".sum", 0.0) + v["sum"], 6
                )
            else:
                out[m.name] = _num(out.get(m.name, 0) + m.value())
        return dict(sorted(out.items()))

    def retire(self, *metrics: Any) -> None:
        """Fold a CLOSED component's labeled series into an
        ``inst="closed"`` aggregate and drop them from the table.
        Components that open and close freely (one engine per repo, one
        replication manager per network) call this from their close
        path so a long-lived process does not grow the registry by a
        label set per lifecycle — while ``snapshot()`` keeps the
        process totals. The component's cached handles stay readable
        (its ``stats`` view is handle-based), they just stop being
        listed."""
        closed = (("inst", "closed"),)
        with self._lock:
            for m in metrics:
                key = (m.kind, m.name, m.labels)
                if self._series.get(key) is not m:
                    continue  # reset/replaced already
                del self._series[key]
                if m.kind != "counter":
                    continue  # a dead gauge's last value is noise
                v = m.value()
                if not v:
                    continue
                akey = ("counter", m.name, closed)
                agg = self._series.get(akey)
                if agg is None:
                    agg = self._series[akey] = Counter(m.name, closed)
                agg.add(v)

    def reset(self) -> None:
        """Zero every series IN PLACE (tests/embedding apps isolating
        runs). The table keeps its entries, so module-level cached
        handles (net.tcp.*, pipeline.*, storage.* are created once at
        import) stay live and visible afterwards — dropping them would
        blind those subsystems for the process lifetime. An add racing
        the reset on another thread may be lost; this is a measurement
        hook, not a synchronization point."""
        with self._lock:
            for m in self._series.values():
                if m.kind == "gauge":
                    m.set(0)
                else:
                    m._shards.clear()


def _num(v: float) -> Any:
    """ints stay ints; floats round to 6 (stable JSON)."""
    if isinstance(v, float):
        if v.is_integer():
            return int(v)
        return round(v, 6)
    return v


REGISTRY = MetricsRegistry()

_instances = itertools.count(1)


def next_instance() -> int:
    """A process-unique instance tag for per-component label sets
    (two RepoBackends in one process must not blur each other's
    per-engine stats)."""
    return next(_instances)
