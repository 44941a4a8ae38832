"""Bounded structured-trace ring buffer of spans.

Spans are begin/end windows with tags, recorded into a fixed-capacity
ring (HM_TRACE_RING events, default 65536) — a long-running daemon
keeps the LAST N events, never unbounded memory. Export renders
Chrome trace-event JSON (load the file in Perfetto / chrome://tracing)
via telemetry.export.

Off by default and cheap when off: ``span()`` checks one module flag
and returns a shared no-op singleton — no object allocation, no
timestamp read. Enable with:

- ``HM_TRACE=<path>`` in the environment (read at import): tracing on
  for the process lifetime, the trace file written at exit (atexit)
  and on explicit ``flush()``.
- ``enable(path=None)`` at runtime (tests, tools). ``path=None`` keeps
  the ring in memory only (``events()`` reads it).

Recording is lock-free on the hot path: a global monotone sequence
(itertools.count — atomic in CPython) claims a slot, and the slot
assignment is a single list-item store. Wraparound overwrites the
oldest slot; ``events()`` reorders by sequence.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# event tuples: (seq implicit via slot, ph, name, cat, ts_us, dur_us,
# tid, args) — converted to Chrome dicts at export time (export.py)
EventT = Tuple[str, str, str, float, float, int, Optional[Dict]]


def _ring_capacity() -> int:
    try:
        return max(16, int(os.environ.get("HM_TRACE_RING", "65536")))
    except ValueError:
        return 65536


class _Ring:
    __slots__ = ("cap", "_buf", "_seq")

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self._buf: List[Optional[Tuple[int, EventT]]] = [None] * cap
        self._seq = itertools.count()

    def add(self, ev: EventT) -> None:
        i = next(self._seq)  # atomic claim
        self._buf[i % self.cap] = (i, ev)

    def events(self) -> List[EventT]:
        got = [s for s in list(self._buf) if s is not None]
        got.sort(key=lambda s: s[0])
        return [ev for _i, ev in got]

    def __len__(self) -> int:
        return sum(1 for s in self._buf if s is not None)


class _Tracer:
    def __init__(self) -> None:
        self.on = False
        self.path: Optional[str] = None
        self.ring = _Ring(_ring_capacity())
        self.t0 = time.perf_counter()
        self.tid_names: Dict[int, str] = {}
        self._tid_seen = threading.local()
        self._atexit = False


_T = _Tracer()


def enabled() -> bool:
    return _T.on


def enable(path: Optional[str] = None, capacity: Optional[int] = None):
    """Turn tracing on (idempotent). ``path`` is where ``flush()`` and
    the atexit hook write the Chrome trace; None keeps the ring
    memory-only."""
    if capacity is not None:
        _T.ring = _Ring(max(16, capacity))
    if path:
        _T.path = path
        if not _T._atexit:
            import atexit

            atexit.register(_atexit_flush)
            _T._atexit = True
    _T.on = True


def disable() -> None:
    _T.on = False


def reset() -> None:
    """Drop recorded events (tests); keeps the enabled flag/path."""
    _T.ring = _Ring(_T.ring.cap)
    _T.tid_names.clear()
    # threads must RE-register their names (the per-thread seen flag
    # would otherwise leave post-reset exports without thread labels)
    _T._tid_seen = threading.local()


def _note_thread() -> int:
    tid = threading.get_ident()
    seen = getattr(_T._tid_seen, "done", False)
    if not seen:
        _T.tid_names[tid] = threading.current_thread().name
        _T._tid_seen.done = True
    return tid


class SpanHandle:
    """An open span: ``end()`` records it. Use via ``span()`` as a
    context manager, or ``begin()``/``end()`` across seams where the
    window opens and closes on different code paths."""

    __slots__ = ("name", "cat", "t0", "args")

    def __init__(self, name: str, cat: str, args: Optional[Dict]):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = time.perf_counter()

    def end(self, **more: Any) -> None:
        if not _T.on:
            return
        t1 = time.perf_counter()
        args = self.args
        if more:
            args = {**(args or {}), **more}
        _T.ring.add((
            "X",
            self.name,
            self.cat,
            (self.t0 - _T.t0) * 1e6,
            (t1 - self.t0) * 1e6,
            _note_thread(),
            args,
        ))

    # context-manager protocol (what span() hands out when enabled)
    def __enter__(self) -> "SpanHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NoopSpan:
    """The shared disabled span: no allocation, no clock read."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def end(self, **more: Any) -> None:
        pass


NOOP = _NoopSpan()


def span(name: str, cat: str = "", **args: Any):
    """A context manager timing one section into the ring. Disabled
    tracing returns the shared no-op singleton."""
    if not _T.on:
        return NOOP
    return SpanHandle(name, cat, args or None)


def begin(name: str, cat: str = "", **args: Any):
    """Open a span to be closed by ``handle.end()`` later (possibly on
    another code path). Disabled tracing returns the no-op handle."""
    if not _T.on:
        return NOOP
    return SpanHandle(name, cat, args or None)


def instant(name: str, cat: str = "", **args: Any) -> None:
    """A point event (demotions, resync closures, faults)."""
    if not _T.on:
        return
    _T.ring.add((
        "i",
        name,
        cat,
        (time.perf_counter() - _T.t0) * 1e6,
        0.0,
        _note_thread(),
        args or None,
    ))


def events() -> List[EventT]:
    """Recorded events, oldest first (ring order)."""
    return _T.ring.events()


def event_count() -> int:
    return len(_T.ring)


def trace_path() -> Optional[str]:
    return _T.path


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write the ring as Chrome trace JSON to ``path`` (default: the
    enable()/HM_TRACE path). Returns the path written, or None when
    there is nowhere to write."""
    out = path or _T.path
    if out is None:
        return None
    from .export import write_chrome_trace

    write_chrome_trace(out, events(), dict(_T.tid_names))
    return out


def _atexit_flush() -> None:
    try:
        flush()
    except Exception:
        pass  # never fail interpreter shutdown over a trace file


def _maybe_enable_from_env() -> None:
    v = os.environ.get("HM_TRACE", "")
    if v and v != "0":
        # HM_TRACE=<path>: run-long trace file. A bare "1" enables the
        # in-memory ring without a file.
        enable(None if v == "1" else v)


_maybe_enable_from_env()
