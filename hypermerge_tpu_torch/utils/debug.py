"""Namespaced debug logging + micro-bench timers.

Mirrors the reference's observability story (SURVEY.md §5): the `debug`
library with per-component namespaces gated by the DEBUG env var (reference
src/Debug.ts:1-8, src/RepoBackend.ts:42), plus per-apply wall-clock timers
(reference src/DocBackend.ts:207-212). Timers additionally aggregate into a
process-wide registry that bench.py reads.
"""

from __future__ import annotations

import fnmatch
import os
import re
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, Tuple

from ..analysis.lockdep import make_lock

# Patterns re-resolve at CALL time, not import time: a daemon can
# toggle namespaces without a restart, either programmatically
# (set_patterns) or by mutating os.environ["DEBUG"] — the env string
# is compared each call (one dict lookup) and only re-parsed on
# change. set_patterns() overrides the env until set_patterns(None).
_env_cache: str = ""
_env_patterns: list = []
_override: "list | None" = None
_patterns_lock = make_lock("util.debug")


def _parse(spec: str) -> list:
    return [p for p in re.split(r"[\s,]+", spec) if p]


def set_patterns(spec=None) -> None:
    """Set the active DEBUG patterns at runtime. ``spec`` is a
    DEBUG-style string ("live,net:*") or an iterable of patterns;
    ``None`` returns control to the DEBUG env var."""
    global _override
    if spec is None:
        _override = None
    elif isinstance(spec, str):
        _override = _parse(spec)
    else:
        _override = [str(p) for p in spec]


def _current_patterns() -> list:
    if _override is not None:
        return _override
    global _env_cache, _env_patterns
    env = os.environ.get("DEBUG", "")
    if env != _env_cache:
        with _patterns_lock:
            if env != _env_cache:
                _env_patterns = _parse(env)
                _env_cache = env
    return _env_patterns


def enabled(namespace: str) -> bool:
    return any(
        fnmatch.fnmatch(namespace, pat) for pat in _current_patterns()
    )


def log(namespace: str, *args: Any) -> None:
    if enabled(namespace):
        print(f"[{namespace}]", *args, file=sys.stderr)


def trace(label: str) -> Callable[..., Any]:
    """Logging combinator: returns a fn that logs its args and returns the
    first one (reference src/Debug.ts trace)."""

    def _trace(first: Any = None, *rest: Any) -> Any:
        log("trace", label, first, *rest)
        return first

    return _trace


# -- timers ----------------------------------------------------------------

_TIMINGS: Dict[str, Tuple[int, float]] = defaultdict(lambda: (0, 0.0))
_TIMINGS_LOCK = make_lock("util.debug")


@contextmanager
def bench(label: str) -> Iterator[None]:
    """Wall-clock one section; aggregates (count, total_seconds) per label
    (reference src/DocBackend.ts:207-212 logs per-apply ms; we also keep a
    cumulative registry like src/Metadata.ts:244-251)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _TIMINGS_LOCK:
            count, total = _TIMINGS[label]
            _TIMINGS[label] = (count + 1, total + dt)
        log("bench", f"{label}: {dt * 1e3:.3f}ms")


def timings() -> Dict[str, Tuple[int, float]]:
    return dict(_TIMINGS)


def reset_timings() -> None:
    _TIMINGS.clear()
