"""Runtime lockdep: opt-in instrumented locks + potential-deadlock
detection (HM_LOCKDEP=1).

Every lock in the package is created through `make_lock` /
`make_rlock` / `make_condition` with a lock-class name declared in
`analysis/hierarchy.py`. With lockdep OFF (the default) the factories
return plain `threading` primitives — zero overhead, nothing imported
beyond stdlib. With lockdep ON they return `DepLock` wrappers that
record, per thread, the acquisition order of every tracked lock and
maintain one process-global CLASS-level lock-order graph — the Linux
lockdep idea: a single observed A-held-while-acquiring-B edge is
enough to prove the order, so an inverted B->A acquisition on ANY
later run (or the other branch of a race) is reported as a potential
deadlock *without the deadlock ever firing*.

Checks, all reported through `report()` / `assert_clean()`:

- **cycles**: the class graph gains edge (A, B) whenever B is acquired
  with A held; a path B -> ... -> A at insertion time is a potential
  deadlock cycle (two threads interleaving the two chains can wedge).
- **order**: acquiring a RANKED class while holding an equal-or-lower
  ranked one inverts the declared hierarchy (hierarchy.RANKED).
- **leaf**: acquiring ANY tracked lock while holding a leaf class.
- **blocking**: `blocking(kind)` is called from the package's blocking
  seams (io_fsync, sqlite commit, socket sendall, thread joins, queue
  first-waits); reaching one with a no-block class held (the emission
  locks) is a held-across-blocking-call violation.
- **self-deadlock**: re-acquiring a held non-reentrant Lock.
- **unknown-class**: a factory call naming a class missing from the
  manifest (keeps hierarchy.py in sync with the code).

The fault harnesses double as race harnesses: the port's live, chaos,
discovery, service, write-plane and serve-race suites
(tests/test_torch_*.py) run with lockdep and racedep enabled and
assert a clean graph at teardown (see `tests/test_torch_analysis.py`
for the detector's own fixtures and the suites' fixture factories).
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from .hierarchy import ALLOWED_EDGES, BY_NAME, LEAVES, NO_BLOCK, RANKED

_MAX_REPORTS = 200  # bound memory on a pathological run

_enabled = os.environ.get("HM_LOCKDEP", "0") == "1"
# HM_RACEDEP=1: Eraser-style lockset race detection over the guard
# manifest (analysis/guards.py) — see the "racedep" section below.
# Implies lockdep (the per-thread held stacks ARE the lockset input).
_race_enabled = os.environ.get("HM_RACEDEP", "0") == "1"


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    """Flip instrumentation for locks created AFTER this call (tests:
    enable before constructing the repos under test). Existing plain
    locks stay untracked; existing DepLocks stay tracked."""
    global _enabled
    _enabled = on


class _State:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        # class -> set of classes observed acquired while it was held
        self.graph: Dict[str, set] = {}
        self.edge_sites: Dict[Tuple[str, str], str] = {}
        self.cycles: List[Dict[str, Any]] = []
        self.violations: List[Dict[str, Any]] = []
        self._seen_cycles: set = set()
        self._seen_viol: set = set()


_state = _State()
_tls = threading.local()
# every lock class acquired since the last reset (the port's own record:
# a class that never nests under another leaves no edge in the graph)
_seen_classes: set = set()


def _held() -> List[list]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _site(skip: int = 3) -> str:
    """Short code-site witness: innermost non-lockdep frames."""
    frames = traceback.extract_stack()[:-skip]
    tail = frames[-3:]
    return " <- ".join(
        f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
        for f in reversed(tail)
    )


def _record_violation(kind: str, key: tuple, msg: str) -> None:
    with _state.lock:
        if key in _state._seen_viol:
            return
        _state._seen_viol.add(key)
        if len(_state.violations) < _MAX_REPORTS:
            _state.violations.append(
                {"kind": kind, "msg": msg, "site": _site(skip=4)}
            )


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> ... -> dst in the class graph (caller holds
    _state.lock)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _state.graph.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _add_edge(holder: str, acquired: str) -> None:
    with _state.lock:
        succ = _state.graph.setdefault(holder, set())
        if acquired in succ:
            return
        # cycle check BEFORE inserting: a path acquired -> ... -> holder
        # plus this new edge closes a loop
        path = _find_path(acquired, holder)
        succ.add(acquired)
        site = _site(skip=4)
        _state.edge_sites.setdefault((holder, acquired), site)
        if path is not None:
            key = frozenset(path)
            if key not in _state._seen_cycles:
                _state._seen_cycles.add(key)
                if len(_state.cycles) < _MAX_REPORTS:
                    _state.cycles.append(
                        {
                            "cycle": path + [acquired],
                            "edge": (holder, acquired),
                            "site": site,
                            "prior_sites": [
                                _state.edge_sites.get((a, b), "?")
                                for a, b in zip(path, path[1:])
                            ],
                        }
                    )


class DepLock:
    """Instrumented Lock/RLock with per-thread order tracking. Quacks
    like the wrapped primitive, including the private Condition
    protocol (`_is_owned`/`_release_save`/`_acquire_restore`) so
    `threading.Condition(DepLock(...))` works."""

    __slots__ = ("name", "_inner", "_reentrant")

    def __init__(self, name: str, reentrant: bool) -> None:
        self.name = name
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        if name not in BY_NAME:
            _record_violation(
                "unknown-class",
                ("unknown", name),
                f"lock class {name!r} is not declared in "
                f"analysis/hierarchy.py",
            )

    # -- bookkeeping ---------------------------------------------------

    def _pre_acquire(self, held: List[list]) -> None:
        name = self.name
        _seen_classes.add(name)
        my_rank = RANKED.get(name)
        for hname, hinst, _cnt in held:
            if hinst is self:
                continue
            if (hname, name) in ALLOWED_EDGES:
                continue
            if (
                hname in LEAVES
                and name in RANKED
                and name not in LEAVES
            ):
                # scoped to the ranked world: terminal unranked
                # latches (native load-once, fault recorders) are
                # pure sinks a leaf may touch — cycle detection still
                # covers them
                _record_violation(
                    "leaf",
                    ("leaf", hname, name),
                    f"acquiring {name!r} while holding leaf lock "
                    f"{hname!r}",
                )
            hr = RANKED.get(hname)
            if my_rank is not None and hr is not None and hr >= my_rank:
                _record_violation(
                    "order",
                    ("order", hname, name),
                    f"acquiring {name!r} (rank {my_rank}) while "
                    f"holding {hname!r} (rank {hr}) — inverts the "
                    f"declared hierarchy",
                )
            _add_edge(hname, name)

    # -- lock protocol -------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = _held()
        entry = None
        for e in held:
            if e[1] is self:
                entry = e
                break
        if entry is None:
            self._pre_acquire(held)
        elif not self._reentrant:
            _record_violation(
                "self-deadlock",
                ("self", self.name),
                f"re-acquiring held non-reentrant lock {self.name!r} "
                f"on the same thread",
            )
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if entry is not None and self._reentrant:
                entry[2] += 1
            else:
                held.append([self.name, self, 1])
        return ok

    def release(self) -> None:
        self._inner.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                held[i][2] -= 1
                if held[i][2] == 0:
                    del held[i]
                return

    def locked(self) -> bool:
        inner = getattr(self._inner, "locked", None)
        return bool(inner()) if inner is not None else False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<DepLock {self.name!r} {self._inner!r}>"

    # -- Condition protocol --------------------------------------------

    def _is_owned(self):
        inner = getattr(self._inner, "_is_owned", None)
        if inner is not None:
            return inner()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        """Condition.wait: fully release (all recursion levels) and pop
        our held entry — while waiting, the thread does NOT hold this
        lock and must not contribute edges with it."""
        count = 0
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                count = held[i][2]
                del held[i]
                break
        inner = getattr(self._inner, "_release_save", None)
        if inner is not None:
            st = inner()
        else:
            self._inner.release()
            st = None
        return (st, count)

    def _acquire_restore(self, saved) -> None:
        st, count = saved
        self._pre_acquire(_held())
        inner = getattr(self._inner, "_acquire_restore", None)
        if inner is not None:
            inner(st)
        else:
            self._inner.acquire()
        _held().append([self.name, self, max(count, 1)])


# ---------------------------------------------------------------------------
# factories — the ONE way the package creates locks (linter rule
# raw-lock enforces this)


def make_lock(name: str):
    """A non-reentrant lock of the given manifest class."""
    return DepLock(name, False) if _enabled else threading.Lock()


def make_rlock(name: str):
    """A re-entrant lock of the given manifest class."""
    return DepLock(name, True) if _enabled else threading.RLock()


def make_condition(name: str, lock=None):
    """A Condition whose underlying lock is tracked under `name` (or
    the caller's already-tracked `lock`)."""
    if lock is None:
        lock = make_rlock(name)
    return threading.Condition(lock)


# ---------------------------------------------------------------------------
# blocking seams


class _NoopSeam:
    """Shared do-nothing seam (lockdep off / nothing held)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP_SEAM = _NoopSeam()

# per-lock-class blocking-debt counters (`lock.held_blocking_ms.<cls>`
# with the class dots flattened): the time the package spent inside a
# blocking primitive while HOLDING each lock class. This is the
# ROADMAP write-plane gate as a NUMBER — the feed-append/clock-commit
# debt under `live.engine` must read zero before the per-doc emission
# split lands. Lazy telemetry import: registry.py imports this module.
_blk_handles: Dict[str, Any] = {}


def _blk_counter(cls_name: str):
    h = _blk_handles.get(cls_name)
    if h is None:
        from .. import telemetry

        h = _blk_handles[cls_name] = telemetry.counter(
            "lock.held_blocking_ms." + cls_name.replace(".", "_")
        )
    return h


class _BlockingSeam:
    """Times one blocking primitive and charges the wall to every lock
    class the calling thread held at entry."""

    __slots__ = ("classes", "t0")

    def __init__(self, classes: Tuple[str, ...]) -> None:
        self.classes = classes
        self.t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        dt_ms = (time.perf_counter() - self.t0) * 1e3
        for c in self.classes:
            _blk_counter(c).add(dt_ms)


def blocking(kind: str, detail: str = ""):
    """Called from the package's blocking primitives (fsync, sqlite
    commit, socket sendall, joins, first-waits). With lockdep on,
    reaching one while holding a no-block class (the emission locks)
    is recorded as a held-across-blocking-call violation.

    Returns a context manager: seams that wrap the blocking operation
    in `with blocking(...)` additionally accumulate its wall time into
    the per-held-lock-class `lock.held_blocking_ms.*` counters (the
    write-plane blocking-debt series bench/top/BASELINE track). A bare
    call keeps the violation check only."""
    if not _enabled:
        return _NOOP_SEAM
    held = getattr(_tls, "held", None)
    if not held:
        return _NOOP_SEAM
    noblock = False
    for hname, _inst, _cnt in held:
        if hname in NO_BLOCK:
            noblock = True
            _record_violation(
                "blocking",
                ("blocking", hname, kind),
                f"blocking call {kind!r}{f' ({detail})' if detail else ''}"
                f" while holding no-block lock {hname!r}",
            )
    if noblock:
        from .. import telemetry

        telemetry.instant("lock.held_blocking", cat="lock")
    return _BlockingSeam(
        tuple(dict.fromkeys(h[0] for h in held))
    )


def held_classes() -> List[str]:
    """Lock classes the CURRENT thread holds (debug aid)."""
    return [e[0] for e in getattr(_tls, "held", ())]


# ---------------------------------------------------------------------------
# racedep (HM_RACEDEP=1): Eraser lockset detection over the guard
# manifest. Every non-`unguarded` attribute declared in
# analysis/guards.py is wrapped in a data descriptor; each access
# intersects the per-(object, attribute) candidate lockset with the
# accessing thread's held stack. The Eraser state machine: an
# attribute starts EXCLUSIVE to its creating thread (no refinement —
# init writes hold nothing, by design); the first access from a
# SECOND thread starts the candidate set at that thread's held locks;
# every later access intersects. An empty candidate set once the
# attribute is written-while-shared means NO lock consistently guards
# it — reported with the first shared-access site AND the violating
# site, without the race ever firing. `atomic_read_ok` attributes
# track writes only (their lone reads are declared GIL-atomic);
# `init_only` attributes report any write once a second thread has
# touched the object.


class _AttrTrack:
    __slots__ = ("owner", "state", "lockset", "first_site", "reported")

    EXCL, SHARED, SHARED_MOD = 0, 1, 2

    def __init__(self, owner: int) -> None:
        self.owner = owner
        self.state = _AttrTrack.EXCL
        self.lockset: Optional[set] = None
        self.first_site = ""
        self.reported = False


_race_lock = threading.Lock()  # guards every _AttrTrack transition;
# inner order is _race_lock -> _state.lock (never reversed)
_race_n = 0
_race_sample_n = 1
_race_installed: List[Tuple[type, str]] = []
_SKIP = object()  # sampled-out marker


def _race_sample() -> int:
    try:
        return max(1, int(os.environ.get("HM_RACEDEP_SAMPLE", "1")))
    except ValueError:
        return 1


class _RaceAttr:
    """Data descriptor wrapping one declared guarded attribute. The
    value itself still lives in the instance `__dict__` (the
    descriptor shadows it for lookups), so instrumented objects keep
    their exact state and uninstalling restores plain access."""

    __slots__ = ("cls", "attr", "guard", "escape", "skey")

    def __init__(self, cls: str, attr: str, guard: str,
                 escape: str) -> None:
        self.cls = cls
        self.attr = attr
        self.guard = guard
        self.escape = escape
        self.skey = "_racedep__" + attr

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            val = obj.__dict__[self.attr]
        except KeyError:
            raise AttributeError(
                f"{type(obj).__name__!r} object has no attribute "
                f"{self.attr!r}"
            ) from None
        # declared-atomic reads and init-only reads are free; guarded
        # reads participate in the lockset
        if _race_enabled and self.escape == "":
            _race_access(self, obj, write=False)
        return val

    def __set__(self, obj, value) -> None:
        obj.__dict__[self.attr] = value
        if _race_enabled:
            _race_access(self, obj, write=True)

    def __delete__(self, obj) -> None:
        try:
            del obj.__dict__[self.attr]
        except KeyError:
            raise AttributeError(self.attr) from None
        if _race_enabled:
            _race_access(self, obj, write=True)


def _race_access(desc: _RaceAttr, obj, write: bool) -> None:
    ident = threading.get_ident()
    held = frozenset(e[0] for e in getattr(_tls, "held", ()))
    hit = False
    with _race_lock:
        tr = obj.__dict__.get(desc.skey)
        if tr is _SKIP:
            return
        if tr is None:
            global _race_n
            _race_n += 1
            if _race_sample_n > 1 and (_race_n % _race_sample_n):
                obj.__dict__[desc.skey] = _SKIP
                return
            obj.__dict__[desc.skey] = _AttrTrack(ident)
            return
        if tr.reported:
            return
        if tr.state == _AttrTrack.EXCL:
            if tr.owner == ident:
                return
            # second thread: refinement begins (Eraser's
            # exclusive->shared transition)
            if desc.escape == "init_only":
                if write:
                    hit = _race_report(desc, tr, held, write)
                return
            tr.lockset = set(held)
            tr.state = (
                _AttrTrack.SHARED_MOD if write else _AttrTrack.SHARED
            )
            # drop _site/_race_access/__get__|__set__ so the witness
            # is the accessing code line
            tr.first_site = _site(skip=3)
        else:
            if desc.escape == "init_only":
                if write:
                    hit = _race_report(desc, tr, held, write)
                return
            tr.lockset &= held
            if write:
                tr.state = _AttrTrack.SHARED_MOD
        if tr.state == _AttrTrack.SHARED_MOD and not tr.lockset:
            hit = _race_report(desc, tr, held, write)
    if hit:
        from .. import telemetry

        telemetry.counter("lock.racedep_violations").add(1)
        telemetry.instant("lock.racedep_violation", cat="lock")


def _race_report(
    desc: _RaceAttr, tr: _AttrTrack, held: frozenset, write: bool
) -> bool:
    """Record one lockset violation (caller holds _race_lock). True
    when it was newly recorded (kind+class+attr dedup)."""
    tr.reported = True
    if desc.escape == "init_only":
        kind, why = "lockset", (
            f"init-only field {desc.cls}.{desc.attr} written after "
            f"the object was shared across threads"
        )
    else:
        kind, why = "lockset", (
            f"{desc.cls}.{desc.attr} (declared guard {desc.guard!r}): "
            f"candidate lockset is EMPTY — no lock consistently "
            f"guards it. This {'write' if write else 'read'} holds "
            f"{sorted(held) or 'no locks'}; first shared access at "
            f"{tr.first_site or '<exclusive phase>'}"
        )
    key = ("lockset", desc.cls, desc.attr)
    before = len(_state.violations)
    _record_violation(kind, key, why)
    return len(_state.violations) != before


def racedep_enabled() -> bool:
    return _race_enabled


def install_racedep() -> int:
    """Instrument every non-`unguarded` attribute of the guard
    manifest's classes (analysis/guards.py) with lockset descriptors.
    Idempotent; returns the number of attributes wrapped. Enables
    lockdep too — the per-thread held stacks are the lockset input,
    so only factory-made locks created AFTER this call participate
    (enable before constructing the repos under test, exactly like
    lockdep)."""
    global _race_enabled, _race_sample_n
    import importlib

    from . import guards

    enable(True)
    _race_enabled = True
    _race_sample_n = _race_sample()
    wrapped = {(c, a) for c, a in _race_installed}
    n = 0
    for (cls_name, attr), entry in sorted(guards.BY_CLS_ATTR.items()):
        if entry.escape == "unguarded":
            continue
        mod = importlib.import_module(entry.module)
        cls = getattr(mod, cls_name)
        if (cls, attr) in wrapped:
            continue
        cur = cls.__dict__.get(attr)
        if isinstance(cur, _RaceAttr):
            continue
        if cur is not None:
            raise ValueError(
                f"guard manifest names {cls_name}.{attr} but the class "
                f"defines it at class level (property/default) — "
                f"racedep can only wrap instance attributes"
            )
        setattr(
            cls, attr, _RaceAttr(cls_name, attr, entry.guard,
                                 entry.escape)
        )
        _race_installed.append((cls, attr))
        n += 1
    return n


def uninstall_racedep() -> None:
    """Remove the descriptors (test teardown): instance values were
    always stored in `__dict__`, so plain attribute access resumes."""
    global _race_enabled
    _race_enabled = False
    for cls, attr in _race_installed:
        try:
            delattr(cls, attr)
        except AttributeError:
            pass
    _race_installed.clear()


def maybe_install_racedep() -> None:
    """HM_RACEDEP=1 activation hook (called from RepoBackend
    construction — a daemon or bench run needs no test fixture)."""
    if os.environ.get("HM_RACEDEP", "0") == "1" and not _race_installed:
        install_racedep()


# ---------------------------------------------------------------------------
# reporting


def report() -> Dict[str, Any]:
    """The global observation so far: every class-order edge with its
    first witness site, potential cycles, and violations."""
    with _state.lock:
        pairs = sorted(
            (a, b) for a, succ in _state.graph.items() for b in succ
        )
        edges = [
            {"from": a, "to": b, "site": _state.edge_sites.get((a, b), "?")}
            for a, b in pairs
        ]
        return {
            "enabled": _enabled,
            "edges": edges,
            "cycles": [dict(c) for c in _state.cycles],
            "violations": [dict(v) for v in _state.violations],
        }


def classes_seen() -> List[str]:
    """Every lock class a DepLock was acquired under since the last
    `reset()` (the port's addition: `report()` names only the classes
    that nested)."""
    return sorted(_seen_classes)


def reset() -> None:
    """Drop every observation (test isolation). Held-lock state of
    live threads is intentionally kept — resetting mid-acquisition
    would corrupt release bookkeeping."""
    _seen_classes.clear()
    with _state.lock:
        _state.graph.clear()
        _state.edge_sites.clear()
        _state.cycles.clear()
        _state.violations.clear()
        _state._seen_cycles.clear()
        _state._seen_viol.clear()


def assert_clean(
    allow_kinds: Tuple[str, ...] = (), msg: str = ""
) -> None:
    """Raise AssertionError when any potential cycle or violation was
    observed (tests call this at teardown). `allow_kinds` filters
    violation kinds a specific suite tolerates."""
    rep = report()
    viol = [v for v in rep["violations"] if v["kind"] not in allow_kinds]
    if rep["cycles"] or viol:
        lines = [msg or "lockdep observations:"]
        for c in rep["cycles"]:
            lines.append(
                f"  potential deadlock cycle: {' -> '.join(c['cycle'])}"
                f"\n    closing edge at {c['site']}"
            )
        for v in viol:
            lines.append(f"  {v['kind']}: {v['msg']}\n    at {v['site']}")
        raise AssertionError("\n".join(lines))
