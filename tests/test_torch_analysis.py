"""The port's concurrency analysis (hypermerge_tpu_torch/analysis/):
tests/test_analysis.py's cases under their own names on the port, the
two packages held equal, and the race-driver suites' fixtures.

- The reference's cases: the manifests validate; `lint_repo()` over the
  port's tree (`hypermerge_tpu_torch/`, `bench_torch/`, `chip_smoke.py`)
  reports no unsuppressed violation; each lint rule on small violating
  and conforming snippets; the runtime detector (an AB/BA cycle on two
  threads reported without a deadlock, rank / leaf / blocking
  violations, plain primitives while lockdep is off), racedep's
  lockset reports, the blocking seam's `lock.held_blocking_ms.*` debt,
  the cursor hydration race, and the CLI (`python -m
  hypermerge_tpu_torch.tools.lint`).
- Across packages: both manifests agree on every shared lock class
  (rank, leaf, no_block), env var (name, default) and guard row (module
  path mapped), with the port's own rows listed here; every lint
  snippet of the reference's cases gives the same rule ids and lines
  through both linters; the same seeded AB/BA order, rank and leaf
  inversions, blocking call and lockset race give the same `report()`;
  `telemetry.snapshot_repo` on one reference-written corpus opens the
  same docs and names the same series in both packages.
- `lockdep_suite()` / `racedep_suite()`: module-scoped autouse fixture
  factories (tests/lockdep_fixture.py and tests/racedep_fixture.py on
  the port's lockdep) that the port's race-driver suites import: every
  lock and guarded field they churn is instrumented, and the module's
  teardown fails on any finding.

The JAX package is imported only inside the cross-package cases, so the
factories import on a machine without JAX.

Tolerance: exact.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import threading

import pytest

from hypermerge_tpu_torch.analysis import (
    envvars, guards, hierarchy, linter, lockdep,
)
from hypermerge_tpu_torch.analysis import suppressions as suppmod


# ---------------------------------------------------------------------------
# the race-driver suites' fixtures

REF_LOCKDEP = "hypermerge_tpu.analysis.lockdep"


@contextlib.contextmanager
def reference_restored():
    """Leave the JAX package's checkers as they were. A reference
    `RepoBackend` built while HM_RACEDEP=1 is set (the suites' parity
    cases build them) installs the reference's racedep and enables its
    lockdep for the rest of the process; undo that on the way out. The
    reference is looked up, never imported, so a process without JAX is
    untouched."""
    ref = sys.modules.get(REF_LOCKDEP)
    was_enabled = ref.enabled() if ref is not None else False
    was_installed = bool(ref._race_installed) if ref is not None else False
    try:
        yield
    finally:
        ref = sys.modules.get(REF_LOCKDEP)
        if ref is not None:
            if ref._race_installed and not was_installed:
                ref.uninstall_racedep()
            ref.enable(was_enabled)


def lockdep_suite():
    """Module-scoped autouse fixture factory: enable lockdep for every
    lock created while the module's tests run, and assert a clean graph
    at teardown (cycles, rank inversions, leaf violations, blocking
    calls under `live.engine`)."""

    @pytest.fixture(autouse=True, scope="module")
    def _lockdep_suite():
        with reference_restored():
            was_env = os.environ.get("HM_LOCKDEP")
            was = lockdep.enabled()
            os.environ["HM_LOCKDEP"] = "1"
            lockdep.enable(True)
            lockdep.reset()
            yield
            lockdep.enable(was)
            if was_env is None:
                os.environ.pop("HM_LOCKDEP", None)
            else:
                os.environ["HM_LOCKDEP"] = was_env
        lockdep.assert_clean(
            msg="the suite's lock churn surfaced lockdep findings:",
        )

    return _lockdep_suite


def racedep_suite():
    """Module-scoped autouse fixture factory: instrument the guard
    manifest's attributes for every object created while the module's
    tests run, and assert a clean lockset report at teardown."""

    @pytest.fixture(autouse=True, scope="module")
    def _racedep_suite():
        with reference_restored():
            was_env = os.environ.get("HM_RACEDEP")
            os.environ["HM_RACEDEP"] = "1"
            lockdep.install_racedep()  # implies lockdep enable
            yield
            if was_env is None:
                os.environ.pop("HM_RACEDEP", None)
            else:
                os.environ["HM_RACEDEP"] = was_env
        try:
            lockdep.assert_clean(
                msg="the suite's churn surfaced lockset findings:",
            )
        finally:
            lockdep.uninstall_racedep()

    return _racedep_suite


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKG_PATH = "hypermerge_tpu_torch/_fixture.py"
LINT_CLI = "hypermerge_tpu_torch.tools.lint"


def _rules(viols, rule=None, suppressed=False):
    return [
        v
        for v in viols
        if (rule is None or v.rule == rule)
        and v.suppressed == suppressed
    ]


# ---------------------------------------------------------------------------
# manifests


def test_manifests_validate():
    hierarchy.validate()
    envvars.validate()
    guards.validate()


def test_guards_manifest_shape():
    """Every guard names a declared lock class; the escapes are the
    documented four; flattening is collision-free (validate raised
    otherwise) and the hot concurrent classes are covered."""
    for entry in guards.BY_CLS_ATTR.values():
        assert entry.guard in hierarchy.BY_NAME
        assert entry.escape in guards.ESCAPES
    for cls in (
        "LiveApplyEngine", "DocBackend", "RepoBackend", "ReadBatcher",
        "ResidencyCache", "SessionSupervisor", "NetworkPeer",
        "CursorStore", "DurabilityManager",
    ):
        assert cls in guards.CLASSES
    assert guards.guard_for("LiveApplyEngine", "_docs").guard == (
        "live.engine"
    )
    assert guards.guard_for("NetworkPeer", "connection").escape == (
        "unguarded"
    )


def test_hierarchy_core_order():
    """The documented core order is what the manifest declares."""
    r = hierarchy.RANKED
    # doc.emit OUTRANKS the engine lock since the write-plane split:
    # an emission path holds its doc's domain first and dips into the
    # engine only for table bookkeeping
    assert r["repo.bulk"] < r["doc.emit"] < r["live.engine"] < r["doc"]
    assert r["doc"] < r["repo"] < r["actor"] < r["store.feed"]
    assert r["store.feed"] < r["store.wal"]  # journal appends run
    # under the feed lock (feed.py append -> durability.journal_append)
    assert r["store.sql"] < r["store.cursors"]  # bulk batches absorb
    # into the mirror with the sql lock held (stores.py)
    assert "store.integrity" in hierarchy.LEAVES
    assert "util.debug" in hierarchy.LEAVES
    # the per-doc emission domain MAY block (a durable ack under it
    # stalls exactly one doc); only the global coordination lock is a
    # no-block class
    assert hierarchy.NO_BLOCK == {"live.engine"}


# ---------------------------------------------------------------------------
# THE tier-1 gate


def test_tree_is_clean():
    """Zero unsuppressed violations over the port's tree — the same
    check `python -m hypermerge_tpu_torch.tools.lint` runs."""
    viols = linter.unsuppressed(linter.lint_repo(ROOT))
    assert viols == [], "\n" + "\n".join(v.format() for v in viols)


# ---------------------------------------------------------------------------
# lint rule fixtures


FIXTURE_LOCKS = """
from hypermerge_tpu_torch.analysis.lockdep import make_rlock

class Engine:
    def __init__(self):
        self._lock = make_rlock("live.engine")

class Store:
    def __init__(self):
        self._slock = make_rlock("store.feed")
"""


def test_lock_order_rule():
    bad = FIXTURE_LOCKS + """
class User:
    def __init__(self, engine, store):
        self.e, self.s = engine, store
    def broken(self):
        with self.s._slock:
            with self.e._lock:
                pass
"""
    viols = _rules(linter.lint_source(bad, PKG_PATH), "lock-order")
    assert len(viols) == 1 and "inverts" in viols[0].msg
    good = FIXTURE_LOCKS + """
class User:
    def __init__(self, engine, store):
        self.e, self.s = engine, store
    def fine(self):
        with self.e._lock:
            with self.s._slock:
                pass
"""
    assert _rules(linter.lint_source(good, PKG_PATH), "lock-order") == []


def test_lock_order_leaf_rule():
    bad = """
from hypermerge_tpu_torch.analysis.lockdep import make_rlock

class I:
    def __init__(self):
        self._ilock = make_rlock("store.integrity")
        self._flock = make_rlock("store.feed")
    def broken(self):
        with self._ilock:
            with self._flock:
                pass
"""
    viols = _rules(linter.lint_source(bad, PKG_PATH), "lock-order")
    assert len(viols) == 1 and "leaf" in viols[0].msg


def test_engine_entrypoint_rule():
    bad = FIXTURE_LOCKS + """
class R:
    def __init__(self, live):
        self._rlock = make_rlock("repo")
        self.live = live
    def broken(self, doc, changes):
        with self._rlock:
            self.live.submit_remote(doc, changes)
"""
    viols = _rules(linter.lint_source(bad, PKG_PATH), "lock-order")
    assert len(viols) == 1 and "outermost" in viols[0].msg
    good = bad.replace(
        "with self._rlock:\n            self.live.submit_remote",
        "if True:\n            self.live.submit_remote",
    )
    assert _rules(linter.lint_source(good, PKG_PATH), "lock-order") == []


def test_no_block_rule():
    bad = FIXTURE_LOCKS + """
import os

class E2(Engine):
    def broken(self, fh, t):
        with self._lock:
            os.fsync(fh.fileno())
            t.join()
"""
    viols = _rules(linter.lint_source(bad, PKG_PATH), "no-block")
    assert len(viols) == 2
    # str.join is not a blocking call; outside the lock nothing flags
    good = FIXTURE_LOCKS + """
import os

class E2(Engine):
    def fine(self, fh, t, parts):
        with self._lock:
            x = ", ".join(parts)
        os.fsync(fh.fileno())
        t.join()
        return x
"""
    assert _rules(linter.lint_source(good, PKG_PATH), "no-block") == []


def test_no_block_skips_nested_defs():
    """A closure DEFINED under the lock does not RUN under it."""
    src = FIXTURE_LOCKS + """
import os

class E3(Engine):
    def fine(self, fh):
        with self._lock:
            def later():
                os.fsync(fh.fileno())
        return later
"""
    assert _rules(linter.lint_source(src, PKG_PATH), "no-block") == []


def test_churn_send_rule():
    bad = """
def broadcast(peer, msg):
    if peer.connection is not None:
        peer.connection.send(msg)
        peer.connection.open_channel("doc").send(msg)
"""
    viols = _rules(linter.lint_source(bad, PKG_PATH), "churn-send")
    assert len(viols) == 2 and "try_send" in viols[0].msg
    good = """
def broadcast(peer, msg):
    peer.try_send("doc", msg)
"""
    assert _rules(linter.lint_source(good, PKG_PATH), "churn-send") == []
    # NetworkPeer itself implements the idiom
    assert (
        _rules(
            linter.lint_source(bad, "hypermerge_tpu_torch/net/peer.py"),
            "churn-send",
        )
        == []
    )


def test_env_registry_rule():
    bad = """
import os
x = os.environ.get("HM_NOT_A_REAL_KNOB", "1")
"""
    viols = _rules(linter.lint_source(bad, PKG_PATH), "env-registry")
    assert len(viols) == 1 and "undeclared" in viols[0].msg
    drift = """
import os
x = os.environ.get("HM_FSYNC", "2")
"""
    viols = _rules(linter.lint_source(drift, PKG_PATH), "env-registry")
    assert len(viols) == 1 and "drifts" in viols[0].msg
    good = """
import os
x = os.environ.get("HM_FSYNC", "0")
"""
    assert _rules(linter.lint_source(good, PKG_PATH), "env-registry") == []


def test_telemetry_name_rule():
    bad = """
from hypermerge_tpu_torch import telemetry
c = telemetry.counter("Frames_TX")
g = telemetry.gauge("depth")
"""
    viols = _rules(linter.lint_source(bad, PKG_PATH), "telemetry-name")
    assert len(viols) == 2
    good = """
from hypermerge_tpu_torch import telemetry
c = telemetry.counter("net.tcp.frames_tx")
d = {k: telemetry.counter("live." + k) for k in ("a", "b")}
h = model.counter("NotARegistryCall")
"""
    assert _rules(linter.lint_source(good, PKG_PATH), "telemetry-name") == []


def test_raw_lock_rule():
    bad = """
import threading
a = threading.Lock()
b = threading.RLock()
c = threading.Condition()
"""
    viols = _rules(linter.lint_source(bad, PKG_PATH), "raw-lock")
    assert len(viols) == 3
    good = """
import threading
from hypermerge_tpu_torch.analysis.lockdep import make_rlock
lk = make_rlock("util.queue")
cv = threading.Condition(lk)
"""
    assert _rules(linter.lint_source(good, PKG_PATH), "raw-lock") == []
    # outside the package (tests, tools) raw locks are fine
    assert _rules(linter.lint_source(bad, "tools/x.py"), "raw-lock") == []


FIXTURE_GUARDED = """
from hypermerge_tpu_torch.analysis.lockdep import make_rlock

class ResidencyCache:
    def __init__(self):
        self._lock = make_rlock("serve.cache")
        self._entries = {}
        self._bytes = 0
"""


def test_guarded_attr_rule():
    bad = FIXTURE_GUARDED + """
    def bad_write(self, k, v):
        self._entries[k] = v

    def bad_mutate(self):
        self._entries.clear()

    def bad_read(self):
        return list(self._entries)

    def bad_bytes_write(self):
        self._bytes = 0
"""
    viols = _rules(linter.lint_source(bad, PKG_PATH), "guarded-attr")
    msgs_ = [v.msg for v in viols]
    assert len(viols) == 4, msgs_
    assert sum("writes" in m for m in msgs_) == 3
    assert sum("reads" in m for m in msgs_) == 1
    good = FIXTURE_GUARDED + """
    def fine(self, k, v):
        with self._lock:
            self._entries[k] = v
            self._entries.clear()
            return list(self._entries)

    def bytes_snapshot(self):
        return self._bytes  # atomic_read_ok: lone read is declared

    def _note_evicted(self, k):
        # guards.REQUIRES: the whole body runs with serve.cache held
        self._entries.pop(k, None)
"""
    assert _rules(linter.lint_source(good, PKG_PATH), "guarded-attr") == []


def test_guarded_attr_init_only_and_closures():
    bad = """
class ReadBatcher:
    def __init__(self):
        self._cap = 4  # exempt: not shared yet

    def later(self):
        self._cap = 8
"""
    viols = _rules(linter.lint_source(bad, PKG_PATH), "guarded-attr")
    assert len(viols) == 1 and "init-only" in viols[0].msg
    # a closure defined under the `with` does not RUN under it — its
    # guarded writes must still be flagged
    closure = FIXTURE_GUARDED + """
    def leaks(self, k):
        with self._lock:
            def later():
                self._entries.pop(k, None)
        return later
"""
    viols = _rules(linter.lint_source(closure, PKG_PATH), "guarded-attr")
    assert len(viols) == 1 and "writes" in viols[0].msg


def test_guarded_attr_suppression_and_other_classes():
    src = FIXTURE_GUARDED + """
    def noted(self):
        self._entries.clear()  # lint: allow(guarded-attr) — fixture exercising the suppression path
"""
    viols = linter.lint_source(src, PKG_PATH)
    sup = _rules(viols, "guarded-attr", suppressed=True)
    assert len(sup) == 1 and linter.unsuppressed(viols) == []
    # an undeclared class with the same attribute names is untouched
    other = """
class SomethingElse:
    def write(self, k, v):
        self._entries = {k: v}
"""
    assert _rules(linter.lint_source(other, PKG_PATH), "guarded-attr") == []


def test_guards_registry_stale_detection():
    """A manifest entry nothing in the scanned tree accesses is
    flagged stale (the anti-rot twin of the env-registry rule)."""
    out = []
    linter._check_guards_registry(out, set(), linter.repo_root())
    stale = [v for v in out if "stale guard entry" in v.msg]
    assert len(stale) == len(guards.BY_CLS_ATTR)
    out2 = []
    linter._check_guards_registry(
        out2, set(guards.BY_CLS_ATTR), linter.repo_root()
    )
    assert [v for v in out2 if "stale" in v.msg] == []


def test_inline_suppression():
    src = """
import threading
a = threading.Lock()  # lint: allow(raw-lock) — fixture exercising the suppression path
"""
    viols = linter.lint_source(src, PKG_PATH)
    sup = _rules(viols, "raw-lock", suppressed=True)
    assert len(sup) == 1 and "fixture" in sup[0].justification
    assert linter.unsuppressed(viols) == []
    # a justification is REQUIRED
    bare = """
import threading
a = threading.Lock()  # lint: allow(raw-lock)
"""
    viols = linter.lint_source(bare, PKG_PATH)
    assert _rules(viols, "raw-lock") != []
    assert _rules(viols, "suppression") != []


def test_file_suppression_and_stale(monkeypatch):
    entry = suppmod.Suppression(
        "raw-lock", "hypermerge_tpu_torch/_fixture.py", "threading.Lock",
        "fixture: exercising the file-suppression path",
    )
    monkeypatch.setattr(suppmod, "SUPPRESSIONS", (entry,))
    src = "import threading\na = threading.Lock()\n"
    viols = linter.lint_source(src, PKG_PATH)
    assert linter.unsuppressed(viols) == []
    # the same entry against a clean tree is STALE and flagged
    viols = linter.lint_source("x = 1\n", PKG_PATH)
    stale = _rules(viols, "suppression")
    assert len(stale) == 1 and "stale" in stale[0].msg


# ---------------------------------------------------------------------------
# runtime lockdep


@pytest.fixture
def dep():
    """Isolated lockdep session: enabled, empty graph; restored after."""
    was = lockdep.enabled()
    lockdep.enable(True)
    lockdep.reset()
    yield lockdep
    lockdep.enable(was)
    lockdep.reset()


def test_factories_plain_when_disabled():
    was = lockdep.enabled()
    lockdep.enable(False)
    try:
        assert not isinstance(
            lockdep.make_rlock("live.engine"), lockdep.DepLock
        )
        assert not isinstance(lockdep.make_lock("doc"), lockdep.DepLock)
    finally:
        lockdep.enable(was)


def test_lockdep_reports_ab_ba_cycle_without_deadlock(dep):
    """The acceptance fixture: thread 1 nests A->B, thread 2 nests
    B->A — never concurrently, so no deadlock CAN fire — and the
    detector still reports the potential cycle."""
    a = dep.make_rlock("net.network")
    b = dep.make_rlock("net.swarm")
    t1_done = threading.Event()

    def t1():
        with a:
            with b:
                pass
        t1_done.set()

    def t2():
        t1_done.wait(5)
        with b:
            with a:
                pass

    th1, th2 = threading.Thread(target=t1), threading.Thread(target=t2)
    th1.start(); th2.start()
    th1.join(5); th2.join(5)
    assert not th1.is_alive() and not th2.is_alive()
    rep = dep.report()
    assert len(rep["cycles"]) == 1
    cyc = rep["cycles"][0]["cycle"]
    assert set(cyc) == {"net.network", "net.swarm"}
    with pytest.raises(AssertionError):
        dep.assert_clean()


def test_lockdep_order_and_leaf_violations(dep):
    eng = dep.make_rlock("live.engine")
    sql = dep.make_rlock("store.sql")
    with sql:
        with eng:  # store.sql (60) held while taking live.engine (10)
            pass
    leaf = dep.make_rlock("store.integrity")
    feed = dep.make_rlock("store.feed")
    with leaf:
        with feed:
            pass
    kinds = sorted(v["kind"] for v in dep.report()["violations"])
    assert kinds == ["leaf", "order", "order"]  # leaf inversion is both


def test_lockdep_blocking_violation(dep):
    eng = dep.make_rlock("live.engine")
    dep.blocking("fsync")  # nothing held: fine
    assert dep.report()["violations"] == []
    with eng:
        dep.blocking("fsync", "/tmp/x")
    viol = dep.report()["violations"]
    assert len(viol) == 1 and viol[0]["kind"] == "blocking"
    with pytest.raises(AssertionError):
        dep.assert_clean()
    dep.assert_clean(allow_kinds=("blocking",))


def test_lockdep_rlock_reentrancy_no_self_edge(dep):
    lk = dep.make_rlock("repo")
    with lk:
        with lk:
            pass
    rep = dep.report()
    assert rep["edges"] == [] and rep["violations"] == []


def test_lockdep_unknown_class(dep):
    dep.make_rlock("definitely.not.declared")
    viol = dep.report()["violations"]
    assert len(viol) == 1 and viol[0]["kind"] == "unknown-class"


def test_lockdep_condition_wait_releases_held_state(dep):
    """Condition.wait over a DepLock pops the held entry (a waiter
    holds nothing) and re-pushes on wakeup — no phantom edges."""
    cv = dep.make_condition("util.debounce")
    other = dep.make_rlock("util.queue")

    def waiter():
        with cv:
            cv.wait(timeout=2)

    t = threading.Thread(target=waiter)
    with cv:
        t.start()
        # give the waiter time to block; it must NOT hold the lock
        # class while waiting
    t.join(5)
    assert not t.is_alive()
    with other:
        pass
    assert dep.report()["violations"] == []


def test_registry_name_assert_under_lockdep(dep):
    from hypermerge_tpu_torch.telemetry import REGISTRY

    with pytest.raises(ValueError):
        REGISTRY.counter("BadFlatName")
    REGISTRY.counter("live.test_lockdep_name_ok")  # dotted: fine


# ---------------------------------------------------------------------------
# runtime racedep (HM_RACEDEP lockset detection)


@pytest.fixture
def race(dep):
    """Isolated racedep session on top of the `dep` fixture: guard
    descriptors installed, removed (and lockdep restored) after.
    install_racedep() is idempotent and returns only the NEWLY
    wrapped count — 0 when a full-suite HM_RACEDEP=1 run already
    auto-installed the descriptors at an earlier repo construction —
    so the assertion is on the installed STATE."""
    lockdep.install_racedep()
    assert lockdep.racedep_enabled()
    yield dep
    lockdep.uninstall_racedep()


def test_racedep_reports_seeded_violation_without_deadlock(race):
    """Two threads, one takes the declared guard and one does not —
    no deadlock CAN fire (the accesses never block each other), and
    the lockset detector still reports the guard violation with both
    stacks."""
    from hypermerge_tpu_torch.serve.resident import ResidencyCache

    c = ResidencyCache()

    def locked():
        with c._lock:
            c._use += 1

    def unlocked():
        c._use += 1  # violates the declared serve.cache guard

    t1 = threading.Thread(target=locked)
    t1.start(); t1.join(5)
    t2 = threading.Thread(target=unlocked)
    t2.start(); t2.join(5)
    assert not t1.is_alive() and not t2.is_alive()
    viol = [
        v for v in race.report()["violations"] if v["kind"] == "lockset"
    ]
    assert len(viol) == 1
    msg = viol[0]["msg"]
    assert "ResidencyCache._use" in msg and "serve.cache" in msg
    # both stacks in the report, and the first-shared-access witness
    # leads with the ACCESSING code line, not threading internals
    site = msg.split("first shared access at ", 1)[1]
    assert site.split(" <- ", 1)[0].startswith("test_torch_analysis.py:")
    with pytest.raises(AssertionError):
        race.assert_clean(allow_kinds=("blocking",))


def test_racedep_consistent_guard_is_clean(race):
    """The same two-thread churn WITH the guard held everywhere stays
    clean — the candidate lockset never empties."""
    from hypermerge_tpu_torch.serve.resident import ResidencyCache

    c = ResidencyCache()

    def worker():
        for _ in range(20):
            with c._lock:
                c._use += 1

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    assert [
        v for v in race.report()["violations"] if v["kind"] == "lockset"
    ] == []


def test_racedep_descriptor_preserves_attribute_semantics(race):
    """Instrumented attributes still read/write/delete like plain
    instance attributes (values live in __dict__), and a missing
    attribute still raises AttributeError."""
    from hypermerge_tpu_torch.storage.durability import DurabilityManager

    d = DurabilityManager()
    assert d._closed is False
    with d._lock:
        d._closed = True
    assert d._closed is True
    obj = DurabilityManager.__new__(DurabilityManager)
    with pytest.raises(AttributeError):
        obj._dirty
    lockdep.uninstall_racedep()
    assert d._closed is True  # plain access resumes after uninstall


def test_blocking_seam_accumulates_per_class_debt(dep):
    """`with blocking(...)` charges the blocked wall time to every
    held lock class — the `lock.held_blocking_ms.*` series the
    write-plane split is gated on."""
    import time as _time

    from hypermerge_tpu_torch import telemetry

    eng = dep.make_rlock("live.engine")
    before = telemetry.snapshot().get(
        "lock.held_blocking_ms.live_engine", 0.0
    )
    with eng:
        with dep.blocking("fsync", "fixture"):
            _time.sleep(0.01)
    after = telemetry.snapshot().get(
        "lock.held_blocking_ms.live_engine", 0.0
    )
    assert after - before >= 5.0  # ms
    # the violation (blocking under a no-block lock) is still recorded
    kinds = [v["kind"] for v in dep.report()["violations"]]
    assert "blocking" in kinds


# ---------------------------------------------------------------------------
# regression: the sql<->cursors fix (hydration vs delete)


def test_cursor_hydration_discards_snapshot_a_delete_raced():
    """CursorStore._ensure_hydrated queries SQLite BEFORE taking the
    mirror lock (the lock-order fix); a delete_doc landing between the
    query and the merge must invalidate the snapshot, not be
    resurrected by it."""
    from hypermerge_tpu_torch.storage.sql import SqlDatabase
    from hypermerge_tpu_torch.storage.stores import CursorStore

    db = SqlDatabase(":memory:")
    seed = CursorStore(db)
    seed.update("r", "docX", {"a1": 5})
    seed.update("r", "docY", {"a2": 3})

    store = CursorStore(db)  # fresh mirror, unhydrated
    real_query = db.query
    raced = []

    def racing_query(sql, params=()):
        rows = real_query(sql, params)
        if not raced and "FROM cursors" in sql:
            raced.append(True)
            store.delete_doc("r", "docX")  # lands mid-hydration
        return rows

    db.query = racing_query
    try:
        assert store.get("r", "docX") == {}  # NOT the stale {"a1": 5}
        assert store.get("r", "docY") == {"a2": 3}
        assert store.docs_with_actor("r", "a1") == []
    finally:
        db.query = real_query


# ---------------------------------------------------------------------------
# CLI


def test_lint_cli_json():
    out = subprocess.run(
        [sys.executable, "-m", LINT_CLI, "--json"],
        capture_output=True, text=True, cwd=ROOT,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["n_unsuppressed"] == 0


def test_lint_cli_env_table():
    out = subprocess.run(
        [sys.executable, "-m", LINT_CLI, "--env-table"],
        capture_output=True, text=True, cwd=ROOT,
    )
    assert out.returncode == 0
    assert "HM_LOCKDEP" in out.stdout and "HM_FSYNC" in out.stdout
    assert "HM_RACEDEP" in out.stdout


def test_lint_cli_guards_table():
    out = subprocess.run(
        [sys.executable, "-m", LINT_CLI, "--guards-table"],
        capture_output=True, text=True, cwd=ROOT,
    )
    assert out.returncode == 0
    assert "`LiveApplyEngine`" in out.stdout
    assert "`live.engine`" in out.stdout
    assert "atomic_read_ok" in out.stdout
    # the README's port section carries exactly this generated table
    # (drift is a lint violation, same contract as the env table)
    readme = linter._port_readme(ROOT)
    assert readme
    for line in out.stdout.strip().splitlines():
        assert line in readme, f"README guard table drifted: {line}"


# ---------------------------------------------------------------------------
# across packages: the reference's manifests, linter and detectors


def _ref_analysis():
    from hypermerge_tpu.analysis import envvars as r_env
    from hypermerge_tpu.analysis import guards as r_guards
    from hypermerge_tpu.analysis import hierarchy as r_hier
    from hypermerge_tpu.analysis import linter as r_linter
    from hypermerge_tpu.analysis import lockdep as r_lockdep

    return r_env, r_guards, r_hier, r_linter, r_lockdep


# the port's own lock classes: the nvcc build, the launch counters,
# libcrypto's load-once latch, and the locks of the command-line tools
# and examples (inside the port's package, so the linter covers them)
PORT_ONLY_LOCKS = {"kernels.build", "kernels.launches", "util.ossl",
                   "tools.top", "examples.chat"}
# the knobs of XLA and Pallas the port has nothing to switch
REF_ONLY_ENV = {
    "HM_COMPILE_CACHE", "HM_COMPILE_CACHE_FORCE", "HM_ASYNC_SUMMARY_COPY",
    "HM_ICI_PALLAS",
}
PORT_ONLY_ENV: set = set()
# (reference default, port default): the port's recorded deviations
PORT_DEFAULTS = {"HM_DEVICE_PACK": ("0", "1"), "HM_SERVICE": ("1", "0")}
# no port-only class holds shared state under a lock: the port's own
# locks guard module state (the build table, the launch counts, the
# libcrypto handle), which the guard map's (class, field) rows cannot
# name
PORT_ONLY_GUARDS: set = set()


def _mapped(module: str) -> str:
    assert module.startswith("hypermerge_tpu."), module
    return "hypermerge_tpu_torch." + module[len("hypermerge_tpu."):]


@pytest.mark.parametrize("part", ["locks", "env", "guards", "rules"])
def test_manifests_agree_across_packages(part):
    r_env, r_guards, r_hier, _r_linter, _r_lockdep = _ref_analysis()
    if part == "locks":
        ref = r_hier.BY_NAME
        port = hierarchy.BY_NAME
        assert set(port) - set(ref) == PORT_ONLY_LOCKS
        assert set(ref) <= set(port)
        for name, rc in ref.items():
            pc = port[name]
            assert (pc.rank, pc.leaf, pc.no_block) == (
                rc.rank, rc.leaf, rc.no_block
            ), name
        assert hierarchy.ALLOWED_EDGES == r_hier.ALLOWED_EDGES
    elif part == "env":
        ref, port = r_env.BY_NAME, envvars.BY_NAME
        assert set(ref) - set(port) == REF_ONLY_ENV
        assert set(port) - set(ref) == PORT_ONLY_ENV
        for name in set(ref) & set(port):
            want = PORT_DEFAULTS.get(name)
            got = (ref[name].default, port[name].default)
            if want is None:
                assert got[0] == got[1], name
            else:
                assert got == want, name
    elif part == "guards":
        ref = {g.cls: g for g in r_guards.GUARDS}
        port = {g.cls: g for g in guards.GUARDS}
        assert set(port) - set(ref) == PORT_ONLY_GUARDS
        assert set(ref) <= set(port)
        for cls, rg in ref.items():
            # the rows' stories (`doc`) are prose; every field is held
            assert port[cls]._replace(doc="") == rg._replace(
                module=_mapped(rg.module), doc=""), cls
        assert guards.REQUIRES == r_guards.REQUIRES
    else:
        assert hierarchy.ENGINE_ENTRYPOINTS == r_hier.ENGINE_ENTRYPOINTS
        assert hierarchy.BLOCKING_CALLS == r_hier.BLOCKING_CALLS
        assert hierarchy.NO_BLOCK == r_hier.NO_BLOCK
        assert hierarchy.LEAVES - r_hier.LEAVES == {"kernels.launches"}
        assert (hierarchy.TELEMETRY_NAME_RE.pattern
                == r_hier.TELEMETRY_NAME_RE.pattern)
        assert linter.RULES == _ref_analysis()[3].RULES


# the reference cases that lint snippets: each runs again with the
# port's `lint_source` wrapped so that every snippet also goes through
# the reference's linter, at the reference's path
LINT_CASES = [
    "test_lock_order_rule", "test_lock_order_leaf_rule",
    "test_engine_entrypoint_rule", "test_no_block_rule",
    "test_no_block_skips_nested_defs", "test_churn_send_rule",
    "test_env_registry_rule", "test_telemetry_name_rule",
    "test_raw_lock_rule", "test_guarded_attr_rule",
    "test_guarded_attr_init_only_and_closures",
    "test_guarded_attr_suppression_and_other_classes",
    "test_inline_suppression",
]


def _lint_key(viols):
    return sorted((v.rule, v.line, v.suppressed, v.justification)
                  for v in viols)


@pytest.mark.parametrize("case", LINT_CASES)
def test_lint_snippets_agree_across_packages(case, monkeypatch):
    r_linter = _ref_analysis()[3]
    port_lint = linter.lint_source
    seen = []

    def both(src, path=PKG_PATH):
        got = port_lint(src, path)
        ref_path = path.replace("hypermerge_tpu_torch/", "hypermerge_tpu/")
        ref_src = src.replace("hypermerge_tpu_torch", "hypermerge_tpu")
        want = r_linter.lint_source(ref_src, ref_path)
        assert _lint_key(got) == _lint_key(want), (path, src)
        seen.append(path)
        return got

    monkeypatch.setattr(linter, "lint_source", both)
    globals()[case]()
    assert seen


def _seed_ab_ba(dep):
    a = dep.make_rlock("net.network")
    b = dep.make_rlock("net.swarm")
    first = threading.Event()

    def t1():
        with a:
            with b:
                pass
        first.set()

    def t2():
        first.wait(5)
        with b:
            with a:
                pass

    threads = [threading.Thread(target=t1), threading.Thread(target=t2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)


def _seed_order_leaf(dep):
    eng, sql = dep.make_rlock("live.engine"), dep.make_rlock("store.sql")
    with sql:
        with eng:
            pass
    leaf, feed = dep.make_rlock("store.integrity"), dep.make_rlock(
        "store.feed")
    with leaf:
        with feed:
            pass


def _seed_blocking(dep):
    with dep.make_rlock("live.engine"):
        dep.blocking("fsync", "fixture")


def _seed_lockset(dep, cache_cls):
    c = cache_cls()

    def locked():
        with c._lock:
            c._use += 1

    def unlocked():
        c._use += 1

    for fn in (locked, unlocked):
        t = threading.Thread(target=fn)
        t.start()
        t.join(5)


def _report_under(dep, seed, racedep):
    was = dep.enabled()
    dep.enable(True)
    dep.reset()
    try:
        if racedep:
            dep.install_racedep()
            try:
                seed(dep)
            finally:
                dep.uninstall_racedep()
        else:
            seed(dep)
        rep = dep.report()
    finally:
        dep.enable(was)
        dep.reset()
    # the witness sites name lockdep.py's own lines, which the two copies
    # number apart where their docstrings differ
    return json.loads(re.sub(r"lockdep\.py:\d+", "lockdep.py",
                             json.dumps(rep, sort_keys=True)))


@pytest.mark.parametrize("seed", ["ab_ba", "order_leaf", "blocking",
                                  "lockset"])
def test_lockdep_reports_agree_across_packages(seed):
    r_lockdep = _ref_analysis()[4]
    if seed == "lockset":
        from hypermerge_tpu.serve.resident import ResidencyCache as RefCache
        from hypermerge_tpu_torch.serve.resident import ResidencyCache

        caches = {r_lockdep: RefCache, lockdep: ResidencyCache}
        fns = {d: (lambda x, c=c: _seed_lockset(x, c))
               for d, c in caches.items()}
    else:
        fn = {"ab_ba": _seed_ab_ba, "order_leaf": _seed_order_leaf,
              "blocking": _seed_blocking}[seed]
        fns = {r_lockdep: fn, lockdep: fn}
    # one call site for both packages: the witness sites then agree
    ref, port = [_report_under(d, fns[d], seed == "lockset")
                 for d in (r_lockdep, lockdep)]
    assert port["cycles"] or port["violations"]
    if seed == "lockset":
        assert [v["kind"] for v in port["violations"]] == ["lockset"]
    assert port == ref


def test_suite_fixtures_leave_the_reference_uninstrumented(monkeypatch):
    """A reference Repo built under the suites' HM_RACEDEP=1 installs the
    reference's racedep and enables its lockdep; `reference_restored`
    undoes both, so the instrumentation does not outlive a port suite."""
    from hypermerge_tpu.analysis import lockdep as r_lockdep
    from hypermerge_tpu.repo import Repo as RefRepo

    for k, v in {"HM_LIVE": "0", "HM_PIPELINE": "0", "HM_WAL": "0",
                 "HM_SERVICE": "0"}.items():
        monkeypatch.setenv(k, v)
    was = r_lockdep.enabled()
    assert not r_lockdep._race_installed
    with reference_restored():
        monkeypatch.setenv("HM_RACEDEP", "1")
        repo = RefRepo(memory=True)
        repo.close()
        assert r_lockdep._race_installed and r_lockdep.enabled()
    assert not r_lockdep._race_installed
    assert not r_lockdep.racedep_enabled()
    assert r_lockdep.enabled() == was
    r_lockdep.reset()


SNAPSHOT_CHILD = r"""
import json, sys
which, path = sys.argv[1], sys.argv[2]
opened = []
if which == "ref":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from hypermerge_tpu import telemetry
    from hypermerge_tpu.repo import Repo
    kw = {}
else:
    from hypermerge_tpu_torch import telemetry
    from hypermerge_tpu_torch.repo import Repo
    kw = {"device": "cpu"}
real = Repo.open_many
def spy(self, urls, *a, **k):
    opened.append(len(urls))
    return real(self, urls, *a, **k)
Repo.open_many = spy
payload = telemetry.snapshot_repo(path, **kw)
print(json.dumps({"opened": opened, "counters": sorted(payload["counters"]),
                  "keys": sorted(payload)}))
"""

# the subsystems both packages run on a bulk open (the port's `pack.*`,
# `mesh.*` and `kernels` series differ: its pack and slab run CUDA
# kernels, not jitted programs)
SHARED_SUBSYSTEMS = ("live.", "pipeline.", "serve.", "service.", "storage.")


def test_snapshot_repo_agrees_across_packages(tmp_path):
    import shutil

    from hypermerge_tpu.ops.corpus import make_corpus

    src = str(tmp_path / "corpus")
    make_corpus(src, 6, 32)
    out = {}
    for which in ("ref", "port"):
        dst = str(tmp_path / which)
        shutil.copytree(src, dst)
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "HM_SERVICE": "1",
               "HM_PIPELINE": "1"}
        run = subprocess.run(
            [sys.executable, "-c", SNAPSHOT_CHILD, which, dst],
            capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
        )
        assert run.returncode == 0, run.stderr[-2000:]
        out[which] = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["port"]["opened"] == out["ref"]["opened"] == [6]
    assert out["port"]["keys"] == out["ref"]["keys"]

    def shared(names):
        return {n for n in names if n.startswith(SHARED_SUBSYSTEMS)}

    assert shared(out["port"]["counters"]) == shared(out["ref"]["counters"])
