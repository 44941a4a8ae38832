"""Lock factories — the port's copy of hypermerge_tpu/analysis/lockdep.py.

Every lock of the package is made through `make_lock`, `make_rlock` or
`make_condition` with a lock-class name, as in the reference. The
reference can record the acquisition order of those classes and report
potential deadlocks (HM_LOCKDEP=1, with the class manifest in
analysis/hierarchy.py); the port has no lock-order checking yet, so the
factories return plain `threading` primitives and the class name is only
documentation. The names stay, so that a later port of the checker
needs no change at the call sites. For the same reason `blocking`, the
reference's seam around a blocking call (a sqlite commit, an fsync), is
kept as a context manager that does nothing, `enabled` answers that
checking is off, and `maybe_install_racedep` (the reference's HM_RACEDEP
hook) installs nothing.
"""

from __future__ import annotations

import contextlib
import threading


def make_lock(name: str):
    """A non-reentrant lock of the given lock class."""
    del name
    return threading.Lock()


def make_rlock(name: str):
    """A re-entrant lock of the given lock class."""
    del name
    return threading.RLock()


def make_condition(name: str, lock=None):
    """A Condition over `lock`, or over a new re-entrant lock of class
    `name`."""
    return threading.Condition(make_rlock(name) if lock is None else lock)


@contextlib.contextmanager
def blocking(kind: str, what=None):
    """Marks a blocking call of the given kind (e.g. "sqlite_commit") on
    `what`; the reference checks and times it, the port runs it as is."""
    del kind, what
    yield


def enabled() -> bool:
    """Whether runtime lock-order checking is on: never, in the port."""
    return False


def maybe_install_racedep() -> None:
    """The reference's lockset-detector hook; the port has no detector."""
