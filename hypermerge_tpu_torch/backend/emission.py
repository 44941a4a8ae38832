"""Per-doc emission domains — the many-writer write plane.

Until this module, `live.engine` was THE emission lock: every
{compute patch -> feed append -> IPC push} pair in the repo — every
doc, every writer thread — serialized under one global re-entrant
lock, and at HM_FSYNC=2 that put ~0.4ms of platter time under the
global lock per acked edit (bench `config_lockdebt`, BASELINE round
17). This module splits emission ordering into per-doc domains:

- `EmissionDomain` — ONE re-entrant lock per doc, the emission
  ordering domain. Everything that must stay ordered is per-doc: a
  Ready snapshot may not be overtaken by a newer delta patch OF THE
  SAME DOC; a local echo must precede the next tick's delta ON THE
  SAME DOC. Disjoint docs' emissions have no ordering contract, so
  they now run concurrently — feed appends, WAL commits, and frontend
  pushes for different docs proceed on different threads in parallel.

- the **no-cross-doc invariant**: a thread never holds two docs'
  domains at once, and never holds any OTHER doc's domain across a
  feed append or push. Machine-checked twice: `doc.emit` ranks at 8
  and lockdep flags a same-class nested acquisition as an order
  violation, and the domain tracks a thread-local stack of entered
  doc ids so re-entry can be detected.

- `entered_other(doc_id)` + `defer(fn)` — the re-entrancy escape
  hatch. A frontend callback dispatched synchronously from a push
  (the pushing thread holds that doc's domain) may re-enter the repo:
  same-doc re-entry simply recurses on the re-entrant domain; a
  CROSS-doc call (change/open of another doc from inside a patch
  callback) must not nest domains — the caller parks the work on the
  deferred-emission worker, which replays it on a clean thread with
  no domains held. This replaces the old answer (one global lock so
  re-entry always recurses) without reintroducing the global
  serialization.

The engine lock (`live.engine`) survives as tick/dirty-set
COORDINATION only and is never held across a blocking call —
`lock.held_blocking_ms.live_engine` reading 0.0 at every HM_FSYNC
tier is the acceptance gate bench `config_lockdebt` measures.
"""

from __future__ import annotations

import threading
from typing import Callable, List

from ..analysis.lockdep import make_condition, make_lock, make_rlock
from ..utils.debug import log

_tls = threading.local()


def _stack() -> List[str]:
    s = getattr(_tls, "domains", None)
    if s is None:
        s = _tls.domains = []
    return s


def entered_ids() -> List[str]:
    """Doc ids whose emission domains the CURRENT thread holds."""
    return list(_stack())


def entered_other(doc_id: str) -> bool:
    """True when this thread is mid-emission for a DIFFERENT doc —
    the caller must defer() instead of nesting domains."""
    return any(d != doc_id for d in _stack())


class EmissionDomain:
    """One doc's emission ordering domain: a re-entrant `doc.emit`
    lock plus the thread-local entry bookkeeping the cross-doc
    invariant is checked against. Used as a context manager."""

    def __init__(self, doc_id: str) -> None:
        self.doc_id = doc_id
        self._lock = make_rlock("doc.emit")

    def __enter__(self) -> "EmissionDomain":
        self._lock.acquire()
        _stack().append(self.doc_id)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()
        self._lock.release()

    def held_by_me(self) -> bool:
        return self.doc_id in _stack()


# ---------------------------------------------------------------------------
# deferred-emission worker (cross-doc re-entry escape hatch)

_defer_lock = make_lock("doc.emit.defer")
_defer_cv = make_condition("doc.emit.defer", _defer_lock)
_defer_items: List[Callable[[], None]] = []
_defer_thread = None


def defer(fn: Callable[[], None]) -> None:
    """Run `fn` on the deferred-emission worker — a clean thread with
    no emission domains held. Per-source ordering is preserved (one
    worker drains in FIFO order); the deferred path is the RARE
    cross-doc re-entry case, not a hot path."""
    global _defer_thread
    with _defer_cv:
        _defer_items.append(fn)
        if _defer_thread is None or not _defer_thread.is_alive():
            _defer_thread = threading.Thread(
                target=_defer_loop, daemon=True, name="hm-emit-defer"
            )
            _defer_thread.start()
        _defer_cv.notify()


def _defer_loop() -> None:
    while True:
        with _defer_cv:
            while not _defer_items:
                _defer_cv.wait()
            batch = list(_defer_items)
            del _defer_items[:]
        for fn in batch:
            try:
                fn()
            except Exception as e:  # pragma: no cover - defensive
                log("emission", f"deferred emission failed: {e}")
