"""tests/test_write_plane.py on the port: the many-writer write plane
(hypermerge_tpu_torch/backend/emission.py + storage/wal.py), each case
under its own name, with the port's checkers on.

- the two-writer seeded race: disjoint docs edited concurrently from
  separate threads, fully instrumented (HM_LOCKDEP=1 + HM_RACEDEP=1 on
  the port's analysis/lockdep.py). The module teardown asserts a clean
  graph and lockset report: no same-class `doc.emit` nesting and no
  blocking call under `live.engine`;
- cross-doc re-entry defers: a callback dispatched from one doc's push
  that edits or opens ANOTHER doc replays on the deferred-emission
  worker instead of nesting the second domain under the first;
- emission-domain bookkeeping units (entered_other / held_by_me).

Repos run on the CPU (`device="cpu"`). Tolerance: exact.
"""

import threading

from hypermerge_tpu_torch.backend import emission
from hypermerge_tpu_torch.repo import Repo as _PortRepo

from helpers import wait_until
from test_torch_analysis import lockdep_suite, racedep_suite

_lockdep = lockdep_suite()
_racedep = racedep_suite()


def Repo(**kwargs):
    return _PortRepo(device="cpu", **kwargs)


# ---------------------------------------------------------------------------
# emission-domain units


def test_domain_entry_bookkeeping():
    a = emission.EmissionDomain("docA")
    b = emission.EmissionDomain("docB")
    assert not a.held_by_me()
    with a:
        assert a.held_by_me()
        assert emission.entered_ids() == ["docA"]
        # same-doc re-entry is not "other": the re-entrant domain recurses
        assert not emission.entered_other("docA")
        # a cross-doc call from inside the emission must defer
        assert emission.entered_other("docB")
        with a:  # re-entrant
            assert emission.entered_ids() == ["docA", "docA"]
        assert emission.entered_ids() == ["docA"]
    assert not a.held_by_me()
    assert not emission.entered_other("docB")
    del b


def test_defer_runs_off_thread_in_order():
    got = []
    ev = threading.Event()
    for i in range(8):
        emission.defer(lambda i=i: got.append(i))
    emission.defer(ev.set)
    assert ev.wait(10)
    assert got == list(range(8))  # FIFO, one worker
    assert threading.current_thread().name != "hm-emit-defer"


# ---------------------------------------------------------------------------
# the two-writer seeded race (instrumented; teardown asserts clean)


def test_two_writers_disjoint_docs_instrumented():
    """Two threads, two docs, interleaved edits with the live engine on:
    every edit lands exactly once, and the module's lockdep / racedep
    teardown proves no cross-doc domain nesting and no blocking under the
    engine lock happened anywhere in the run."""
    repo = Repo(memory=True)
    try:
        urls = [repo.create({"edits": []}) for _ in range(2)]
        n_edits = 30
        barrier = threading.Barrier(2)

        def writer(w):
            barrier.wait()  # maximize interleaving
            for i in range(n_edits):
                repo.change(urls[w], lambda d, i=i: d["edits"].append(i))

        ts = [threading.Thread(target=writer, args=(w,)) for w in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        if repo.back.live is not None:
            repo.back.live.flush_now()
        for url in urls:
            wait_until(
                lambda url=url: list((repo.doc(url) or {}).get("edits", []))
                == list(range(n_edits))
            )
    finally:
        repo.close()


def test_cross_doc_reentry_defers_not_nests():
    """A subscriber editing doc B from inside doc A's patch dispatch: the
    edit lands via the deferred-emission worker, both docs converge, and
    the teardown asserts no doc.emit -> doc.emit edge was ever taken."""
    repo = Repo(memory=True)
    try:
        url_a = repo.create({"n": 0})
        url_b = repo.create({"mirror": -1})
        fired = []

        def mirror(state, _index):
            n = state.get("n", 0)
            if n >= 1 and n not in fired:
                fired.append(n)
                repo.change(url_b, lambda d, n=n: d.__setitem__("mirror", n))

        h = repo.watch(url_a, mirror)
        for i in range(1, 4):
            repo.change(url_a, lambda d, i=i: d.__setitem__("n", i))
        wait_until(lambda: (repo.doc(url_b) or {}).get("mirror") == 3)
        h.close()
    finally:
        repo.close()


def test_open_from_patch_callback_defers_ready():
    """A subscriber that opens another doc from inside a patch dispatch:
    the Open's Ready emission defers instead of nesting doc B's domain
    under A's."""
    repo = Repo(memory=True)
    try:
        url_a = repo.create({"n": 0})
        url_b = repo.create({"other": 1})
        repo.close_doc(url_b)  # B's Ready will be re-sent on re-open
        opened = []

        def open_other(state, _index):
            if state.get("n", 0) >= 1 and not opened:
                opened.append(True)
                repo.watch(url_b, lambda st, _i: opened.append(dict(st or {})))

        h = repo.watch(url_a, open_other)
        repo.change(url_a, lambda d: d.__setitem__("n", 1))
        wait_until(lambda: any(
            isinstance(o, dict) and o.get("other") == 1 for o in opened
        ))
        h.close()
    finally:
        repo.close()


def test_send_ready_defers_under_foreign_domain(monkeypatch):
    """`_send_ready` invoked on a thread holding ANOTHER doc's emission
    domain parks the Ready on the deferred-emission worker instead of
    nesting doc B's domain under doc A's."""
    from hypermerge_tpu_torch.utils.ids import url_to_id

    repo = Repo(memory=True)
    try:
        url_a = repo.create({"n": 0})
        url_b = repo.create({"other": 1})
        back = repo.back
        doc_a = back.docs[url_to_id(url_a)]
        doc_b = back.docs[url_to_id(url_b)]
        deferred = []
        monkeypatch.setattr(emission, "defer", lambda fn: deferred.append(fn))
        with doc_a.emission:
            back._send_ready(doc_b)
            assert deferred, "Ready nested B's domain under A's"
            assert not doc_b.emission.held_by_me()
        deferred[0]()  # the worker's replay: clean thread, no domains
    finally:
        repo.close()
