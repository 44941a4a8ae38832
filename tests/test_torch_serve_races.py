"""tests/test_serve_races.py on the port: serving-tier race drivers with
the port's checkers on (HM_LOCKDEP=1 + HM_RACEDEP=1), each case under
its own name.

Concurrent writers, readers and eviction churn exercise every serve lock
(serve.cache, serve.batch) against the engine, doc and store locks, and
the kernel locks of the port (`kernels.launches` around every serve
launch on the card; here the plain versions run); the module teardown
asserts the observed lock-order graph and lockset report are clean. The
chaos case pins the freshness contract: a read issued after a patch was
delivered never returns state older than that patch.

Repos run on the CPU (`device="cpu"`). Tolerance: exact.
"""

import threading

import pytest

from hypermerge_tpu_torch.models import Text
from hypermerge_tpu_torch.repo import Repo

from test_torch_analysis import lockdep_suite, racedep_suite

_lockdep = lockdep_suite()
# eviction churn + invalidation races under the lockset detector: the
# serve-tier guard rows verified live
_racedep = racedep_suite()


@pytest.fixture
def repo():
    r = Repo(memory=True, device="cpu")
    yield r
    r.close()


def test_eviction_churn_race(repo, monkeypatch):
    """Readers over more docs than the byte budget holds: every read
    races installs + LRU evictions of the others. Values stay correct
    and the lock graph clean."""
    monkeypatch.setenv("HM_SERVE_MAX_BYTES", "4000")
    urls = []
    for i in range(6):
        u = repo.create({"i": i})
        repo.change(u, lambda d, i=i: d.__setitem__("t", Text(f"doc{i}")))
        urls.append(u)
    errors = []

    def reader(n):
        try:
            for j in range(10):
                i = (n + j) % len(urls)
                v = repo.read(urls[i], {"kind": "text", "path": ["t"]})
                assert v == f"doc{i}", v
        except Exception as e:  # pragma: no cover - failure surface
            errors.append(e)

    ts = [threading.Thread(target=reader, args=(n,)) for n in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors


def test_invalidation_race(repo):
    """Writers move clocks while readers install / serve: a read may see
    the pre- or post-edit value of a concurrent edit, never a value that
    contradicts the doc's history (values only grow)."""
    url = repo.create()
    repo.change(url, lambda d: d.__setitem__("n", 0))
    stop = threading.Event()
    errors = []

    def writer():
        try:
            for i in range(1, 30):
                repo.change(url, lambda d, i=i: d.__setitem__("n", i))
        finally:
            stop.set()

    def reader():
        last = -1
        try:
            while not stop.is_set() or last < 0:
                v = repo.read(url, {"kind": "lookup", "path": ["n"]})
                assert v is not None and v >= last, (v, last)
                last = v
        except Exception as e:  # pragma: no cover - failure surface
            errors.append(e)

    ts = [threading.Thread(target=reader) for _ in range(3)]
    w = threading.Thread(target=writer)
    for t in ts:
        t.start()
    w.start()
    w.join()
    for t in ts:
        t.join()
    assert not errors


def test_no_stale_read_past_delivered_patch(repo):
    """Every read issued after a patch's delivery reflects at least that
    patch's text."""
    url = repo.create()
    repo.change(url, lambda d: d.__setitem__("t", Text("")))
    seen = [0]  # longest delivered text, updated by the watcher

    def watch(state, _idx):
        t = state.get("t")
        if isinstance(t, Text) and len(t) > seen[0]:
            seen[0] = len(t)

    handle = repo.watch(url, watch)
    errors = []
    stop = threading.Event()

    def writer():
        try:
            for i in range(40):
                repo.change(
                    url, lambda d, i=i: d["t"].insert(len(d["t"]), "x"))
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                floor = seen[0]  # delivered before this read is issued
                v = repo.read(url, {"kind": "text", "path": ["t"]})
                assert v is not None and len(v) >= floor, (len(v), floor)
        except Exception as e:  # pragma: no cover - failure surface
            errors.append(e)

    rs = [threading.Thread(target=reader) for _ in range(2)]
    w = threading.Thread(target=writer)
    for t in rs:
        t.start()
    w.start()
    w.join()
    for t in rs:
        t.join()
    handle.close()
    assert not errors
    assert repo.read(url, {"kind": "text", "path": ["t"]}) == "x" * 40
