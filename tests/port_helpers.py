"""tests/helpers.py on the port, for the case-for-case twins.

`Site`, `plainify`, `sync` and `random_mutation` are tests/helpers.py's,
built on the port's FrontendDoc, OpSet and models. `plainify` gives the
same plain form as the reference's (("__text__", str), ("__counter__",
int), ...), so a port value and a reference value compare with ==.
`to_reference` carries a port history into the reference's Change type
(the JSON form both packages share), for the twins that hold a value
against the reference package's answer on the same inputs. `Repo` is the
port's Repo on the CPU, as every twin runs it.

The reference package is imported only inside the functions that ask
it for its answer (`to_reference`, `ref_bulk_summaries`, `ref_docs`,
`ref_plain`), never at module level.
"""

import contextlib
import os
import shutil
import time

import pytest

from hypermerge_tpu_torch.crdt.frontend_state import FrontendDoc
from hypermerge_tpu_torch.crdt.opset import OpSet
from hypermerge_tpu_torch.models import Counter, Table, Text
from hypermerge_tpu_torch.repo import Repo as _PortRepo


def Repo(*args, **kw):
    """The port's Repo on the CPU (tests run where no card is present)."""
    kw.setdefault("device", "cpu")
    return _PortRepo(*args, **kw)


class Site:
    def __init__(self, actor: str):
        self.actor = actor
        self.front = FrontendDoc()
        self.opset = OpSet()
        self.seq = 1

    def change(self, fn, message=""):
        req, preview = self.front.change(fn, self.actor, self.seq, message)
        if req is None:
            return None, preview
        self.seq += 1
        change, patch = self.opset.apply_local_request(req)
        self.front.apply_patch(patch)
        return change, preview

    def receive(self, changes):
        patch = self.opset.apply_changes(changes)
        self.front.apply_patch(patch)

    @property
    def doc(self):
        return self.front.materialize()

    def assert_consistent(self):
        assert plainify(self.opset.materialize()) == plainify(self.doc)


def plainify(v):
    if isinstance(v, Text):
        return ("__text__", str(v))
    if isinstance(v, Table):
        return ("__table__", {k: plainify(v.by_id(k)) for k in v.ids})
    if isinstance(v, Counter):
        return ("__counter__", int(v))
    if isinstance(v, dict):
        return {k: plainify(x) for k, x in v.items()}
    if isinstance(v, list):
        return [plainify(x) for x in v]
    return v


def wait_until(fn, timeout=10.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while True:
        v = fn()
        if v:
            return v
        if time.monotonic() > deadline:
            raise AssertionError(f"wait_until timed out: {fn}")
        time.sleep(interval)


def sync(*sites):
    for a in sites:
        for b in sites:
            if a is not b:
                a.receive(list(b.opset.history))


def random_mutation(site: Site, r) -> None:
    """One random change covering every op family (maps, lists, text,
    counters, deletes, nested objects): tests/helpers.py's, on the port's
    models, drawing from `r` in the same order."""

    def fn(d):
        choice = r.random()
        if choice < 0.3:
            d[r.choice("abc")] = r.randint(0, 99)
        elif choice < 0.45:
            if "l" not in d:
                d["l"] = []
            lst = d["l"]
            lst.insert(r.randint(0, len(lst)), r.randint(0, 9))
        elif choice < 0.55:
            if "l" in d and len(d["l"]) > 0:
                del d["l"][r.randint(0, len(d["l"]) - 1)]
        elif choice < 0.7:
            if "t" not in d:
                d["t"] = Text("")
            d["t"].insert(r.randint(0, len(d["t"])), r.choice("xyz"))
        elif choice < 0.8:
            if "n" not in d or not isinstance(d.get("n"), Counter):
                d["n"] = Counter(0)
            else:
                d.increment("n", r.randint(1, 3))
        elif choice < 0.9:
            k = r.choice("abc")
            if k in d:
                del d[k]
        else:
            d[r.choice("mn")] = {"v": [r.randint(0, 9)]}

    site.change(fn)


def to_reference(changes):
    """The reference package's Changes for a port history."""
    from hypermerge_tpu.crdt.change import Change as RefChange

    return [RefChange.from_json(c.to_json()) for c in changes]


# -- the reference package's answers on the same inputs ---------------------

# the switches under which the reference's Repo runs the port's routes
# ("off" in the port: no live engine, pipeline, journal or service plane)
REF_SWITCHES = {
    "HM_LIVE": "0", "HM_PIPELINE": "0", "HM_WAL": "0", "HM_SERVICE": "0",
}


@contextlib.contextmanager
def env_vars(**values):
    """Environment variables set for the block, restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture
def ref_repo(monkeypatch):
    """A reference Repo(memory=True) under REF_SWITCHES (a test module
    that imports this name gets the fixture)."""
    from hypermerge_tpu.repo import Repo as RefRepo

    for k, v in REF_SWITCHES.items():
        monkeypatch.setenv(k, v)
    r = RefRepo(memory=True)
    yield r
    r.close()


def copy_repo(src, dst):
    """A copy of a repo directory (never hard links: an open writes
    through them)."""
    shutil.copytree(str(src), str(dst))
    return str(dst)


def ref_bulk_summaries(path, urls, **env):
    """{doc id: summary} of the reference Repo's `open_many` +
    `fetch_bulk_summaries` on the repo directory `path` (open it on a
    copy: the reference writes its own sidecars and markers)."""
    from hypermerge_tpu.repo import Repo as RefRepo
    from hypermerge_tpu.utils.ids import validate_doc_url

    with env_vars(**{**REF_SWITCHES, **env}):
        r = RefRepo(path=str(path))
        try:
            r.open_many(urls)
            s = r.back.fetch_bulk_summaries()
            return {validate_doc_url(u): s.doc(validate_doc_url(u))
                    for u in urls}
        finally:
            r.close()


def ref_docs(path, urls, **env):
    """[plain value] of each url in the reference Repo opened on `path`."""
    from hypermerge_tpu.repo import Repo as RefRepo

    with env_vars(**{**REF_SWITCHES, **env}):
        r = RefRepo(path=str(path))
        try:
            return [ref_plain(r.doc(u)) for u in urls]
        finally:
            r.close()


def ref_plain(v):
    """A reference value in `plainify`'s form."""
    from helpers import plainify as ref_plainify

    return ref_plainify(v)


def ref_opset(changes):
    """A reference OpSet that applied the port history `changes`."""
    from hypermerge_tpu.crdt.opset import OpSet as RefOpSet

    op = RefOpSet()
    op.apply_changes(to_reference(changes))
    return op


def assert_reference_agrees(*sites):
    """Each port site's state == the reference OpSet's after the same
    changes, in the order the site holds them: the materialized doc, the
    clock, the snapshot patch's JSON and the doc a fresh frontend builds
    from that patch."""
    from hypermerge_tpu.crdt.frontend_state import FrontendDoc as RefFront

    for s in sites:
        ref = ref_opset(s.opset.history)
        assert ref_plain(ref.materialize()) == plainify(s.opset.materialize())
        assert dict(ref.clock) == dict(s.opset.clock)
        front, port_front = RefFront(), FrontendDoc()
        front.apply_patch(ref.snapshot_patch())
        port_front.apply_patch(s.opset.snapshot_patch())
        assert ref_plain(front.materialize()) == plainify(
            port_front.materialize())
        assert ref.snapshot_patch().to_json() == \
            s.opset.snapshot_patch().to_json()


def assert_batch_equal(batch, ref_batch):
    """A port ColumnarBatch == a reference one, field for field (the
    derived doc_actors and slot planes derived on both sides first: a
    kernel call caches them onto a batch)."""
    import numpy as np

    from hypermerge_tpu.ops import crdt_kernels as ref_ck
    from hypermerge_tpu_torch import convert
    from hypermerge_tpu_torch.ops import crdt_kernels as ck

    ck.ensure_slot(batch)
    ref_ck.ensure_slot(ref_batch)

    got, want = convert.batch_to_numpy(batch), convert.batch_to_numpy(ref_batch)
    for name in convert.BATCH_FIELDS:
        g, w = got[name], want[name]
        if name == "cols":
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)
        elif w is None or g is None:
            assert g is None and w is None, name
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=name)
        else:
            assert list(g) == list(w), name


def assert_reference_reads(path, urls, want, **env):
    """The reference Repo, opened on a copy of the repo directory `path`,
    gives the plain values `want` for `urls`."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="hm-ref-") as tmp:
        copy = copy_repo(path, os.path.join(tmp, "repo"))
        assert ref_docs(copy, urls, **env) == list(want)


def assert_reference_summaries(path, urls, want, **env):
    """The reference Repo's bulk summaries of `urls`, on a copy of the
    repo directory `path`, == `want` ({doc id: summary})."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="hm-ref-") as tmp:
        copy = copy_repo(path, os.path.join(tmp, "repo"))
        assert ref_bulk_summaries(copy, urls, **env) == want


def repo_history(repo, url):
    """A port Repo's change history of one doc: each actor of its cursor,
    up to the cursor's seq (the feeds the doc reads)."""
    from hypermerge_tpu_torch.utils.ids import validate_doc_url

    back = repo.back
    doc_id = validate_doc_url(url)
    back._stores.flush_now()
    cursor = back.cursors.get(back.id, doc_id)
    changes = []
    for actor_id, seq in sorted(cursor.items()):
        actor = back.actors.get(actor_id)
        if actor is not None:
            changes += actor.changes_in_window(0, seq)
    return changes


def assert_repo_doc_reference(repo, url, value=None):
    """The doc's value in a port Repo == the reference OpSet's after the
    doc's history (carried over by its JSON form); returns the reference
    OpSet."""
    ref = ref_opset(repo_history(repo, url))
    want = ref_plain(ref.materialize())
    got = plainify(repo.doc(url) if value is None else value)
    assert got == want
    return ref


def assert_kernel_built_once(tmp_path, monkeypatch):
    """kernels/_build.py builds and loads a kernel library once per
    process: through a stand-in compiler (tests/test_torch_pipeline.py's),
    a stem's first `load` compiles once and every later `load` returns the
    same library with no second compile."""
    from hypermerge_tpu_torch.kernels import _build
    from test_torch_pipeline import _stand_in_compiler

    script, count = _stand_in_compiler(tmp_path)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "stand_in.cu").write_text("// a kernel source\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(_build, "_libs", {})
    lib = _build.load("stand_in")
    assert all(_build.load("stand_in") is lib for _ in range(3))
    assert lib.hm_stand_in() == 7
    assert count.read_text() == "x"  # one compile
