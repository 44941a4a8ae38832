"""Every case of tests/test_serve.py not already in tests/test_torch_serve.py,
and the owed case of tests/test_serve_twin.py, under their own names on
the port's read-serving tier (hypermerge_tpu_torch/serve/: on a
`Repo(memory=True, device="cpu")` its installs and batched reads run the
plain versions of serve_lookup.cu, serve_order.cu and serve_counts.cu).
Each read a case checks is also made, through the same calls, on a
reference `Repo(memory=True)` (under HM_LIVE=0 HM_PIPELINE=0 HM_WAL=0
HM_SERVICE=0), and the answers are held equal (clock reads by their seq
multiset: actor ids are random per repo); tolerance 0.

`test_program_table_traces_once` tests the reference's jit program table;
its port counterpart is that the serve path builds nothing on repeated
reads and each kernel library is built and loaded once per process
(kernels/_build.py `load`).

The twinned files' own docstrings follow.

The read-serving tier (serve/): residency, batched query kernels,
degradation ladder, and the facade wiring.

HM_SERVE=1/0 twin fuzz: reads are bit-identical across random
edit/read interleavings, run in BOTH env orders.
"""

import random

import pytest

from hypermerge_tpu_torch import telemetry
from hypermerge_tpu_torch.models import Counter, Text
from hypermerge_tpu_torch.serve import READ_KINDS, host_read
from hypermerge_tpu_torch.utils.ids import validate_doc_url
from port_helpers import REF_SWITCHES, Repo, assert_kernel_built_once, ref_repo  # noqa: F401


def snap():
    return telemetry.snapshot()


def serve_counter(name):
    return snap().get("serve." + name, 0)


@pytest.fixture
def repo():
    r = Repo(memory=True)
    yield r
    r.close()


def _models(repo):
    """(Text, Counter) of the repo's package."""
    if type(repo).__module__.startswith("hypermerge_tpu_torch"):
        return Text, Counter
    from hypermerge_tpu.models import Counter as RefCounter
    from hypermerge_tpu.models import Text as RefText

    return RefText, RefCounter


def _seed(repo):
    text, _ = _models(repo)
    url = repo.create({"title": "hello", "n": 41, "pi": 2.5, "yes": True})
    repo.change(url, lambda d: d.__setitem__("text", text("hey there")))
    repo.change(url, lambda d: d.__setitem__("list", [1, "x", False]))
    repo.change(
        url, lambda d: d.__setitem__("nested", {"deep": {"v": 7}})
    )
    return url


def _normalize(q, v):
    if q["kind"] == "clock" and isinstance(v, list):
        # actor keys are random per repo: pin the seq multiset only
        return sorted(s.rsplit(":", 1)[-1] for s in v)
    return v


def _reads(repo, url, queries):
    return [_normalize(q, repo.read(url, q)) for q in queries]


QUERIES = [
    {"kind": "text", "path": ["text"]},
    {"kind": "lookup", "path": ["title"]},
    {"kind": "lookup", "path": ["n"]},
    {"kind": "lookup", "path": ["pi"]},
    {"kind": "lookup", "path": ["yes"]},
    {"kind": "lookup", "path": ["nested", "deep", "v"]},
    {"kind": "index", "path": ["list"], "index": 1},
    {"kind": "index", "path": ["text"], "index": 0},
    {"kind": "len", "path": []},
    {"kind": "len", "path": ["list"]},
    {"kind": "len", "path": ["text"]},
    {"kind": "history"},
    {"kind": "clock"},
]

MISSES = [
    {"kind": "lookup", "path": ["nested"]},
    {"kind": "lookup", "path": ["list"]},
    {"kind": "lookup", "path": ["text"]},
    {"kind": "lookup", "path": ["nope"]},
    {"kind": "lookup", "path": ["n", "deeper"]},
    {"kind": "text", "path": ["list"]},
    {"kind": "index", "path": ["list"], "index": 99},
    {"kind": "len", "path": ["n"]},
    {"kind": "wat", "path": []},
]


# ---------------------------------------------------------------------------
# read kinds


def test_read_kinds_against_materialized(repo, ref_repo):
    url = _seed(repo)
    doc = repo.doc(url)
    assert repo.read(url, {"kind": "text", "path": ["text"]}) == str(
        doc["text"]
    )
    assert repo.read(url, {"kind": "lookup", "path": ["title"]}) == "hello"
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 41
    assert repo.read(url, {"kind": "lookup", "path": ["pi"]}) == 2.5
    assert repo.read(url, {"kind": "lookup", "path": ["yes"]}) is True
    assert (
        repo.read(url, {"kind": "lookup", "path": ["nested", "deep", "v"]})
        == 7
    )
    assert repo.read(url, {"kind": "index", "path": ["list"], "index": 1}) == "x"
    assert repo.read(url, {"kind": "index", "path": ["text"], "index": 0}) == "h"
    assert repo.read(url, {"kind": "len", "path": []}) == len(doc)
    assert repo.read(url, {"kind": "len", "path": ["list"]}) == 3
    assert repo.read(url, {"kind": "len", "path": ["text"]}) == len(
        doc["text"]
    )
    assert repo.read(url, {"kind": "history"}) == 4
    clock = repo.read(url, {"kind": "clock"})
    assert isinstance(clock, list) and len(clock) == 1
    # the reference's answers to the same reads of the same doc
    got = _reads(repo, url, QUERIES)
    assert got == _reads(ref_repo, _seed(ref_repo), QUERIES)
    assert [type(v) for v in got] == [
        type(v) for v in _reads(ref_repo, _seed(ref_repo), QUERIES)]


def test_read_markers_and_misses(repo, ref_repo):
    url = _seed(repo)
    # containers collapse to type markers
    assert repo.read(url, {"kind": "lookup", "path": ["nested"]}) == {
        "_type": "map"
    }
    assert repo.read(url, {"kind": "lookup", "path": ["list"]}) == {
        "_type": "list"
    }
    assert repo.read(url, {"kind": "lookup", "path": ["text"]}) == {
        "_type": "text"
    }
    # broken paths answer None, never an error
    assert repo.read(url, {"kind": "lookup", "path": ["nope"]}) is None
    assert repo.read(url, {"kind": "lookup", "path": ["n", "deeper"]}) is None
    assert repo.read(url, {"kind": "text", "path": ["list"]}) is None
    assert (
        repo.read(url, {"kind": "index", "path": ["list"], "index": 99})
        is None
    )
    assert repo.read(url, {"kind": "len", "path": ["n"]}) is None
    assert repo.read(url, {"kind": "wat", "path": []}) is None
    assert _reads(repo, url, MISSES) == _reads(
        ref_repo, _seed(ref_repo), MISSES)


def test_counter_reads_fold_increments(repo, ref_repo):
    got = []
    for r in (repo, ref_repo):
        _, counter = _models(r)
        url = r.create()
        r.change(url, lambda d: d.__setitem__("c", counter(3)))
        r.change(url, lambda d: d.increment("c", 4))
        got.append(r.read(url, {"kind": "lookup", "path": ["c"]}))
    assert got[0] == 7
    assert got[0] == got[1]


def test_write_invalidates_and_rebuilds(repo, ref_repo):
    url = _seed(repo)
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 41
    inv0 = serve_counter("invalidations")
    repo.change(url, lambda d: d.__setitem__("n", 42))
    assert serve_counter("invalidations") == inv0 + 1
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 42
    rurl = _seed(ref_repo)
    ref_repo.read(rurl, {"kind": "lookup", "path": ["n"]})
    ref_repo.change(rurl, lambda d: d.__setitem__("n", 42))
    assert _reads(repo, url, QUERIES) == _reads(ref_repo, rurl, QUERIES)


# ---------------------------------------------------------------------------
# batched kernels + program table


def test_program_table_traces_once(tmp_path, monkeypatch):
    """The reference's serve programs trace once each in its shared
    table. The port's counterpart: repeated reads build no kernel
    library (on the CPU the plain versions run: no build at all, and no
    launch), give the same answers, and a kernel library is built and
    loaded once per process (a second `_build.load` of a stem returns
    the same library with no second compile)."""
    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.ops import crdt_kernels as ck

    r = Repo(memory=True)
    log, launches = dict(_build.build_log), dict(ck.launches)
    try:
        urls = [r.create({"i": i}) for i in range(4)]
        for i, u in enumerate(urls):
            r.change(u, lambda d, i=i: d.__setitem__("t", Text(f"x{i}")))
        d0 = serve_counter("dispatches")
        answers = []
        for _ in range(3):
            answers.append([r.read(u, {"kind": "text", "path": ["t"]})
                            for u in urls])
            assert all(answers[-1])
        assert answers == [[f"x{i}" for i in range(4)]] * 3
        assert serve_counter("dispatches") > d0, "the serve path never ran"
    finally:
        r.close()
    assert _build.build_log == log
    assert dict(ck.launches) == launches

    assert_kernel_built_once(tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# introspection surfaces


def test_host_read_twin_smoke(repo, ref_repo):
    from hypermerge_tpu.serve import host_read as ref_host_read

    url = _seed(repo)
    doc = repo.back.docs[validate_doc_url(url)]
    rurl = _seed(ref_repo)
    rdoc = ref_repo.back.docs[rurl.split("/")[-1]]
    for q in (
        {"kind": "text", "path": ["text"]},
        {"kind": "lookup", "path": ["title"]},
        {"kind": "len", "path": []},
        {"kind": "history"},
    ):
        assert host_read(doc, q) == {"value": repo.read(url, q)}
        assert host_read(doc, q) == ref_host_read(rdoc, q)
    assert set(READ_KINDS) == {
        "lookup", "index", "text", "len", "clock", "history"
    }
    from hypermerge_tpu.serve import READ_KINDS as REF_READ_KINDS

    assert set(READ_KINDS) == set(REF_READ_KINDS)


def test_write_releases_resident_bytes(repo, ref_repo):
    """mark_stale frees the invalidated entry's device tensors at the
    write, not at the next LRU pass."""
    url = _seed(repo)
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 41
    b0 = repo.back.serve._cache.resident_bytes
    assert b0 > 0
    repo.change(url, lambda d: d.__setitem__("n", 99))
    assert repo.back.serve._cache.resident_bytes < b0
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 99
    rurl = _seed(ref_repo)
    ref_repo.read(rurl, {"kind": "lookup", "path": ["n"]})
    ref_repo.change(rurl, lambda d: d.__setitem__("n", 99))
    assert _reads(repo, url, QUERIES) == _reads(ref_repo, rurl, QUERIES)


# ---------------------------------------------------------------------------
# tests/test_serve_twin.py: the HM_SERVE=1/0 twin fuzz

KEYS = ["a", "b", "c", "text", "list", "deep"]


def _edit(rng, text, counter):
    """One random mutation closure (deterministic given the rng stream),
    on the models of one package."""
    roll = rng.random()
    if roll < 0.25:
        k, v = rng.choice(KEYS[:3]), rng.randrange(100)
        return lambda d: d.__setitem__(k, v)
    if roll < 0.40:
        s = "".join(rng.choice("abcdef") for _ in range(3))

        def set_text(d):
            if not isinstance(d.get("text"), text):
                d["text"] = text(s)
            else:
                d["text"].insert(
                    rng.randrange(len(d["text"]) + 1) if len(d["text"])
                    else 0,
                    s,
                )
        return set_text
    if roll < 0.55:
        vals = [rng.randrange(10) for _ in range(rng.randrange(1, 4))]
        return lambda d: d.__setitem__("list", vals)
    if roll < 0.70:
        def bump(d):
            if isinstance(d.get("ctr"), counter):
                d.increment("ctr", 1)
            else:
                d["ctr"] = counter(rng.randrange(5))
        return bump
    if roll < 0.85:
        return lambda d: d.__setitem__(
            "deep", {"x": {"y": rng.randrange(50)}}
        )
    k = rng.choice(KEYS[:3])

    def remove(d):
        if k in d:
            del d[k]
    return remove


def _script_reads(rng):
    return [
        {"kind": "text", "path": ["text"]},
        {"kind": "lookup", "path": [rng.choice(KEYS[:3])]},
        {"kind": "lookup", "path": ["deep", "x", "y"]},
        {"kind": "lookup", "path": ["ctr"]},
        {"kind": "len", "path": []},
        {"kind": "len", "path": ["list"]},
        {"kind": "index", "path": ["list"], "index": rng.randrange(4)},
        {"kind": "history"},
        {"kind": "clock"},
    ]


def run_script(seed: int, serve: str, monkeypatch, make=None) -> list:
    monkeypatch.setenv("HM_SERVE", serve)
    rng = random.Random(seed)
    repo = (make or Repo)(memory=True)
    text, counter = _models(repo)
    out = []
    try:
        assert (repo.back.serve is None) == (serve == "0")
        urls = [repo.create() for _ in range(3)]
        for step in range(40):
            url = urls[rng.randrange(len(urls))]
            if rng.random() < 0.55:
                repo.change(url, _edit(rng, text, counter))
            else:
                for q in _script_reads(rng):
                    out.append(
                        (step, q["kind"], _normalize(q, repo.read(url, q)))
                    )
    finally:
        repo.close()
    return out


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("order", ["serve-first", "host-first"])
def test_twin_reads_bit_identical(seed, order, monkeypatch):
    """The port under HM_SERVE=1 and =0 (both orders), and the
    reference's served repo on the same script: every read equal."""
    from hypermerge_tpu.repo import Repo as RefRepo

    first, second = ("1", "0") if order == "serve-first" else ("0", "1")
    a = run_script(seed, first, monkeypatch)
    b = run_script(seed, second, monkeypatch)
    assert a == b
    for k, v in REF_SWITCHES.items():
        monkeypatch.setenv(k, v)
    assert a == run_script(seed, "1", monkeypatch, make=RefRepo)
