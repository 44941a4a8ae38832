"""The port's read-serving tier (hypermerge_tpu_torch/serve/) against the
JAX package's (hypermerge_tpu/serve/), on the CPU.

- Each plain serve kernel (serve/kernels.py) against the reference's
  jitted program on CPU jax, on the same lanes: synthetic lanes with pad
  rows, pad batch slots, misses, all-matching rows, mass rank ties and
  ranks at the int32 ends, and the lanes of real resident entries carried
  across with `convert.resident_entry_from_reference`.
- `build_entry` through both install routes (the host kernel run of a
  created or changed doc, and the bulk loader's summary memo) against
  the reference's lanes and host half, on copies of one
  reference-written repo directory.
- The read kinds and misses of tests/test_serve.py on the port, each
  equal to the port's host twin (`host_read`) and to the reference's
  served read; the residency lifecycle; the OOM evict-and-retry and
  degrade-to-host ladder through the `_to_device` seam.
- A device fault (a kernel launch that returns an error, an install
  upload that fails for another reason than memory) reaches the reader
  as ServeDeviceError, never as a None.
- tests/test_serve_twin.py's script on the port: served reads equal the
  port's HM_SERVE=0 twin and the reference's answers.

The reference runs with HM_LIVE=0 HM_PIPELINE=0 HM_WAL=0 HM_SERVICE=0,
the switches the port runs "off"; the port runs with device="cpu", where
its wrappers take the plain versions. Tolerance: exact.
"""

import contextlib
import functools
import random
import shutil
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypermerge_tpu.models import Counter as RefCounter
from hypermerge_tpu.models import Text as RefText
from hypermerge_tpu.ops.corpus import make_corpus as ref_make_corpus
from hypermerge_tpu.repo import Repo as RefRepo
from hypermerge_tpu.serve import kernels as ref_sk
from hypermerge_tpu.serve import resident as ref_resident
from hypermerge_tpu_torch import convert, telemetry
from hypermerge_tpu_torch.models import Counter, Text
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops import synth
from hypermerge_tpu_torch.repo import Repo
from hypermerge_tpu_torch.serve import READ_KINDS, ServeDeviceError, host_read
from hypermerge_tpu_torch.serve import kernels as sk
from hypermerge_tpu_torch.serve import resident
from hypermerge_tpu_torch.serve import tier as tiermod
from hypermerge_tpu_torch.utils import keys as keymod
from hypermerge_tpu_torch.utils.ids import to_doc_url, validate_doc_url

# the reference's switches for the parts the port leaves out
REF_SWITCHES = {
    "HM_LIVE": "0", "HM_PIPELINE": "0", "HM_WAL": "0", "HM_SERVICE": "0",
}


@pytest.fixture
def ref_env(monkeypatch):
    for k, v in REF_SWITCHES.items():
        monkeypatch.setenv(k, v)


@pytest.fixture
def repo():
    r = Repo(memory=True, device="cpu")
    yield r
    r.close()


def serve_counter(name):
    return telemetry.snapshot().get("serve." + name, 0)


class _Entry:
    """What the serve kernels read of a resident entry: its lanes."""

    def __init__(self, dev):
        self.dev = dev


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _run_kernel(mod, kind, entries, qobj, qkey):
    if kind == "map_lookup":
        return mod.map_lookup(entries, list(qobj), list(qkey))
    return getattr(mod, kind)(entries, list(qobj))


# ---------------------------------------------------------------------------
# the plain serve kernels against the reference's jitted programs


@pytest.mark.parametrize("scenario", synth.SERVE_SCENARIOS)
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("kind", ["map_lookup", "seq_order", "counts"])
def test_serve_plain_equals_reference(kind, B, scenario):
    """B = 3 pads the batch to 4 with a copy of entry 0 and NO_OBJ."""
    lanes, qobj, qkey = synth.synth_serve_lanes(B, 64, scenario, seed=B)
    ref = [_Entry(jnp.asarray(lanes[b])) for b in range(B)]
    port = [_Entry(torch.from_numpy(lanes[b].copy())) for b in range(B)]
    _assert_same(
        _run_kernel(sk, kind, port, qobj, qkey),
        _run_kernel(ref_sk, kind, ref, qobj, qkey),
    )


def _seed_doc(r, text_cls):
    url = r.create({"title": "hello", "n": 41, "pi": 2.5, "yes": True})
    r.change(url, lambda d: d.__setitem__("text", text_cls("hey there")))
    r.change(url, lambda d: d.__setitem__("list", [1, "x", False]))
    r.change(url, lambda d: d.__setitem__("nested", {"deep": {"v": 7}}))
    return url


def _ref_repo_dir(root):
    """A reference-written repo directory: seeded docs with text, lists,
    nested maps and a counter, then closed cleanly."""
    r = RefRepo(path=str(root))
    try:
        urls = [_seed_doc(r, RefText) for _ in range(3)]
        r.change(urls[1], lambda d: d.__setitem__("c", RefCounter(3)))
        r.change(urls[1], lambda d: d.increment("c", 4))
        r.change(urls[2], lambda d: d["text"].insert(3, "!!"))
        r.change(urls[2], lambda d: d["list"].__setitem__(1, "y"))
    finally:
        r.close()
    return urls


def _copies(src, tmp_path):
    a, b = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    return str(a), str(b)


def _assert_entries_equal(re, pe):
    assert pe.doc_id == re.doc_id and pe.clock == re.clock
    assert (pe.n, pe.bucket) == (re.n, re.bucket)
    assert pe.dev.dtype == torch.int32 and pe.dev.device.type == "cpu"
    np.testing.assert_array_equal(pe.dev.numpy(), np.asarray(re.dev))
    for k in ("action", "vkind", "value", "dt", "inc_total", "elem_val"):
        np.testing.assert_array_equal(getattr(pe, k), getattr(re, k), k)
    assert pe.key_index == re.key_index
    for k in ("strings", "floats", "bigints"):
        assert list(getattr(pe.tables, k)) == list(getattr(re.tables, k))


@pytest.mark.parametrize("route", ["host", "memo", "memo_kernel"])
def test_build_entry_matches_reference(tmp_path, ref_env, monkeypatch, route):
    """"host": docs opened one by one install through the host kernel
    run; "memo": after open_many + fetch_bulk_summaries the install
    reuses the summary memo (make_corpus docs, which the memo can
    serve). The port's slab always runs run_batch_full; "memo" holds it
    to the reference's host-twin slab, "memo_kernel" to the reference's
    device slab (HM_DEVICE_MIN_CELLS=0)."""
    src = tmp_path / "src"
    if route == "host":
        urls = _ref_repo_dir(src)
    else:
        urls = ref_make_corpus(str(src), 12, 64, distinct=3)
    if route == "memo_kernel":
        monkeypatch.setenv("HM_DEVICE_MIN_CELLS", "0")
    a, b = _copies(src, tmp_path)
    ref, port = RefRepo(path=a), Repo(path=b, device="cpu")
    try:
        for r in (ref, port):
            if route == "host":
                for u in urls:
                    r.doc(u)
            else:
                r.open_many(urls)
                r.back.fetch_bulk_summaries()
        for u in urls:
            doc_id = validate_doc_url(u)
            rclock = ref.back.docs[doc_id].clock
            assert port.back.docs[doc_id].clock == rclock
            re, rhit = ref_resident.build_entry(ref.back, doc_id, rclock)
            pe, phit = resident.build_entry(port.back, doc_id, rclock)
            assert rhit == phit == (route != "host")
            _assert_entries_equal(re, pe)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("kind", ["map_lookup", "seq_order", "counts"])
def test_kernels_on_converted_entries(tmp_path, ref_env, kind):
    """Real resident lanes: reference entries carried across with
    convert.resident_entry_from_reference, queried by both packages for
    every container row of each doc (and the root, and a miss)."""
    urls = _ref_repo_dir(tmp_path / "src")
    ref = RefRepo(path=str(tmp_path / "src"))
    try:
        entries = []
        for u in urls:
            ref.doc(u)
            doc_id = validate_doc_url(u)
            e, _ = ref_resident.build_entry(
                ref.back, doc_id, ref.back.docs[doc_id].clock
            )
            entries.append(e)
    finally:
        ref.close()
    port = [convert.resident_entry_from_reference(e, device="cpu")
            for e in entries]
    for pe, re in zip(port, entries):
        _assert_entries_equal(re, pe)
    rng = random.Random(5)
    for _ in range(6):
        picks = [rng.randrange(len(entries)) for _ in range(rng.randint(1, 5))]
        qobj, qkey = [], []
        for i in picks:
            e = entries[i]
            rows = [-1, sk.NO_OBJ] + [
                r for r in range(e.n) if e.obj_type(r) is not None
            ]
            qobj.append(rng.choice(rows))
            qkey.append(rng.choice(list(e.key_index.values()) + [-1]))
        _assert_same(
            _run_kernel(sk, kind, [port[i] for i in picks], qobj, qkey),
            _run_kernel(ref_sk, kind, [entries[i] for i in picks], qobj, qkey),
        )


# ---------------------------------------------------------------------------
# read kinds, markers and misses (tests/test_serve.py:49-104) on the port


READ_QUERIES = [
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
    {"kind": "lookup", "path": ["nested"]},
    {"kind": "lookup", "path": ["list"]},
    {"kind": "lookup", "path": ["text"]},
    {"kind": "lookup", "path": ["nope"]},
    {"kind": "lookup", "path": ["n", "deeper"]},
    {"kind": "text", "path": ["list"]},
    {"kind": "index", "path": ["list"], "index": 99},
    {"kind": "len", "path": ["n"]},
    {"kind": "wat", "path": []},
    {"kind": "lookup", "path": ["c"]},
]


@pytest.fixture(scope="module")
def seeded_pair():
    """(port repo, its url, reference repo, its url) holding the same
    seeded doc (plus a counter folded from 3 and an increment of 4)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_SWITCHES.items():
            mp.setenv(k, v)
        ref = RefRepo(memory=True)
    port = Repo(memory=True, device="cpu")
    try:
        out = []
        for r, text_cls, ctr in ((port, Text, Counter), (ref, RefText, RefCounter)):
            url = _seed_doc(r, text_cls)
            r.change(url, lambda d, ctr=ctr: d.__setitem__("c", ctr(3)))
            r.change(url, lambda d: d.increment("c", 4))
            out += [r, url]
        yield tuple(out)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize(
    "query", READ_QUERIES, ids=lambda q: "-".join(
        [q["kind"]] + [str(s) for s in q.get("path", [])]
        + ([str(q["index"])] if "index" in q else [])
    )
)
def test_read_kinds_equal_host_twin_and_reference(seeded_pair, query):
    port, url, ref, ref_url = seeded_pair
    got = port.read(url, query)
    doc = port.back.docs[validate_doc_url(url)]
    want = host_read(doc, query)
    assert (got is None and want is None) or got == want["value"]
    assert got == ref.read(ref_url, query)


def test_read_values_against_materialized(seeded_pair):
    port, url, _ref, _ref_url = seeded_pair
    doc = port.doc(url)
    assert port.read(url, {"kind": "text", "path": ["text"]}) == str(doc["text"])
    assert port.read(url, {"kind": "lookup", "path": ["c"]}) == 7
    assert port.read(url, {"kind": "len", "path": []}) == len(doc)
    clock = port.read(url, {"kind": "clock"})
    assert isinstance(clock, list) and len(clock) == 1
    assert set(READ_KINDS) == {
        "lookup", "index", "text", "len", "clock", "history"
    }


def test_read_unknown_doc_is_none_and_creates_nothing(repo):
    url = to_doc_url(keymod.create().public_key)
    n_docs = len(repo.back.docs)
    assert repo.read(url, {"kind": "lookup", "path": ["a"]}) is None
    assert len(repo.back.docs) == n_docs


def test_read_async_callback(repo):
    url = _seed_doc(repo, Text)
    done = threading.Event()
    got = []

    def cb(value):
        got.append(value)
        done.set()

    repo.read(url, {"kind": "lookup", "path": ["n"]}, cb)
    assert done.wait(10)
    assert got == [41]


# ---------------------------------------------------------------------------
# residency lifecycle


def test_install_then_hits(repo):
    url = _seed_doc(repo, Text)
    h0, i0 = serve_counter("hits"), serve_counter("installs")
    for _ in range(3):
        assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 41
    assert serve_counter("installs") == i0 + 1
    assert serve_counter("hits") >= h0 + 2
    rep = repo.back.serve.residency_report()["resident"]
    assert list(rep) == [validate_doc_url(url)]


def test_write_invalidates_rebuilds_and_releases_bytes(repo):
    url = _seed_doc(repo, Text)
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 41
    b0 = repo.back.serve._cache.resident_bytes
    inv0 = serve_counter("invalidations")
    repo.change(url, lambda d: d.__setitem__("n", 42))
    assert serve_counter("invalidations") == inv0 + 1
    assert repo.back.serve._cache.resident_bytes < b0
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 42


def test_byte_budget_evicts_lru(repo, monkeypatch):
    monkeypatch.setenv("HM_SERVE_MAX_BYTES", "4000")
    urls = [_seed_doc(repo, Text) for _ in range(4)]
    for u in urls:
        assert repo.read(u, {"kind": "lookup", "path": ["n"]}) == 41
    assert serve_counter("evictions") > 0
    rep = repo.back.serve.residency_report()
    assert rep["evicted"] and rep["bytes"] <= 4000
    assert repo.read(urls[0], {"kind": "lookup", "path": ["title"]}) == "hello"


def test_close_doc_drops_residency(repo):
    url = _seed_doc(repo, Text)
    repo.read(url, {"kind": "lookup", "path": ["n"]})
    repo.close_doc(url)
    assert validate_doc_url(url) not in (
        repo.back.serve.residency_report()["resident"]
    )


def test_concurrent_reads_batch(repo):
    urls = [_seed_doc(repo, Text) for _ in range(4)]
    b0, r0 = serve_counter("batches"), serve_counter("reads")
    out = {}

    def reader(n):
        for j in range(8):
            u = urls[(n + j) % len(urls)]
            out[(n, j)] = repo.read(u, {"kind": "text", "path": ["text"]})

    ts = [threading.Thread(target=reader, args=(n,)) for n in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(v == "hey there" for v in out.values())
    assert serve_counter("reads") - r0 == 64
    assert serve_counter("batches") - b0 < 64


def test_bulk_summary_memo_feeds_installs(tmp_path):
    path = str(tmp_path / "repo")
    r = Repo(path=path, device="cpu")
    try:
        urls = [r.create({"i": i}) for i in range(3)]
        for i, u in enumerate(urls):
            r.change(u, lambda d, i=i: d.__setitem__("t", Text(f"doc{i}")))
    finally:
        r.close()
    r = Repo(path=path, device="cpu")
    try:
        r.open_many(urls)
        r.back.fetch_bulk_summaries()
        m0 = serve_counter("memo_hits")
        for i, u in enumerate(urls):
            assert r.read(u, {"kind": "text", "path": ["t"]}) == f"doc{i}"
        assert serve_counter("memo_hits") >= m0 + len(urls)
    finally:
        r.close()


def test_telemetry_query_carries_residency(repo):
    url = _seed_doc(repo, Text)
    repo.read(url, {"kind": "lookup", "path": ["n"]})
    got = []
    repo.telemetry(got.append)
    assert got and got[0]["serve"]["resident"]
    assert any(k.startswith("serve.") for k in got[0]["counters"])


def test_serve_off_is_host_twin(monkeypatch):
    monkeypatch.setenv("HM_SERVE", "0")
    r = Repo(memory=True, device="cpu")
    try:
        assert r.back.serve is None
        url = r.create({"a": 1})
        r.change(url, lambda d: d.__setitem__("t", Text("plain")))
        assert r.read(url, {"kind": "text", "path": ["t"]}) == "plain"
        assert r.read(url, {"kind": "lookup", "path": ["a"]}) == 1
    finally:
        r.close()


def test_read_after_tier_close_degrades(repo):
    url = _seed_doc(repo, Text)
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 41
    repo.back.serve.close()
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 41
    assert repo.read(url, {"kind": "text", "path": ["text"]}) == "hey there"


def test_admission_overflow_degrades(monkeypatch):
    monkeypatch.setenv("HM_SERVE_QUEUE", "0")
    r = Repo(memory=True, device="cpu")
    try:
        url = _seed_doc(r, Text)
        f0, s0 = serve_counter("fallbacks"), serve_counter("overload_shed")
        assert r.read(url, {"kind": "lookup", "path": ["n"]}) == 41
        assert serve_counter("overload_shed") == s0 + 1
        assert serve_counter("fallbacks") == f0
    finally:
        r.close()


# ---------------------------------------------------------------------------
# the degradation ladder through the _to_device seam


def test_device_oom_evicts_and_retries_once(repo, monkeypatch):
    warm = _seed_doc(repo, Text)
    assert repo.read(warm, {"kind": "lookup", "path": ["n"]}) == 41
    url = _seed_doc(repo, Text)
    real = resident._to_device
    fails = {"n": 1}

    def flaky(arr, device):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(arr, device)

    monkeypatch.setattr(resident, "_to_device", flaky)
    p0, f0 = serve_counter("evictions_pressure"), serve_counter("fallbacks")
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 41
    assert serve_counter("evictions_pressure") > p0
    assert serve_counter("fallbacks") == f0


def test_device_oom_twice_degrades_to_host(repo, monkeypatch):
    warm = _seed_doc(repo, Text)
    repo.read(warm, {"kind": "lookup", "path": ["n"]})
    url = _seed_doc(repo, Text)

    def dead(arr, device):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(resident, "_to_device", dead)
    f0 = serve_counter("fallbacks")
    assert repo.read(url, {"kind": "text", "path": ["text"]}) == "hey there"
    assert serve_counter("fallbacks") > f0


def test_unserveable_doc_falls_back_with_host_memo(repo, monkeypatch):
    url = _seed_doc(repo, Text)
    monkeypatch.setattr(repo.back, "_serveable_spec", lambda clock: None)
    f0, m0 = serve_counter("fallbacks"), serve_counter("host_memo_hits")
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 41
    assert repo.read(url, {"kind": "lookup", "path": ["title"]}) == "hello"
    assert serve_counter("fallbacks") >= f0 + 2
    assert serve_counter("host_memo_hits") >= m0 + 1


def test_non_oom_install_failure_does_not_shed(repo, monkeypatch):
    urls = [_seed_doc(repo, Text) for _ in range(3)]
    for u in urls:
        assert repo.read(u, {"kind": "lookup", "path": ["n"]}) == 41
    n0 = repo.back.serve._cache.resident_docs

    def broken(backend, doc_id, clock):
        raise ValueError("corrupt sidecar (not oom)")

    monkeypatch.setattr(tiermod, "build_entry", broken)
    cold = _seed_doc(repo, Text)
    p0, f0 = serve_counter("evictions_pressure"), serve_counter("fallbacks")
    assert repo.read(cold, {"kind": "lookup", "path": ["n"]}) == 41
    assert serve_counter("fallbacks") > f0
    assert serve_counter("evictions_pressure") == p0
    assert repo.back.serve._cache.resident_docs == n0


@pytest.mark.parametrize("exc, oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (MemoryError(), True),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), True),
    (ValueError("corrupt sidecar"), False),
])
def test_looks_like_oom(exc, oom):
    assert resident.looks_like_oom(exc) is oom


# ---------------------------------------------------------------------------
# device faults reach the reader


def _fail_launches(monkeypatch, public):
    """Send the serve wrapper `public` (map_lookup, seq_order, counts)
    down its CUDA route on CPU lanes, with its kernel's launch returning
    the error 719 (cudaErrorLaunchFailure); the other wrappers keep their
    plain route. Returns the launch counts before any read."""
    real, on = getattr(sk, public), [False]

    @functools.wraps(real)
    def cuda_route(*args):
        on[0] = True
        try:
            return real(*args)
        finally:
            on[0] = False

    monkeypatch.setattr(sk, public, cuda_route)
    monkeypatch.setattr(sk, "_on_gpu", lambda devs: on[0])
    monkeypatch.setattr(ck, "kernel_fn", lambda stem: (lambda *a: 719))
    monkeypatch.setattr(
        torch.cuda, "device", lambda dev: contextlib.nullcontext()
    )
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda dev=None: types.SimpleNamespace(cuda_stream=0),
    )
    return dict(ck.launches)


@pytest.mark.parametrize("public, kernel, query", [
    ("map_lookup", "serve_lookup", {"kind": "lookup", "path": ["n"]}),
    ("seq_order", "serve_order", {"kind": "text", "path": ["text"]}),
    ("counts", "serve_counts", {"kind": "len", "path": []}),
])
def test_kernel_launch_failure_raises_to_reader(repo, monkeypatch, public,
                                                kernel, query):
    url = _seed_doc(repo, Text)
    before = _fail_launches(monkeypatch, public)
    f0 = serve_counter("fallbacks")
    with pytest.raises(ServeDeviceError,
                       match=f"{kernel} failed to launch: error 719"):
        repo.read(url, query)
    assert ck.launches == before  # a failed launch counts nothing
    assert serve_counter("fallbacks") == f0


def test_kernel_launch_failure_reaches_the_callback(repo, monkeypatch):
    url = _seed_doc(repo, Text)
    _fail_launches(monkeypatch, "counts")
    got, done = [], threading.Event()

    def cb(value):
        got.append(value)
        done.set()

    repo.read(url, {"kind": "len", "path": []}, cb)
    assert done.wait(10)
    assert "serve_counts failed to launch" in got[0]["_error"]


def test_install_upload_fault_raises_to_reader(repo, monkeypatch):
    url = _seed_doc(repo, Text)

    def broken(arr, device):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(resident, "_to_device", broken)
    f0 = serve_counter("fallbacks")
    p0 = serve_counter("evictions_pressure")
    with pytest.raises(ServeDeviceError, match="illegal memory access"):
        repo.read(url, {"kind": "lookup", "path": ["n"]})
    assert serve_counter("fallbacks") == f0
    assert serve_counter("evictions_pressure") == p0
    monkeypatch.undo()  # the device is back: the doc installs and serves
    assert repo.read(url, {"kind": "lookup", "path": ["n"]}) == 41


# ---------------------------------------------------------------------------
# the twin script (tests/test_serve_twin.py) on the port and the reference

KEYS = ["a", "b", "c", "text", "list", "deep"]


def _edit(rng, text_cls, ctr_cls):
    roll = rng.random()
    if roll < 0.25:
        k, v = rng.choice(KEYS[:3]), rng.randrange(100)
        return lambda d: d.__setitem__(k, v)
    if roll < 0.40:
        s = "".join(rng.choice("abcdef") for _ in range(3))

        def set_text(d):
            if not isinstance(d.get("text"), text_cls):
                d["text"] = text_cls(s)
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
            if isinstance(d.get("ctr"), ctr_cls):
                d.increment("ctr", 1)
            else:
                d["ctr"] = ctr_cls(rng.randrange(5))
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


def _reads(rng):
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


def _normalize(q, v):
    if q["kind"] == "clock" and isinstance(v, list):
        # actor keys are random per run: pin the seq multiset only
        return sorted(s.rsplit(":", 1)[-1] for s in v)
    return v


def run_script(seed, make_repo, text_cls, ctr_cls):
    rng = random.Random(seed)
    repo = make_repo()
    out = []
    try:
        urls = [repo.create() for _ in range(3)]
        for step in range(40):
            url = urls[rng.randrange(len(urls))]
            if rng.random() < 0.55:
                repo.change(url, _edit(rng, text_cls, ctr_cls))
            else:
                for q in _reads(rng):
                    out.append(
                        (step, q["kind"], _normalize(q, repo.read(url, q)))
                    )
    finally:
        repo.close()
    return out


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("order", ["serve-first", "host-first"])
def test_twin_reads_equal_host_twin_and_reference(seed, order, ref_env,
                                                  monkeypatch):
    def port(serve):
        monkeypatch.setenv("HM_SERVE", serve)
        return run_script(seed, lambda: Repo(memory=True, device="cpu"),
                          Text, Counter)

    first, second = ("1", "0") if order == "serve-first" else ("0", "1")
    a, b = port(first), port(second)
    assert a == b
    monkeypatch.setenv("HM_SERVE", "1")
    assert run_script(seed, lambda: RefRepo(memory=True), RefText,
                      RefCounter) == a


def test_twin_interleaved_invalidation(monkeypatch):
    def run(serve):
        monkeypatch.setenv("HM_SERVE", serve)
        r = Repo(memory=True, device="cpu")
        try:
            url = r.create()
            r.change(url, lambda d: d.__setitem__("t", Text("")))
            vals = []
            for i in range(12):
                r.change(url, lambda d, i=i: d["t"].insert(len(d["t"]), str(i)))
                vals.append(r.read(url, {"kind": "text", "path": ["t"]}))
            return vals
        finally:
            r.close()

    served, host = run("1"), run("0")
    assert served == host
    assert served[-1] == "".join(str(i) for i in range(12))
