"""The port's `Repo` facade (hypermerge_tpu_torch/repo.py and the frontend,
backend and storage beneath it) against the JAX package's, on the CPU.

- `create` / `change` / `doc` / `materialize` over seeded edit scripts
  give the same documents in both packages, at every point of history.
- A corpus the reference wrote (16 docs x 64 ops, `make_corpus`, and a
  repo of interactively edited docs with counters and list overrides),
  copied into two directories and opened by each package through
  `open_many` + `fetch_bulk_summaries`, gives byte-equal summaries and
  identical snapshot patches — the port's slab always through
  `run_batch_full`, the reference's through its host kernel twin and
  through its device kernels (HM_DEVICE_MIN_CELLS=0) — and again from
  the summary memo after `close_doc` and a second `open_many`.
- A corpus the port's `make_corpus` wrote opens in the reference to the
  same state, with the corpus slab and with per-feed `.cols2` files.
- A directory left with its `repo.dirty` marker is recovered on open,
  with the reference's recovery report on a copy of it, and a clean close
  removes the marker.
- The host library (native/): blocks and change frames one package
  packed, the other unpacks, byte for byte; parallel first builds are
  atomic.
- The Repo scenarios of tests/test_repo.py on the port, and its file
  entry points (`files`, `start_file_server`) answering as the
  reference's.

The reference runs with HM_LIVE=0 HM_PIPELINE=0 HM_WAL=0 HM_SERVICE=0;
the port runs with device="cpu". Tolerance: exact.
"""

import json
import os
import random
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from hypermerge_tpu.crdt import codec as ref_codec
from hypermerge_tpu.models import Counter as RefCounter
from hypermerge_tpu.models import Text as RefText
from hypermerge_tpu.ops.corpus import make_corpus as ref_make_corpus
from hypermerge_tpu.repo import Repo as RefRepo
from hypermerge_tpu.storage import block as ref_block
from hypermerge_tpu_torch import native
from hypermerge_tpu_torch.crdt import codec
from hypermerge_tpu_torch.models import Counter, Text
from hypermerge_tpu_torch.ops.corpus import make_corpus
from hypermerge_tpu_torch.repo import Repo
from hypermerge_tpu_torch.storage import block
from hypermerge_tpu_torch.utils.ids import validate_doc_url
from test_torch_serve import REF_SWITCHES, _edit, _ref_repo_dir

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ref_env(monkeypatch):
    for k, v in REF_SWITCHES.items():
        monkeypatch.setenv(k, v)


@pytest.fixture
def repo():
    r = Repo(memory=True, device="cpu")
    yield r
    r.close()


def plain(v):
    """A materialized value of either package as plain Python, tagged by
    type: the two packages' Text and Counter are different classes."""
    name = type(v).__name__
    if name == "Text":
        return ("Text", str(v))
    if name == "Counter":
        return ("Counter", int(v))
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [plain(x) for x in v]
    return v


def materialized(r, url, k):
    out = []
    r.materialize(url, k, out.append)
    assert len(out) == 1
    return plain(out[0])


# ---------------------------------------------------------------------------
# create / change / doc / materialize


def _script(r, seed, text_cls, ctr_cls):
    """Seeded edits over three docs and a fork of one; returns the urls
    in creation order. (No merge: concurrent writes to one key resolve
    by actor id, which is random per repo.)"""
    rng = random.Random(seed)
    urls = [r.create({"i": i}) for i in range(3)]
    for _ in range(30):
        r.change(urls[rng.randrange(3)], _edit(rng, text_cls, ctr_cls))
    fork = r.fork(urls[2])
    r.change(fork, _edit(rng, text_cls, ctr_cls))
    return urls + [fork]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_histories_identical(ref_env, seed):
    ref = RefRepo(memory=True)
    port = Repo(memory=True, device="cpu")
    try:
        ref_urls = _script(ref, seed, RefText, RefCounter)
        port_urls = _script(port, seed, Text, Counter)
        for ru, pu in zip(ref_urls, port_urls):
            assert plain(port.doc(pu)) == plain(ref.doc(ru))
            rdoc = ref.back.docs[validate_doc_url(ru)]
            pdoc = port.back.docs[validate_doc_url(pu)]
            assert pdoc.history_len == rdoc.history_len
            for k in range(1, pdoc.history_len + 1):
                assert materialized(port, pu, k) == materialized(ref, ru, k)
    finally:
        ref.close()
        port.close()


# ---------------------------------------------------------------------------
# reference-written corpora through open_many + fetch_bulk_summaries


def _write_corpus(kind, root):
    if kind == "make_corpus":
        return ref_make_corpus(str(root), 16, 64, distinct=4)
    return _ref_repo_dir(root)


def _summary_rows(summ, doc_ids):
    rows = {}
    for d in doc_ids:
        arrays, j = summ.arrays(d)
        rows[d] = {
            k: np.asarray(arrays[k][j])
            for k in ("map_winner", "elem_live", "elem_order",
                      "n_live_elems", "n_map_entries", "clock")
        }
        rows[d]["doc"] = summ.doc(d)
    return rows


def _assert_rows_equal(got, want):
    assert got.keys() == want.keys()
    for d in want:
        assert got[d]["doc"] == want[d]["doc"]
        for k, w in want[d].items():
            if k == "doc":
                continue
            g = got[d][k]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k


def _bulk_open(r, urls):
    r.open_many(urls)
    return r.back.fetch_bulk_summaries()


@pytest.mark.parametrize("min_cells", [None, "0"])
@pytest.mark.parametrize("kind", ["make_corpus", "interactive"])
def test_reference_corpus_opens_identically(tmp_path, ref_env, monkeypatch,
                                            kind, min_cells):
    src = tmp_path / "src"
    urls = _write_corpus(kind, src)
    if min_cells is not None:  # the reference's slab on its kernels too
        monkeypatch.setenv("HM_DEVICE_MIN_CELLS", min_cells)
    a, b = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    ref, port = RefRepo(path=str(a)), Repo(path=str(b), device="cpu")
    try:
        ids = [validate_doc_url(u) for u in urls]
        want = _summary_rows(_bulk_open(ref, urls), ids)
        got = _summary_rows(_bulk_open(port, urls), ids)
        _assert_rows_equal(got, want)
        assert port.back.last_bulk_stats["fast"] == len(urls)
        for d in ids:
            rp = ref.back.docs[d].snapshot_patch().to_json()
            assert port.back.docs[d].snapshot_patch().to_json() == rp
        for u in urls:
            assert plain(port.doc(u)) == plain(ref.doc(u))
    finally:
        ref.close()
        port.close()


def test_reopen_serves_from_the_summary_memo(tmp_path, ref_env):
    src = tmp_path / "src"
    urls = ref_make_corpus(str(src), 16, 64, distinct=4)
    a, b = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    ref, port = RefRepo(path=str(a)), Repo(path=str(b), device="cpu")
    try:
        ids = [validate_doc_url(u) for u in urls]
        for r in (ref, port):
            _bulk_open(r, urls)
            for u in urls:
                r.close_doc(u)
        want = _summary_rows(_bulk_open(ref, urls), ids)
        got = _summary_rows(_bulk_open(port, urls), ids)
        assert port.back.last_bulk_stats["memo"] == len(urls)
        assert ref.back.last_bulk_stats["memo"] == len(urls)
        _assert_rows_equal(got, want)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("slab", ["1", "0"])
def test_port_corpus_opens_in_reference(tmp_path, ref_env, monkeypatch, slab):
    monkeypatch.setenv("HM_SLAB", slab)
    src = tmp_path / "src"
    urls = make_corpus(str(src), 12, 64, distinct=3)
    assert os.path.exists(src / "feeds" / "cols.slab") == (slab == "1")
    a, b = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    ref, port = RefRepo(path=str(a)), Repo(path=str(b), device="cpu")
    try:
        ids = [validate_doc_url(u) for u in urls]
        want = _summary_rows(_bulk_open(ref, urls), ids)
        _assert_rows_equal(_summary_rows(_bulk_open(port, urls), ids), want)
        for u in urls:
            assert plain(port.doc(u)) == plain(ref.doc(u))
            assert port.read(u, {"kind": "len", "path": ["t"]}) == ref.read(
                u, {"kind": "len", "path": ["t"]}
            )
    finally:
        ref.close()
        port.close()


# ---------------------------------------------------------------------------
# the crash marker


def test_dirty_directory_recovers(tmp_path, ref_env):
    path = str(tmp_path / "repo")
    r = Repo(path=path, device="cpu")
    url = r.create({"x": 1})
    r.change(url, lambda d: d.__setitem__("y", [1, 2]))
    assert os.path.exists(os.path.join(path, "repo.dirty"))
    r.close()
    assert not os.path.exists(os.path.join(path, "repo.dirty"))
    # a crash leaves the marker behind: the port recovers on open, and
    # its report equals the reference's on a copy
    open(os.path.join(path, "repo.dirty"), "wb").close()
    shutil.copytree(path, tmp_path / "ref")
    ref = RefRepo(path=str(tmp_path / "ref"))
    r = Repo(path=path, device="cpu")
    try:
        got, want = r.back.recovery_report, ref.back.recovery_report
        assert got is not None and want is not None
        got.pop("t_recover_ms")
        want.pop("t_recover_ms")
        assert got == want
        assert got["feeds"] >= 1 and got["wal"]["present"] == 0
        assert r.doc(url) == {"x": 1, "y": [1, 2]}
        assert plain(r.doc(url)) == plain(ref.doc(url))
    finally:
        ref.close()
        r.close()
    assert not os.path.exists(os.path.join(path, "repo.dirty"))


# ---------------------------------------------------------------------------
# the host library: blocks, change frames, the build


BLOCKS = {
    "small_json": {"a": 1, "s": "x" * 40},
    "brotli": {"ops": [{"k": f"key{i}", "v": "value" * 8} for i in range(80)]},
    "wide": {"t": "".join(chr(97 + i % 26) for i in range(5000))},
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_blocks_cross_read(name):
    obj = BLOCKS[name]
    packed = block.pack(obj)
    assert packed == ref_block.pack(obj)
    if name != "small_json":
        assert packed[:2] == b"BR"  # both builds carry brotli here
    assert ref_block.unpack(packed) == block.unpack(ref_block.pack(obj)) == obj


def test_change_frames_identical(tmp_path):
    hist = [c.to_json() for c in _reference_history()]
    for c in hist:
        frame = codec.encode_change(c)
        assert frame is not None and frame == ref_codec.encode_change(c)
        assert codec.decode_change(frame) == ref_codec.decode_change(frame)
        assert block.unpack(block.pack_change(c)) == ref_block.unpack(
            ref_block.pack_change(c)
        )


def _reference_history():
    from helpers import Site, random_mutation

    site = Site("actor00")
    rng = random.Random(3)
    for _ in range(12):
        random_mutation(site, rng)
    return list(site.opset.history)


def test_native_build_is_atomic(tmp_path):
    """Four processes build the library into one empty directory at
    once: one compiles, the others wait on the lock and load its file;
    no temporary file is left behind."""
    build_dir = str(tmp_path / "build")
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO_ROOT!r})
        from pathlib import Path
        from hypermerge_tpu_torch import native
        native.BUILD_DIR = Path({build_dir!r})
        lib = native.load()
        print(lib is not None, native.caps(), native.load_error)
    """)
    procs = [
        subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all(o.split()[0] == "True" for o in outs), outs
    assert len({o.split()[1] for o in outs}) == 1, outs
    files = sorted(os.listdir(build_dir))
    assert [f for f in files if f.endswith(".so")] == [native.target().name]
    assert not [f for f in files if f.endswith(".tmp")]


def test_native_caps_reported():
    lib = native.load()
    assert (lib is None) == (native.load_error is not None)
    if lib is not None:
        assert native.codec_drops_gil()


# ---------------------------------------------------------------------------
# the Repo scenarios of tests/test_repo.py, on the port


def test_create_change_watch_sequence(repo):
    url = repo.create()
    states = []
    h = repo.open(url).subscribe(lambda doc, _i: states.append(dict(doc)))
    repo.change(url, lambda d: d.__setitem__("title", "hi"))
    assert states[0] == {}
    assert states[-1] == {"title": "hi"}
    assert repo.doc(url) == {"title": "hi"}
    h.close()


def test_merge_fork_and_time_travel(repo):
    a = repo.create({"a": 1})
    b = repo.create({"b": 2})
    repo.merge(a, b)
    assert repo.doc(a) == {"a": 1, "b": 2}
    fork = repo.fork(a)
    repo.change(fork, lambda d: d.__setitem__("y", 2))
    assert repo.doc(fork) == {"a": 1, "b": 2, "y": 2}
    assert repo.doc(a) == {"a": 1, "b": 2}
    url = repo.create({"x": 1})
    repo.change(url, lambda d: d.__setitem__("x", 2))
    assert materialized(repo, url, 1) == {"x": 1}
    assert materialized(repo, url, 2) == {"x": 2}


def test_meta_and_destroy(repo):
    url = repo.create({"x": 1})
    repo.change(url, lambda d: d.__setitem__("y", 2))
    out = []
    repo.meta(url, out.append)
    assert out[0]["type"] == "Document" and out[0]["history"] == 2
    doc_id = validate_doc_url(url)
    repo.destroy(url)
    assert doc_id not in repo.back.docs
    assert repo.back.clocks.get(repo.back.id, doc_id) == {}


def test_persistence_and_bulk_cold_start(tmp_path):
    path = str(tmp_path / "repo")
    r = Repo(path=path, device="cpu")
    urls = []
    try:
        for i in range(5):
            url = r.create({"i": i, "t": Text(f"doc{i}")})
            r.change(url, lambda d: d["t"].insert(0, ">"))
            r.change(url, lambda d: d.__setitem__("n", Counter(i)))
            r.change(url, lambda d: d.increment("n", 2))
            urls.append(url)
        repo_id = r.id
    finally:
        r.close()
    r = Repo(path=path, device="cpu")
    try:
        assert r.id == repo_id
        r.open_many(urls)
        summ = r.back.fetch_bulk_summaries()
        assert len(summ.doc_ids) == len(urls)
        for i, url in enumerate(urls):
            doc = r.doc(url)
            assert doc["i"] == i and str(doc["t"]) == f">doc{i}"
            assert int(doc["n"]) == i + 2
        r.change(urls[0], lambda d: d.__setitem__("again", True))
        assert r.doc(urls[0])["again"] is True
    finally:
        r.close()


@pytest.mark.parametrize("call", [
    lambda r, sock: r.files,
    lambda r, sock: r.start_file_server(sock),
], ids=["files", "start_file_server"])
def test_unported_entry_points_raise(repo, call):
    """The hyperfile entry points, which raised NotImplementedError until
    files/ was ported, answer as the reference's: `files` is None until
    the file server listens and its client after; a second server on one
    backend raises RuntimeError."""
    import tempfile

    from hypermerge_tpu_torch.files.file_client import FileServerClient

    sock_dir = tempfile.mkdtemp(prefix="hm-")
    sock = os.path.join(sock_dir, "files.sock")  # unix paths: <= 107 bytes
    try:
        assert call(repo, sock) is None
        if repo.files is None:
            repo.start_file_server(sock)
        assert isinstance(repo.files, FileServerClient)
        assert repo.files.socket_path == sock
        with pytest.raises(RuntimeError):
            repo.start_file_server(sock)
    finally:
        repo.back._file_server.close()  # the fixture closes the repo
        shutil.rmtree(sock_dir, ignore_errors=True)


def test_repo_runs_on_the_backends_device(repo):
    assert repo.back.device.type == "cpu"
    assert repo.back.clocks.device.type == "cpu"
    assert repo.back.clocks.mirror.device.type == "cpu"
    # the live engine (on by default) dispatches on the backend's device
    from hypermerge_tpu_torch.backend.live import LiveApplyEngine

    assert isinstance(repo.back.live, LiveApplyEngine)
    assert repo.back.live._back.device.type == "cpu"
    json.dumps(repo.back.telemetry_payload(), default=str)


# ---------------------------------------------------------------------------
# the numpy kernel twin (ops/host_kernel.py) behind the host paths


@pytest.mark.parametrize("name", ["synth_3actor_text", "synth_1actor",
                                  "synth_tiny", "fuzz"])
def test_host_kernel_matches_plain(name):
    """run_batch_host equals kernel 1's plain version (run_batch on the
    CPU) lane for lane, and the reference's host twin on the same batch."""
    import torch

    from hypermerge_tpu.ops import host_kernel as ref_host_kernel
    from hypermerge_tpu_torch.ops import crdt_kernels as ck
    from hypermerge_tpu_torch.ops.host_kernel import run_batch_host
    from test_torch_kernel_sources import CASES

    batch = CASES[name]()
    got = run_batch_host(batch)
    want = ck.run_batch(batch, device="cpu")
    ref = ref_host_kernel.run_batch_host(batch)
    for f in want._fields:
        g = np.asarray(getattr(got, f))
        assert np.array_equal(g, getattr(want, f).numpy()), f
        assert np.array_equal(g, np.asarray(getattr(ref, f))), f
        assert torch.from_numpy(np.ascontiguousarray(g)).dtype == getattr(want, f).dtype, f


class _GossipTap:
    """A stand-in network that records each cursor gossip frame."""

    def __init__(self):
        self.frames = []

    def gossip_cursor(self, doc_id, cursor, clock):
        self.frames.append((time.perf_counter(), doc_id, dict(cursor),
                            dict(clock)))


@pytest.mark.parametrize("fresh", ["0", "1"])
def test_gossip_knobs_equal_reference(monkeypatch, fresh):
    """HM_GOSSIP_FLUSH_MS sets the gossip debouncer's window and
    HM_GOSSIP_FRESH=0 gossips the stored clock row instead of an open
    doc's in-memory clock, in both packages: for a doc whose store row
    lags its open clock (the row set back to the first change), each
    package gossips the same clock (its writer actor named by role) after
    the same 50 ms window."""
    for k, v in REF_SWITCHES.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("HM_GOSSIP_FLUSH_MS", "50")
    monkeypatch.setenv("HM_GOSSIP_FRESH", fresh)
    monkeypatch.setenv("HM_STORE_DEBOUNCE", "0")  # rows written through
    got = {}
    for name, make in (("ref", lambda: RefRepo(memory=True)),
                       ("port", lambda: Repo(memory=True, device="cpu"))):
        r = make()
        try:
            back = r.back
            url = r.create({"n": 0})
            for i in range(1, 4):
                r.change(url, lambda d, i=i: d.__setitem__("n", i))
            doc = back.docs[validate_doc_url(url)]
            writer = doc.actor_id
            back.clocks.set(back.id, doc.id, {writer: 1})
            assert dict(doc.clock) == {writer: 4}
            assert back._gossip._window == 0.05
            # the reference marks the debouncer on every patch, swarm or
            # not: let that window pass before the timed one
            assert back._gossip.flush_now(10)
            tap = _GossipTap()
            back.network = tap
            t0 = time.perf_counter()
            back._gossip_cursor(doc)
            deadline = t0 + 10
            while not tap.frames and time.perf_counter() < deadline:
                time.sleep(0.005)
            back.network = None
            (t, doc_id, cursor, clock), = tap.frames
            assert doc_id == doc.id
            assert t - t0 >= 0.05
            got[name] = {("writer" if a == writer else a): s
                         for a, s in clock.items()}
        finally:
            r.close()
    assert got["port"] == got["ref"]
    assert got["port"] == ({"writer": 1} if fresh == "0" else {"writer": 4})
