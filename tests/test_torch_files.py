"""The hyperfile slice on the port (hypermerge_tpu_torch/files/, the backend's
get_file_store / start_file_server and Repo.files), on the CPU.

- Every case of tests/test_files.py under its own name on the port's
  modules; repos are `Repo(..., device="cpu")`.
- Parity with the JAX package (below the twins): see the cross-package
  section.

The twinned file's own docstring follows.

Hyperfile subsystem: chunking, FileStore, server round trip, ledger.

Parity targets: reference tests/StreamLogic.test.ts (chunk edge cases),
tests/FileStore.test.ts:15-35 (1MiB file -> 17 blocks @62KiB, sha256
header round trip), tests/repo.test.ts:199-213 (file round trip through
the repo facade)."""

import hashlib
import os
import tempfile
import uuid

import pytest

from hypermerge_tpu_torch.backend.metadata import Metadata
from hypermerge_tpu_torch.files.file_store import FileHeader, FileStore
from hypermerge_tpu_torch.files.stream_logic import (
    MAX_BLOCK_SIZE,
    HashCounter,
    iter_chunks,
    rechunk,
)
from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.storage.feed import FeedStore, memory_storage_fn
from hypermerge_tpu_torch.utils.ids import url_to_id


def Repo(*args, **kw):
    """The port's Repo on the CPU (tests run where no card is present)."""
    kw.setdefault("device", "cpu")
    return _PortRepo(*args, **kw)


class TestRemoteFileFetch:
    """Hyperfile replication end-to-end (VERDICT r5 item 5): a repo
    fetches a file it doesn't hold from a peer over encrypted TCP,
    streaming blocks with progress events (reference
    src/FileStore.ts:33-36 + src/ReplicationManager.ts:71-89)."""

    def _tcp_pair(self):
        from hypermerge_tpu_torch.net.tcp import TcpSwarm

        ra, rb = Repo(memory=True), Repo(memory=True)
        sa, sb = TcpSwarm(), TcpSwarm()
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)
        return ra, rb, sa, sb

    def test_one_mib_file_replicates_over_tcp_with_progress(self):
        ra, rb, sa, sb = self._tcp_pair()
        try:
            data = os.urandom(1024 * 1024)
            header = ra.back.get_file_store().write(
                data, "application/octet-stream"
            )
            file_id = url_to_id(header.url)
            fs_b = rb.back.get_file_store()
            progress = []
            fs_b.subscribe_progress(
                file_id, lambda blocks, nbytes: progress.append(
                    (blocks, nbytes)
                )
            )
            got = fs_b.read_bytes(file_id, timeout=60)
            assert got == data
            hdr = fs_b.header_wait(file_id, timeout=10)
            assert hdr.sha256 == header.sha256
            assert hdr.size == len(data)
            assert hdr.mime_type == "application/octet-stream"
            assert hdr.blocks == 17  # 1MiB @ 62KiB
            # progress fired per block: 17 data + 1 header
            assert progress and progress[-1][0] == 18
            assert progress[-1][1] >= len(data)
        finally:
            ra.close()
            rb.close()
            sa.destroy()
            sb.destroy()

    def test_remote_read_times_out_when_no_holder(self):
        from hypermerge_tpu_torch.utils import keys as keymod
        from hypermerge_tpu_torch.utils.ids import to_hyperfile_url

        repo = Repo(memory=True)
        try:
            bogus = keymod.create().public_key
            fs = repo.back.get_file_store()
            with pytest.raises(TimeoutError):
                fs.read_bytes(url_to_id(to_hyperfile_url(bogus)),
                              timeout=0.3)
        finally:
            repo.close()

    def test_http_server_fetches_remote_file(self):
        """GET /hyperfile:/<id> on a swarm-wired file server for a file
        a PEER holds: the server replicates it in and streams it
        (reference: file feeds replicate like any feed)."""
        ra, rb, sa, sb = self._tcp_pair()
        sock = server_path()
        try:
            data = os.urandom(200_000)
            header = ra.back.get_file_store().write(data, "text/plain")
            rb.start_file_server(sock)
            from hypermerge_tpu_torch.files.file_client import FileServerClient

            hdr2, got = FileServerClient(sock).read(header.url)
            assert got == data
            assert hdr2.sha256 == header.sha256
            assert hdr2.mime_type == "text/plain"
        finally:
            ra.close()
            rb.close()
            sa.destroy()
            sb.destroy()
            if os.path.exists(sock):
                os.remove(sock)

    def test_failed_remote_fetch_leaves_no_trace(self):
        """A bogus-id fetch on a SWARM-WIRED store times out AND cleans
        up: no feed stays registered/announced for an id that yielded
        nothing."""
        from hypermerge_tpu_torch.utils import keys as keymod
        from hypermerge_tpu_torch.utils.ids import to_hyperfile_url

        ra, rb, sa, sb = self._tcp_pair()
        try:
            bogus = keymod.create().public_key
            fid = url_to_id(to_hyperfile_url(bogus))
            fs = rb.back.get_file_store()
            with pytest.raises(TimeoutError):
                fs.header_wait(fid, timeout=0.3)
            assert rb.back.feeds.get_feed(fid) is None
            assert fid not in rb.back.feed_info.all_public_ids()
        finally:
            ra.close()
            rb.close()
            sa.destroy()
            sb.destroy()

    def test_local_read_semantics_unchanged(self):
        """timeout=0 keeps the strict local contract: missing feeds
        raise FileNotFoundError immediately."""
        store = FileStore(FeedStore(memory_storage_fn))
        from hypermerge_tpu_torch.utils import keys as keymod

        with pytest.raises(FileNotFoundError):
            store.read_bytes(keymod.create().public_key)


def server_path() -> str:
    return os.path.join(
        tempfile.gettempdir(), f"hypermerge-tpu-test-{uuid.uuid4().hex[:8]}.sock"
    )


# -- stream logic -------------------------------------------------------


def test_rechunk_passthrough_small_chunks():
    chunks = [b"ab", b"cd", b"e"]
    assert list(rechunk(chunks, 4)) == [b"ab", b"cd", b"e"]


def test_rechunk_splits_oversized():
    out = list(rechunk([b"abcdefghij"], 4))
    assert out == [b"abcd", b"efgh", b"ij"]
    assert b"".join(out) == b"abcdefghij"


def test_rechunk_exact_multiple_and_empty():
    assert list(rechunk([b"abcd"], 4)) == [b"abcd"]
    assert list(rechunk([b""], 4)) == []
    assert list(rechunk([], 4)) == []


def test_iter_chunks_normalizes_bytes_and_iterables():
    assert list(iter_chunks(b"xyz")) == [b"xyz"]
    assert list(iter_chunks([b"x", b"yz"])) == [b"x", b"yz"]


def test_hash_counter():
    c = HashCounter()
    data = [b"hello ", b"world"]
    assert list(c.wrap(data)) == data
    assert c.bytes == 11
    assert c.chunks == 2
    assert c.digest_hex == hashlib.sha256(b"hello world").hexdigest()


# -- FileStore ----------------------------------------------------------


@pytest.fixture
def store():
    return FileStore(FeedStore(memory_storage_fn))


def test_one_mib_file_is_17_blocks(store):
    """1MiB at 62KiB chunks = 17 data blocks (reference
    tests/FileStore.test.ts:15-35)."""
    data = os.urandom(1024 * 1024)
    header = store.write(data, "application/octet-stream")
    assert header.blocks == 17
    assert header.size == len(data)
    assert header.sha256 == hashlib.sha256(data).hexdigest()
    file_id = url_to_id(header.url)
    assert store.read_bytes(file_id) == data
    # feed holds data blocks + ONE trailing header block
    feed = store.feeds.get_feed(file_id)
    assert feed.length == 18
    assert max(len(b) for b in feed.read_all()[:-1]) <= MAX_BLOCK_SIZE


def test_header_round_trip(store):
    header = store.write(b"hello", "text/plain")
    got = store.header(url_to_id(header.url))
    assert got == header
    assert got.mime_type == "text/plain"
    assert FileHeader.from_json(header.to_json()) == header


def test_empty_file(store):
    header = store.write(b"", "text/plain")
    assert header.blocks == 0
    assert header.size == 0
    assert store.read_bytes(url_to_id(header.url)) == b""


def test_write_log_announces_completed_uploads(store):
    seen = []
    store.write_log.subscribe(seen.append)
    h = store.write(b"abc", "text/plain")
    assert seen == [h]


# -- server + client through the repo facade ----------------------------


def test_repo_file_round_trip():
    """Write via repo.files, read back, check meta (reference
    tests/repo.test.ts:199-213)."""
    repo = Repo(memory=True)
    path = server_path()
    try:
        repo.start_file_server(path)
        assert repo.files is not None
        data = os.urandom(200 * 1024)
        header = repo.files.write(data, "application/x-test")
        assert header.size == len(data)
        assert header.blocks == 4  # ceil(200KiB / 62KiB)

        got_header, body = repo.files.read(header.url)
        assert body == data
        assert got_header.sha256 == hashlib.sha256(data).hexdigest()
        assert got_header.mime_type == "application/x-test"
        assert repo.files.header(header.url) == got_header

        # meta() resolves hyperfile urls from the ledger
        metas = []
        repo.meta(header.url, metas.append)
        assert metas == [
            {
                "type": "File",
                "bytes": len(data),
                "mimeType": "application/x-test",
            }
        ]
    finally:
        repo.close()
        assert not os.path.exists(path)


def test_file_server_missing_file_404():
    repo = Repo(memory=True)
    path = server_path()
    try:
        repo.start_file_server(path)
        from hypermerge_tpu_torch.utils import keys

        bogus = f"hyperfile:/{keys.create().public_key}"
        with pytest.raises(FileNotFoundError):
            repo.files.header(bogus)
        # a 404 lookup must not create/register a feed for the bogus id
        assert repo.back.feeds.get_feed(url_to_id(bogus)) is None
    finally:
        repo.close()


# -- metadata ledger ----------------------------------------------------


def test_metadata_ledger_persists_across_restart(tmp_path):
    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    sock = server_path()
    try:
        repo.start_file_server(sock)
        header = repo.files.write(b"persistent", "text/plain")
    finally:
        repo.close()

    repo2 = Repo(path=path)
    try:
        file_id = url_to_id(header.url)
        assert repo2.back.meta.file_metadata(file_id) == {
            "type": "File",
            "bytes": 10,
            "mimeType": "text/plain",
        }
        # the file bytes themselves also survive
        assert FileStore(repo2.back.feeds).read_bytes(file_id) == b"persistent"
    finally:
        repo2.close()


def test_metadata_ledger_skips_corrupt_entries():
    from hypermerge_tpu_torch.storage.sql import SqlDatabase
    from hypermerge_tpu_torch.storage.stores import KeyStore

    from hypermerge_tpu_torch.utils import keys

    feeds = FeedStore(memory_storage_fn)
    key_store = KeyStore(SqlDatabase(":memory:"))
    meta = Metadata(feeds, key_store)
    meta.add_file(f"hyperfile:/{keys.create().public_key}", 5, "a/b")
    meta.ledger.append(b"\xff\xfenot json")  # corrupt entry
    meta.add_file(f"hyperfile:/{keys.create().public_key}", 6, "c/d")

    meta2 = Metadata(feeds, key_store)  # replay over the same feed
    assert len(meta2.files) == 2


# -- parity with the JAX package ---------------------------------------
#
# Both packages on the CPU, on data made from a numpy seed, at the sizes
# where chunking changes shape: empty, one byte, either side of one block
# and 1 MiB (17 data blocks). Each size goes in once as bytes and once as
# an iterable of odd-sized chunks (rechunk splits and never coalesces, so
# the two forms give different block sequences). Tolerance: none, every
# comparison is byte for byte.

import shutil

import numpy as np

from hypermerge_tpu_torch.net.tcp import TcpSwarm
from hypermerge_tpu_torch.storage.feed import file_storage_fn
from hypermerge_tpu_torch.storage.integrity import file_sig_storage_fn
from hypermerge_tpu_torch.utils import keys as port_keys
from hypermerge_tpu_torch.utils.ids import to_hyperfile_url

from helpers import wait_until
from test_torch_repo import _assert_rows_equal, _summary_rows, plain

SIZES = [0, 1, MAX_BLOCK_SIZE - 1, MAX_BLOCK_SIZE, MAX_BLOCK_SIZE + 1,
         1 << 20]
FORMS = ["bytes", "chunks"]
MIME = "application/x-parity"


def _data(size):
    rng = np.random.default_rng(7000 + size)
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def _chunks(data):
    """`data` as odd-sized chunks, some above MAX_BLOCK_SIZE (split by
    the write path), some far below (kept whole)."""
    rng = np.random.default_rng(len(data))
    out, i = [], 0
    while i < len(data):
        n = 2 * int(rng.integers(0, MAX_BLOCK_SIZE)) + 1
        out.append(data[i:i + n])
        i += n
    return out


def _input(data, form):
    return data if form == "bytes" else iter(_chunks(data))


def _ref():
    """The reference's file modules, imported per test (jax comes with
    them)."""
    from hypermerge_tpu.files.file_store import FileStore as RefFileStore
    from hypermerge_tpu.storage.feed import FeedStore as RefFeedStore
    from hypermerge_tpu.storage.feed import file_storage_fn as ref_storage_fn
    from hypermerge_tpu.storage.integrity import (
        file_sig_storage_fn as ref_sig_fn,
    )

    return RefFileStore, RefFeedStore, ref_storage_fn, ref_sig_fn


def _disk_store(pkg, root):
    """A FileStore over feeds on disk (blocks, index and signatures), of
    the reference ("ref") or the port ("port")."""
    if pkg == "ref":
        fs_cls, feeds_cls, storage_fn, sig_fn = _ref()
    else:
        fs_cls, feeds_cls, storage_fn, sig_fn = (
            FileStore, FeedStore, file_storage_fn, file_sig_storage_fn)
    return fs_cls(feeds_cls(storage_fn(str(root)), sig_fn=sig_fn(str(root))))


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("size", SIZES)
def test_write_equals_reference(tmp_path, monkeypatch, size, form):
    """With one fixed keypair in both packages, FileStore.write gives the
    same header JSON, the same blocks (the data rechunked, then the
    header last) and the same feed files on disk, signatures included."""
    from hypermerge_tpu.utils import keys as ref_keys

    seed = bytes(range(32))
    for mod in (ref_keys, port_keys):
        monkeypatch.setattr(
            mod, "create", lambda s=None, _create=mod.create: _create(seed))
    data = _data(size)
    got = {}
    for pkg in ("ref", "port"):
        store = _disk_store(pkg, tmp_path / pkg)
        header = store.write(_input(data, form), MIME)
        fid = url_to_id(header.url)
        blocks = store.feeds.get_feed(fid).read_all()
        store.feeds.close()
        got[pkg] = (header.to_json(), blocks, _tree(tmp_path / pkg))
    assert got["port"] == got["ref"]
    hdr, blocks, tree = got["port"]
    assert hdr == {
        "type": "File", "url": to_hyperfile_url(port_keys.create().public_key),
        "bytes": size, "mimeType": MIME,
        "sha256": hashlib.sha256(data).hexdigest(), "blocks": len(blocks) - 1,
    }
    assert b"".join(blocks[:-1]) == data
    assert all(0 < len(b) <= MAX_BLOCK_SIZE for b in blocks[:-1])
    if form == "bytes":
        assert len(blocks) - 1 == -(-size // MAX_BLOCK_SIZE)
    assert len(tree) >= 2  # the block log and its signatures at least


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("size", SIZES)
def test_cross_read(tmp_path, size, writer):
    """Files one package writes into a directory read back through the
    other's FileStore byte for byte, with equal headers, and their feeds
    audit clean there (the writer's signatures verify)."""
    reader = "port" if writer == "ref" else "ref"
    data = _data(size)
    store = _disk_store(writer, tmp_path)
    headers = [store.write(_input(data, form), MIME) for form in FORMS]
    store.feeds.close()
    other = _disk_store(reader, tmp_path)
    try:
        for header in headers:
            fid = url_to_id(header.url)
            assert other.read_bytes(fid) == data
            assert other.header(fid).to_json() == header.to_json()
            assert other.feeds.get_feed(fid).audit()
    finally:
        other.feeds.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("size", SIZES)
def test_mixed_pair_fetches_over_tcp(monkeypatch, size, writer):
    """A reference Repo and a port Repo on one TcpSwarm pair (each on its
    package's swarm, encrypted and authenticated): the writer stores the
    file in both forms, the other fetches each with progress events, and
    the bytes, header and per-block progress equal the writer's."""
    from hypermerge_tpu.net.tcp import TcpSwarm as RefTcpSwarm
    from hypermerge_tpu.repo import Repo as RefRepo

    monkeypatch.setenv("HM_SERVICE", "0")
    rp, rr = Repo(memory=True), RefRepo(memory=True)
    sp, sr = TcpSwarm(), RefTcpSwarm()
    try:
        rp.set_swarm(sp)
        rr.set_swarm(sr)
        sp.connect(sr.address)
        w, r = (rr, rp) if writer == "ref" else (rp, rr)
        data = _data(size)
        for form in FORMS:
            header = w.back.get_file_store().write(_input(data, form), MIME)
            fid = url_to_id(header.url)
            held = w.back.feeds.get_feed(fid).read_all()
            fs = r.back.get_file_store()
            progress = []
            fs.subscribe_progress(
                fid, lambda blocks, nbytes: progress.append((blocks, nbytes)))
            assert fs.read_bytes(fid, timeout=60) == data
            assert fs.header_wait(fid, timeout=10).to_json() == \
                header.to_json()
            assert r.back.feeds.get_feed(fid).read_all() == held
            last = (len(held), sum(len(b) for b in held))
            wait_until(lambda: progress and progress[-1] == last)
            assert [p[0] for p in progress] == list(range(1, len(held) + 1))
        (peer,) = rp.back.network.peers.values()
        assert peer.connection.peer_identity == rr.back.id
    finally:
        rr.close()
        rp.close()
        sr.destroy()
        sp.destroy()


def test_repo_with_files_reopens_as_without(tmp_path, monkeypatch):
    """A Repo(path) holding docs and hyperfiles, closed and reopened: its
    open_many + fetch_bulk_summaries rows equal those of the same docs in
    a copy that never held the files, each file reads back byte for byte
    from disk, and no file feed reached a sidecar: the corpus slab and
    the feeds directory hold column state for the docs' actors alone."""
    monkeypatch.setenv("HM_SERVICE", "0")
    plain_dir, with_dir = tmp_path / "docs", tmp_path / "docs_files"
    pairs = [port_keys.create() for _ in SIZES]
    r = Repo(path=str(plain_dir))
    urls = []
    try:
        for i, pair in enumerate(pairs):
            url = r.create({"file": to_hyperfile_url(pair.public_key),
                            "edits": []})
            for k in range(3):
                r.change(url, lambda d, k=k: d["edits"].append(10 * i + k))
            urls.append(url)
    finally:
        r.close()
    shutil.copytree(plain_dir, with_dir)
    r = Repo(path=str(with_dir))
    headers = []
    try:
        fs = r.back.get_file_store()
        it = iter(pairs)
        with monkeypatch.context() as m:  # the docs' urls name these keys
            m.setattr(port_keys, "create", lambda s=None: next(it))
            for size in SIZES:
                headers.append(fs.write(_data(size), MIME))
    finally:
        r.close()
    rows = {}
    for name, root in (("docs", plain_dir), ("files", with_dir)):
        r = Repo(path=str(root))
        try:
            r.open_many(urls)
            summ = r.back.fetch_bulk_summaries()
            rows[name] = _summary_rows(summ, [url_to_id(u) for u in urls])
            docs = [plain(r.doc(u)) for u in urls]
            if name == "files":
                assert docs == want_docs
                fs = r.back.get_file_store()
                for size, header in zip(SIZES, headers):
                    fid = url_to_id(header.url)
                    assert docs[SIZES.index(size)]["file"] == header.url
                    assert fs.read_bytes(fid) == _data(size)
                    assert fs.header(fid) == header
                    assert r.back.meta.file_metadata(fid) == {
                        "type": "File", "bytes": size, "mimeType": MIME}
                    assert fid not in r.back.actors
                slab = r.back._col_slab
                names = set(slab.feed_names()) if slab is not None else set()
            else:
                want_docs = docs
        finally:
            r.close()
    _assert_rows_equal(rows["files"], rows["docs"])
    file_ids = {url_to_id(h.url) for h in headers}
    assert not names & file_ids
    for dirpath, _dirs, files in os.walk(with_dir / "feeds"):
        for f in files:
            if any(f.startswith(fid) for fid in file_ids):
                assert not f.endswith((".cols", ".cols2")), f
